"""Multi-process (multi-host) execution harness and demo.

The reference library is strictly single-address-space (SURVEY.md §2:
grep-verified no MPI/NCCL; ``std::vector<T>(n)`` in one process,
lambda_lanczos.hpp:242).  This framework scales across HOSTS via
``jax.distributed.initialize`` + a global mesh (SURVEY.md:314-315) — and
that path is testable without a cluster (SURVEY.md:269): each process gets a
few virtual CPU devices (``--xla_force_host_platform_device_count``) and
the XLA CPU client runs the cross-process collectives over gloo.

This module is both the proof harness (tests/test_multiprocess.py and
``__graft_entry__`` dryrun regime 11 spawn it) and the user template for a
real multi-host launch: run one copy per host with

    python -m lanczos_tpu.parallel.mp_demo \
        --coordinator HOST0:PORT --num-processes N --process-id I

Every process executes the same driver logic; sharded arrays span all
processes (each host touches only its addressable shards), replicated
scalars (alpha/beta, eigenvalues) come out bitwise-identical everywhere.
The one multi-process invariant the library itself guarantees is
cross-process consistency of "replicated" host randomness — see
``utils.random._fresh_rng`` (process 0's entropy is broadcast, so the
hybrid engine's replicated Krylov buffer stays consistent; a per-process
draw measured 9.7e-6 instead of 1e-15 on the 2-process stencil).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

__all__ = ["run_solves", "launch", "main"]


def run_solves(n: int = 512, pv_rows: int = 48, pv_restarts: int = 64) -> dict:
    """Solve the chain stencil (hybrid engine) and a precise_vectors thick
    problem on the GLOBAL mesh; returns errors + values for cross-process
    comparison.  Call after ``jax.distributed`` is initialized."""
    import numpy as np

    from ..api import LambdaLanczos
    from . import mesh as pmesh
    from .sharded import ShardedDIAOperator

    m = pmesh.make_mesh()
    op = ShardedDIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n, m)

    # 1. hybrid engine (replicated Krylov buffer, per-iteration host solve):
    # the engine most sensitive to cross-process replica consistency.
    eng = LambdaLanczos(op, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-12
    val, _vec = eng.run_one()
    exact1 = -2 * np.cos(np.pi / (n + 1))

    # 2. precise_vectors + thick restart (fused while_loop, sharded state):
    # the bounded-memory accuracy path over the same cross-process halos.
    eng2 = LambdaLanczos(op, find_maximum=False, num_eigs=2)
    eng2.eigenvalue_offset = -4.0
    eng2.precise_vectors = True
    eng2.restart_policy = "thick"
    eng2.max_iteration = pv_rows
    eng2.max_restarts = pv_restarts
    eng2.eps = 1e-12
    vals2, _ = eng2.run()
    exact2 = [-2 * np.cos(k * np.pi / (n + 1)) for k in (1, 2)]
    return {
        "stencil_val": float(val),
        "stencil_err": abs(float(val) - exact1),
        "pv_vals": [float(v) for v in vals2],
        "pv_err": max(abs(float(vals2[i]) - exact2[i]) for i in range(2)),
    }


def _maybe_coverage_hook() -> None:
    """Record line coverage inside a spawned worker process.

    The repo's coverage gate (tools/coverage_gate.py) is built on THIS
    process's sys.monitoring, which cannot see lines executed in the real
    OS processes :func:`launch` spawns — exactly the lines this module
    exists for.  When the gate exports ``LT_COV_DUMP`` (a
    directory), each worker installs the same first-hit LINE monitor and
    dumps its hits there at exit; the gate merges the dumps."""
    dump_dir = os.environ.get("LT_COV_DUMP")
    if not dump_dir:
        return
    import atexit
    import json as _json

    target = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hits: dict = {}

    def on_line(code, line):
        f = code.co_filename
        if f.startswith(target):
            hits.setdefault(f, set()).add(line)
        return sys.monitoring.DISABLE

    mon = sys.monitoring
    tool = mon.COVERAGE_ID
    mon.use_tool_id(tool, "lanczos-mp-coverage")
    mon.register_callback(tool, mon.events.LINE, on_line)
    mon.set_events(tool, mon.events.LINE)

    def dump():
        path = os.path.join(dump_dir, f"mp_{os.getpid()}.json")
        with open(path, "w") as fh:
            _json.dump({f: sorted(ls) for f, ls in hits.items()}, fh)

    atexit.register(dump)


def main(argv=None) -> int:
    _maybe_coverage_hook()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default="127.0.0.1:12321")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="virtual CPU devices per process (CPU testing only)")
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)

    # CPU-virtual-device env must be set before the first jax import.  The
    # children stay on the CPU: a JAX process that touches an accelerator
    # reserves most of its memory, so a second one on the same card fails.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault(
        "XLA_FLAGS",
        f"--xla_force_host_platform_device_count={args.local_devices}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from . import mesh as pmesh

    pmesh.initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes
    out = run_solves(n=args.n)
    out["process_id"] = args.process_id
    out["global_devices"] = len(jax.devices())
    out["local_devices"] = len(jax.local_devices())
    print(json.dumps(out), flush=True)
    return 0


def launch(num_processes: int = 2, *, local_devices: int = 4, n: int = 512,
           timeout: float = 540.0, port: int | None = None) -> list[dict]:
    """Spawn ``num_processes`` real OS processes running :func:`main` against
    a local coordinator and return each process's parsed result dict.

    Raises on any nonzero exit; the caller asserts cross-process equality.
    """
    if port is None:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # one process per card: children never open one
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={local_devices}"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "lanczos_tpu.parallel.mp_demo",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes),
             "--process-id", str(i),
             "--local-devices", str(local_devices),
             "--n", str(n)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(num_processes)
    ]
    results = []
    errors = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"process {i} rc={p.returncode}\n{err[-2000:]}")
            continue
        results.append(json.loads(out.strip().splitlines()[-1]))
    if errors:
        raise RuntimeError("multi-process launch failed:\n" + "\n".join(errors))
    return results


if __name__ == "__main__":
    sys.exit(main())
