"""The reference CI's valgrind "Memory Test" step, re-thought for JAX.

The reference runs its whole suite under ASan + valgrind to prove no memory
misbehavior (reference test/CMakeLists.txt:3; .github/workflows/ci.yml
"Memory Test").  The JAX-world failure modes worth the same treatment are
(1) HIDDEN host<->device transfers — an implicit sync inside an engine loop
silently serializes the device and is invisible in tests that only check values —
and (2) comm-structure drift on the sharded path — an operator change that
silently replaces the ring ppermute halo with a full all_gather would still
pass every value test while multiplying interconnect traffic by n/boundary.

(1) is locked with ``jax.transfer_guard_device_to_host("disallow")``:
implicit device->host pulls (the hidden syncs that stall a device) raise, while
the engines' *explicit* boundary syncs (batched ``jax.device_get`` at
restart edges) stay legal — exactly the contract the docstrings promise.
(Host->device scalar uploads — eps/offset/k_limit as dynamic jit operands —
are deliberate design, bytes-sized, and not guarded.)  (2) is locked by counting collective primitives in the
matvec jaxpr and bounding the ppermute operand (halo) sizes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu import LambdaLanczos, Exponentiator
from lanczos_tpu.ops.operators import DIAOperator
from lanczos_tpu.parallel import mesh as pmesh
from lanczos_tpu.parallel.sharded import ShardedBSROperator, ShardedDIAOperator
from lanczos_tpu.utils.random import fixed_seed_initializer


@pytest.fixture(autouse=True, scope="module")
def _fresh_compilation_state():
    """The guard tests run late in the suite; with hundreds of compiled
    executables alive, the donated-buffer hybrid step under an active
    transfer guard segfaulted the CPU runtime twice (flaky, full-suite-only
    — never reproducible in isolation or in small subsets).  A fresh
    executable cache before this module sidesteps the stale-donation
    interaction."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return pmesh.make_mesh(jax.devices()[:8])


def _chain_dia(n, dtype=np.float64):
    return DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, dtype), np.full(n, -1.0, dtype)], n
    )


# ---------------------------------------------------------------------------
# (1) no hidden transfers: the valgrind analogue for engine loops
# ---------------------------------------------------------------------------


def test_fused_solve_no_implicit_transfers():
    """A fused-engine deflated solve performs ONLY explicit host syncs."""
    n = 256
    op = _chain_dia(n)
    eng = LambdaLanczos(op, find_maximum=False, num_eigs=2, mode="fused")
    eng.eigenvalue_offset = -4.0
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    with jax.transfer_guard_device_to_host("disallow"):
        vals, vecs = eng.run()
    exact = np.sort(-2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))[:2]
    assert np.max(np.abs(np.sort(np.asarray(vals)) - exact)) < 1e-9


def test_pv_thick_solve_no_implicit_transfers():
    """The df64 thick-restart engine (heaviest host<->device choreography:
    segment reads, Schur restarts, df rotations) is also implicit-free."""
    n = 256
    op = _chain_dia(n, np.float32)
    eng = LambdaLanczos(op, find_maximum=False, num_eigs=2, dtype=np.float32, mode="fused")
    eng.precise_vectors = True
    eng.restart_policy = "thick"
    eng.max_iteration = 40
    eng.max_restarts = 64
    eng.eps = 1e-12
    eng.eigenvalue_offset = -4.0
    with jax.transfer_guard_device_to_host("disallow"):
        vals, _ = eng.run()
    exact = np.sort(-2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))[:2]
    assert np.max(np.abs(np.sort(np.asarray(vals)) - exact)) < 1e-9


def test_exponentiator_fused_no_implicit_transfers():
    n = 128
    op = _chain_dia(n)
    ex = Exponentiator(op, mode="fused")
    v = jnp.zeros((n,), jnp.float64).at[0].set(1.0)
    with jax.transfer_guard_device_to_host("disallow"):
        out, itern = ex.run(0.5, v)
    assert np.isfinite(np.asarray(out)).all() and itern >= 1


def test_sharded_solve_no_implicit_transfers(mesh):
    n = 1024
    op = ShardedDIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh=mesh
    )
    eng = LambdaLanczos(op, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.init_vector = fixed_seed_initializer(np.float64, seed=5)
    with jax.transfer_guard_device_to_host("disallow"):
        val, _ = eng.run_one()
    assert abs(val - (-2 * np.cos(np.pi / (n + 1)))) < 1e-9


# ---------------------------------------------------------------------------
# (2) collective structure: comm volume per iteration, locked from the jaxpr
# ---------------------------------------------------------------------------

_COLLECTIVES = ("ppermute", "all_gather", "psum", "all_to_all", "reduce_scatter")


def _walk(jaxpr, acc, ppermute_elems):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        acc[name] = acc.get(name, 0) + 1
        if name == "ppermute":
            ppermute_elems.append(int(np.prod(eqn.invars[0].aval.shape)))
        for val in eqn.params.values():
            if hasattr(val, "jaxpr"):
                _walk(val.jaxpr, acc, ppermute_elems)
            elif hasattr(val, "eqns"):
                _walk(val, acc, ppermute_elems)
            elif isinstance(val, (list, tuple)):
                for it in val:
                    if hasattr(it, "jaxpr"):
                        _walk(it.jaxpr, acc, ppermute_elems)
                    elif hasattr(it, "eqns"):
                        _walk(it, acc, ppermute_elems)
    return acc


def _collectives(fn, *args):
    acc, pp = {}, []
    _walk(jax.make_jaxpr(fn)(*args).jaxpr, acc, pp)
    return {k: v for k, v in acc.items() if k in _COLLECTIVES}, pp


def test_dia_ring_halo_comm_structure(mesh):
    """Ring DIA matvec: exactly TWO ppermutes (left+right halo), no
    all_gather, and each halo moves only max|offset| elements per shard —
    the comm-volume contract of the ring halo."""
    n = 1024
    op = ShardedDIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh=mesh
    )
    counts, pp_elems = _collectives(op.matvec, jnp.zeros((n,)))
    assert counts.get("ppermute", 0) == 2, counts
    assert counts.get("all_gather", 0) == 0, counts
    # halo width = max|offset| = 1 element per shard per direction
    assert pp_elems and max(pp_elems) <= 1, pp_elems


def test_bsr_gather_comm_structure(mesh):
    """Gather-mode BSR matvec: exactly ONE all_gather of the input vector
    (each row slab may reference any column), no ppermute."""
    n = 1024
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1])
    cols = np.concatenate([i + 1, i])
    vals = np.full(2 * (n - 1), -1.0)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh)
    counts, _ = _collectives(op.matvec, jnp.zeros((n,)))
    assert counts.get("all_gather", 0) == 1, counts
    assert counts.get("ppermute", 0) == 0, counts


def test_bsr_ring_comm_structure(mesh):
    """Ring-mode BSR matvec: ppermute pipeline instead of all_gather."""
    n = 1024
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1])
    cols = np.concatenate([i + 1, i])
    vals = np.full(2 * (n - 1), -1.0)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, comm="ring")
    counts, _ = _collectives(op.matvec, jnp.zeros((n,)))
    assert counts.get("all_gather", 0) == 0, counts
    assert counts.get("ppermute", 0) >= 1, counts


def test_bsr_footprint_comm_volume(mesh):
    """Footprint-mode BSR matvec (VERDICT r4 item 2): no all_gather; one
    ppermute per occurring owner hop, and the TOTAL words moved per chip
    equal sum_h F_h * bk — proportional to the touched remote column
    blocks, NOT to n.  Pattern: chain + a handful of long-range couplings;
    touched remote blocks = 14 of 128, so the exchange moves ~9% of the
    gather's volume."""
    rng = np.random.default_rng(0)
    n = 1024
    i = np.arange(n - 1)
    r = [i, i + 1]
    c = [i + 1, i]
    v = [np.full(n - 1, -1.0)] * 2
    for d, cnt in ((n // 2, 12), (n // 4, 8)):
        pos = rng.choice(n - d, cnt, replace=False)
        w = rng.standard_normal(cnt)
        r += [pos, pos + d]
        c += [pos + d, pos]
        v += [w, w]
    rows = np.concatenate(r)
    cols = np.concatenate(c)
    vals = np.concatenate(v)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8, comm="auto")
    assert op.comm == "footprint", op.comm
    counts, pp_elems = _collectives(op.matvec, jnp.zeros((n,)))
    assert counts.get("all_gather", 0) == 0, counts
    hop_list = op.footprint[1]
    assert counts.get("ppermute", 0) == len(hop_list), (counts, len(hop_list))
    # words moved = sum over hops of the padded footprint F_h * bk
    expect = sum(s.shape[1] * op.bk for (_h, _b, _c, s) in hop_list)
    assert sum(pp_elems) == expect, (pp_elems, expect)
    # and that is a small fraction of the gather-mode volume (n words)
    assert expect < n // 4, (expect, n)


def test_bsr_footprint_df_comm_volume(mesh):
    """matvec_df in footprint mode: both words ride ONE stacked ppermute
    per hop (2x the payload, same message count)."""
    rng = np.random.default_rng(1)
    n = 1024
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1, [0], [n // 2]])
    cols = np.concatenate([i + 1, i, [n // 2], [0]])
    vals = np.concatenate([np.full(2 * (n - 1), -1.0), [0.5, 0.5]])
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8, comm="footprint")
    assert op.comm == "footprint"
    counts, pp_elems = _collectives(
        op.matvec_df, jnp.zeros((n,)), jnp.zeros((n,)))
    assert counts.get("all_gather", 0) == 0, counts
    hop_list = op.footprint[1]
    assert counts.get("ppermute", 0) == len(hop_list), counts
    expect = 2 * sum(s.shape[1] * op.bk for (_h, _b, _c, s) in hop_list)
    assert sum(pp_elems) == expect, (pp_elems, expect)
