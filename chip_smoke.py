"""End-to-end smoke run of lanczos_tpu on one GPU (or, with --multi, four).

    python chip_smoke.py            # every phase below, one card
    python chip_smoke.py --multi    # the sharded phase only, four cards

Each phase drives a user entry point at a size users run, compares the
answer with a plain reference (float64 on the host, or a closed form),
prints one line (error, tolerance, warm wall seconds, compile seconds as
set-up) and raises on any miss.  The script refuses to run anywhere but on a
GPU and catches no phase failure: any failure exits non-zero without the
final ``{"ok": true, ...}`` line.  All data is generated from a fixed seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Full sizes.  ``run_phases`` takes a smaller table in the CPU rehearsal.
FULL = dict(
    spmv_r=512, spmv_s=8,           # 512 row blocks x 8 tiles of 128x128 f32: 64 Mi nnz
    reorth_n=1 << 22, reorth_cap=257, reorth_k=200,
    reorth_ref_n=1 << 18, reorth_ref_cap=129, reorth_ref_k=100,
    df64_n=1 << 20,
    lanczos_n=1 << 20,
    flagship_n=1 << 22,
    precise_n=4000, pv_n=1 << 20,
    expm_n=1 << 20,
)


def _say(phase, **kw):
    print(phase, json.dumps(kw), flush=True)


def _timed(fn):
    """(result, warm wall seconds, compile seconds): first call pays the
    compile, the second is the steady run."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    warm = time.perf_counter() - t0
    return out, warm, max(first - warm, 0.0)


def _check(phase, err, tol):
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{phase}: error {err:.3e} exceeds tolerance {tol:.1e}")


def _chain_exact(n, k):
    """k lowest eigenvalues of the open -1 hopping chain of length n."""
    return -2.0 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))


def _chain_dia(n):
    import jax.numpy as jnp

    from lanczos_tpu import DIAOperator

    off = jnp.full(n, -1.0, jnp.float32)
    return DIAOperator.from_diagonals([-1, 1], [off, off], n)


def _chain_coo(n):
    i = np.arange(n - 1)
    return np.concatenate([i, i + 1]), np.concatenate([i + 1, i]), -np.ones(2 * (n - 1))


def phase_spmv(z):
    """The BSR matvec against a float64 host evaluation of the same tiles.
    Tolerance 1e-5 max|y|: the f32 rounding of a 1024-term sum (TF32 would
    show ~1e-3)."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu import BSROperator

    r, s, b = z["spmv_r"], z["spmv_s"], 128
    n = r * b
    kb, kc, kx = jax.random.split(jax.random.PRNGKey(0), 3)
    blocks = jax.random.normal(kb, (r, s, b, b), jnp.float32) / np.sqrt(s * b)
    cols = jax.random.randint(kc, (r, s), 0, n // b, dtype=jnp.int32)
    x = jax.random.normal(kx, (n,), jnp.float32)
    op = BSROperator(blocks, cols, n)
    mv = jax.jit(lambda o, v: o.matvec(v))
    y, warm, comp = _timed(lambda: mv(op, x))
    xg = np.asarray(x, np.float64).reshape(-1, b)[np.asarray(cols)]
    ref = np.einsum("rsmk,rsk->rm", np.asarray(blocks, np.float64), xg).reshape(-1)
    err = float(np.abs(np.asarray(y, np.float64) - ref).max() / np.abs(ref).max())
    tol = 1e-5
    _say("spmv", nnz=int(blocks.size), rel_err=err, tol=tol, warm_s=warm, compile_s=comp,
         GBs=(blocks.size * 4 + 2 * n * 4) / warm / 1e9)
    _check("spmv", err, tol)


def _hadamard_rows(idx, n, signs):
    """Rows ``idx`` of the n x n Walsh-Hadamard matrix / sqrt(n), times a
    random sign per column: exactly orthonormal in f32 (entries are
    +-2^-k), generated on the device."""
    import jax
    import jax.numpy as jnp

    cols = jnp.arange(n, dtype=jnp.uint32)
    par = jax.lax.population_count(idx[:, None] & cols[None, :]) & 1
    return (1.0 - 2.0 * par.astype(jnp.float32)) * (signs / np.float32(np.sqrt(n)))[None, :]


def phase_reorth(z):
    """One ``orthogonalize_bcgs_dyn`` pass: the output must be orthogonal to
    every live row to 1e-6 ||v|| (f32 dot products over n terms), and at
    a smaller size match a float64 host classical Gram-Schmidt to
    1e-5 max|v| (f32 rounding of ~k rank-1 updates)."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu.core import linalg

    def basis_and_v(cap, n, k, seed):
        kr, ks, kj, kv = jax.random.split(jax.random.PRNGKey(seed), 4)
        idx = jax.random.choice(kr, n, (cap,), replace=False).astype(jnp.uint32)
        signs = jnp.where(jax.random.bernoulli(ks, 0.5, (n,)), 1.0, -1.0).astype(jnp.float32)
        live = _hadamard_rows(idx[:k], n, signs)
        junk = jax.random.normal(kj, (cap - k, n), jnp.float32)  # rows >= k must be ignored
        v = jax.random.normal(kv, (n,), jnp.float32)
        return jnp.concatenate([live, junk]), v

    cap, n, k = z["reorth_cap"], z["reorth_n"], z["reorth_k"]
    basis, v = basis_and_v(cap, n, k, 1)
    step = jax.jit(lambda u, bs: linalg.orthogonalize_bcgs_dyn(u, bs, jnp.int32(k), passes=1))
    out, warm, comp = _timed(lambda: step(v, basis))
    over = jnp.matmul(basis[:k], out, precision=jax.lax.Precision.HIGHEST)
    err = float(jnp.max(jnp.abs(over)) / jnp.linalg.norm(v))
    tol = 1e-6
    _say("reorth", shape=[cap, n], k=k, max_overlap_rel=err, tol=tol, warm_s=warm, compile_s=comp,
         GBs_two_sweeps=2 * (-(-k // 64) * 64) * n * 4 / warm / 1e9)
    _check("reorth", err, tol)
    del basis, out

    cap, n, k = z["reorth_ref_cap"], z["reorth_ref_n"], z["reorth_ref_k"]
    basis, v = basis_and_v(cap, n, k, 2)
    out = np.asarray(jax.jit(lambda u, bs: linalg.orthogonalize_bcgs_dyn(u, bs, jnp.int32(k), passes=1))(v, basis), np.float64)
    b64 = np.asarray(basis[:k], np.float64)
    v64 = np.asarray(v, np.float64)
    ref = v64 - b64.T @ (b64 @ v64)
    err = float(np.abs(out - ref).max() / np.abs(v64).max())
    tol = 1e-5
    _say("reorth_vs_f64", shape=[cap, n], k=k, rel_err=err, tol=tol)
    _check("reorth_vs_f64", err, tol)


def phase_df64(z):
    """Dekker two_prod and Knuth two_sum must be EXACT on the card: p + e
    equals the float64 product/sum of the f32 inputs, bit for bit (an FMA
    contraction in the split would show up here)."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu.core import df64

    rng = np.random.default_rng(3)
    n = z["df64_n"]
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    (p, e), warm, comp = _timed(lambda: jax.jit(df64.two_prod)(jnp.asarray(a), jnp.asarray(b)))
    s, f = jax.jit(df64.two_sum)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    bad_p = int(np.sum(np.asarray(p, np.float64) + np.asarray(e, np.float64) != a64 * b64))
    bad_s = int(np.sum(np.asarray(s, np.float64) + np.asarray(f, np.float64) != a64 + b64))
    _say("df64", pairs=n, inexact_two_prod=bad_p, inexact_two_sum=bad_s, tol=0, warm_s=warm, compile_s=comp)
    _check("df64", bad_p + bad_s, 0)


def phase_lanczos(z):
    """LambdaLanczos on a BSR chain, fused engine, f32: the lowest
    eigenvalue within 10 eps |lambda| of -2cos(pi/(n+1)), eps the engine's
    default f32 tolerance (the f32 bar the CPU tests use)."""
    from lanczos_tpu import BSROperator, LambdaLanczos
    from lanczos_tpu.utils.random import fixed_seed_initializer

    n = z["lanczos_n"]
    t0 = time.perf_counter()
    op = BSROperator.from_coo(*_chain_coo(n), n)
    setup = time.perf_counter() - t0
    eng = LambdaLanczos(op, find_maximum=False, dtype=np.float32, mode="fused")
    eng.init_vector = fixed_seed_initializer(np.float32, seed=1)
    (val, _vec), warm, comp = _timed(eng.run_one)
    exact = _chain_exact(n, 1)[0]
    err = abs(float(val) - exact)
    tol = 10 * eng.eps * abs(exact)
    _say("lanczos", n=n, tiles=list(op.blocks.shape), iters=eng.iteration_counts, abs_err=err, tol=tol,
         warm_s=warm, compile_s=comp, pack_s=setup)
    _check("lanczos", err, tol)


def phase_flagship(z):
    """filtered_lanczos on the DIA chain: 3 lowest eigenvalues to 1e-6."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu import ChebyshevFilterOperator, filtered_lanczos

    n = z["flagship_n"]
    op = _chain_dia(n)

    def solve():
        def cfg(eng):
            eng.max_restarts = 2
            eng.max_iteration = 48

        return filtered_lanczos(op, num_eigs=3, degree=400, mu=1e-5, lo=-2.0, hi=2.0, configure=cfg)[0]

    vals, warm, comp = _timed(solve)
    err = float(np.max(np.abs(np.asarray(vals, np.float64) - _chain_exact(n, 3))))
    tol = 1e-6
    _say("flagship", n=n, abs_err=err, tol=tol, warm_s=warm, compile_s=comp)
    _check("flagship", err, tol)
    filt = ChebyshevFilterOperator.from_interval(op, 400, -2.0, 2.0, 1e-5)
    compiled = jax.jit(lambda f, x: f.matvec(x)).lower(filt, jnp.zeros(n, jnp.float32)).compile()
    print("flagship filter-apply memory_analysis:", compiled.memory_analysis(), flush=True)


def phase_precise(z):
    """precise=True filtered solve (<= 1e-13) and the bounded-memory
    precise_vectors thick-restart solve (<= 1e-12)."""
    import jax.numpy as jnp

    from lanczos_tpu import DIAOperator, LambdaLanczos, filtered_lanczos

    n = z["precise_n"]
    op = _chain_dia(n)
    vals, warm, comp = _timed(lambda: filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, precise=True)[0])
    err = float(np.max(np.abs(np.asarray(vals, np.float64) - _chain_exact(n, 3))))
    tol = 1e-13
    _say("precise_filter", n=n, abs_err=err, tol=tol, warm_s=warm, compile_s=comp)
    _check("precise_filter", err, tol)

    # Block-diagonal chain: 128-site blocks, the lowest block eigenvalue
    # with multiplicity n/128; three copies through a 128-row basis.
    n, nb = z["pv_n"], 128
    off = np.ones(n - 1, np.float32)
    off[nb - 1 :: nb] = 0.0
    d = np.zeros((2, n), np.float32)
    d[0, 1:] = -off
    d[1, : n - 1] = -off
    opv = DIAOperator.from_diagonals([-1, 1], jnp.asarray(d), n)

    def solve():
        eng = LambdaLanczos(opv, find_maximum=False, num_eigs=3, dtype=np.float32, mode="fused")
        eng.precise_vectors = True
        eng.restart_policy = "thick"
        eng.max_iteration = 128
        eng.eps = 1e-11
        eng.eigenvalue_offset = -4.0
        return eng.run()[0]

    vals, warm, comp = _timed(solve)
    err = float(np.max(np.abs(np.asarray(vals, np.float64) - _chain_exact(nb, 1)[0])))
    tol = 1e-12
    _say("pv_thick", n=n, abs_err=err, tol=tol, warm_s=warm, compile_s=comp)
    _check("pv_thick", err, tol)


def phase_expm(z):
    """exp(5i H) psi on the chain against the DST-I truth: Chebyshev
    propagator in f32 (angle <= 1e-5) and df64 (<= 1e-12), and 100 Krylov
    evolve steps of 0.05i (<= 1e-4)."""
    from scipy.fft import dst

    from lanczos_tpu import Exponentiator

    n = z["expm_n"]
    op = _chain_dia(n)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = _chain_exact(n, n)
    truth = dst(np.exp(5.0j * lam) * dst(v, type=1, norm="ortho"), type=1, norm="ortho")
    tn = truth / np.linalg.norm(truth)

    def angle(o_re, o_im):
        out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
        on = out / np.linalg.norm(out)
        ip = np.vdot(tn, on)
        return float(np.linalg.norm(on - (ip / abs(ip)) * tn))

    ex = Exponentiator(op, dtype=np.float32)
    vr, vi = v.real.astype(np.float32), v.imag.astype(np.float32)
    cases = (
        ("expm_cheby_f32", 1e-5, lambda: ex.run_chebyshev(5.0j, vr, vi, lo=-2.0, hi=2.0)[0]),
        ("expm_cheby_precise", 1e-12,
         lambda: ex.run_chebyshev(5.0j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)[0]),
        ("expm_evolve_f32", 1e-4, lambda: ex.evolve(0.05j, vr, vi, 100, krylov_dim=16)),
    )
    for name, tol, fn in cases:
        (o_re, o_im), warm, comp = _timed(fn)
        err = angle(o_re, o_im)
        _say(name, n=n, angle=err, tol=tol, warm_s=warm, compile_s=comp)
        _check(name, err, tol)


PHASES = (phase_spmv, phase_reorth, phase_df64, phase_lanczos, phase_flagship, phase_precise, phase_expm)


def run_phases(z):
    for phase in PHASES:
        phase(z)


def run_multi(z):
    """The sharded operators over a 4-device mesh against the same call on
    one device and the closed form: ShardedBSROperator (gather, ring,
    footprint halos) through LambdaLanczos, ShardedDIAOperator through the
    flagship filtered solve."""
    import jax
    import jax.numpy as jnp

    from lanczos_tpu import BSROperator, LambdaLanczos, filtered_lanczos
    from lanczos_tpu.parallel.mesh import make_mesh, shard_vector
    from lanczos_tpu.parallel.sharded import ShardedBSROperator, ShardedDIAOperator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    ndev = len(jax.devices())
    if ndev != 4:
        raise RuntimeError(f"--multi needs 4 devices, found {ndev}")
    mesh = make_mesh()

    def spread(arr, what):
        got = len(arr.sharding.device_set)
        if got != ndev:
            raise AssertionError(f"{what} lives on {got} devices, expected {ndev}")

    def lowest(op):
        eng = LambdaLanczos(op, find_maximum=False, dtype=np.float32, mode="fused")
        eng.init_vector = fixed_seed_initializer(np.float32, seed=1)
        return float(eng.run_one()[0]), eng

    n = z["lanczos_n"]
    coo = _chain_coo(n)
    exact = _chain_exact(n, 1)[0]
    with jax.default_device(jax.devices()[0]):
        single, eng1 = lowest(BSROperator.from_coo(*coo, n))
    tol = 10 * eng1.eps * abs(exact)
    x = shard_vector(jnp.ones(n, jnp.float32), mesh)
    spread(x, "input vector")
    for comm in ("gather", "ring", "footprint"):
        op = ShardedBSROperator.from_coo(*coo, n, mesh, comm=comm)
        if op.comm != comm:
            raise AssertionError(f"asked for comm={comm}, got {op.comm}")
        spread(op.blocks, f"{comm} blocks")
        spread(op.col_blocks, f"{comm} col_blocks")
        spread(op.matvec(x), f"{comm} matvec output")
        t0 = time.perf_counter()
        val, _ = lowest(op)
        wall = time.perf_counter() - t0
        err, diff = abs(val - exact), abs(val - single)
        _say(f"multi_bsr_{comm}", n=n, abs_err=err, vs_one_card=diff, tol=tol, wall_s=wall)
        _check(f"multi_bsr_{comm}", max(err, diff), tol)

    n = z["flagship_n"]
    exact3 = _chain_exact(n, 3)
    off = np.full(n, -1.0, np.float32)

    def flagship(op):
        def cfg(eng):
            eng.max_restarts = 2
            eng.max_iteration = 48

        return np.asarray(filtered_lanczos(op, num_eigs=3, degree=400, mu=1e-5, lo=-2.0, hi=2.0,
                                           configure=cfg)[0], np.float64)

    with jax.default_device(jax.devices()[0]):
        single = flagship(_chain_dia(n))
    op = ShardedDIAOperator.from_diagonals([-1, 1], [off, off], n, mesh)
    spread(op.data, "DIA diagonals")
    t0 = time.perf_counter()
    vals = flagship(op)
    wall = time.perf_counter() - t0
    err, diff = float(np.max(np.abs(vals - exact3))), float(np.max(np.abs(vals - single)))
    tol = 1e-6
    _say("multi_dia_flagship", n=n, abs_err=err, vs_one_card=diff, tol=tol, wall_s=wall)
    _check("multi_dia_flagship", max(err, diff), tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--multi", action="store_true", help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lanczos_tpu.utils.compile_cache import enable_compilation_cache

    print("compile cache:", enable_compilation_cache(), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print("device_kind:", dev.device_kind, "devices:", len(jax.devices()), "jax", jax.__version__, flush=True)

    t0 = time.perf_counter()
    if args.multi:
        run_multi(FULL)
    else:
        run_phases(FULL)
        print("peak_bytes_in_use:", dev.memory_stats().get("peak_bytes_in_use"), flush=True)
    print(f"total_s: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                              "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
