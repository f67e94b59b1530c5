"""Benchmark sections on one GPU: BSR SpMV throughput against a measured
read stream, fused Lanczos iteration rate, and the accuracy and wall time of
the flagship, precise and exponentiator paths.

    python bench.py

The BSR SpMV must stream every stored nonzero once, so its speed of light
is the card's read bandwidth.  That bandwidth is *measured* in the same
process with a pure streaming reduction over an equally sized array, and

    vs_baseline = achieved_spmv_bandwidth / measured_stream_bandwidth

i.e. 1.0 means the sparse matvec runs at the card's demonstrated read speed.

Methodology: the K iterations run *inside one jit* as a ``lax.fori_loop``
(single dispatch), each timing ends in ``block_until_ready``, and the
per-iteration time is the *difference* between a long and a short chain,
cancelling fixed dispatch and loop-setup overhead.

Exits non-zero without a result when JAX finds no GPU.  Prints exactly one
JSON line, which names the device it ran on.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

RESULT: dict = {
    "metric": "bsr_spmv_throughput",
    "value": None,
    "unit": "Gnnz/s",
    "vs_baseline": None,
    "extra": {},
}
EXTRA = RESULT["extra"]


# ---------------------------------------------------------------------------
# Timing helper
# ---------------------------------------------------------------------------


def _marginal_time(run_k, k_short, k_long, *, repeats=5):
    """Per-iteration seconds from the (k_long - k_short) timing difference.

    Median over repeats: robust to one-off dispatch hiccups that can make a
    single difference negative."""
    import jax

    jax.block_until_ready(run_k(k_short))  # compile both
    jax.block_until_ready(run_k(k_long))
    diffs = []
    for _i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run_k(k_short))
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run_k(k_long))
        t_l = time.perf_counter() - t0
        diffs.append((t_l - t_s) / (k_long - k_short))
    return float(np.median(diffs))


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2

    from lanczos_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    EXTRA["device"] = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    EXTRA["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # ---- headline: BSR SpMV vs measured stream roofline ------------------
    def sec_spmv():
        from lanczos_tpu.ops.operators import BSROperator

        bm, bk = 128, 128  # roofline layout (see BSROperator docstring)
        r, s = 512, 8  # 64 Mi nnz -> 256 MiB of f32 tiles
        k_short, k_long = 64, 192

        n_pad = r * bm
        # GENERATE the data on device (jax.random under jit): no 256 MiB
        # host upload in the set-up.  Scaled so chained iterates neither
        # overflow nor denormalize in f32.
        kb, kc, kx = jax.random.split(jax.random.PRNGKey(0), 3)
        blocks = jax.jit(lambda k: jax.random.normal(k, (r, s, bm, bk), jnp.float32) * 0.01)(kb)
        col_blocks = jax.jit(
            lambda k: jax.random.randint(k, (r, s), 0, n_pad // bk, dtype=jnp.int32)
        )(kc)
        x = jax.jit(lambda k: jax.random.normal(k, (n_pad,), jnp.float32))(kx)

        # The operator arrays are jit *arguments* (a closure would bake
        # 256 MiB of tiles into the HLO as a literal — oversized compile
        # payload).
        @functools.partial(jax.jit, static_argnames=("k",))
        def spmv_chain(b, c, v, k):
            op = BSROperator(b, c, n_pad)
            return jax.lax.fori_loop(0, k, lambda _, vv: op.matvec(vv), v)

        # Measured streaming bandwidth on the same array.  The SpMV reads
        # 512x more than it writes, so the fair roofline is a *read* stream:
        # a full reduction whose input is scaled by the carried scalar (the
        # data dependence stops XLA hoisting the sum out of the loop; the
        # multiply fuses into the reduction, so each iteration reads the
        # array once).
        @functools.partial(jax.jit, static_argnames=("k",))
        def stream_chain(b, k):
            return jax.lax.fori_loop(
                0, k, lambda _, acc: jnp.sum(b * (1.0 + acc * 1e-30), dtype=jnp.float32), jnp.float32(0)
            )

        nnz = r * s * bm * bk
        spmv_bytes = nnz * 4 + n_pad * 4 * 2  # tiles + x read + y write

        # A card's delivered bandwidth drifts with clocks and power;
        # measuring SpMV and the stream reference minutes apart makes
        # vs_baseline noisy.  Interleave them (spmv, stream, spmv,
        # stream, ...) so each ratio sees the same card state, then medians.
        pairs = []
        for _rep in range(3):
            t_sp = _marginal_time(lambda k: spmv_chain(blocks, col_blocks, x, k), k_short, k_long, repeats=2)
            t_st = _marginal_time(lambda k: stream_chain(blocks, k), k_short, k_long, repeats=2)
            pairs.append((t_sp, t_st))
        t_spmv = float(np.median([p[0] for p in pairs]))
        t_stream = float(np.median([p[1] for p in pairs]))
        RESULT["value"] = round(nnz / t_spmv / 1e9, 3)
        RESULT["vs_baseline"] = round(
            float(np.median([(spmv_bytes / t_sp) / (blocks.size * 4 / t_st) for t_sp, t_st in pairs])), 3
        )
        # Raw GB/s alongside the ratio: card bandwidth drifts run to run, so
        # later runs need both absolutes to tell card drift (both move)
        # from a kernel regression (only spmv_gbps moves).
        EXTRA["spmv_gbps"] = round(spmv_bytes / t_spmv / 1e9, 1)
        EXTRA["stream_gbps"] = round(blocks.size * 4 / t_stream / 1e9, 1)

    sec_spmv()

    # ---- Lanczos iteration rate, fused engine, full vs selective ---------
    def sec_lanczos():
        from lanczos_tpu.ops.operators import DIAOperator
        from lanczos_tpu.solvers.lanczos_fused import fused_krylov

        nl = 1 << 20
        m_s, m_l = 32, 96
        opl = DIAOperator.from_diagonals(
            [-1, 1], [jnp.full(nl, -1.0, jnp.float32), jnp.full(nl, -1.0, jnp.float32)], nl
        )
        v0 = jax.jit(
            lambda k: (lambda u: u / jnp.linalg.norm(u))(
                jax.random.uniform(k, (nl,), jnp.float32, -1.0, 1.0)
            )
        )(jax.random.PRNGKey(1))
        defl = jnp.zeros((1, nl), jnp.float32)
        mask = jnp.zeros((1,), jnp.float32)

        for policy in ("full", "selective"):
            def run(m_cap, policy=policy):
                # eps=-1: benchmark sentinel — the Sturm check runs on the
                # production cadence but can never stop the loop (eps==0
                # would skip the check; any positive eps is reachable when
                # consecutive estimates come out bit-identical).
                r = fused_krylov(
                    opl, v0, defl, mask, -1.0, 0.0,
                    nroot=1, m_cap=m_cap, find_maximum=False, reorth_policy=policy,
                    check_every=4,  # the engine default (LanczosConfig.resolved)
                )
                return r[3]
            t = _marginal_time(lambda m, _r=run: _r(m), m_s, m_l, repeats=3)
            # Guard the marginal method's premise: the sentinel must never
            # actually converge (bit-identical consecutive Sturm estimates
            # would pass a strict '<' drift test and truncate the chain).
            it_l = int(np.asarray(run(m_l)))
            if it_l != m_l:
                EXTRA[f"lanczos_{policy}_early_stop"] = it_l
            EXTRA[f"lanczos_{policy}_us_per_iter"] = round(t * 1e6, 1)
            EXTRA[f"lanczos_{policy}_iters_per_s"] = round(1.0 / t, 1)

    sec_lanczos()

    # ---- precise_vectors accuracy ------------------------------------------
    def sec_pv_chain():
        from lanczos_tpu import LambdaLanczos, DIAOperator as _DIA

        np_ = 256
        opp = _DIA.from_diagonals(
            [-1, 1], [np.full(np_, -1.0, np.float32), np.full(np_, -1.0, np.float32)], np_
        )
        eng = LambdaLanczos(opp, find_maximum=False, dtype=np.float32)
        eng.precise_vectors = True
        eng.eps = 1e-13
        eng.initial_buffer_size = np_
        val, _vec = eng.run_one()
        EXTRA["pv_chain256_eig_err"] = float(abs(val - (-2.0 * np.cos(np.pi / (np_ + 1)))))

    sec_pv_chain()

    # ---- exponentiator accuracy: overlap AND vector-level (angle) --------
    def sec_expm():
        # Ring Hamiltonian, imaginary a=3i (quantum evolution), vs the
        # plane-wave analytic truth.  The overlap criterion is the
        # reference's bar (machine_eps*1e2, exponentiator.hpp:58) but is
        # QUADRATIC in the state's angle error, so the honest vector-level
        # metric — the norm of the difference of normalized states in the
        # optimal phase gauge — is recorded alongside (VERDICT r3 item 4).
        from lanczos_tpu import Exponentiator as _Expo

        nr = 100
        h = np.zeros((nr, nr), np.float32)
        ir = np.arange(nr - 1)
        h[ir, ir + 1] = h[ir + 1, ir] = -1.0
        h[0, nr - 1] = h[nr - 1, 0] = -1.0
        kv = 2 * np.pi / nr * np.arange(nr)
        evs_r = -2.0 * np.cos(kv)
        u_r = np.exp(1j * np.outer(np.arange(nr), kv)) / np.sqrt(nr)
        vin = np.zeros(nr, np.complex128)
        vin[0], vin[-1], vin[50] = 1 + 2j, 1 + 2j, 8 + 2j
        vin /= np.linalg.norm(vin)
        truth_e = u_r @ (np.diag(np.exp(3.0j * evs_r)) @ (u_r.conj().T @ vin))
        ex = _Expo(jnp.asarray(h), dtype=np.float32)
        ex.eps = 1e-14
        (o_re, o_im), _it = ex.run_split(
            3.0j, jnp.asarray(vin.real, np.float32), jnp.asarray(vin.imag, np.float32)
        )
        out_e = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
        tn = truth_e / np.linalg.norm(truth_e)
        on = out_e / np.linalg.norm(out_e)
        ip = np.vdot(tn, on)
        EXTRA["expm_ring100_overlap_err"] = float(abs(1.0 - abs(ip)))
        phase = ip / abs(ip) if abs(ip) > 0 else 1.0
        EXTRA["expm_ring100_angle_err"] = float(np.linalg.norm(on - phase * tn))

    sec_expm()

    # ---- 100-step evolve() drift at n=2^20 (vector-level) -----------------
    def sec_expm_evolve():
        # Open chain at n=2^20: eigenbasis is the type-I DST, so the exact
        # evolved state is computable on host in f64.  100 steps of
        # exp(0.05i*H) == exp(5i*H); records the compounding direction/phase
        # drift that the per-step overlap metric cannot see.
        from scipy.fft import dst

        from lanczos_tpu import DIAOperator as _DIA, Exponentiator as _Expo

        ne = 1 << 20
        ope = _DIA.from_diagonals(
            [-1, 1], [np.full(ne, -1.0, np.float32), np.full(ne, -1.0, np.float32)], ne
        )
        rng = np.random.default_rng(7)
        v = rng.standard_normal(ne) + 1j * rng.standard_normal(ne)
        v /= np.linalg.norm(v)
        # truth: H = S diag(lam) S with S the orthonormal DST-I
        lam = -2.0 * np.cos(np.arange(1, ne + 1) * np.pi / (ne + 1))
        coef = dst(v, type=1, norm="ortho")
        truth = dst(np.exp(5.0j * lam) * coef, type=1, norm="ortho")
        ex = _Expo(ope, dtype=np.float32)
        steps = 100
        o_re, o_im = ex.evolve(
            0.05j,
            jnp.asarray(v.real, np.float32),
            jnp.asarray(v.imag, np.float32),
            steps,
            krylov_dim=16,
        )
        out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
        tn = truth / np.linalg.norm(truth)
        on = out / np.linalg.norm(out)
        ip = np.vdot(tn, on)
        phase = ip / abs(ip) if abs(ip) > 0 else 1.0
        EXTRA["expm_evolve100_overlap_err"] = float(abs(1.0 - abs(ip)))
        EXTRA["expm_evolve100_angle_err"] = float(np.linalg.norm(on - phase * tn))

    sec_expm_evolve()

    # ---- Chebyshev propagator: same workload as ONE matvec chain ---------
    def sec_expm_cheby():
        # Identical DST-I truth protocol to sec_expm_evolve (exp(5i*H) on
        # the n=2^20 chain), but the whole evolution is a single
        # Tal-Ezer/Kosloff chain (solvers/cheby_expm.py) — no per-step
        # Krylov builds.  Records f32-chain and df64-chain walls + angles.
        from scipy.fft import dst

        from lanczos_tpu import DIAOperator as _DIA5, Exponentiator as _Expo5

        ne = 1 << 20
        ope = _DIA5.from_diagonals(
            [-1, 1], [np.full(ne, -1.0, np.float32), np.full(ne, -1.0, np.float32)], ne
        )
        rng = np.random.default_rng(7)
        v = rng.standard_normal(ne) + 1j * rng.standard_normal(ne)
        v /= np.linalg.norm(v)
        lam = -2.0 * np.cos(np.arange(1, ne + 1) * np.pi / (ne + 1))
        coef = dst(v, type=1, norm="ortho")
        truth = dst(np.exp(5.0j * lam) * coef, type=1, norm="ortho")
        tn = truth / np.linalg.norm(truth)

        def angle(o_re, o_im):
            out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
            on = out / np.linalg.norm(out)
            ip = np.vdot(tn, on)
            phase = ip / abs(ip) if abs(ip) > 0 else 1.0
            return float(np.linalg.norm(on - phase * tn))

        ex = _Expo5(ope, dtype=np.float32)
        vr = v.real.astype(np.float32)
        vi = v.imag.astype(np.float32)
        ex.run_chebyshev(5.0j, vr, vi, lo=-2.0, hi=2.0)  # warm compile
        t0 = time.perf_counter()
        (o_re, o_im), terms = ex.run_chebyshev(5.0j, vr, vi, lo=-2.0, hi=2.0)
        _ = np.asarray(jnp.ravel(o_re)[0])  # host-transfer sync
        EXTRA["expm_cheby_t5_s"] = round(time.perf_counter() - t0, 3)
        EXTRA["expm_cheby_t5_terms"] = int(terms)
        EXTRA["expm_cheby_t5_angle_err"] = angle(o_re, o_im)

        ex.run_chebyshev(5.0j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)
        t0 = time.perf_counter()
        (p_re, p_im), _t2 = ex.run_chebyshev(
            5.0j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)
        EXTRA["expm_cheby_t5_precise_s"] = round(time.perf_counter() - t0, 3)
        EXTRA["expm_cheby_t5_precise_angle_err"] = angle(p_re, p_im)

    sec_expm_cheby()

    # ---- flagship: Chebyshev-filtered n=4.19M solve ----------------------
    def sec_flagship_cheby():
        # The flagship config: filtered Lanczos, degree=400, mu=1e-5,
        # analytic chain bounds, B-space budget max_restarts=2 x
        # max_iteration=48.  Recorded as ONE pass, compile included.
        from lanczos_tpu import DIAOperator as _DIA3, filtered_lanczos

        nf = 1 << 22
        opf = _DIA3.from_diagonals(
            [-1, 1], [jnp.full(nf, -1.0, jnp.float32), jnp.full(nf, -1.0, jnp.float32)], nf
        )

        def _cfg(eng):
            eng.max_restarts = 2
            eng.max_iteration = 48

        t0 = time.perf_counter()
        vals_f, _vecs_f, _info = filtered_lanczos(
            opf, num_eigs=3, degree=400, mu=1e-5, lo=-2.0, hi=2.0, configure=_cfg
        )
        EXTRA["flagship_cheby_s"] = round(time.perf_counter() - t0, 1)
        exact_f = [-2.0 * np.cos((k + 1) * np.pi / (nf + 1)) for k in range(3)]
        EXTRA["flagship_cheby_max_err"] = float(
            max(abs(float(vals_f[i]) - exact_f[i]) for i in range(3))
        )

    sec_flagship_cheby()

    # ---- precise_vectors x thick restart: bounded-memory accuracy --------
    def sec_pv_thick():
        # n>=2^20 degenerate clustered spectrum, <=128-row basis: the
        # reference's f64-grade tolerance in pure f32 bounded memory.
        # Block-diagonal chain: every eigenvalue of the 128-site chain with
        # multiplicity n/128; 3 copies of the lowest via deflation.
        from lanczos_tpu import LambdaLanczos as _LL, DIAOperator as _DIA2

        npv = 1 << 20
        nb = 128
        off = np.ones(npv - 1, np.float32)
        off[nb - 1 :: nb] = 0.0
        d = np.zeros((2, npv), np.float32)
        d[0, 1:] = -off
        d[1, : npv - 1] = -off
        opv = _DIA2.from_diagonals([-1, 1], jnp.asarray(d), npv)
        engv = _LL(opv, find_maximum=False, num_eigs=3, dtype=np.float32, mode="fused")
        engv.precise_vectors = True
        engv.restart_policy = "thick"
        engv.max_iteration = 128  # bounded basis: 128 rows at n=2^20
        engv.eps = 1e-11
        engv.eigenvalue_offset = -4.0
        t0 = time.perf_counter()
        vals_v, _ = engv.run()
        truth_v = -2.0 * np.cos(np.pi / (nb + 1))
        EXTRA["pv_thick_n2p20_eig_err"] = float(
            np.max(np.abs(np.sort(np.asarray(vals_v)) - truth_v))
        )
        EXTRA["pv_thick_n2p20_wall_s"] = round(time.perf_counter() - t0, 1)

    sec_pv_thick()

    # ---- precise-filtered point ------------------------------------------
    def sec_precise_filter():
        # Spectral inverse-map refinement: f64-exact eigenvalues from f32
        # storage at filter cost (n=4000 chain, 3 lowest at the reference's
        # own eps=1e-12 problem).  ONE warm point.
        from lanczos_tpu import DIAOperator as _DIA4, filtered_lanczos as _fl

        nh = 4000
        oph = _DIA4.from_diagonals(
            [-1, 1], [np.full(nh, -1.0, np.float32)] * 2, nh)
        exact_h = [-2.0 * np.cos((k + 1) * np.pi / (nh + 1)) for k in range(3)]
        _fl(oph, num_eigs=3, lo=-2.0, hi=2.0, precise=True)  # warm compile
        t0 = time.perf_counter()
        vals_h, vh, _ih = _fl(oph, num_eigs=3, lo=-2.0, hi=2.0, precise=True)
        EXTRA["precise_filter_n4000_s"] = round(time.perf_counter() - t0, 2)
        EXTRA["precise_filter_n4000_err"] = float(
            max(abs(float(vals_h[i]) - exact_h[i]) for i in range(3)))
        # round-5: the path refines vectors to the df floor by default —
        # record the true A-space residual (host f64 stencil apply)
        vh = np.asarray(vh, np.float64)
        res_v = 0.0
        for i in range(3):
            av = np.empty(nh)
            av[0] = -vh[i][1]
            av[-1] = -vh[i][-2]
            av[1:-1] = -(vh[i][:-2] + vh[i][2:])
            res_v = max(res_v, float(np.linalg.norm(av - vals_h[i] * vh[i])))
        EXTRA["precise_filter_n4000_vec_res"] = res_v

    sec_precise_filter()

    # ---- df64 precise evolve ---------------------------------------------
    def sec_expm_evolve_precise():
        # Same DST-I protocol as sec_expm_evolve, through the df64-carried
        # evolve (solvers/exponentiator_precise.py): the vector-level drift
        # the f32 path accumulates over 100 steps drops to the df floor.
        from scipy.fft import dst

        from lanczos_tpu import DIAOperator as _DIA4, Exponentiator as _Expo2

        ne = 1 << 20
        ope = _DIA4.from_diagonals(
            [-1, 1], [np.full(ne, -1.0, np.float32), np.full(ne, -1.0, np.float32)], ne
        )
        rng = np.random.default_rng(7)
        v = rng.standard_normal(ne) + 1j * rng.standard_normal(ne)
        v /= np.linalg.norm(v)
        lam = -2.0 * np.cos(np.arange(1, ne + 1) * np.pi / (ne + 1))
        coef = dst(v, type=1, norm="ortho")
        steps = 100
        truth = dst(np.exp(1j * 0.05 * steps * lam) * coef, type=1, norm="ortho")
        ex = _Expo2(ope, dtype=np.float32)
        t0 = time.perf_counter()
        o_re, o_im = ex.evolve(0.05j, v.real, v.imag, steps, krylov_dim=16, precise=True)
        wall = time.perf_counter() - t0
        out = o_re + 1j * o_im
        tn = truth / np.linalg.norm(truth)
        on = out / np.linalg.norm(out)
        ip = np.vdot(tn, on)
        phase = ip / abs(ip) if abs(ip) > 0 else 1.0
        EXTRA["expm_evolve100_precise_angle_err"] = float(np.linalg.norm(on - phase * tn))
        EXTRA["expm_evolve100_precise_ms_per_step"] = round(wall / steps * 1e3, 1)

    sec_expm_evolve_precise()

    print(json.dumps(RESULT), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
