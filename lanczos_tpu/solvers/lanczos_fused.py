"""Fused Lanczos engine: the whole Krylov build as one ``lax.while_loop``.

The hybrid engine (lanczos.py) round-trips two scalars and a host tridiagonal
solve per iteration — microseconds of work but a full device->host sync each
time, which stalls the device between matvecs.  This engine keeps the *entire*
reference iteration (lambda_lanczos.hpp:216-322) resident on device:

* fixed-capacity Krylov buffer (static shapes; the analogue of the
  reference's growing ``std::vector`` u at lambda_lanczos.hpp:221),
* alpha/beta written into static buffers,
* the per-iteration convergence eigenvalues (lambda_lanczos.hpp:267-277) from
  the vectorized Sturm-bisection solver
  (:func:`lanczos_tpu.core.tridiagonal.extremal_eigenvalues_device`),
* breakdown and relative-change exits (:279-309) as the while-loop predicate.

Capacity is staged: the build starts with a small buffer and, if the loop
hits capacity without converging, the state is zero-padded to twice the size
and the (retraced-once-per-size) while_loop *resumes* — no matvec repeats.
This keeps the per-iteration reorthogonalization and Sturm-scan cost
O(cap * n) with cap ~ 2k instead of O(max_iteration * n) from iteration 1,
which matters because everything here is static-shaped for XLA.

Only the final Ritz recombination (lambda_lanczos.hpp:316) pulls the m x m
tridiagonal back to host for a float64 eigensolve — once per restart instead
of once per iteration.

The deflation driver is shared with the hybrid engine
(:func:`lanczos_tpu.solvers.lanczos.lanczos_run` semantics).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import df64, linalg, tridiagonal
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from .lanczos import EigenPairManager, LanczosConfig, LanczosResult, _ritz_combine, _prepare_init_vector

__all__ = ["lanczos_iteration_fused", "lanczos_run_fused", "fused_krylov", "reorth_total"]

# Cumulative basis-reorthogonalization count across fused solves in this
# process (same surfacing pattern as tridiagonal.unconverged_total): the
# engine snapshots it before/after a run to fill RunStats.reorth_count.
_REORTH_TOTAL = 0


def reorth_total() -> int:
    return _REORTH_TOTAL


def _add_reorth(n) -> None:
    global _REORTH_TOTAL
    _REORTH_TOTAL += int(n)


class _LoopState(NamedTuple):
    u_buf: jax.Array  # (cap+1, n)
    alpha: jax.Array  # (cap,) solver dtype
    beta: jax.Array  # (cap,)
    k: jax.Array  # next iteration index (1-based)
    evs_prev: jax.Array  # (nroot,)
    have_prev: jax.Array  # bool: evs_prev holds a full nroot-sized estimate
    stop: jax.Array  # bool
    itern: jax.Array  # iteration count at exit (0 while running)
    omega: jax.Array  # (cap+1,) orthogonality estimates |<u_k, u_j>| (selective)
    omega_prev: jax.Array  # (cap+1,) previous row of the omega recurrence
    force_reorth: jax.Array  # bool: reorthogonalize this iteration regardless
    alpha_lo: jax.Array  # (cap,) df64 low words of alpha (precise mode)
    bsq_hi: jax.Array  # (cap,) df64 high words of ||w||^2 (precise mode)
    bsq_lo: jax.Array  # (cap,) df64 low words of ||w||^2 (precise mode)
    u_lo: jax.Array  # (cap+1, n) df64 low words of the basis (precise_vectors) or (1,1)
    beta_lo: jax.Array  # (cap,) df64 low words of beta (precise_vectors)
    evs_lo: jax.Array  # (nroot,) df64 low words of evs_prev (precise_vectors)
    # (cap+1, cap+1) recaptured CGS couplings (precise_vectors) or (1, 1):
    # column k-1 holds the coefficients c_j the reorthogonalization removed
    # from w at step k.  With them, A u_{k-1} = alpha u_{k-1} + beta u_{k-2}
    # + sum_j c_j u_j + beta_k u_k holds to df64 precision REGARDLESS of the
    # f32 orthogonality floor, so the host eigensolve of M = T + C is exact
    # where a plain tridiagonal solve is floor-limited at ~1e-8.
    coup: jax.Array
    # (nd, cap) recaptured DEFLATION-SLOT couplings (precise_vectors) or
    # (1, 1): column k-1 holds the coefficients removed against the defl rows
    # at step k.  For the thick-restart engine the kept Ritz vectors ride in
    # the deflation slot, and these columns are exactly the Y<->U block of the
    # bordered projected matrix — the couplings that are zero in exact
    # arithmetic but ~f32-noise-sized in storage, and whose omission is what
    # capped the bounded-memory engines at ~1e-6 on clustered spectra.
    coup_d: jax.Array
    # (nd, cap) two_sum low words of coup_d (precise_vectors) or (1, 1): the
    # k=1 arrowhead coupling is O(1), so even summing its CGS passes in f32
    # loses ~eps*|c| — the recorded M entry carries the error-free pair.
    coup_d_lo: jax.Array
    # int32 count of iterations that ran a basis reorthogonalization: every
    # iteration under 'full', only omega-triggered ones under 'selective'
    # (surfaced as RunStats.reorth_count — the knob-tuning signal the
    # trigger rate would otherwise hide inside the while_loop).
    n_reorth: jax.Array


@functools.partial(jax.jit, static_argnames=("nroot", "find_maximum", "reorth_passes", "reorth_policy", "precise", "precise_vectors"))
def _fused_stage(op, state: _LoopState, defl, defl_mask, eps, offset, nroot: int, find_maximum: bool, check_every=1, reorth_passes: int = 2, reorth_policy: str = "full", precise: bool = False, precise_vectors: bool = False, k_limit=None, defl_lo=None):
    """Advance the Krylov build until convergence/breakdown or buffer capacity.

    ``check_every`` and ``k_limit`` are *dynamic* operands (not static jit
    arguments): changing the check throttle or the iteration bound reuses the
    compiled program.  This is what lets the segmented thick-restart cycles
    run every segment of every cycle through ONE compiled while_loop (a
    static per-segment shape ladder cost ~6 distinct n=4M compiles, which
    dominated the production solve's wall time).
    ``k_limit=None`` bounds at buffer capacity.

    ``reorth_policy='full'`` reorthogonalizes against the whole basis every
    iteration (reference semantics, lambda_lanczos.hpp:259-260).
    ``'selective'`` tracks Simon's omega recurrence — a running estimate of
    |<u_k, u_j>| driven by the same three-term recurrence the vectors obey —
    and runs the (cap, n) CGS matmuls only when the estimate crosses
    sqrt(machine_eps) (plus the following iteration, the standard
    two-consecutive-steps rule).  Between events an iteration is just
    matvec + AXPYs: for large n this removes the dominant cost of the loop.
    Deflation projection stays every iteration (nd rows — cheap, and the
    degeneracy logic depends on it).

    ``precise=True`` (default for f32 storage, set by the caller from
    ``LanczosConfig.precise_reductions``) accumulates alpha and ||w||^2 in
    double-float (df64) arithmetic and stores the low words in extra
    buffers: the in-loop recurrence stays f32, but the host Ritz solve
    reconstructs ~f64-quality tridiagonal entries — this is what lets the
    f32 path reach ~1e-9-level eigenvalues (SURVEY.md hard part (1)).

    ``precise_vectors=True`` goes the rest of the way to reference-grade
    tolerances with f32 storage: the Krylov vectors themselves are
    stored as double-float (hi, lo) pairs, the matvec runs through the
    operator's EFT ``matvec_df``, the three-term recurrence/normalization
    run in df arithmetic, and the convergence test bisects with
    df Sturm counts — everything except the CGS projections (hi-word f32
    matmuls, whose orthogonality floor only enters eigenvalue error
    quadratically).  Real dtypes only; requires a df-capable operator.
    """
    dtype = state.u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))
    cap = state.alpha.shape[0]
    pv = precise_vectors
    if pv and is_complex_dtype(dtype):
        raise TypeError("precise_vectors supports real dtypes only (use HermitianSplitOperator for complex)")
    if pv and reorth_policy != "full":
        raise ValueError("precise_vectors requires reorth_policy='full' (selective thresholds are f32-scaled)")

    # Breakdown threshold (lambda_lanczos.hpp:279): absolute eps*10 for the
    # plain engine (reference parity); in precise_vectors mode it is RELATIVE
    # to the matrix scale and set at the f32 CGS noise floor (see _body_pv).
    breakdown_eps = jnp.asarray(machine_eps(rdtype) * (100.0 if pv else 10.0), rdtype)
    eps_m = jnp.asarray(machine_eps(rdtype), rdtype)  # storage-dtype orthogonality floor
    reorth_threshold = jnp.sqrt(eps_m)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    eps = jnp.asarray(eps, rdtype)
    offset = jnp.asarray(offset, rdtype)
    selective = reorth_policy == "selective"
    check_every = jnp.asarray(check_every, jnp.int32)
    k_lim = jnp.asarray(cap if k_limit is None else jnp.minimum(k_limit, cap), jnp.int32)

    def cond(st: _LoopState):
        return (st.k <= k_lim) & (~st.stop)

    def _body_pv(st: _LoopState, k, u_prev, u_pp) -> _LoopState:
        """Double-float-vector iteration: EFT matvec, df recurrence, hi-word
        f32 reorthogonalization, df Sturm convergence."""
        zero = jnp.zeros((), rdtype)
        u_prev_lo = jax.lax.dynamic_index_in_dim(st.u_lo, k - 1, axis=0, keepdims=False)
        u_pp_lo = jax.lax.dynamic_index_in_dim(st.u_lo, jnp.maximum(k - 2, 0), axis=0, keepdims=False)

        au = op.matvec_df(u_prev, u_prev_lo)
        au = df64.df_add(au, df64.df_mul((offset, zero), (u_prev, u_prev_lo)))

        a_df = linalg.inner_prod_df_df((u_prev, u_prev_lo), au)
        alpha_k, alpha_lo_k = a_df[0].astype(rdtype), a_df[1].astype(rdtype)

        beta_prev = jax.lax.dynamic_index_in_dim(st.beta, jnp.maximum(k - 2, 0), keepdims=False)
        beta_prev_lo = jax.lax.dynamic_index_in_dim(st.beta_lo, jnp.maximum(k - 2, 0), keepdims=False)
        bsel = k >= 2
        b_df = (jnp.where(bsel, beta_prev, zero), jnp.where(bsel, beta_prev_lo, zero))

        w_df = df64.df_sub(
            au,
            df64.df_add(
                df64.df_mul((alpha_k, alpha_lo_k), (u_prev, u_prev_lo)),
                df64.df_mul(b_df, (u_pp, u_pp_lo)),
            ),
        )
        # Deflation-slot projection: ALWAYS >= CGS2.  These couplings
        # (accepted eigenvectors; kept Ritz rows between recaptured events)
        # are not fully represented in the relation matrix, so their
        # orthogonality enters the eigenvalues directly — a single pass
        # floors the on-chip ring50 zoo at 1.1e-13 vs CGS2's 7.8e-15.  The
        # slot is nd rows (cheap); the recaptured BASIS CGS below keeps the
        # configured single pass.
        defl_passes = max(reorth_passes, 2)
        if defl_lo is None:
            w_df, c_defl = linalg.orthogonalize_cgs2_df_coeffs(w_df, defl, defl_mask, passes=defl_passes)
            c_defl = (c_defl, jnp.zeros_like(c_defl))
        else:
            # Thick restart parks df64 Ritz rows in the deflation slot.  At
            # k=1 the coupling against them is the O(1) arrowhead entry and
            # the subtraction must be df-exact (hi-only correction injects
            # ~1e-8*|c| of relation error per restart — the measured engine
            # floor); at k>=2 the couplings are f32-noise-sized and the
            # cheap hi-word path contributes <=1e-15.
            w_df, c_defl = jax.lax.cond(
                k == 1,
                lambda wd: linalg.orthogonalize_cgs2_dfdf_coeffs(
                    wd, (defl, defl_lo), defl_mask, passes=defl_passes
                ),
                lambda wd: (lambda r: (r[0], (r[1], jnp.zeros_like(r[1]))))(
                    linalg.orthogonalize_cgs2_df_coeffs(
                        wd, defl, defl_mask, passes=defl_passes
                    )
                ),
                w_df,
            )
        if st.coup_d.shape == (defl.shape[0], cap):
            coup_d = jax.lax.dynamic_update_slice(
                st.coup_d, c_defl[0][:, None], (jnp.zeros((), k.dtype), k - 1)
            )
            coup_d_lo = jax.lax.dynamic_update_slice(
                st.coup_d_lo, c_defl[1][:, None], (jnp.zeros((), k.dtype), k - 1)
            )
        else:
            coup_d = st.coup_d
            coup_d_lo = st.coup_d_lo
        row_mask = (jnp.arange(cap + 1) < k).astype(rdtype)
        # CGS against the basis, RECAPTURING the removed couplings: the
        # summed coefficients are column k-1 of the correction matrix C.
        w_hi, w_lo = w_df
        c_total = jnp.zeros((cap + 1,), rdtype)
        for _ in range(reorth_passes):
            c_pass = linalg._project_coeffs(st.u_buf, w_hi, row_mask)
            corr = jnp.matmul(c_pass, st.u_buf, precision=jax.lax.Precision.HIGHEST)
            w_hi, w_lo = df64.df_add((w_hi, w_lo), (-corr, jnp.zeros_like(corr)))
            c_total = c_total + c_pass
        w_df = (w_hi, w_lo)
        coup = jax.lax.dynamic_update_slice(
            st.coup, c_total[:, None], (jnp.zeros((), k.dtype), k - 1)
        )

        bsq = linalg.inner_prod_df_df(w_df, w_df)
        bsq_hi_k, bsq_lo_k = bsq[0].astype(rdtype), bsq[1].astype(rdtype)
        beta_k, beta_lo_k = df64.df_sqrt((bsq_hi_k, bsq_lo_k))

        alpha = jax.lax.dynamic_update_slice_in_dim(st.alpha, alpha_k[None], k - 1, axis=0)
        beta = jax.lax.dynamic_update_slice_in_dim(st.beta, beta_k[None], k - 1, axis=0)
        beta_lo = jax.lax.dynamic_update_slice_in_dim(st.beta_lo, beta_lo_k[None], k - 1, axis=0)
        alpha_lo = jax.lax.dynamic_update_slice_in_dim(st.alpha_lo, alpha_lo_k[None], k - 1, axis=0)
        bsq_hi = jax.lax.dynamic_update_slice_in_dim(st.bsq_hi, bsq_hi_k[None], k - 1, axis=0)
        bsq_lo = jax.lax.dynamic_update_slice_in_dim(st.bsq_lo, bsq_lo_k[None], k - 1, axis=0)

        # Breakdown at the ORTHOGONALITY floor, not the df64 recurrence
        # floor: the f32 CGS leaves ~O(100 eps_f32)*||A|| noise in w, so once
        # beta falls below that the next direction is noise — stop before a
        # junk row enters the basis (a too-small legit coupling just
        # triggers a deflated restart, which is correct).
        scale = jnp.max(jnp.abs(alpha)) + 2.0 * jnp.max(beta)
        breakdown = beta_k < breakdown_eps * jnp.maximum(scale, tiny)

        # Normalize only when beta is sound: df_recip near the f32 tiny floor
        # overflows Dekker's split; a breakdown row is never read anyway.
        safe = (jnp.where(breakdown, jnp.ones((), rdtype), beta_k), jnp.where(breakdown, zero, beta_lo_k))
        u_next_hi, u_next_lo = df64.df_mul(w_df, df64.df_recip(safe))
        u_next_hi = jnp.where(breakdown, zero, u_next_hi)
        u_next_lo = jnp.where(breakdown, zero, u_next_lo)

        u_buf = jax.lax.dynamic_update_slice_in_dim(st.u_buf, u_next_hi[None], k, axis=0)
        u_lo = jax.lax.dynamic_update_slice_in_dim(st.u_lo, u_next_lo[None], k, axis=0)

        def with_check(_):
            evs_hi, evs_lo = tridiagonal.extremal_eigenvalues_device_df(
                (alpha, alpha_lo), (bsq_hi, bsq_lo), k, nroot, find_maximum
            )
            d_hi, d_lo = df64.df_sub((evs_hi, evs_lo), (st.evs_prev, st.evs_lo))
            err = jnp.abs(d_hi + d_lo)
            rel_ok = jnp.all(err < jnp.minimum(jnp.abs(evs_hi), jnp.abs(st.evs_prev)) * eps)
            return evs_hi, evs_lo, st.have_prev & rel_ok, jnp.asarray(True)

        def without_check(_):
            return st.evs_prev, st.evs_lo, jnp.asarray(False), st.have_prev

        # eps sentinel states: > 0 normal; == 0 skips the df Sturm entirely
        # (thick-restart segments judge convergence on host; the scan costs
        # ~10-15 ms per call at production caps); < 0 runs the scan on the
        # normal cadence but can never converge — benchmark mode (bench.py /
        # benchmarks/run_all.py measure production iteration cost incl. the
        # amortized check without any reachable stop: under reference
        # semantics bit-identical consecutive estimates converge at ANY
        # positive eps, so no tiny positive value is safe).
        do_check = breakdown | (((k % check_every == 0) | (k >= k_lim)) & (eps != 0))
        evs, evs_lo, converged, have_prev = jax.lax.cond(do_check, with_check, without_check, None)
        converged = converged & (eps > 0)

        stop = breakdown | converged
        itern = jnp.where(stop, k, st.itern)
        return _LoopState(
            u_buf, alpha, beta, k + 1, evs, have_prev & (k >= nroot), stop, itern,
            st.omega, st.omega_prev, jnp.asarray(False), alpha_lo, bsq_hi, bsq_lo,
            u_lo, beta_lo, evs_lo, coup, coup_d, coup_d_lo, st.n_reorth + 1,
        )

    def body(st: _LoopState) -> _LoopState:
        k = st.k
        u_prev = jax.lax.dynamic_index_in_dim(st.u_buf, k - 1, axis=0, keepdims=False)
        u_pp = jax.lax.dynamic_index_in_dim(st.u_buf, jnp.maximum(k - 2, 0), axis=0, keepdims=False)

        if pv:
            return _body_pv(st, k, u_prev, u_pp)

        au = op.matvec(u_prev)
        au = au + offset * u_prev
        if precise:
            a_df = linalg.inner_prod_df(u_prev, au)
            if is_complex_dtype(dtype):
                a_df = a_df[0]  # real part pair
            alpha_k = a_df[0].astype(rdtype)
            alpha_lo_k = a_df[1].astype(rdtype)
        else:
            alpha_k = jnp.real(linalg.inner_prod(u_prev, au)).astype(rdtype)
            alpha_lo_k = jnp.zeros((), rdtype)
        beta_prev = jax.lax.dynamic_index_in_dim(st.beta, jnp.maximum(k - 2, 0), keepdims=False)
        b = jnp.where(k >= 2, beta_prev, jnp.asarray(0, rdtype))
        w = au - alpha_k * u_prev - b * u_pp

        w = linalg.orthogonalize_cgs2(w, defl, defl_mask, passes=reorth_passes)

        # Basis reorthogonalization reads only the ceil(k/chunk) LIVE row
        # chunks (dynamic trip count) — the masked full-capacity CGS
        # streamed all cap+1 rows every pass, ~2x the necessary
        # device-memory traffic averaged over a Krylov build.
        if not selective:
            w = linalg.orthogonalize_bcgs_dyn(w, st.u_buf, k, passes=reorth_passes)
            beta_k = linalg.norm(w).astype(rdtype)
            omega, omega_prev = st.omega, st.omega_prev
            force_next = jnp.asarray(False)
            n_reorth_inc = jnp.asarray(1, jnp.int32)
        else:
            beta_t = linalg.norm(w).astype(rdtype)
            # Omega recurrence: with T's action on u_j,
            #   beta[k-1] w_k(j) = beta[j] w_{k-1}(j+1) + (alpha[j]-alpha_k) w_{k-1}(j)
            #                    + beta[j-1] w_{k-1}(j-1) - beta[k-2] w_{k-2}(j) + noise
            j = jnp.arange(cap + 1)
            a_vec = jnp.concatenate([st.alpha, jnp.zeros((1,), rdtype)])
            b_vec = jnp.concatenate([st.beta, jnp.zeros((1,), rdtype)])
            b_jm1 = jnp.concatenate([jnp.zeros((1,), rdtype), st.beta])
            om_p1 = jnp.roll(st.omega, -1)
            om_m1 = jnp.roll(st.omega, 1)
            noise = eps_m * (b_vec + beta_t)
            w_new = (
                b_vec * om_p1 + (a_vec - alpha_k) * st.omega + b_jm1 * om_m1 - b * st.omega_prev
            ) / jnp.maximum(beta_t, tiny) + noise
            w_new = jnp.abs(w_new)
            # Boundary rows: w_k(k-1) ~ eps, w_k(k) = 1, nothing beyond k.
            w_new = jnp.where(j == k - 1, eps_m, w_new)
            w_new = jnp.where(j == k, jnp.asarray(1.0, rdtype), w_new)
            w_new = jnp.where(j > k, jnp.zeros((), rdtype), w_new)
            w_new = jnp.maximum(w_new, jnp.where(j <= k, eps_m, jnp.zeros((), rdtype)))

            drift = jnp.max(jnp.where(j <= k - 2, w_new, jnp.zeros((), rdtype)))
            trigger = (drift > reorth_threshold) | st.force_reorth

            def do_reorth(w):
                return linalg.orthogonalize_bcgs_dyn(w, st.u_buf, k, passes=reorth_passes)

            w = jax.lax.cond(trigger, do_reorth, lambda w: w, w)
            beta_k = jnp.where(trigger, linalg.norm(w).astype(rdtype), beta_t)
            # After a reorth the stored-basis overlaps are at noise level.
            w_new = jnp.where(trigger & (j <= k - 2), eps_m, w_new)
            omega, omega_prev = w_new, jnp.where(trigger, eps_m, st.omega)
            force_next = trigger  # two-consecutive-steps rule
            n_reorth_inc = trigger.astype(jnp.int32)

        if precise:
            w_df = linalg.inner_prod_df(w, w)
            if is_complex_dtype(dtype):
                w_df = w_df[0]
            bsq_hi_k, bsq_lo_k = w_df[0].astype(rdtype), w_df[1].astype(rdtype)
            beta_k = jnp.sqrt(jnp.maximum(bsq_hi_k, jnp.zeros((), rdtype)))
        else:
            bsq_hi_k = beta_k * beta_k
            bsq_lo_k = jnp.zeros((), rdtype)

        u_buf = jax.lax.dynamic_update_slice_in_dim(st.u_buf, (w / jnp.maximum(beta_k, tiny))[None], k, axis=0)
        alpha = jax.lax.dynamic_update_slice_in_dim(st.alpha, alpha_k[None], k - 1, axis=0)
        beta = jax.lax.dynamic_update_slice_in_dim(st.beta, beta_k[None], k - 1, axis=0)
        alpha_lo = jax.lax.dynamic_update_slice_in_dim(st.alpha_lo, alpha_lo_k[None], k - 1, axis=0)
        bsq_hi = jax.lax.dynamic_update_slice_in_dim(st.bsq_hi, bsq_hi_k[None], k - 1, axis=0)
        bsq_lo = jax.lax.dynamic_update_slice_in_dim(st.bsq_lo, bsq_lo_k[None], k - 1, axis=0)

        breakdown = beta_k < breakdown_eps

        # Convergence eigenvalues of the leading k x k block, on device.  The
        # Sturm bisection is the expensive non-matvec op in the loop, so it
        # can be throttled to every ``check_every`` iterations (always runs on
        # breakdown so the returned estimate covers the final block).
        def with_check(_):
            evs = tridiagonal.extremal_eigenvalues_device(alpha, beta, k, nroot, find_maximum)
            # Same gate as the reference's pevs.size()==evs.size() check
            # (lambda_lanczos.hpp:291): a full previous estimate exists only
            # once the previous solve saw >= nroot rows.
            rel_ok = jnp.all(jnp.abs(evs - st.evs_prev) < jnp.minimum(jnp.abs(evs), jnp.abs(st.evs_prev)) * eps)
            return evs, st.have_prev & rel_ok, jnp.asarray(True)

        def without_check(_):
            return st.evs_prev, jnp.asarray(False), st.have_prev

        # eps sentinels (see the pv body): >0 normal, ==0 skip the Sturm scan
        # (host-judged segments), <0 run the scan but never converge
        # (benchmark mode).
        do_check = breakdown | (((k % check_every == 0) | (k >= k_lim)) & (eps != 0))
        evs, converged, have_prev = jax.lax.cond(do_check, with_check, without_check, None)
        converged = converged & (eps > 0)

        stop = breakdown | converged
        itern = jnp.where(stop, k, st.itern)
        return _LoopState(
            u_buf, alpha, beta, k + 1, evs, have_prev & (k >= nroot), stop, itern,
            omega, omega_prev, force_next, alpha_lo, bsq_hi, bsq_lo,
            st.u_lo, st.beta_lo, st.evs_lo, st.coup, st.coup_d, st.coup_d_lo,
            st.n_reorth + n_reorth_inc,
        )

    return jax.lax.while_loop(cond, body, state)


def _init_state(v0, cap: int, nroot: int, precise_vectors: bool = False, nd: int = 0):
    """``nd > 0`` (precise_vectors only) sizes the deflation-coupling
    recapture buffer ``coup_d`` for ``nd`` deflation-slot rows."""
    dtype = v0.dtype
    rdtype = np.dtype(real_dtype(dtype))
    n = v0.shape[0]
    omega0 = jnp.zeros((cap + 1,), rdtype).at[0].set(1.0)  # w_0(0) = 1
    u_lo_shape = (cap + 1, n) if precise_vectors else (1, 1)
    return _LoopState(
        jnp.zeros((cap + 1, n), dtype).at[0].set(v0),
        jnp.zeros((cap,), rdtype),
        jnp.zeros((cap,), rdtype),
        jnp.asarray(1, jnp.int32),
        jnp.full((nroot,), jnp.inf, rdtype),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        omega0,
        jnp.zeros((cap + 1,), rdtype),
        jnp.asarray(False),
        jnp.zeros((cap,), rdtype),
        jnp.zeros((cap,), rdtype),
        jnp.zeros((cap,), rdtype),
        jnp.zeros(u_lo_shape, rdtype),
        jnp.zeros((cap,), rdtype),
        jnp.zeros((nroot,), rdtype),
        jnp.zeros((cap + 1, cap + 1) if precise_vectors else (1, 1), rdtype),
        jnp.zeros((nd, cap) if (precise_vectors and nd > 0) else (1, 1), rdtype),
        jnp.zeros((nd, cap) if (precise_vectors and nd > 0) else (1, 1), rdtype),
        jnp.asarray(0, jnp.int32),
    )


def _grow_state(state: _LoopState, new_cap: int) -> _LoopState:
    n = state.u_buf.shape[1]
    pad_rows = new_cap + 1 - state.u_buf.shape[0]
    pad_s = new_cap - state.alpha.shape[0]
    pad_o = new_cap + 1 - state.omega.shape[0]
    return state._replace(
        u_buf=jnp.concatenate([state.u_buf, jnp.zeros((pad_rows, n), state.u_buf.dtype)]),
        alpha=jnp.concatenate([state.alpha, jnp.zeros((pad_s,), state.alpha.dtype)]),
        beta=jnp.concatenate([state.beta, jnp.zeros((pad_s,), state.beta.dtype)]),
        omega=jnp.concatenate([state.omega, jnp.zeros((pad_o,), state.omega.dtype)]),
        omega_prev=jnp.concatenate([state.omega_prev, jnp.zeros((pad_o,), state.omega_prev.dtype)]),
        alpha_lo=jnp.concatenate([state.alpha_lo, jnp.zeros((pad_s,), state.alpha_lo.dtype)]),
        bsq_hi=jnp.concatenate([state.bsq_hi, jnp.zeros((pad_s,), state.bsq_hi.dtype)]),
        bsq_lo=jnp.concatenate([state.bsq_lo, jnp.zeros((pad_s,), state.bsq_lo.dtype)]),
        u_lo=(
            jnp.concatenate([state.u_lo, jnp.zeros((pad_rows, n), state.u_lo.dtype)])
            if state.u_lo.shape[0] > 1
            else state.u_lo
        ),
        beta_lo=jnp.concatenate([state.beta_lo, jnp.zeros((pad_s,), state.beta_lo.dtype)]),
        coup=(
            jnp.pad(state.coup, ((0, pad_rows), (0, pad_rows)))
            if state.coup.shape[0] > 1
            else state.coup
        ),
        coup_d=(
            jnp.pad(state.coup_d, ((0, 0), (0, pad_s)))
            if state.coup_d.shape != (1, 1)
            else state.coup_d
        ),
        coup_d_lo=(
            jnp.pad(state.coup_d_lo, ((0, 0), (0, pad_s)))
            if state.coup_d_lo.shape != (1, 1)
            else state.coup_d_lo
        ),
    )


@functools.partial(jax.jit, static_argnames=("nroot", "m_cap", "find_maximum", "reorth_policy", "precise_vectors"))
def fused_krylov(op, v0, defl, defl_mask, eps, offset, *, nroot: int, m_cap: int, find_maximum: bool, check_every=1, reorth_policy: str = "full", precise_vectors: bool = False):
    """Single-trace fixed-capacity Krylov build (no staging): returns
    ``(u_buf, alpha, beta, itern, evs)``.  Jittable end-to-end — the
    building block for embedding a whole restart inside larger jitted
    programs (see ``__graft_entry__``)."""
    state = _init_state(v0, m_cap, nroot, precise_vectors)
    # Passes mirror LanczosConfig.resolved: one classical pass (the
    # reference's per-iteration sweep; see the reorth_passes field rationale
    # in lanczos.LanczosConfig).
    passes = 1
    state = _fused_stage(
        op, state, defl, defl_mask, eps, offset, nroot, find_maximum, check_every, passes,
        reorth_policy, False, precise_vectors,
    )
    itern = jnp.where(state.stop, state.itern, state.k - 1)
    return state.u_buf, state.alpha, state.beta, itern, state.evs_prev


def lanczos_iteration_fused(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """One deflated restart with the fused engine; same return contract as
    :func:`lanczos_tpu.solvers.lanczos.lanczos_iteration`."""
    dtype = np.dtype(v0.dtype)
    rdtype = real_dtype(dtype)
    m_max = min(cfg.max_iteration, max(cfg.matrix_size, 1))
    check_every = max(int(cfg.convergence_check_interval), 1)
    pv = bool(getattr(cfg, "precise_vectors", False))
    reorth_policy = "full" if pv else str(cfg.reorth_policy)

    v0 = _prepare_init_vector(v0, defl, defl_mask)
    cap = min(max(cfg.initial_buffer_size, 2), m_max)
    state = _init_state(v0, cap, int(nroot), pv)

    while True:
        state = _fused_stage(
            op, state, defl, defl_mask, cfg.eps, cfg.eigenvalue_offset,
            int(nroot), bool(cfg.find_maximum), check_every, int(cfg.reorth_passes),
            reorth_policy, bool(cfg.precise_reductions), pv,
        )
        if bool(jax.device_get(state.stop)) or cap >= m_max:
            break
        cap = min(4 * cap, m_max)  # 4x growth: fewer retraces
        state = _grow_state(state, cap)

    # ONE batched device_get for all boundary scalars/vectors — each
    # separate get costs a full device round trip.
    _stop, _itern, _k, _a, _a_lo, _b, _b_hi, _b_lo, _nro = jax.device_get(
        (state.stop, state.itern, state.k, state.alpha, state.alpha_lo,
         state.beta, state.bsq_hi, state.bsq_lo, state.n_reorth)
    )
    _add_reorth(_nro)
    stopped = bool(_stop)
    m = int(_itern) if stopped else int(_k) - 1
    converged = stopped or m >= cfg.matrix_size  # full-space basis is exact
    u_buf = state.u_buf
    if cfg.precise_reductions or pv:
        # Reconstruct ~f64 tridiagonal entries from the df64 word pairs.
        alphas = (np.asarray(_a, np.float64) + np.asarray(_a_lo, np.float64))[:m]
        bsq = np.asarray(_b_hi, np.float64) + np.asarray(_b_lo, np.float64)
        betas = np.sqrt(np.maximum(bsq, 0.0))[: m - 1]
    else:
        alphas = np.asarray(_a, np.float64)[:m]
        betas = np.asarray(_b, np.float64)[: m - 1]

    # Host float64 recombination (once per restart).
    if pv:
        # Exact-relation solve: A U^T = U^T (T + C) + residual holds to df64
        # precision regardless of the f32 orthogonality floor (C = recaptured
        # CGS couplings), so the Ritz values come from the small dense
        # NONSYMMETRIC M = T + C — this is what takes the f32 path from the
        # ~1e-8 tridiagonal floor to ~1e-11.
        c_mat = np.asarray(jax.device_get(state.coup), np.float64)[:m, :m]
        m_hat = np.diag(alphas)
        if m > 1:
            m_hat += np.diag(betas, 1) + np.diag(betas, -1)
        m_hat += c_mat
        w_all, y_all = np.linalg.eig(m_hat)
        order = np.argsort(w_all.real)
        tri_vals = w_all.real[order]
        tri_vecs = np.ascontiguousarray(y_all.real[:, order].T)
        nrm = np.linalg.norm(tri_vecs, axis=1, keepdims=True)
        tri_vecs = tri_vecs / np.where(nrm > 0, nrm, 1.0)
    else:
        tri_vals, tri_vecs = tridiagonal.eigh_tridiagonal_host(alphas, betas, backend=cfg.tridiag_backend)
    num_out = min(nroot, m)
    sel = [m - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    q_pad = np.zeros((num_out, u_buf.shape[0]), dtype=np.dtype(rdtype))
    q_pad[:, :m] = tri_vecs[sel]
    if pv:
        # Fold the basis low words into the recombination (the remaining
        # eigenvector error is the f32 matmul/storage floor ~1e-7; the
        # eigenVALUES come from the df64 tridiagonal and are ~1e-11).
        q = jnp.asarray(q_pad)
        vecs = jnp.matmul(q, u_buf, precision=jax.lax.Precision.HIGHEST) + jnp.matmul(
            q, state.u_lo, precision=jax.lax.Precision.HIGHEST
        )
        norms = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2, axis=1, keepdims=True))
        tiny = np.finfo(np.dtype(rdtype)).tiny
        eigvecs = vecs / jnp.maximum(norms, tiny)
    else:
        eigvecs = _ritz_combine(jnp.asarray(q_pad), u_buf)

    eigenvalues = [float(tri_vals[s]) - cfg.eigenvalue_offset for s in sel]
    return eigenvalues, eigvecs, m, converged


def lanczos_run_fused(op, cfg: LanczosConfig, init_vector, dtype) -> LanczosResult:
    """Fused engine under the shared deflation driver
    (:func:`lanczos_tpu.solvers.lanczos.deflation_driver`)."""
    from .lanczos import deflation_driver

    cfg = cfg.resolved(dtype)
    return deflation_driver(
        lambda v0, nroot, defl, mask: lanczos_iteration_fused(op, v0, nroot, defl, mask, cfg),
        cfg, init_vector, dtype,
    )
