"""Fused block thick-restart Lanczos — degenerate clusters in ONE build.

The reference resolves an eigenvalue of multiplicity d by d+ deflated random
restarts (lambda_lanczos.hpp:330-366): each round's fresh random vector leaks
into the unseen part of the degenerate subspace.  On a production-scale
solve every extra round is a full Krylov build — the n=4.2M chain's 1e-12-
close triple costs 4 rounds x ~1400 iterations with the scalar engines.

This engine combines the two bounded-memory ideas already in the package:

* **block Lanczos** (block_lanczos.py): a width-b block captures multiplicity
  <= b in one build, and every reorthogonalization pass amortizes its basis
  reads over b vectors — the dominant HBM traffic of a large-n iteration
  drops ~b-fold per vector;
* **thick restart** (thick_restart.py, Wu & Simon TRLan): keep the l best
  Ritz vectors with exact couplings when the buffer fills, so memory stays
  O(m_max * n) without losing subspace progress.

All block cycles run device-resident inside one ``lax.while_loop`` with a
*dynamic* ``k_limit`` operand (same one-compiled-program discipline as
``lanczos_fused._fused_stage``); the host touches the device only at segment
boundaries — a batched read of the (b, b) coefficient blocks — to run the
float64 convergence test on the arrowhead band matrix

    T = [[diag(theta_kept),  S,     0 ],
         [S^H,               A_0,  R_0^H, ...],
         [0,                 R_0,  A_1,  ...]]

where S = Y^H (A + offset) U_0 couples the kept Ritz vectors to the first
new block only (A y_i lies in span(Y, R-block) exactly, so all later
couplings vanish — the block generalization of the TRLan arrowhead).

Per-step numerics:
  W   = (A + offset) U_k                       (b matvecs, one fused pass)
  A_k = U_k^H W                                (df64 pair dots when precise)
  W  -= A_k^T U_k + B_{k-1}^H U_{k-1}          (three-term block recurrence)
  W   = cgs(W, deflation + kept Ritz)          (masked block CGS)
  W   = bcgs(W, live basis rows)               (chunked, traffic ∝ k*b
                                                and shared by the b vectors)
  U_{k+1}, R_k = mgs(W)                        (in-block masked MGS: W = R^T U,
                                                dead rows exactly zero)
Per-row rank collapse (a zero diag(R) entry) stops the loop; the host either
repairs the dead rows with fresh random directions and resumes, or — when
nothing is revivable — treats the build as space-exhausted (the block form
of the beta breakdown, lambda_lanczos.hpp:279-283).  Convergence combines
the reference's relative-drift test with the free band residual bound
``||R_last q_lastblock|| <= sqrt(eps) * scale`` (drift alone fires on
plateaus).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import df64, linalg
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from .lanczos import LanczosConfig
from .lanczos_fused import _add_reorth

__all__ = ["block_thick_iteration_fused", "block_thick_iteration_fused_pv", "lanczos_run_block_thick"]

_PREC = jax.lax.Precision.HIGHEST


def _block_matvec(op, u_rows, offset):
    """(A + offset) applied to every row of a (b, n) block."""
    w = jax.vmap(op.matvec)(u_rows)
    return w + offset.astype(np.dtype(real_dtype(u_rows.dtype))) * u_rows


def _fresh_block(rng, b, n, dtype):
    """A (b, n) uniform[-1,1] block drawn ON DEVICE from a host-fed key:
    host-generated numpy blocks would be uploaded host-to-device on every
    repair event."""
    key = jax.random.PRNGKey(int(rng.integers(0, 2**31 - 1)))
    rdtype = np.dtype(real_dtype(dtype))
    if is_complex_dtype(dtype):
        kr, ki = jax.random.split(key)
        re = jax.random.uniform(kr, (b, n), rdtype, -1.0, 1.0)
        im = jax.random.uniform(ki, (b, n), rdtype, -1.0, 1.0)
        return (re + 1j * im).astype(dtype)
    return jax.random.uniform(key, (b, n), rdtype, -1.0, 1.0).astype(dtype)


def _block_cgs(w, rows, row_mask, passes: int = 1):
    """One-or-more classical GS passes of the (b, n) block ``w`` against the
    masked ``rows`` — the block form of :func:`linalg.orthogonalize_cgs2`:
    each pass reads ``rows`` ONCE for all b vectors (two (nd, n) x (n, b)
    matmuls) instead of b times."""
    rc = jnp.conj(rows) if is_complex_dtype(rows.dtype) else rows
    for _ in range(passes):
        c = jnp.matmul(rc, w.T, precision=_PREC)
        if row_mask is not None:
            c = c * row_mask.astype(c.dtype)[:, None]
        w = w - jnp.matmul(c.T, rows, precision=_PREC)
    return w


def _bcgs_block(w, basis, live, passes: int = 1, chunk: int = 64):
    """Chunked live-rows block CGS: orthogonalize the (b, n) block against
    rows [0, live) of ``basis`` reading only ceil(live/chunk) chunks — the
    block form of :func:`linalg.orthogonalize_bcgs_dyn` (HBM traffic scales
    with the filled row count AND is shared by all b vectors)."""
    cap_rows = basis.shape[0]
    if jax.default_backend() == "cpu":
        mask = (jnp.arange(cap_rows) < jnp.asarray(live, jnp.int32)).astype(jnp.float32)
        return _block_cgs(w, basis, mask, passes)

    chunk = min(int(chunk), cap_rows)
    live = jnp.asarray(live, jnp.int32)
    nchunks = (live + chunk - 1) // chunk
    idx = jnp.arange(chunk)

    def one_pass(w):
        def body(ci, w):
            start = jnp.minimum(ci * chunk, cap_rows - chunk)
            rows = jax.lax.dynamic_slice_in_dim(basis, start, chunk, axis=0)
            rc = jnp.conj(rows) if is_complex_dtype(rows.dtype) else rows
            rmask = (start + idx) < live
            c = jnp.matmul(rc, w.T, precision=_PREC) * rmask.astype(w.dtype)[:, None]
            return w - jnp.matmul(c.T, rows, precision=_PREC)

        return jax.lax.fori_loop(0, nchunks, body, w)

    for _ in range(passes):
        w = one_pass(w)
    return w


def _pair_dots_df(u, w):
    """All pairwise <u_i, w_j> in double-float (real f32 path): (b, b) hi/lo.

    The b^2 EFT dots replace the scalar engine's df64 alpha accumulation
    (lanczos_fused.py precise mode) — plain f32 block overlaps floor the
    eigenvalues at ~1e-4 (measured round 1, README), df64 restores ~1e-9."""
    f = jax.vmap(lambda ui: jax.vmap(lambda wj: df64.dot_df(ui, wj))(w))
    return f(u)  # ((b, b) hi, (b, b) lo)


def _pair_dots_df_df(u_df, w_df):
    """All pairwise <u_i, w_j> for DF-PAIR blocks: ((b, b) hi, (b, b) lo)."""
    u_hi, u_lo = u_df
    w_hi, w_lo = w_df

    def one(ui_hi, ui_lo):
        return jax.vmap(
            lambda wj_hi, wj_lo: linalg.inner_prod_df_df((ui_hi, ui_lo), (wj_hi, wj_lo))
        )(w_hi, w_lo)

    hi, lo = jax.vmap(one)(u_hi, u_lo)
    return hi, lo


def _df_block_comb_sub(w_df, coeff_df, rows_df):
    """W_j -= sum_i coeff[i, j] * rows_i, ALL in df arithmetic.

    The pv relation bookkeeping requires the subtracted quantity to equal
    the recorded (hi, lo) coefficients times the df basis rows EXACTLY — an
    f32 matmul would round at eps*|coeff| (the O(1) block-Rayleigh and band
    coefficients would leak ~1e-8 per step, the scalar engine's measured
    failure mode).  b is small and static, so this unrolls to b^2
    elementwise df ops."""
    c_hi, c_lo = coeff_df
    r_hi, r_lo = rows_df
    w_hi, w_lo = w_df
    b_rows = r_hi.shape[0]
    b_cols = w_hi.shape[0]
    outs_hi, outs_lo = [], []
    for j in range(b_cols):
        acc = (w_hi[j], w_lo[j])
        for i in range(b_rows):
            prod = df64.df_mul((c_hi[i, j], c_lo[i, j]), (r_hi[i], r_lo[i]))
            acc = df64.df_sub(acc, prod)
        outs_hi.append(acc[0])
        outs_lo.append(acc[1])
    return jnp.stack(outs_hi), jnp.stack(outs_lo)


def _block_cgs_df_coeffs(w_df, rows_hi, row_mask, passes: int = 1):
    """Delegates to :func:`linalg.orthogonalize_block_cgs2_df_coeffs` (the
    shared exact-relation recapture primitive; one implementation holds the
    two_sum accumulation subtlety for the scalar AND block pv engines)."""
    return linalg.orthogonalize_block_cgs2_df_coeffs(w_df, rows_hi, row_mask, passes)


def _block_cgs_dfdf_coeffs(w_df, rows_df, row_mask, passes: int = 1):
    """Delegates to :func:`linalg.orthogonalize_block_cgs2_dfdf_coeffs`."""
    return linalg.orthogonalize_block_cgs2_dfdf_coeffs(w_df, rows_df, row_mask, passes)



def _mgs_block(w, breakdown_eps, precise: bool = False):
    """In-block sequential MGS: returns (u_next, r, r_lo, live) with
    ``w = r^T u_next`` (r upper triangular — the B_k band coupling, same
    layout as block_lanczos._band_matrix) and per-row ``live`` flags.

    A row whose residual norm falls below ``breakdown_eps`` (the scalar
    beta-breakdown threshold, lambda_lanczos.hpp:279) becomes exactly ZERO
    with a zero R column — per-row rank collapse is thereby visible to the
    host (diag(R) == 0) instead of poisoning a Cholesky.  b is small and
    static, so the double loop unrolls under jit (~b^2/2 elementwise dots).

    ``precise`` (real f32): the coefficients and norms come from EFT df64
    dots — plain f32 reductions carry ~n*eps error into the R entries and
    bias every Ritz value (measured 2.2e-4 at n=262144 where the scalar
    engine's df64 betas give 1.3e-6); the hi words land in ``r`` (correctly
    rounded) and the low words in ``r_lo`` for the host's float64 T."""
    b = w.shape[0]
    dtype = w.dtype
    rdtype = np.dtype(real_dtype(dtype))
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    zero_c = jnp.zeros((), dtype)
    zero_r = jnp.zeros((), rdtype)

    outs = []
    live = []
    r_cols = []
    rlo_cols = []
    for j in range(b):
        wj = w[j]
        col = []
        col_lo = []
        for i in range(j):
            if precise:
                c_hi, c_lo = linalg.inner_prod_df(outs[i], wj)
                c = c_hi.astype(dtype)
                col_lo.append(c_lo.astype(rdtype))
            else:
                c = linalg.inner_prod(outs[i], wj).astype(dtype)
                col_lo.append(zero_r)
            wj = wj - c * outs[i]
            col.append(c)
        if precise:
            nsq_hi, nsq_lo = linalg.inner_prod_df(wj, wj)
            b_hi, b_lo = df64.df_sqrt((nsq_hi.astype(rdtype), nsq_lo.astype(rdtype)))
            nrm = b_hi
            nrm_lo = b_lo
        else:
            nrm = linalg.norm(wj).astype(rdtype)
            nrm_lo = zero_r
        live_j = nrm > breakdown_eps
        outs.append(jnp.where(live_j, wj / jnp.maximum(nrm, tiny), jnp.zeros_like(wj)))
        col.append(jnp.where(live_j, nrm.astype(dtype), zero_c))
        col_lo.append(jnp.where(live_j, nrm_lo, zero_r))
        col.extend([zero_c] * (b - 1 - j))
        col_lo.extend([zero_r] * (b - 1 - j))
        r_cols.append(jnp.stack(col))
        rlo_cols.append(jnp.stack(col_lo))
        live.append(live_j)
    u_next = jnp.stack(outs)
    r = jnp.stack(r_cols, axis=1)  # r[i, j] = col_j[i]: upper triangular
    r_lo = jnp.stack(rlo_cols, axis=1)
    return u_next, r, r_lo, jnp.stack(live)



class _BlockState(NamedTuple):
    u_buf: jax.Array  # ((cap_b + 1) * b, n): block j at rows [j*b, (j+1)*b)
    a_buf: jax.Array  # (cap_b, b, b) diagonal blocks A_k
    a_lo: jax.Array  # (cap_b, b, b) df64 low words of A_k (precise) or (1,1,1)
    r_buf: jax.Array  # (cap_b, b, b) couplings R_k (upper triangular)
    r_lo: jax.Array  # (cap_b, b, b) df64 low words of R_k (precise) or (1,1,1)
    k: jax.Array  # int32: completed block steps
    stop: jax.Array  # bool: rank collapse (block breakdown)
    itern: jax.Array  # int32: block count at breakdown (0 while running)


@functools.partial(jax.jit, donate_argnums=(0,))
def _reset_block_state(state: _BlockState, u0):
    """Start a new cycle IN the old state's buffers (donated: in-place on
    device).  Stale basis rows / coefficient blocks beyond the new live
    counts are never read — every consumer masks by the live row count, and
    the host only reads a/r blocks [0, kb_done) which the new cycle rewrites.
    A fresh _init_block_state per cycle would transiently hold two
    (cap+1)*b x n buffers (~8.6 GB at the n=4.2M flagship)."""
    u_buf = jax.lax.dynamic_update_slice_in_dim(state.u_buf, u0, 0, axis=0)
    return state._replace(
        u_buf=u_buf,
        k=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(False),
        itern=jnp.asarray(0, jnp.int32),
    )


def _init_block_state(u0, cap_b: int, precise: bool):
    b, n = u0.shape
    dtype = u0.dtype
    rdtype = np.dtype(real_dtype(dtype))
    lo_shape = (cap_b, b, b) if precise else (1, 1, 1)
    return _BlockState(
        jnp.zeros(((cap_b + 1) * b, n), dtype).at[:b].set(u0),
        jnp.zeros((cap_b, b, b), dtype),
        jnp.zeros(lo_shape, rdtype),
        jnp.zeros((cap_b, b, b), dtype),
        jnp.zeros(lo_shape, rdtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, donate_argnums=(1,), static_argnames=("passes", "precise"))
def _fused_block_stage(op, state: _BlockState, defl, defl_mask, offset, k_limit, passes: int = 1, precise: bool = False):
    """Advance the block build until ``k_limit`` completed steps or rank
    breakdown — the block analogue of ``lanczos_fused._fused_stage``.

    ``k_limit`` is a dynamic operand: every segment of every cycle reuses
    ONE compiled while_loop (recompiles dominate otherwise; see
    thick_restart.thick_lanczos_iteration_fused).  Convergence is judged on
    host at segment boundaries — there is no cheap on-device eigensolver
    for the block band matrix, and the segmented schedule already amortizes
    the boundary sync over O(segment) steps.
    """
    dtype = state.u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))
    cap_b = state.a_buf.shape[0]
    b = state.r_buf.shape[1]
    breakdown_eps = jnp.asarray(machine_eps(rdtype) * 10.0, rdtype)
    offset = jnp.asarray(offset, rdtype)
    k_lim = jnp.asarray(jnp.minimum(k_limit, cap_b), jnp.int32)

    def cond(st: _BlockState):
        return (st.k < k_lim) & (~st.stop)

    def body(st: _BlockState) -> _BlockState:
        k = st.k
        u_k = jax.lax.dynamic_slice_in_dim(st.u_buf, k * b, b, axis=0)
        u_km1 = jax.lax.dynamic_slice_in_dim(st.u_buf, jnp.maximum(k - 1, 0) * b, b, axis=0)

        w = _block_matvec(op, u_k, offset)

        if precise:
            a_hi, a_lo_k = _pair_dots_df(u_k, w)
            a_k = a_hi.astype(dtype)
        else:
            uc = jnp.conj(u_k) if is_complex_dtype(dtype) else u_k
            a_k = jnp.matmul(uc, w.T, precision=_PREC)
            a_lo_k = None

        w = w - jnp.matmul(a_k.T, u_k, precision=_PREC)
        r_prev = jax.lax.dynamic_index_in_dim(st.r_buf, jnp.maximum(k - 1, 0), axis=0, keepdims=False)
        r_prev = jnp.where(k >= 1, r_prev, jnp.zeros_like(r_prev))
        w = w - jnp.matmul(jnp.conj(r_prev), u_km1, precision=_PREC)

        # Deflation slot (accepted pairs + kept Ritz vectors) then the live
        # basis rows — same ordering as the reference (:259-260).
        w = _block_cgs(w, defl, defl_mask, passes=passes)
        w = _bcgs_block(w, st.u_buf, (k + 1) * b, passes=passes)

        u_next, r_k, r_lo_k, live = _mgs_block(w, breakdown_eps, precise)
        bad = ~jnp.all(live)  # any dead row stops the loop; the host decides
        # between invariant-subspace exit and repair-and-resume.

        u_buf = jax.lax.dynamic_update_slice_in_dim(st.u_buf, u_next, (k + 1) * b, axis=0)
        zi = jnp.zeros((), k.dtype)
        a_buf = jax.lax.dynamic_update_slice(st.a_buf, a_k[None], (k, zi, zi))
        a_lo = (
            jax.lax.dynamic_update_slice(st.a_lo, a_lo_k[None], (k, zi, zi))
            if precise
            else st.a_lo
        )
        r_buf = jax.lax.dynamic_update_slice(st.r_buf, r_k[None], (k, zi, zi))
        r_lo = (
            jax.lax.dynamic_update_slice(st.r_lo, r_lo_k[None], (k, zi, zi))
            if precise
            else st.r_lo
        )

        itern = jnp.where(bad, k + 1, st.itern)
        return _BlockState(u_buf, a_buf, a_lo, r_buf, r_lo, k + 1, bad, itern)

    return jax.lax.while_loop(cond, body, state)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_candidate(u_buf, block, start):
    """Donated in-place write of the repaired candidate block: an eager
    dynamic_update_slice would copy the whole multi-GB basis buffer
    (the 8.6 GB transient _reset_block_state exists to avoid)."""
    return jax.lax.dynamic_update_slice_in_dim(u_buf, block, start, axis=0)


@jax.jit
def _repair_candidates(u_buf, defl, defl_mask, fresh, dead, live_rows_incl):
    """Replace dead candidate rows (given as the (b, n) block ``cand`` inside
    ``u_buf`` — its live rows are already orthonormal and must NOT move, so
    only the fresh replacements are orthogonalized) with random directions
    orthonormal to the deflation slot, ALL basis rows up to
    ``live_rows_incl`` (which includes the candidate block — zero rows are
    inert), and each other.  Returns the (b, n) repaired block and per-row
    revived flags.  Replacement rows carry zero band coupling (their true
    residual was ~0) — "restart inside the block", the block analogue of
    the reference's deflated random restarts (lambda_lanczos.hpp:231-234)."""
    b = fresh.shape[0]
    dtype = u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))
    tol = jnp.asarray(machine_eps(rdtype) * 100.0, rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)

    start = live_rows_incl - b
    cand = jax.lax.dynamic_slice_in_dim(u_buf, start, b, axis=0)
    outs = []
    revived = []
    for j in range(b):
        v = fresh[j]
        v = linalg.orthogonalize_cgs2(v, defl, defl_mask)
        v = linalg.orthogonalize_bcgs_dyn(v, u_buf, live_rows_incl)
        for i in range(j):
            v = v - linalg.inner_prod(outs[i], v) * outs[i]
        nrm = linalg.norm(v).astype(rdtype)
        ok = dead[j] & (nrm > tol)
        outs.append(jnp.where(ok, v / jnp.maximum(nrm, tiny), jnp.zeros_like(v)))
        revived.append(ok)
    repl = jnp.stack(outs)
    block = jnp.where(dead[:, None], repl, cand)
    return block, jnp.stack(revived)


@jax.jit
def _rotate_two(q_y, y_rows, q_u, u_buf):
    """Ritz recombination over [Y; U] as two matmuls (a concatenated basis
    would materialize a second (cap, n) buffer — GBs at production n)."""
    return jnp.matmul(q_y.astype(y_rows.dtype), y_rows, precision=_PREC) + jnp.matmul(
        q_u.astype(u_buf.dtype), u_buf, precision=_PREC
    )


@jax.jit
def _coupling_block(op, y_rows, u0, offset):
    """S = Y^H (A + offset) U_0 — the (l, b) arrowhead couplings (one block
    matvec per restart; the block form of thick_restart._coupling_row)."""
    au = _block_matvec(op, u0, offset)
    yc = jnp.conj(y_rows) if is_complex_dtype(y_rows.dtype) else y_rows
    return jnp.matmul(yc, au.T, precision=_PREC)


@jax.jit
def _coupling_block_df(op, y_rows, u0, offset):
    """df64 arrowhead couplings (real f32 precise mode): the S entries enter
    the host T directly, so they need the same EFT treatment as A_k/R_k —
    a plain f32 contraction carries ~n*eps error into every coupled Ritz
    value.  Returns ((l, b) hi, (l, b) lo)."""
    au = _block_matvec(op, u0, offset)
    return _pair_dots_df(y_rows, au)


def block_thick_iteration_fused(op, v0_block, nroot: int, defl, defl_mask, cfg: LanczosConfig, block_size: int, rng=None):
    """One deflated solve of the fused block thick-restart engine; same
    return contract as :func:`lanczos_tpu.solvers.lanczos.lanczos_iteration`:
    (eigenvalues, eigenvectors, total_block_steps, converged).

    ``cfg.precise_vectors`` dispatches to the df64-basis variant
    (:func:`block_thick_iteration_fused_pv`)."""
    from .block_lanczos import _orthonormalize_block, _repair_block

    if getattr(cfg, "precise_vectors", False):
        return block_thick_iteration_fused_pv(op, v0_block, nroot, defl, defl_mask, cfg, block_size, rng)

    dtype = np.dtype(v0_block.dtype)
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    b = int(block_size)

    # When the space left after deflation is only a few blocks wide, rank
    # collapse becomes structural (dead rows cannot be repaired — there is
    # nothing left to explore) and dead rows would enter the band matrix as
    # spurious zero eigenvalues.  Such tiny tails are scalar-cheap anyway:
    # delegate them to the scalar thick engine.
    nd_live = int(np.asarray(jax.device_get(defl_mask)).sum())
    if n - nd_live < 4 * b:
        from .thick_restart import thick_lanczos_iteration_fused

        return thick_lanczos_iteration_fused(op, v0_block[0], nroot, defl, defl_mask, cfg)
    host_c = np.complex128 if is_complex_dtype(dtype) else np.float64
    # Fresh entropy by default: a fixed seed would replay the same repair
    # directions every deflation round (measured on the scalar engines: a
    # replayed v0 plateaus at ~1e-5 instead of 1.3e-6 on degenerate spectra).
    rng = rng if rng is not None else np.random.default_rng()
    precise = bool(cfg.precise_reductions) and np.dtype(rdtype) == np.float32 and not is_complex_dtype(dtype)
    passes = max(int(cfg.reorth_passes), 1)

    m_max_rows = max(min(cfg.max_iteration, n), 3 * b)
    # Kept-subspace width: block restarts benefit from a wider Y than the
    # scalar's nroot+2 — the cluster converges collectively, so the kept set
    # should cover the wanted roots plus a buffer of the same order.
    l_default = nroot + max(2, b)
    l_keep = cfg.resolve_thick_keep(l_default, m_max_rows - 2 * b)
    cap_b = max(m_max_rows // b, 2)
    nd_cap = defl.shape[0]

    # Deflation slot = accepted pairs + kept Ritz vectors (cycles >= 1).
    defl_big = jnp.zeros((nd_cap + l_keep, n), dtype).at[:nd_cap].set(defl)
    mask_big = jnp.zeros((nd_cap + l_keep,), np.dtype(rdtype)).at[:nd_cap].set(defl_mask)

    # Start block: orthonormal against accepted pairs; rank-repair identical
    # rows (fixed-seed initializers) with fresh random directions.
    zero_basis = jnp.zeros((1 * b, n), dtype)
    u0, live = _orthonormalize_block(v0_block, defl_big, mask_big, zero_basis, 0)
    if np.any(np.asarray(jax.device_get(live)) < 0.5):
        fresh = _fresh_block(rng, b, n, dtype)
        u0, _ = _repair_block(
            u0, defl_big, mask_big, zero_basis, 0, fresh,
            jnp.asarray(np.asarray(jax.device_get(live)) < 0.5),
        )

    theta_kept = np.zeros(0, dtype=np.float64)
    y_rows = jnp.zeros((l_keep, n), dtype)
    s_host = np.zeros((0, b), dtype=host_c)

    total_steps = 0
    pevs: np.ndarray | None = None
    converged = False
    offset = jnp.asarray(cfg.eigenvalue_offset, np.dtype(rdtype))

    def read_coeffs(state, kb):
        """ONE batched device_get of the coefficient blocks (each separate
        get is a device round trip)."""
        if precise:
            a, a_lo, r, r_lo = jax.device_get(
                (state.a_buf, state.a_lo, state.r_buf, state.r_lo)
            )
            a64 = np.asarray(a, host_c)[:kb] + np.asarray(a_lo, np.float64)[:kb]
            r64 = np.asarray(r, host_c)[:kb] + np.asarray(r_lo, np.float64)[:kb]
        else:
            a, r = jax.device_get((state.a_buf, state.r_buf))
            a64 = np.asarray(a, host_c)[:kb]
            r64 = np.asarray(r, host_c)[:kb]
        return a64, r64

    def resid_ok(theta_all, q_all, r_last, l_cur, kb):
        """Free a-posteriori residual bound from the band matrix: for a Ritz
        pair (theta, Vq) the residual is ||R_last @ q[last-block rows]||
        (only the candidate block leaks — the arrowhead is exact).  The
        relative-drift test alone can fire on a convergence PLATEAU (measured:
        n=2000 chain stalled at 1.3e-7 with eps=1e-12); gating on
        res <= sqrt(eps)*scale matches the err ~ res^2 relation of extremal
        Ritz values, so a genuine eps-level eigenvalue needs res ~ sqrt(eps)
        — while loose enough not to over-iterate (the production n=4.2M
        solve sits at res/scale ~ 2e-5 << sqrt(1e-6))."""
        m_tot = l_cur + kb * b
        n_want = min(int(nroot), m_tot)
        sel = (
            list(range(m_tot - 1, m_tot - 1 - n_want, -1))
            if cfg.find_maximum
            else list(range(n_want))
        )
        q_lb = q_all[m_tot - b :, sel]  # last-block rows of the wanted pairs
        res = np.linalg.norm(r_last @ q_lb, axis=0)
        scale = max(np.max(np.abs(theta_all)), np.finfo(np.float64).tiny)
        return bool(np.all(res <= np.sqrt(cfg.eps) * scale))

    def assemble_t(l_cur, a_blocks, r_blocks, kb):
        """Arrowhead band matrix over [Y (l_cur); U_0..U_{kb-1}]."""
        m_tot = l_cur + kb * b
        t = np.zeros((m_tot, m_tot), dtype=host_c)
        if l_cur:
            t[np.arange(l_cur), np.arange(l_cur)] = theta_kept[:l_cur]
            t[:l_cur, l_cur : l_cur + b] = s_host[:l_cur]
            t[l_cur : l_cur + b, :l_cur] = s_host[:l_cur].conj().T
        for j in range(kb):
            blk = a_blocks[j]
            blk = (blk + blk.conj().T) / 2
            o = l_cur + j * b
            t[o : o + b, o : o + b] = blk
        for j in range(kb - 1):  # R_j couples block j and j+1
            o = l_cur + j * b
            t[o + b : o + 2 * b, o : o + b] = r_blocks[j]
            t[o : o + b, o + b : o + 2 * b] = r_blocks[j].conj().T
        return (t + t.conj().T) / 2

    state = None
    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_kept.shape[0]
        kb_max = max((m_max_rows - l_cur) // b, 1)

        state = _init_block_state(u0, cap_b, precise) if state is None else _reset_block_state(state, u0)
        seg = min(kb_max, max(-(-2 * (l_cur + int(nroot)) // b), -(-kb_max // 8), 2))
        pseg: np.ndarray | None = None
        seg_conv = False
        invariant = False
        boundary = None
        while True:
            state = _fused_block_stage(
                op, state, defl_big, mask_big, cfg.eigenvalue_offset,
                jnp.asarray(seg, jnp.int32), passes, precise,
            )
            _stop, _itern, _k = jax.device_get((state.stop, state.itern, state.k))
            if bool(_stop):
                # Rank collapse at step kb_done-1: the candidate block has
                # dead rows (diag(R) == 0 marks them).
                kb_done = int(_itern)
                r_last = np.asarray(jax.device_get(state.r_buf))[kb_done - 1]
                dead = np.abs(np.diag(r_last)) == 0.0
                if dead.all():
                    invariant = True  # full breakdown: Krylov space closed
                    break
                # Partial collapse: repair the dead rows with fresh random
                # directions (zero band coupling) and resume the SAME loop.
                fresh = _fresh_block(rng, b, n, dtype)
                block, revived = _repair_candidates(
                    state.u_buf, defl_big, mask_big, fresh,
                    jnp.asarray(dead), (kb_done + 1) * b,
                )
                if not bool(np.all(np.asarray(jax.device_get(revived))[dead])):
                    # Nothing (or not everything) revivable: the explored
                    # space is essentially exhausted — accept current values.
                    invariant = True
                    break
                state = state._replace(
                    u_buf=_write_candidate(state.u_buf, block, kb_done * b),
                    stop=jnp.asarray(False),
                    itern=jnp.asarray(0, jnp.int32),
                )
                continue
            kb_done = int(_k)
            if seg >= kb_max:
                boundary = None
                break
            a_blocks, r_blocks = read_coeffs(state, kb_done)
            th, q_seg = np.linalg.eigh(assemble_t(l_cur, a_blocks, r_blocks, kb_done))
            boundary = (a_blocks, r_blocks, th, q_seg)  # reused at cycle end
            want = min(int(nroot), th.shape[0])
            evs_seg = th[::-1][:want] if cfg.find_maximum else th[:want]
            if (
                pseg is not None
                and pseg.shape[0] == evs_seg.shape[0]
                and evs_seg.shape[0] == nroot
                and np.all(
                    np.abs(evs_seg - pseg)
                    < np.minimum(np.abs(evs_seg), np.abs(pseg)) * cfg.eps
                )
                and resid_ok(th, q_seg, r_blocks[kb_done - 1], l_cur, kb_done)
            ):
                seg_conv = True  # converged mid-cycle: skip the rest of the budget
                break
            pseg = evs_seg
            seg = min(2 * seg, kb_max)

        total_steps += kb_done
        _add_reorth(kb_done)
        if seg_conv and boundary is not None:
            # The converged segment boundary already fetched/diagonalized
            # exactly this T — don't redo the device round trip + host eigh.
            a_blocks, r_blocks, theta_pre, q_pre = boundary
        else:
            a_blocks, r_blocks = read_coeffs(state, kb_done)
            theta_pre = q_pre = None
        t_mat = assemble_t(l_cur, a_blocks, r_blocks, kb_done)
        cand_live = np.zeros(0, np.intp)
        if invariant:
            # Space-exhausted exit: the candidate block's LIVE rows span the
            # last unexplored directions and must join the final
            # Rayleigh-Ritz — excluding them loses ~res^2 accuracy (measured
            # 1e-7 returned at eps=1e-12 on the n=1000 chain at cap=n).
            # Costs one extra block matvec for the candidate diagonal block.
            r_last = r_blocks[kb_done - 1]
            cand_live = np.nonzero(np.abs(np.diag(r_last)) > 0)[0]
            if cand_live.size:
                cand = jax.lax.dynamic_slice_in_dim(state.u_buf, kb_done * b, b, axis=0)
                if precise:
                    ac_hi, ac_lo = jax.device_get(_coupling_block_df(op, cand, cand, offset))
                    a_cand = np.asarray(ac_hi, host_c) + np.asarray(ac_lo, np.float64)
                else:
                    a_cand = np.asarray(
                        jax.device_get(_coupling_block(op, cand, cand, offset)), host_c
                    )
                m_arrow = t_mat.shape[0]
                ncl = int(cand_live.size)
                t_ext = np.zeros((m_arrow + ncl, m_arrow + ncl), host_c)
                t_ext[:m_arrow, :m_arrow] = t_mat
                cpl = r_last[cand_live, :]  # candidate-live rows x last block
                t_ext[m_arrow:, m_arrow - b : m_arrow] = cpl
                t_ext[m_arrow - b : m_arrow, m_arrow:] = cpl.conj().T
                blk = a_cand[np.ix_(cand_live, cand_live)]
                t_ext[m_arrow:, m_arrow:] = (blk + blk.conj().T) / 2
                t_mat = (t_ext + t_ext.conj().T) / 2
        m_tot = t_mat.shape[0]
        if theta_pre is not None and theta_pre.shape[0] == m_tot:
            theta_all, q_all = theta_pre, q_pre
        else:
            theta_all, q_all = np.linalg.eigh(t_mat)

        m_want = min(nroot, m_tot)
        evs = theta_all[::-1][:m_want] if cfg.find_maximum else theta_all[:m_want]

        if invariant or seg_conv:  # rank breakdown (invariant subspace) or drift
            converged = True
        elif pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            diffs = np.abs(evs - pevs)
            tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
            if np.all(diffs < tol) and resid_ok(
                theta_all, q_all, r_blocks[kb_done - 1], l_cur, kb_done
            ):
                converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1
        n_sel = min(nroot, m_tot) if last_cycle else min(l_keep, m_tot)
        sel = (
            [m_tot - 1 - i for i in range(n_sel)]
            if cfg.find_maximum
            else list(range(n_sel))
        )

        q_y = np.zeros((n_sel, l_keep), dtype=host_c)
        q_y[:, :l_cur] = q_all[:l_cur, sel].T
        q_u = np.zeros((n_sel, state.u_buf.shape[0]), dtype=host_c)
        q_u[:, : kb_done * b] = q_all[l_cur : l_cur + kb_done * b, sel].T
        for a_i, li in enumerate(cand_live):  # extension rows -> live candidate rows
            q_u[:, kb_done * b + int(li)] = q_all[l_cur + kb_done * b + a_i, sel]
        if not is_complex_dtype(dtype):
            q_y, q_u = q_y.real, q_u.real
        ritz = _rotate_two(jnp.asarray(q_y, dtype), y_rows, jnp.asarray(q_u, dtype), state.u_buf)

        if last_cycle:
            norms = jnp.sqrt(jnp.sum(jnp.abs(ritz) ** 2, axis=1, keepdims=True))
            tiny = np.finfo(np.dtype(rdtype)).tiny
            eigvecs = ritz / jnp.maximum(norms, tiny)
            eigenvalues = [float(theta_all[s]) - cfg.eigenvalue_offset for s in sel]
            converged = converged or m_tot >= n
            return eigenvalues, eigvecs, total_steps, converged

        # Thick restart: Y' = selected Ritz vectors; the next start block is
        # the candidate block (already orthonormal against everything).
        theta_kept = theta_all[sel]
        y_rows = jnp.zeros((l_keep, n), dtype).at[:n_sel].set(ritz) if n_sel < l_keep else ritz
        u0 = jax.lax.dynamic_slice_in_dim(state.u_buf, kb_done * b, b, axis=0)
        defl_big = defl_big.at[nd_cap : nd_cap + l_keep].set(y_rows)
        mask_big = mask_big.at[nd_cap : nd_cap + n_sel].set(1.0)
        if precise:
            s_hi, s_lo = jax.device_get(_coupling_block_df(op, y_rows, u0, offset))
            s_host = (np.asarray(s_hi, host_c) + np.asarray(s_lo, np.float64))[:n_sel]
        else:
            s_dev = _coupling_block(op, y_rows, u0, offset)
            s_host = np.asarray(jax.device_get(s_dev), host_c)[:n_sel]
        theta_kept = theta_kept[:n_sel]


def lanczos_run_block_thick(op, cfg: LanczosConfig, init_vector, dtype, block_size: int):
    """Block thick-restart engine under the shared deflation driver
    (v0 is a block of ``block_size`` rows; the engine restarts internally)."""
    from .lanczos import deflation_driver

    cfg = cfg.resolved(dtype)
    b = max(int(block_size), 1)
    return deflation_driver(
        lambda v0, nroot, defl, mask: block_thick_iteration_fused(op, v0, nroot, defl, mask, cfg, b),
        cfg, init_vector, dtype, v0_rows=b, use_warm_restarts=False,
    )


# ---------------------------------------------------------------------------
# precise_vectors block thick restart: df64 block basis, exact-relation band
# ---------------------------------------------------------------------------


def _mgs_block_pv(w_df, breakdown):
    """In-block sequential MGS entirely in df arithmetic: (u_df, r, r_lo,
    live) with ``W = R^T U`` holding at df precision — every coefficient is
    recorded exactly as subtracted (the in-block couplings are O(1), so the
    f32-rounded variant would leak ~1e-8 per step into the relation)."""
    w_hi, w_lo = w_df
    b = w_hi.shape[0]
    rdtype = np.dtype(real_dtype(w_hi.dtype))
    zero_r = jnp.zeros((), rdtype)

    outs = []
    live = []
    r_cols, rlo_cols = [], []
    for j in range(b):
        wj = (w_hi[j], w_lo[j])
        col, col_lo = [], []
        for i in range(j):
            c_df = linalg.inner_prod_df_df(outs[i], wj)
            wj = df64.df_sub(wj, df64.df_mul(c_df, outs[i]))
            col.append(c_df[0].astype(rdtype))
            col_lo.append(c_df[1].astype(rdtype))
        nsq = linalg.inner_prod_df_df(wj, wj)
        b_hi, b_lo = df64.df_sqrt((nsq[0].astype(rdtype), nsq[1].astype(rdtype)))
        live_j = b_hi > breakdown
        safe = (jnp.where(live_j, b_hi, jnp.ones((), rdtype)), jnp.where(live_j, b_lo, zero_r))
        uj_hi, uj_lo = df64.df_mul(wj, df64.df_recip(safe))
        uj = (
            jnp.where(live_j, uj_hi, jnp.zeros_like(uj_hi)),
            jnp.where(live_j, uj_lo, jnp.zeros_like(uj_lo)),
        )
        outs.append(uj)
        col.append(jnp.where(live_j, b_hi, zero_r))
        col_lo.append(jnp.where(live_j, b_lo, zero_r))
        col.extend([zero_r] * (b - 1 - j))
        col_lo.extend([zero_r] * (b - 1 - j))
        r_cols.append(jnp.stack(col))
        rlo_cols.append(jnp.stack(col_lo))
        live.append(live_j)
    u_hi = jnp.stack([o[0] for o in outs])
    u_lo = jnp.stack([o[1] for o in outs])
    r = jnp.stack(r_cols, axis=1)  # r[i, j] = col_j[i]: upper triangular
    r_lo = jnp.stack(rlo_cols, axis=1)
    return (u_hi, u_lo), r, r_lo, jnp.stack(live)


class _BlockStatePV(NamedTuple):
    u_buf: jax.Array  # ((cap_b + 1) * b, n) hi words
    u_lo: jax.Array  # ((cap_b + 1) * b, n) lo words
    a_buf: jax.Array  # (cap_b, b, b) block Rayleigh hi
    a_lo: jax.Array
    r_buf: jax.Array  # (cap_b, b, b) band couplings hi (upper triangular)
    r_lo: jax.Array
    # ((cap_b + 1) * b, cap_b * b): basis-CGS recapture; column k*b+j holds
    # the coefficients removed from w_j at step k (exact-relation C block).
    coup: jax.Array
    # (nd, cap_b * b) hi/lo: deflation-slot recapture (Y couplings) with
    # error-free two_sum pass accumulation.
    coup_d: jax.Array
    coup_d_lo: jax.Array
    k: jax.Array
    stop: jax.Array
    itern: jax.Array


def _init_block_state_pv(u0_hi, u0_lo, cap_b: int, nd: int):
    b, n = u0_hi.shape
    dtype = u0_hi.dtype
    rdtype = np.dtype(real_dtype(dtype))
    cap_rows = (cap_b + 1) * b
    return _BlockStatePV(
        jnp.zeros((cap_rows, n), dtype).at[:b].set(u0_hi),
        jnp.zeros((cap_rows, n), dtype).at[:b].set(u0_lo),
        jnp.zeros((cap_b, b, b), rdtype),
        jnp.zeros((cap_b, b, b), rdtype),
        jnp.zeros((cap_b, b, b), rdtype),
        jnp.zeros((cap_b, b, b), rdtype),
        jnp.zeros((cap_rows, cap_b * b), rdtype),
        jnp.zeros((nd, cap_b * b), rdtype),
        jnp.zeros((nd, cap_b * b), rdtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _reset_block_state_pv(state: _BlockStatePV, u0_hi, u0_lo):
    """New cycle in the old buffers (donated; see _reset_block_state)."""
    return state._replace(
        u_buf=jax.lax.dynamic_update_slice_in_dim(state.u_buf, u0_hi, 0, axis=0),
        u_lo=jax.lax.dynamic_update_slice_in_dim(state.u_lo, u0_lo, 0, axis=0),
        k=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(False),
        itern=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, donate_argnums=(1,), static_argnames=("passes",))
def _fused_block_stage_pv(op, state: _BlockStatePV, defl, defl_lo, defl_mask, offset, k_limit, passes: int = 1):
    """pv analogue of :func:`_fused_block_stage`: df64 block basis, EFT block
    matvec, df recurrence/MGS, recaptured CGS couplings — the computed
    relation ``A V = V M + U_cand R_last E_last^T`` holds to df precision so
    the host's nonsymmetric band-matrix eigensolve is exact where the f32
    band floors at ~1e-6."""
    dtype = state.u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))
    cap_b = state.a_buf.shape[0]
    b = state.r_buf.shape[1]
    eps_m = machine_eps(rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    offset = jnp.asarray(offset, rdtype)
    k_lim = jnp.asarray(jnp.minimum(k_limit, cap_b), jnp.int32)
    zero = jnp.zeros((), rdtype)

    def cond(st: _BlockStatePV):
        return (st.k < k_lim) & (~st.stop)

    def body(st: _BlockStatePV) -> _BlockStatePV:
        k = st.k
        u_k = (
            jax.lax.dynamic_slice_in_dim(st.u_buf, k * b, b, axis=0),
            jax.lax.dynamic_slice_in_dim(st.u_lo, k * b, b, axis=0),
        )
        u_km1 = (
            jax.lax.dynamic_slice_in_dim(st.u_buf, jnp.maximum(k - 1, 0) * b, b, axis=0),
            jax.lax.dynamic_slice_in_dim(st.u_lo, jnp.maximum(k - 1, 0) * b, b, axis=0),
        )

        w_hi, w_lo = jax.vmap(op.matvec_df)(u_k[0], u_k[1])
        off_term = df64.df_mul((offset, zero), u_k)
        w_hi, w_lo = df64.df_add((w_hi, w_lo), off_term)

        a_hi, a_lo_k = _pair_dots_df_df(u_k, (w_hi, w_lo))
        a_hi = a_hi.astype(rdtype)
        a_lo_k = a_lo_k.astype(rdtype)
        w_hi, w_lo = _df_block_comb_sub((w_hi, w_lo), (a_hi, a_lo_k), u_k)

        r_prev = jax.lax.dynamic_index_in_dim(st.r_buf, jnp.maximum(k - 1, 0), axis=0, keepdims=False)
        r_prev_lo = jax.lax.dynamic_index_in_dim(st.r_lo, jnp.maximum(k - 1, 0), axis=0, keepdims=False)
        sel1 = (k >= 1).astype(rdtype)
        # coefficient of u_{k-1,i} in column j is r_prev[j, i] -> transpose.
        w_hi, w_lo = _df_block_comb_sub(
            (w_hi, w_lo), (r_prev.T * sel1, r_prev_lo.T * sel1), u_km1
        )

        # Deflation slot (accepted pairs + kept df Ritz rows): df-exact on the
        # FIRST block of a cycle (O(1) arrowhead couplings), cheap after.
        # Deflation slot always >= CGS2 (couplings not fully recaptured:
        # their orthogonality enters the eigenvalues directly — see the
        # scalar pv body); the recaptured basis CGS keeps ``passes``.
        defl_passes = max(passes, 2)
        (w_hi, w_lo), c_d = jax.lax.cond(
            k == 0,
            lambda wd: _block_cgs_dfdf_coeffs(wd, (defl, defl_lo), defl_mask, passes=defl_passes),
            lambda wd: _block_cgs_df_coeffs(wd, defl, defl_mask, passes=defl_passes),
            (w_hi, w_lo),
        )
        coup_d = jax.lax.dynamic_update_slice(st.coup_d, c_d[0], (jnp.zeros((), k.dtype), k * b))
        coup_d_lo = jax.lax.dynamic_update_slice(st.coup_d_lo, c_d[1], (jnp.zeros((), k.dtype), k * b))

        # Live basis rows (blocks 0..k inclusive): hi-word masked block CGS
        # with recapture (steady-state couplings are noise-small).
        cap_rows = st.u_buf.shape[0]
        row_mask = (jnp.arange(cap_rows) < (k + 1) * b).astype(rdtype)
        (w_hi, w_lo), c_u = _block_cgs_df_coeffs((w_hi, w_lo), st.u_buf, row_mask, passes=passes)
        # basis couplings are noise-small: the hi word is the whole story
        coup = jax.lax.dynamic_update_slice(st.coup, c_u[0], (jnp.zeros((), k.dtype), k * b))

        # Breakdown at the f32 CGS noise floor, relative to the band scale
        # (same reasoning as the scalar pv body).
        scale = jnp.maximum(jnp.max(jnp.abs(st.a_buf)) + 2.0 * jnp.max(jnp.abs(st.r_buf)), jnp.max(jnp.abs(a_hi)))
        breakdown = jnp.asarray(eps_m * 100.0, rdtype) * jnp.maximum(scale, tiny)
        u_next, r_k, r_lo_k, live = _mgs_block_pv((w_hi, w_lo), breakdown)
        bad = ~jnp.all(live)

        u_buf = jax.lax.dynamic_update_slice_in_dim(st.u_buf, u_next[0], (k + 1) * b, axis=0)
        u_lo = jax.lax.dynamic_update_slice_in_dim(st.u_lo, u_next[1], (k + 1) * b, axis=0)
        zi = jnp.zeros((), k.dtype)
        a_buf = jax.lax.dynamic_update_slice(st.a_buf, a_hi[None], (k, zi, zi))
        a_lo = jax.lax.dynamic_update_slice(st.a_lo, a_lo_k[None], (k, zi, zi))
        r_buf = jax.lax.dynamic_update_slice(st.r_buf, r_k[None], (k, zi, zi))
        r_lo = jax.lax.dynamic_update_slice(st.r_lo, r_lo_k[None], (k, zi, zi))

        itern = jnp.where(bad, k + 1, st.itern)
        return _BlockStatePV(
            u_buf, u_lo, a_buf, a_lo, r_buf, r_lo, coup, coup_d, coup_d_lo,
            k + 1, bad, itern,
        )

    return jax.lax.while_loop(cond, body, state)


def block_thick_iteration_fused_pv(op, v0_block, nroot: int, defl, defl_mask, cfg: LanczosConfig, block_size: int, rng=None):
    """Block thick restart with a DOUBLE-FLOAT block basis: multiplicity-<=b
    cluster capture, bounded O(max_iteration * n) memory, AND reference-grade
    (~1e-12) eigenvalues on the f32-native chip — the block completion of
    VERDICT r2 item 1 ("then block").

    The machinery mirrors :func:`thick_lanczos_iteration_fused_pv`
    generalized to width-b blocks: the stage records every quantity it
    subtracts (block Rayleigh A_k, band R_k, CGS couplings C, deflation-slot
    couplings C_d — O(1) coefficients in error-free two_sum pairs), so the
    computed relation ``A V = V M + U_cand R_last E^T`` holds to df64
    precision; restarts carry an ordered-Schur invariant subspace of the
    nonsymmetric band M rotated in df arithmetic; convergence is drift + the
    cluster-robust ||R_last q||^2/gap gate on the values that can reach the
    final answer.

    Rank-collapse handling: a FULLY dead candidate block closes the relation
    (``A V = V M`` exactly) so eig(M) is exact on the explored invariant
    subspace; partially dead rows are repaired with fresh random directions
    (hi words; zero lo — exactly representable) and the loop resumes.  The
    unrevivable-partial corner accepts current values (the excluded live-row
    residual enters at second order; tails narrower than 4b never get here —
    they delegate to the scalar pv engine up front).

    Real dtypes only; requires ``op.matvec_df``.  Same return contract as
    :func:`block_thick_iteration_fused`.
    """
    from .block_lanczos import _orthonormalize_block, _repair_block
    from .thick_restart import (
        _df_rotate,
        _pv_converged,
        _select_invariant_pv,
        _split_rotation_host,
    )

    dtype = np.dtype(v0_block.dtype)
    rdtype = real_dtype(dtype)
    if is_complex_dtype(dtype):
        raise TypeError(
            "precise_vectors supports real dtypes only (use HermitianSplitOperator for complex)"
        )
    n = cfg.matrix_size
    b = int(block_size)

    nd_live = int(np.asarray(jax.device_get(defl_mask)).sum())
    if n - nd_live < 4 * b:
        from .thick_restart import thick_lanczos_iteration_fused

        # Dispatches to the scalar pv engine internally (cfg.precise_vectors).
        return thick_lanczos_iteration_fused(op, v0_block[0], nroot, defl, defl_mask, cfg)

    rng = rng if rng is not None else np.random.default_rng()
    passes = max(int(cfg.reorth_passes), 1)
    m_max_rows = max(min(cfg.max_iteration, n), 3 * b)
    l_default = nroot + max(2, b)
    l_keep = cfg.resolve_thick_keep(l_default, m_max_rows - 2 * b)
    cap_b = max(m_max_rows // b, 2)
    cap_rows = (cap_b + 1) * b
    nd_cap = defl.shape[0]
    nd_tot = nd_cap + l_keep
    n_protect = max(1, min(int(nroot), int(cfg.num_eigs) - nd_live))

    defl_big = jnp.zeros((nd_tot, n), dtype).at[:nd_cap].set(defl)
    defl_lo_big = jnp.zeros((nd_tot, n), dtype)
    mask_big = jnp.zeros((nd_tot,), np.dtype(rdtype)).at[:nd_cap].set(defl_mask)

    zero_basis = jnp.zeros((1 * b, n), dtype)
    u0, live0 = _orthonormalize_block(v0_block, defl_big, mask_big, zero_basis, 0)
    if np.any(np.asarray(jax.device_get(live0)) < 0.5):
        fresh = _fresh_block(rng, b, n, dtype)
        u0, _ = _repair_block(
            u0, defl_big, mask_big, zero_basis, 0, fresh,
            jnp.asarray(np.asarray(jax.device_get(live0)) < 0.5),
        )
    u0_lo = jnp.zeros_like(u0)

    theta_blk = np.zeros((0, 0), np.float64)
    s_host = np.zeros((b, 0), np.float64)  # A Y = Y Theta + U_0-block @ s
    y_df = (jnp.zeros((l_keep, n), dtype), jnp.zeros((l_keep, n), dtype))

    total_steps = 0
    pevs: np.ndarray | None = None
    converged = False

    def read_state(state, kb):
        a, a_lo, r, r_lo, coup, cd_hi, cd_lo = jax.device_get(
            (state.a_buf, state.a_lo, state.r_buf, state.r_lo,
             state.coup, state.coup_d, state.coup_d_lo)
        )
        a64 = np.asarray(a, np.float64)[:kb] + np.asarray(a_lo, np.float64)[:kb]
        r64 = np.asarray(r, np.float64)[:kb] + np.asarray(r_lo, np.float64)[:kb]
        coup64 = np.asarray(coup, np.float64)
        coupd64 = np.asarray(cd_hi, np.float64) + np.asarray(cd_lo, np.float64)
        return a64, r64, coup64, coupd64

    state = None
    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_blk.shape[0]
        kb_max = max((m_max_rows - l_cur) // b, 1)

        def assemble_m(a64, r64, coup64, coupd64, kb):
            """Nonsymmetric exact-relation band matrix over [Y; U_0..U_{kb-1}]:
            column (k, j) carries exactly the recorded coefficients of
            A u_{k,j} in the V basis."""
            m_tot = l_cur + kb * b
            m = np.zeros((m_tot, m_tot), np.float64)
            if l_cur:
                m[:l_cur, :l_cur] = theta_blk
                m[l_cur : l_cur + b, :l_cur] = s_host[:, :l_cur]
                m[:l_cur, l_cur:m_tot] += coupd64[nd_cap : nd_cap + l_cur, : kb * b]
            for k in range(kb):
                o = l_cur + k * b
                m[o : o + b, o : o + b] += a64[k]
                if k >= 1:
                    # coefficient of u_{k-1,i} in column (k, j) is R_{k-1}[j, i]
                    m[o - b : o, o : o + b] += r64[k - 1].T
                if k + 1 < kb:
                    # the MGS factorization W = R^T U: row (k+1, i) gets R_k[i, j]
                    m[o + b : o + 2 * b, o : o + b] += r64[k]
            m[l_cur:m_tot, l_cur:m_tot] += coup64[: kb * b, : kb * b]
            return m

        state = (
            _init_block_state_pv(u0, u0_lo, cap_b, nd_tot)
            if state is None
            else _reset_block_state_pv(state, u0, u0_lo)
        )
        seg = min(kb_max, max(-(-2 * (l_cur + int(nroot)) // b), -(-kb_max // 8), 2))
        seg_conv = False
        invariant = False
        boundary = None
        while True:
            state = _fused_block_stage_pv(
                op, state, defl_big, defl_lo_big, mask_big, cfg.eigenvalue_offset,
                jnp.asarray(seg, jnp.int32), passes,
            )
            _stop, _itern, _k = jax.device_get((state.stop, state.itern, state.k))
            if bool(_stop):
                kb_done = int(_itern)
                r_last_hi = np.asarray(jax.device_get(state.r_buf))[kb_done - 1]
                dead = np.abs(np.diag(r_last_hi)) == 0.0
                if dead.all():
                    invariant = True  # relation closed: eig(M) exact on the span
                    break
                fresh = _fresh_block(rng, b, n, dtype)
                block, revived = _repair_candidates(
                    state.u_buf, defl_big, mask_big, fresh,
                    jnp.asarray(dead), (kb_done + 1) * b,
                )
                if not bool(np.all(np.asarray(jax.device_get(revived))[dead])):
                    invariant = True
                    break
                cand_lo = jax.lax.dynamic_slice_in_dim(state.u_lo, kb_done * b, b, axis=0)
                cand_lo = jnp.where(jnp.asarray(dead)[:, None], 0.0, cand_lo)
                state = state._replace(
                    u_buf=_write_candidate(state.u_buf, block, kb_done * b),
                    u_lo=_write_candidate(state.u_lo, cand_lo, kb_done * b),
                    stop=jnp.asarray(False),
                    itern=jnp.asarray(0, jnp.int32),
                )
                continue
            kb_done = int(_k)
            if seg >= kb_max:
                boundary = None
                break
            a64, r64, coup64, coupd64 = read_state(state, kb_done)
            m_seg = assemble_m(a64, r64, coup64, coupd64, kb_done)
            boundary = (a64, r64, coup64, coupd64, m_seg)  # reused at cycle end
            r_last = r64[kb_done - 1]
            m_tot_seg = m_seg.shape[0]
            res_fn = lambda v, _r=r_last, _m=m_tot_seg: np.linalg.norm(_r @ v[_m - b :, :], axis=0)
            evs_seg, seg_conv = _pv_converged(
                m_seg, res_fn, int(nroot), bool(cfg.find_maximum), cfg.eps, pevs,
                n_protect=n_protect,
            )
            if seg_conv:
                break
            pevs = evs_seg
            seg = min(2 * seg, kb_max)

        total_steps += kb_done
        _add_reorth(kb_done)
        if seg_conv and boundary is not None:
            # The converged segment boundary already fetched exactly this
            # state — don't redo the device round trip + host assembly.
            a64, r64, coup64, coupd64, m_host = boundary
        else:
            a64, r64, coup64, coupd64 = read_state(state, kb_done)
            m_host = assemble_m(a64, r64, coup64, coupd64, kb_done)
        m_tot = m_host.shape[0]
        r_last = r64[kb_done - 1]
        res_fn = lambda v, _r=r_last, _m=m_tot: np.linalg.norm(_r @ v[_m - b :, :], axis=0)

        evs, cyc_conv = _pv_converged(
            m_host, res_fn, int(nroot), bool(cfg.find_maximum), cfg.eps, pevs,
            n_protect=n_protect,
        )
        if invariant or seg_conv or cyc_conv:
            converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1

        if last_cycle:
            from .thick_restart import _pv_final_select

            w_blk, qz = _pv_final_select(m_host, min(nroot, m_tot), bool(cfg.find_maximum))
            num_out = qz.shape[1]
            qy = np.zeros((num_out, l_keep), np.float64)
            qy[:, :l_cur] = qz[:l_cur].T
            qu = np.zeros((num_out, cap_rows), np.float64)
            qu[:, : kb_done * b] = qz[l_cur:].T
            vec_hi, vec_lo = _df_rotate(
                *_split_rotation_host(qy, dtype), *_split_rotation_host(qu, dtype),
                y_df, (state.u_buf, state.u_lo),
            )
            vecs = vec_hi + vec_lo
            norms = jnp.sqrt(jnp.sum(vecs * vecs, axis=1, keepdims=True))
            tiny = np.finfo(np.dtype(rdtype)).tiny
            eigvecs = vecs / jnp.maximum(norms, tiny)
            eigenvalues = [float(w_blk[i]) - cfg.eigenvalue_offset for i in range(num_out)]
            converged = converged or m_tot >= n
            return eigenvalues, eigvecs, total_steps, converged

        # ---- restart: exact invariant subspace of the band M, df rotation --
        q, theta_blk = _select_invariant_pv(m_host, l_keep, bool(cfg.find_maximum))
        l_new = q.shape[1]
        qy = np.zeros((l_keep, l_keep), np.float64)
        qy[:l_new, :l_cur] = q[:l_cur].T
        qu = np.zeros((l_keep, cap_rows), np.float64)
        qu[:l_new, : kb_done * b] = q[l_cur:].T
        y_df = _df_rotate(
            *_split_rotation_host(qy, dtype), *_split_rotation_host(qu, dtype),
            y_df, (state.u_buf, state.u_lo),
        )
        # A Y_new = Y_new Theta + U_cand (R_last @ Q[last-block rows, :]).
        s_host = r_last @ q[l_cur + (kb_done - 1) * b : l_cur + kb_done * b, :]
        u0 = jax.lax.dynamic_slice_in_dim(state.u_buf, kb_done * b, b, axis=0)
        u0_lo = jax.lax.dynamic_slice_in_dim(state.u_lo, kb_done * b, b, axis=0)
        defl_big = defl_big.at[nd_cap : nd_cap + l_keep].set(y_df[0])
        defl_lo_big = defl_lo_big.at[nd_cap : nd_cap + l_keep].set(y_df[1])
        mask_big = mask_big.at[nd_cap : nd_cap + l_keep].set(
            (jnp.arange(l_keep) < l_new).astype(np.dtype(rdtype))
        )

    raise AssertionError("pv block thick restart exited without extraction")
