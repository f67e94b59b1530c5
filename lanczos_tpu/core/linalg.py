"""Vector-kernel layer (the reference's BLAS-1 layer, re-thought for accelerators).

Reference counterpart: include/lambda_lanczos/util/linear_algebra.hpp —
``inner_prod`` (:29-51, conjugated), ``norm`` (:56-60), ``scalar_mul``/
``normalize`` (:65-80), ``m_norm`` (:82-125), ``schmidt_orth`` (:132-144).

Design decisions:

* Everything is a pure jittable function on jnp arrays.  When the arrays
  carry a ``NamedSharding`` over a device mesh, XLA GSPMD turns each global
  reduction into a local partial reduction + ``psum`` over the mesh;
  under ``shard_map`` the explicit-collective variants in
  :mod:`lanczos_tpu.parallel` are used instead.
* Re-orthogonalization is *not* the reference's sequential modified
  Gram-Schmidt loop (linear_algebra.hpp:132-144, O(k) dependent matvec
  passes).  It is two passes of *classical* Gram-Schmidt expressed as two
  (m, n) x (n,) matmuls (CGS2), which streams the basis and has the same or
  better orthogonality guarantees than one MGS pass.
* Optional double-float precision for the scalar reductions (alpha/beta) via
  :mod:`lanczos_tpu.core.df64` so the f32 fast path keeps ~1e-10-level dot
  products.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from .types import is_complex_dtype
from . import df64

# Every f32 contraction is precision-critical (orthogonality, Ritz vectors,
# alpha/beta): force full f32 — an accelerator's DEFAULT f32 matmul may run
# reduced-precision passes (TF32 on the GPU keeps ~3 decimal digits).  These
# ops are bandwidth-bound, so HIGHEST costs nothing measurable.
_PREC = lax.Precision.HIGHEST

__all__ = [
    "inner_prod",
    "inner_prod_df",
    "inner_prod_df_df",
    "norm",
    "m_norm",
    "normalize",
    "orthogonalize_bcgs_dyn",
    "orthogonalize_bcgs_dyn_coeffs",
    "orthogonalize_cgs2",
    "orthogonalize_cgs2_df",
    "orthogonalize_cgs2_df_coeffs",
    "orthogonalize_cgs2_dfdf_coeffs",
    "orthogonalize_rows",
]


def inner_prod(v, w):
    """Mathematical inner product <v, w> = sum_i conj(v_i) * w_i.

    The conjugation of the first argument mirrors the reference's
    ``util::inner_prod`` (linear_algebra.hpp:29-51), which exists precisely
    because ``std::inner_product`` does not conjugate.
    """
    return jnp.vdot(v, w, precision=_PREC)


def inner_prod_df(v, w):
    """<v, w> with double-float accumulation; returns (hi, lo) pairs.

    For complex inputs returns ((re_hi, re_lo), (im_hi, im_lo)).
    """
    if is_complex_dtype(v.dtype):
        vr, vi = jnp.real(v), jnp.imag(v)
        wr, wi = jnp.real(w), jnp.imag(w)
        # re = vr.wr + vi.wi ; im = vr.wi - vi.wr   (conjugated first arg)
        re = df64.df_add(df64.dot_df(vr, wr), df64.dot_df(vi, wi))
        im = df64.df_add(df64.dot_df(vr, wi), df64.dot_df(-vi, wr))
        return re, im
    return df64.dot_df(v, w)


def inner_prod_df_df(x, y):
    """<x, y> for REAL double-float vectors x=(x_hi,x_lo), y=(y_hi,y_lo).

    The hi*hi products go through the full EFT dot; the hi*lo cross terms are
    2^-24-relative corrections whose own f32 rounding is below the df target,
    so plain f32 dots suffice for them (lo*lo is negligible).
    """
    x_hi, x_lo = x
    y_hi, y_lo = y
    hi, lo = df64.dot_df(x_hi, y_hi)
    cross = jnp.dot(x_hi, y_lo, precision=_PREC) + jnp.dot(x_lo, y_hi, precision=_PREC)
    return df64.df_add((hi, lo), (cross, jnp.zeros_like(cross)))


def norm(v):
    """Euclidean norm; always real (linear_algebra.hpp:56-60)."""
    return jnp.sqrt(jnp.real(inner_prod(v, v)))


def m_norm(v):
    """Manhattan-like norm: sum |re| + |im| for complex, matching BLAS _ASUM
    semantics used by the reference (linear_algebra.hpp:82-125)."""
    if is_complex_dtype(v.dtype):
        return jnp.sum(jnp.abs(jnp.real(v)) + jnp.abs(jnp.imag(v)))
    return jnp.sum(jnp.abs(v))


def normalize(v):
    """Return v / ||v|| (linear_algebra.hpp:77-80)."""
    return v / norm(v)


def _project_coeffs(basis, v, row_mask=None):
    """c_k = <u_k, v> for every row u_k of ``basis`` (masked by ``row_mask``)."""
    b = jnp.conj(basis) if is_complex_dtype(basis.dtype) else basis
    c = jnp.matmul(b, v, precision=_PREC)
    if row_mask is not None:
        c = c * row_mask.astype(c.dtype)
    return c


def orthogonalize_rows(v, basis, row_mask=None):
    """One classical Gram-Schmidt pass of ``v`` against the rows of ``basis``.

    ``basis`` rows must be orthonormal (matching the contract of
    ``schmidt_orth``, linear_algebra.hpp:128-131).  ``row_mask`` (float/bool
    (m,) array) disables unused rows of a fixed-capacity Krylov buffer so the
    whole op stays static-shaped under jit.
    """
    c = _project_coeffs(basis, v, row_mask)
    return v - jnp.matmul(c, basis, precision=_PREC)


def orthogonalize_cgs2(v, basis, row_mask=None, passes: int = 2):
    """Classical Gram-Schmidt with ``passes`` re-passes (default CGS2).

    Replaces the reference's sequential MGS ``schmidt_orth``
    (linear_algebra.hpp:132-144) with batched projections; CGS2 restores
    orthogonality to O(machine eps) (Giraud et al.), and every pass is one
    matmul instead of k dependent AXPYs.  ``passes=1`` halves the cost and
    matches the reference's single-MGS-sweep robustness for a well-behaved
    basis.
    """
    for _ in range(passes):
        v = orthogonalize_rows(v, basis, row_mask)
    return v


def orthogonalize_bcgs_dyn(v, basis, k, passes: int = 2, chunk: int = 64):
    """Gram-Schmidt of ``v`` against rows ``[0, k)`` of a fixed-capacity
    ``basis``, reading only ``ceil(k/chunk)`` row chunks from HBM.

    The static-shape :func:`orthogonalize_cgs2` + ``row_mask`` formulation
    streams EVERY capacity row per pass regardless of how many are live —
    at (256, 4.2M) that is 4.3 GB/pass while on average half the rows are
    masked zeros.  Here a dynamic-trip-count ``fori_loop`` walks chunks of
    ``chunk`` rows (``dynamic_slice`` with a static size), so the traffic
    scales with the live count ``k`` (a traced scalar) instead of the
    capacity.  Within a chunk the projection is classical GS (one
    coefficient reduce + one update matmul); across chunks it is
    sequential — block MGS, whose per-pass orthogonality is at least as
    good as classical GS (Barlow & Smoktunowicz).

    Requires orthonormal live rows (same contract as the reference's
    ``schmidt_orth``, linear_algebra.hpp:128-131).  The final chunk's start
    is clamped (re-projecting already-cleaned rows is a no-op), and rows
    ``>= k`` are masked out of the coefficients.

    On the CPU the chunk loop loses to one big masked matmul (caches hide
    the dead rows), so the CPU backend takes the masked CGS path.
    """
    cap_rows = basis.shape[0]
    if jax.default_backend() == "cpu":
        row_mask = jnp.arange(cap_rows) < jnp.asarray(k, jnp.int32)
        return orthogonalize_cgs2(v, basis, row_mask.astype(jnp.float32), passes=passes)

    chunk = min(int(chunk), cap_rows)
    k = jnp.asarray(k, jnp.int32)
    nchunks = (k + chunk - 1) // chunk
    idx = jnp.arange(chunk)

    def one_pass(v):
        def body(ci, v):
            start = jnp.minimum(ci * chunk, cap_rows - chunk)
            rows = lax.dynamic_slice_in_dim(basis, start, chunk, axis=0)
            rmask = (start + idx) < k
            c = _project_coeffs(rows, v, rmask)
            return v - jnp.matmul(c, rows, precision=_PREC)

        return lax.fori_loop(0, nchunks, body, v)

    for _ in range(passes):
        v = one_pass(v)
    return v


def orthogonalize_bcgs_dyn_coeffs(v, basis, k, passes: int = 2, chunk: int = 64):
    """Like :func:`orthogonalize_bcgs_dyn` but also returns the accumulated
    projection coefficients ``c`` (shape ``(cap,)``, zeros at rows >= k).

    ``c[i]`` sums every chunk's and pass's coefficient against row i.  For an
    orthonormal live basis this equals the classical first-pass coefficient
    ``<u_i, v>`` up to O(eps·|c|) cross terms — the same order as the polish
    pass a CGS2 caller adds in anyway — so it is a drop-in T-column source
    for projected-matrix engines (thick restart maintains T = V^H A V from
    exactly these sums; see solvers/thick_restart.py).
    """
    cap_rows = basis.shape[0]
    if jax.default_backend() == "cpu":
        row_mask = jnp.arange(cap_rows) < jnp.asarray(k, jnp.int32)
        c_tot = jnp.zeros((cap_rows,), v.dtype)
        for _ in range(passes):
            c = _project_coeffs(basis, v, row_mask)
            v = v - jnp.matmul(c, basis, precision=_PREC)
            c_tot = c_tot + c
        return v, c_tot

    chunk = min(int(chunk), cap_rows)
    k = jnp.asarray(k, jnp.int32)
    nchunks = (k + chunk - 1) // chunk
    idx = jnp.arange(chunk)

    def one_pass(carry):
        def body(ci, carry):
            v, c_tot = carry
            start = jnp.minimum(ci * chunk, cap_rows - chunk)
            rows = lax.dynamic_slice_in_dim(basis, start, chunk, axis=0)
            rmask = (start + idx) < k
            c = _project_coeffs(rows, v, rmask)
            v = v - jnp.matmul(c, rows, precision=_PREC)
            prev = lax.dynamic_slice_in_dim(c_tot, start, chunk)
            c_tot = lax.dynamic_update_slice_in_dim(c_tot, prev + c, start, axis=0)
            return v, c_tot

        return lax.fori_loop(0, nchunks, body, carry)

    c_tot = jnp.zeros((cap_rows,), v.dtype)
    carry = (v, c_tot)
    for _ in range(passes):
        carry = one_pass(carry)
    return carry


def orthogonalize_cgs2_df(v_df, basis, row_mask=None, passes: int = 2):
    """CGS2 of a double-float vector against an f32 row basis.

    The projection coefficients come from hi-word matmuls (HIGHEST): a
    coefficient's own f32 rounding is a second-order correction (c ~ 2^-24
    after the recurrence), so only the *application* needs df arithmetic.
    This keeps the reorthogonalization cost identical to the plain engine —
    the precise-vector mode's orthogonality floor is the f32 dot-product
    floor ~sqrt(n)*2^-24, whose eigenvalue impact is quadratic (Paige).
    """
    v_df, _ = orthogonalize_cgs2_df_coeffs(v_df, basis, row_mask, passes)
    return v_df


def orthogonalize_block_cgs2_df_coeffs(w_df, rows_hi, row_mask=None, passes: int = 2):
    """Block CGS of a (b, n) df pair against f32 rows; returns
    ``(w_df, (c_hi, c_lo))`` with the SUMMED (rows, b) coefficients recorded
    error-free (two_sum accumulation — a plain f32 sum of pass coefficients
    rounds at eps*|c1|, measured as a 6.8e-8 relation leak on O(1)
    couplings) and the correction applied as an f32 matmul folded in via
    df_add — valid when |c| is noise-small (the steady-state Krylov case;
    the dfdf variant below covers O(1) first-step couplings).  This is THE
    exact-relation bookkeeping primitive of the precise_vectors engines:
    whatever was subtracted is recorded, so
    ``A u = (recurrence terms) + c @ rows + beta u_next`` holds to df
    precision and the removed couplings re-enter the projected matrix on
    host (lanczos_fused pv / thick_restart pv / block_thick pv)."""
    w_hi, w_lo = w_df
    c_hi = c_lo = None
    for _ in range(passes):
        c = jnp.matmul(rows_hi, w_hi.T, precision=_PREC)  # (rows, b)
        if row_mask is not None:
            c = c * row_mask.astype(c.dtype)[:, None]
        corr = jnp.matmul(c.T, rows_hi, precision=_PREC)
        w_hi, w_lo = df64.df_sub((w_hi, w_lo), (corr, jnp.zeros_like(corr)))
        if c_hi is None:
            c_hi, c_lo = c, jnp.zeros_like(c)
        else:
            c_hi, e = df64.two_sum(c_hi, c)
            c_lo = c_lo + e
    return (w_hi, w_lo), (c_hi, c_lo)


def orthogonalize_block_cgs2_dfdf_coeffs(w_df, rows_df, row_mask=None, passes: int = 2):
    """Block CGS of a (b, n) df pair against DF rows, df-exact.

    The df variant above subtracts ``fl(c @ rows_hi)`` — an f32 matmul whose
    own rounding (~2^-24 * |c|) plus the dropped ``c @ rows_lo`` term
    (~1e-8 * |c|) enter the exact-relation bookkeeping as error.  Negligible
    while |c| ~ f32 noise, but the FIRST step after a thick restart carries
    the O(1) arrowhead coupling against the kept Ritz rows — there the
    subtraction must be df-exact or every restart injects ~1e-8 into the
    carried relation (measured: exactly the ~5e-9/cycle floor that capped
    the pv thick engine at ~1e-11).  One lax.scan over rows with elementwise
    df ops — O(rows * b * n) elementwise work for single gated steps, not hot paths.
    """
    r_hi, r_lo = rows_df
    w_hi, w_lo = w_df
    c_hi = c_lo = None
    for _ in range(passes):
        c = jnp.matmul(r_hi, w_hi.T, precision=_PREC)  # (rows, b)
        if row_mask is not None:
            c = c * row_mask.astype(c.dtype)[:, None]

        def step(acc, inp):
            cj, bh, bl = inp  # cj: (b,) this row's coefficient per vector
            prod = df64.df_mul(
                (cj[:, None], jnp.zeros_like(cj)[:, None]), (bh[None, :], bl[None, :])
            )
            return df64.df_add(acc, prod), None

        init = (jnp.zeros_like(w_hi), jnp.zeros_like(w_hi))
        (ch, cl), _ = lax.scan(step, init, (c, r_hi, r_lo))
        w_hi, w_lo = df64.df_sub((w_hi, w_lo), (ch, cl))
        if c_hi is None:
            c_hi, c_lo = c, jnp.zeros_like(c)
        else:
            c_hi, e = df64.two_sum(c_hi, c)
            c_lo = c_lo + e
    return (w_hi, w_lo), (c_hi, c_lo)


def orthogonalize_cgs2_df_coeffs(v_df, basis, row_mask=None, passes: int = 2):
    """Vector (b=1) form of :func:`orthogonalize_block_cgs2_df_coeffs`;
    returns the single-word summed coefficients (= the two_sum hi word,
    bit-identical to a plain f32 pass sum)."""
    (w_hi, w_lo), (c_hi, _c_lo) = orthogonalize_block_cgs2_df_coeffs(
        (v_df[0][None, :], v_df[1][None, :]), basis, row_mask, passes
    )
    return (w_hi[0], w_lo[0]), c_hi[:, 0]


def orthogonalize_cgs2_dfdf_coeffs(v_df, basis_df, row_mask=None, passes: int = 2):
    """Vector (b=1) form of :func:`orthogonalize_block_cgs2_dfdf_coeffs`;
    returns ((v_hi, v_lo), (c_hi, c_lo))."""
    (w_hi, w_lo), (c_hi, c_lo) = orthogonalize_block_cgs2_dfdf_coeffs(
        (v_df[0][None, :], v_df[1][None, :]), basis_df, row_mask, passes
    )
    return (w_hi[0], w_lo[0]), (c_hi[:, 0], c_lo[:, 0])
