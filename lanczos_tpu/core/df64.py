"""Double-float ("df64") arithmetic: ~2x-precision reductions in f32 storage.

The fast path stores Krylov vectors in float32.  The reference library reaches
1e-12..1e-14 eigenvalue tolerances in hardware double precision
(reference: include/lambda_lanczos/lambda_lanczos.hpp:150,
test/lambda_lanczos_test.cpp:290).  To close part of that gap while keeping f32
storage on the hot path, the dot products that feed the Lanczos
recurrence (alpha, beta, reorthogonalization coefficients — reference:
include/lambda_lanczos/util/linear_algebra.hpp:29-60) can be evaluated in
error-free-transformation double-float arithmetic: every value is an unevaluated
sum ``hi + lo`` of two f32, giving ~48 bits of effective mantissa.

Classic algorithms (Dekker 1971, Knuth TwoSum), exact as long as each op
rounds to nearest and nothing contracts a multiply and an add into an FMA
(which would break Dekker's split silently).  XLA:CPU does not contract;
on the H100 ``chip_smoke.py`` phase ``df64`` checks exactness on 2^20 pairs
every run.
All functions are elementwise/jit-friendly and work under vmap/shard_map.
"""

from __future__ import annotations


import jax.numpy as jnp

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_sub",
    "df_mul",
    "df_recip",
    "df_sqrt",
    "df_sum",
    "df_sum_axis",
    "dot_df",
    "df_matmul",
    "df_split",
    "df_join",
]

# Splitting constant for Dekker's algorithm in float32: 2^ceil(24/2) + 1.
_SPLIT_F32 = 4097.0
# and for float64: 2^27 + 1 (used when inputs are f64 — quad-ish precision).
_SPLIT_F64 = 134217729.0


def two_sum(a, b):
    """Knuth's error-free addition: returns (s, e) with s + e == a + b exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    c = jnp.asarray(_SPLIT_F32 if a.dtype == jnp.float32 else _SPLIT_F64, a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker's error-free multiplication: (p, e) with p + e == a * b exactly."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x, y):
    """Add two df numbers (hi, lo) + (hi, lo) -> (hi, lo)."""
    x_hi, x_lo = x
    y_hi, y_lo = y
    s, e = two_sum(x_hi, y_hi)
    e = e + x_lo + y_lo
    hi, lo = two_sum(s, e)
    return hi, lo


def df_sub(x, y):
    """(x_hi, x_lo) - (y_hi, y_lo)."""
    return df_add(x, (-y[0], -y[1]))


def df_mul(x, y):
    """Multiply two df numbers elementwise (broadcasting): (hi, lo) * (hi, lo).

    The x_lo*y_lo cross term is below the df precision and dropped (standard
    df multiplication)."""
    x_hi, x_lo = x
    y_hi, y_lo = y
    p, e = two_prod(x_hi, y_hi)
    e = e + (x_hi * y_lo + x_lo * y_hi)
    return two_sum(p, e)


def df_recip(x):
    """Reciprocal of a df number by one Newton step on the f32 seed:
    r ~ 1/x to full df precision for well-scaled x."""
    x_hi, x_lo = x
    r0 = 1.0 / x_hi
    # e = x * r0 - 1, computed in df; correction r = r0 * (1 - e).
    e_hi, e_lo = df_mul((x_hi, x_lo), (r0, jnp.zeros_like(r0)))
    e_hi, e_lo = df_add((e_hi, e_lo), (-jnp.ones_like(e_hi), jnp.zeros_like(e_hi)))
    corr_hi, corr_lo = df_mul((r0, jnp.zeros_like(r0)), (e_hi, e_lo))
    return df_sub((r0, jnp.zeros_like(r0)), (corr_hi, corr_lo))


def df_sqrt(x):
    """Square root of a (non-negative) df number: f32 seed + one Newton-ish
    correction (the correction is second-order small, so an f32 correction
    term recovers full df precision)."""
    x_hi, x_lo = x
    s0 = jnp.sqrt(jnp.maximum(x_hi, 0.0))
    p, pe = two_prod(s0, s0)
    e_hi, _ = df_sub((x_hi, x_lo), (p, pe))
    denom = jnp.maximum(2.0 * s0, jnp.asarray(jnp.finfo(x_hi.dtype).tiny, x_hi.dtype))
    hi, lo = two_sum(s0, e_hi / denom)
    zero = x_hi <= 0
    return jnp.where(zero, 0.0, hi), jnp.where(zero, 0.0, lo)


def df_split(x64):
    """Split a float64 array into an (hi, lo) float32 pair (x ~ hi + lo)."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(x64.dtype)).astype(jnp.float32)
    return hi, lo


def df_join(hi, lo):
    """Combine an (hi, lo) f32 pair into float64 (host-precision readout)."""
    import numpy as np

    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_sum_axis(hi, lo, axis=-1):
    """Reduce df arrays along ``axis`` with a pairwise df tree (log-depth)."""
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, m - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while hi.shape[-1] > 1:
        half = hi.shape[-1] // 2
        hi, lo = df_add((hi[..., :half], lo[..., :half]), (hi[..., half:], lo[..., half:]))
    return hi[..., 0], lo[..., 0]


def df_sum(hi, lo):
    """Reduce elementwise df arrays (hi[i], lo[i]) to a single df scalar.

    Pairwise tree reduction: log2(n) vectorized df_add rounds, so the error
    growth is O(log n) in the *second* word — effectively exact for any
    practical n.  (One reduction implementation: this is df_sum_axis over
    the flattened array.)
    """
    return df_sum_axis(hi.reshape(-1), lo.reshape(-1), axis=0)


def dot_df(x, y):
    """Dot product sum_i x[i]*y[i] in double-float precision.

    Inputs are real arrays (callers split complex into re/im).  Returns the
    (hi, lo) pair; ``hi + lo`` read in f64 on host recovers ~48-bit precision.
    """
    p, e = two_prod(x, y)
    # Each (p_i, e_i) is already a valid df number, so one tree reduce suffices.
    return df_sum(p, e)


def df_matmul(a_df, b_df):
    """(l, m) @ (m, n) matmul where BOTH factors are df pairs; returns the
    (hi, lo) product with every dot accumulated in df arithmetic.

    An f32 matmul cannot do this: its accumulation rounds each partial
    sum to f32 (precision=HIGHEST fixes the products, not the adds), which is
    exactly the error a df-carried Krylov basis must not absorb.  This runs
    as a ``lax.scan`` over the contraction dim, elementwise — one rank-1 df
    update per step — so it is for SMALL m at boundaries (e.g. the thick-
    restart Ritz rotation, m = basis capacity <= ~256), never for hot loops.
    """
    import jax

    a_hi, a_lo = a_df
    b_hi, b_lo = b_df
    l = a_hi.shape[0]
    n = b_hi.shape[1]

    def step(acc, inputs):
        bh, bl, ah, al = inputs  # bh/bl: (n,) row k of b; ah/al: (l,) col k of a
        prod = df_mul((ah[:, None], al[:, None]), (bh[None, :], bl[None, :]))
        return df_add(acc, prod), None

    init = (jnp.zeros((l, n), a_hi.dtype), jnp.zeros((l, n), a_hi.dtype))
    (hi, lo), _ = jax.lax.scan(step, init, (b_hi, b_lo, a_hi.T, a_lo.T))
    return hi, lo
