"""Spectral-bound estimators for choosing ``eigenvalue_offset``.

Reference counterpart: the standalone demo
src/determine_eigenvalue_offset/determine_eigenvalue_offset.cpp:12-49, which
computes ``max_i sum_j |a_ij|`` (the infinity-norm Gershgorin bound) as a
suggested ``eigenvalue_offset`` magnitude for the Lanczos shift
(lambda_lanczos.hpp:152-165).  Here it is a library function over any
operator representation, plus a matrix-free stochastic bound for operators
whose entries are not materialized.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.linalg import norm
from ..ops.operators import (
    BSROperator,
    COOOperator,
    CSROperator,
    DenseOperator,
    DIAOperator,
    LinearOperator,
    ScaledOperator,
    SumOperator,
)

__all__ = ["gershgorin_bound", "power_bound", "suggest_eigenvalue_offset"]


class _MatrixFreeError(TypeError):
    """The operator's entries are not materialized — use power_bound()."""


def gershgorin_bound(op) -> float:
    """``max_i sum_j |a_ij|`` — every eigenvalue satisfies |lambda| <= bound.

    Accepts a dense array or any operator whose absolute row sums are
    computable (Dense/COO/CSR/BSR/DIA, plus Sum/Scaled compositions via the
    triangle inequality — the composite bound is still a valid bound).
    Raises for genuinely matrix-free operators.
    """
    if isinstance(op, DenseOperator):
        a = op.a
    elif isinstance(op, COOOperator):
        sums = jax.ops.segment_sum(jnp.abs(op.vals), op.rows, num_segments=op.n)
        return float(jnp.max(sums))
    elif isinstance(op, CSROperator):
        sums = jax.ops.segment_sum(jnp.abs(op.data), op.row_of_nnz, num_segments=op.n)
        return float(jnp.max(sums))
    elif isinstance(op, DIAOperator):
        # |row sums| over the stored diagonals, masking off-matrix entries.
        # Accumulate in f64 only when x64 is enabled (otherwise jax
        # silently truncates a requested f64 to f32 with a warning); a bound must never UNDERestimate, so the f32 path
        # inflates by a few ulps to cover accumulation rounding.
        n = op.n
        acc_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        total = jnp.zeros((n,), acc_dtype)
        for j, d in enumerate(op.offsets):
            row = jnp.abs(op.data[j]).astype(acc_dtype)
            if d > 0:
                row = row.at[n - d :].set(0)
            elif d < 0:
                row = row.at[:-d].set(0)
            total = total + row
        pad = 1.0 + 8.0 * float(jnp.finfo(acc_dtype).eps)
        return float(jnp.max(total)) * pad
    elif isinstance(op, BSROperator):
        # |row sums| of the padded tiles == row sums of A (padding is zero).
        sums = jnp.sum(jnp.abs(op.blocks), axis=(1, 3)).reshape(-1)  # over (S, bk) -> (R*bm,)
        return float(jnp.max(sums[: op.n]))
    elif isinstance(op, SumOperator):
        # Triangle inequality: sum of the parts' bounds is a valid bound.
        return float(sum(gershgorin_bound(t) for t in op.terms))
    elif isinstance(op, ScaledOperator):
        return abs(float(op.scale)) * gershgorin_bound(op.base) + abs(float(op.shift))
    elif isinstance(op, LinearOperator):
        raise _MatrixFreeError("matrix-free operator: use power_bound() instead")
    else:
        a = jnp.asarray(op)
    return float(jnp.max(jnp.sum(jnp.abs(a), axis=1)))


def power_bound(op: LinearOperator, *, iters: int = 30, seed: int = 0, safety: float = 1.1) -> float:
    """Matrix-free bound on the spectral radius via power iteration.

    ``safety * max_k ||A v_k|| / ||v_k||`` converges to ||A||_2 from below;
    the safety factor makes it usable as an offset for well-behaved spectra.
    """
    n = op.n
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal(n), op.dtype)
    v = v / norm(v)
    best = 0.0
    for _ in range(iters):
        w = op.matvec(v)
        nw = float(norm(w))
        best = max(best, nw)
        if nw == 0.0:
            break
        v = w / nw
    return best * safety


def suggest_eigenvalue_offset(op, find_maximum: bool) -> float:
    """Offset that pushes the wanted end of the spectrum to the largest
    magnitude: +bound when maximizing, -bound when minimizing
    (reference README.md guidance for ``eigenvalue_offset``)."""
    try:
        bound = gershgorin_bound(op)
    except _MatrixFreeError:
        # Only genuinely matrix-free operators fall back to the stochastic
        # power bound (a from-below estimate); incidental TypeErrors inside
        # gershgorin_bound propagate instead of silently degrading the bound.
        bound = power_bound(op)
    return bound if find_maximum else -bound
