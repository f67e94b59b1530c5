"""Matrix-free MINRES — the inner solver behind shift-invert eigsh.

The reference library has no linear-solver layer (its eigsh analogue steers
convergence with ``eigenvalue_offset`` only, lambda_lanczos.hpp:160-165).
scipy's ``eigsh(sigma=...)`` however is a headline capability of the facade's
target API: eigenvalues nearest an interior ``sigma`` via Lanczos on
``(A - sigma I)^{-1}``.  A matrix-free operator cannot be factorized, so the
inverse is applied ITERATIVELY — and because ``A - sigma I`` is indefinite
for interior shifts, the right Krylov solver is MINRES (Paige & Saunders
1975), not CG.

Design: one ``lax.while_loop`` carrying the two live Lanczos
vectors, two direction vectors, and the Givens-rotation scalars — static
shapes, no host syncs, jittable end-to-end (it nests inside the outer
eigensolver's own device loops).  Each iteration is one matvec + a handful
of AXPYs: the memory profile is O(n), independent of iteration count —
exactly what an inner solver that runs hundreds of times must look like.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import is_complex_dtype, machine_eps, real_dtype

__all__ = ["minres"]


def _dot_exact(v, w):
    """<v, w> as an elementwise multiply-reduce: an accelerator's default
    f32 dot may run reduced-precision passes (TF32 on the GPU), while an
    elementwise product + sum is exact f32.  The MINRES alpha/beta feed the
    Givens recurrence directly, so they must not lose mantissa bits."""
    vc = jnp.conj(v) if is_complex_dtype(v.dtype) else v
    return jnp.sum(vc * w)


def _norm_exact(v):
    return jnp.sqrt(jnp.real(_dot_exact(v, v)))


class _MinresState(NamedTuple):
    x: jax.Array  # current solution
    v_cur: jax.Array  # Lanczos vector v_k
    v_prev: jax.Array  # v_{k-1}
    d_prev: jax.Array  # direction d_{k-1}
    d_prev2: jax.Array  # d_{k-2}
    beta: jax.Array  # beta_k (current off-diagonal)
    dbar: jax.Array  # rotated subdiagonal carry
    epsln: jax.Array  # two-step rotation carry
    phibar: jax.Array  # residual-norm estimate
    cs: jax.Array  # previous Givens cosine
    sn: jax.Array  # previous Givens sine
    k: jax.Array  # iteration counter
    done: jax.Array


@functools.partial(jax.jit, static_argnames=("maxiter",))
def minres(op, b, *, shift=0.0, tol=1e-8, maxiter: int = 200, x0=None):
    """Solve ``(A - shift I) x = b`` for symmetric/Hermitian ``A`` (MINRES).

    Returns ``(x, relres, iters)``: the solution, the final relative
    residual estimate ``||r|| / ||b||``, and the iteration count.  ``shift``
    and ``tol`` are dynamic operands (one compiled program serves every
    sigma); ``maxiter`` bounds the loop statically.  Works for indefinite
    systems — the use case is interior shift-invert, where CG would break.
    """
    dtype = b.dtype
    rdtype = np.dtype(real_dtype(dtype))
    shift = jnp.asarray(shift, rdtype)
    tol = jnp.asarray(tol, rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    eps_m = jnp.asarray(machine_eps(rdtype), rdtype)

    def amv(v):
        return op.matvec(v) - shift.astype(rdtype) * v

    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - amv(x0)
    beta1 = _norm_exact(r0).astype(rdtype)
    bnorm = jnp.maximum(_norm_exact(b).astype(rdtype), tiny)
    v1 = r0 / jnp.maximum(beta1, tiny)

    zero = jnp.zeros((), rdtype)
    one = jnp.ones((), rdtype)
    state = _MinresState(
        x=x0,
        v_cur=v1,
        v_prev=jnp.zeros_like(b),
        d_prev=jnp.zeros_like(b),
        d_prev2=jnp.zeros_like(b),
        beta=beta1,
        dbar=zero,
        epsln=zero,
        phibar=beta1,
        cs=-one,  # Paige-Saunders init: cs=-1, sn=0
        sn=zero,
        k=jnp.asarray(0, jnp.int32),
        done=beta1 <= tol * bnorm,
    )

    def cond(st: _MinresState):
        return (st.k < maxiter) & (~st.done)

    def body(st: _MinresState) -> _MinresState:
        # --- Lanczos step: beta_{k+1} v_{k+1} = A v_k - alpha v_k - beta_k v_{k-1}
        w = amv(st.v_cur)
        alpha = jnp.real(_dot_exact(st.v_cur, w)).astype(rdtype)
        w = w - alpha.astype(rdtype) * st.v_cur - st.beta.astype(rdtype) * st.v_prev
        beta_next = _norm_exact(w).astype(rdtype)
        v_next = w / jnp.maximum(beta_next, tiny)

        # --- previous rotation applied to the new tridiagonal column
        oldeps = st.epsln
        delta = st.cs * st.dbar + st.sn * alpha
        gbar = st.sn * st.dbar - st.cs * alpha
        epsln = st.sn * beta_next
        dbar = -st.cs * beta_next

        # --- current rotation annihilating beta_{k+1}
        gamma = jnp.sqrt(gbar * gbar + beta_next * beta_next)
        gamma = jnp.maximum(gamma, eps_m)
        cs = gbar / gamma
        sn = beta_next / gamma
        phi = cs * st.phibar
        phibar = sn * st.phibar

        # --- direction and solution update
        d = (st.v_cur - oldeps.astype(rdtype) * st.d_prev2 - delta.astype(rdtype) * st.d_prev) / gamma.astype(rdtype)
        x = st.x + phi.astype(rdtype) * d

        done = jnp.abs(phibar) <= tol * bnorm
        # beta breakdown: b (or the residual) lay in an invariant subspace —
        # the solve is exact within it.
        done = done | (beta_next < eps_m * 10.0)
        return _MinresState(
            x, v_next, st.v_cur, d, st.d_prev, beta_next, dbar, epsln,
            phibar, cs, sn, st.k + 1, done,
        )

    out = jax.lax.while_loop(cond, body, state)
    return out.x, jnp.abs(out.phibar) / bnorm, out.k
