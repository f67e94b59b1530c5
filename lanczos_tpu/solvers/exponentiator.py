"""Krylov matrix exponentiation: v' = exp(a*A) v
(reference: include/lambda_lanczos/exponentiator.hpp).

The scalar ``a`` may be complex (e.g. ``-i*dt`` for quantum time evolution,
reference README.md:84-89, exponentiator_test.cpp:123-132) even though the
operator is Hermitian; the small-problem arithmetic (tridiagonal eigensolve,
Krylov coefficients) runs on host in full float64/complex128 regardless of
the device vector dtype — only the O(n) work (matvec, recurrence, reorthogonalization, final recombination)
touches the device.

Convergence differs from the eigensolver: the overlap of successive Krylov
coefficient vectors must reach 1 within eps (exponentiator.hpp:147-158),
with a per-iteration k x k tridiagonal eigenpair solve (:124-126).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import linalg
from ..core import tridiagonal
from ..core.types import is_complex_dtype, machine_eps, real_dtype

__all__ = ["ExponentiatorConfig", "krylov_expm_apply", "krylov_expm_apply_grid", "taylor_expm_apply"]


@dataclasses.dataclass
class ExponentiatorConfig:
    """Mirrors the reference's public fields (exponentiator.hpp:41-71)."""

    matrix_size: int
    max_iteration: int | None = None  # defaults to matrix_size (exponentiator.hpp:81)
    eps: float | None = None  # defaults to machine_eps*1e2 (exponentiator.hpp:58)
    full_orthogonalize: bool = False  # (exponentiator.hpp:63)
    # Krylov expm typically converges in ~10-30 iterations; a small initial
    # capacity keeps the (cap, n) buffer copies cheap (4x growth on demand).
    initial_buffer_size: int = 16
    tridiag_backend: str | None = None

    def resolved(self, dtype):
        cfg = dataclasses.replace(self)
        if cfg.max_iteration is None:
            cfg.max_iteration = cfg.matrix_size
        if cfg.eps is None:
            cfg.eps = machine_eps(dtype) * 1e2
        return cfg


@functools.partial(jax.jit, donate_argnums=(1,), static_argnames=("full_orth",))
def _expm_step(op, u_buf, k, beta_prev, full_orth=False):
    """One Krylov step for the exponentiator (exponentiator.hpp:106-122).

    Unlike the eigensolver there is no eigenvalue shift and (by default) no
    reorthogonalization; returns the *unnormalized* residual norm beta_k and
    the buffer with the normalized u_k written at row k.
    """
    dtype = u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))

    u_prev = jax.lax.dynamic_index_in_dim(u_buf, k - 1, axis=0, keepdims=False)
    u_pp = jax.lax.dynamic_index_in_dim(u_buf, jnp.maximum(k - 2, 0), axis=0, keepdims=False)

    au = op.matvec(u_prev)
    alpha = jnp.real(linalg.inner_prod(u_prev, au)).astype(rdtype)
    b = jnp.where(k >= 2, beta_prev.astype(rdtype), jnp.asarray(0, rdtype))
    w = au - alpha * u_prev - b * u_pp

    if full_orth:  # exponentiator.hpp:120-122
        # Live-rows BCGS on accelerators (traffic ∝ k); masked CGS on CPU.
        w = linalg.orthogonalize_bcgs_dyn(w, u_buf, k)

    beta = linalg.norm(w).astype(rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    u_next = w / jnp.maximum(beta, tiny)
    u_buf = jax.lax.dynamic_update_slice_in_dim(u_buf, u_next[None, :], k, axis=0)
    return u_buf, alpha, beta


@functools.partial(jax.jit, static_argnames=())
def _recombine(coeff_pad, u_buf, scale):
    """output = scale * sum_l coeff[l] * u[l] (exponentiator.hpp:163-170)."""
    out = jnp.matmul(
        coeff_pad.astype(u_buf.dtype), u_buf, precision=jax.lax.Precision.HIGHEST
    )
    return out * scale.astype(out.dtype)


def _krylov_coefficients(a, alphas, betas, backend):
    """coeff[i] = sum_j p[j][i] exp(a*ev[j]) p[j][0] on host float64/complex128
    (exponentiator.hpp:124-133)."""
    ev, p = tridiagonal.eigh_tridiagonal_host(np.asarray(alphas), np.asarray(betas), backend=backend)
    weights = np.exp(a * ev) * p[:, 0]  # (m,)
    return p.T @ weights  # (m,)


def krylov_expm_apply(op, a, v, cfg: ExponentiatorConfig):
    """Compute exp(a*A) v in the Krylov basis (reference run,
    exponentiator.hpp:87-173).  Returns (output, iteration_count).

    Implemented as the single-point case of :func:`krylov_expm_apply_grid`
    — the loops are identical (the grid converges on its largest-|a| point,
    which IS ``a`` here, and recombines with the same pre-final-beta
    coefficients), so the subtle ordering invariants (coefficients computed
    BEFORE the beta push, exponentiator.hpp:124-145) live in exactly one
    place."""
    outputs, itern = krylov_expm_apply_grid(op, [a], v, cfg)
    return outputs[0], itern


def krylov_expm_apply_grid(op, a_list, v, cfg: ExponentiatorConfig):
    """exp(a_i*A) v for a GRID of scalars from ONE Krylov build.

    The Krylov basis depends only on (A, v); time enters solely through the
    host-side coefficients exp(a T) e1 (exponentiator.hpp:124-133).  The
    build is converged for the largest |a_i| (the most demanding point), so
    every smaller point is at least as accurate; the grid recombination is
    then one (num, cap) x (cap, n) device matmul — the scipy
    ``expm_multiply(start/stop/num)`` shape at a fraction of num separate
    builds.  Returns (outputs (num, n), iteration_count).
    """
    dtype = np.dtype(v.dtype)
    rdtype = real_dtype(dtype)
    built = _grid_build(op, a_list, v, cfg)
    if built is None:
        return jnp.zeros((len(list(a_list)), cfg.resolved(dtype).matrix_size), dtype), 0
    u_buf, coeff_grid, input_norm, itern, any_imag = built
    out_dtype = dtype
    if any_imag and not is_complex_dtype(dtype):
        out_dtype = np.dtype(np.complex64) if np.dtype(rdtype) == np.float32 else np.dtype(np.complex128)
        u_buf = u_buf.astype(out_dtype)
    outputs = _recombine(jnp.asarray(coeff_grid, out_dtype), u_buf, input_norm)
    return outputs, itern


def krylov_expm_apply_grid_split(op, a_list, v, cfg: ExponentiatorConfig):
    """Grid variant recombined in SPLIT real arithmetic: the coefficient
    grid's real and imaginary parts each multiply the REAL Krylov basis, so
    no complex dtype ever reaches the device.  Real operator/basis only.  Returns
    ((out_re (num, n), out_im (num, n)), iteration_count)."""
    dtype = np.dtype(v.dtype)
    if is_complex_dtype(dtype):
        raise TypeError("split grid expm needs a real storage dtype")
    built = _grid_build(op, a_list, v, cfg)
    n = cfg.resolved(dtype).matrix_size
    if built is None:
        z = jnp.zeros((len(list(a_list)), n), dtype)
        return (z, z), 0
    u_buf, coeff_grid, input_norm, itern, _any_imag = built
    cr = jnp.asarray(np.real(coeff_grid), dtype)
    ci = jnp.asarray(np.imag(coeff_grid), dtype)
    out_re = _recombine(cr, u_buf, input_norm)
    out_im = _recombine(ci, u_buf, input_norm)
    return (out_re, out_im), itern


def _grid_build(op, a_list, v, cfg: ExponentiatorConfig):
    """Shared Krylov build + host coefficient grid for the grid paths.

    Returns ``(u_buf, coeff_grid (host complex/real), input_norm, itern,
    any_imag)`` or ``None`` for a zero input (exp(a*A) @ 0 = 0)."""
    dtype = np.dtype(v.dtype)
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    n = cfg.matrix_size
    max_iter = min(cfg.max_iteration, max(n, 1))
    if max_iter < 1:
        raise ValueError(f"max_iteration must be >= 1, got {cfg.max_iteration}")
    a_list = [complex(a) for a in a_list]
    if not a_list:
        raise ValueError("a_list must contain at least one scalar")
    any_imag = any(a.imag != 0 for a in a_list) or is_complex_dtype(dtype)
    a_host = [a if any_imag else a.real for a in a_list]
    a_check = a_host[int(np.argmax([abs(a) for a in a_list]))]

    input_norm = linalg.norm(v)
    if float(jax.device_get(input_norm)) == 0.0:
        # dividing by the zero norm would launch a NaN build; same guard as
        # the fused/batch paths
        return None
    cap = min(max(cfg.initial_buffer_size, 2), max_iter + 1)
    u_buf = jnp.zeros((cap, n), dtype)
    u_buf = u_buf.at[0].set(v / input_norm)

    alphas: list[float] = []
    betas: list[float] = []
    coeff_prev: np.ndarray | None = None
    beta_threshold = machine_eps(rdtype)

    itern = max_iter
    beta_prev = jnp.asarray(0, np.dtype(rdtype))
    for k in range(1, max_iter + 1):
        if k >= u_buf.shape[0]:
            pad = min(2 * u_buf.shape[0], max_iter + 1) - u_buf.shape[0]
            u_buf = jnp.concatenate([u_buf, jnp.zeros((pad, n), dtype)], axis=0)
        u_buf, alpha_k, beta_k = _expm_step(op, u_buf, k, beta_prev, full_orth=cfg.full_orthogonalize)
        alphas.append(float(jax.device_get(alpha_k)))
        beta_prev = beta_k
        coeff = _krylov_coefficients(a_check, alphas, betas, cfg.tridiag_backend)
        betas.append(float(jax.device_get(beta_k)))
        overlap = 0.0
        if coeff_prev is not None:
            overlap = np.vdot(coeff_prev, coeff[: coeff_prev.shape[0]])
        coeff_prev = coeff
        if abs(1.0 - abs(overlap)) < cfg.eps or betas[-1] < beta_threshold:
            itern = k
            break

    m = len(alphas)
    host_c = np.complex128 if any_imag else np.float64
    coeff_grid = np.zeros((len(a_host), u_buf.shape[0]), dtype=host_c)
    for i, a in enumerate(a_host):
        coeff_grid[i, :m] = _krylov_coefficients(a, alphas, betas[:-1], cfg.tridiag_backend)
    return u_buf, coeff_grid, input_norm, itern, any_imag


@jax.jit
def _scaled_matvec_jit(op, x, s):
    """Jitted ``(A x) * s`` with op a pytree argument and s a traced scalar
    (one compile covers every term of the Taylor loop)."""
    return op.matvec(x) * s


def taylor_expm_apply(op, a, v, cfg: ExponentiatorConfig):
    """Taylor-series exp(a*A) v with backward (small-to-large) summation for
    stability (reference taylor_run, exponentiator.hpp:175-210).
    Returns (output, term_count).

    Deliberate departure from the reference: the stored terms are the
    *scaled* ones, ``t_k = (|a|^k / k!) A^k v`` (built incrementally as
    ``t_k = (|a|/k) A t_{k-1}``), with the unit phase ``(a/|a|)^k`` kept on
    host.  The reference stores raw ``A^k v`` (exponentiator.hpp:189-191),
    whose norm grows like ``||A||^k`` — in f32 that overflows to inf around
    k~64 for ||A||~4, and since ``inf * factor`` never drops below eps its
    unbounded loop (``for(;;)``, :188) would spin forever on an f32
    storage dtype.  Scaled terms decay once ``k > |a| ||A||``, so termination is
    guaranteed for every finite input, the convergence quantity
    ``norm(t_k)`` equals the reference's ``norm(A^k v) * |a^k/k!|`` exactly,
    and intermediate overflow happens only when exp(|a| ||A||) itself
    overflows the storage dtype (surfaced as OverflowError, not a hang).
    """
    dtype = np.dtype(v.dtype)
    a = complex(a)
    if a == 0:  # zero-a short circuit (:179-182)
        return v, 1
    terms, phase = _taylor_terms(op, a, v, cfg)
    rdtype = np.dtype(real_dtype(dtype))

    out_dtype = dtype
    if a.imag != 0 and not is_complex_dtype(dtype):
        out_dtype = np.dtype(np.complex64) if rdtype == np.float32 else np.dtype(np.complex128)

    output = jnp.zeros(v.shape, out_dtype)
    for kk in range(len(terms) - 1, -1, -1):
        ph = phase**kk  # recomputed per term: no accumulated phase drift
        f = ph if np.dtype(out_dtype).kind == "c" else ph.real
        output = output + terms[kk].astype(out_dtype) * f
    return output, len(terms)


def taylor_expm_apply_split(op, a, v, cfg: ExponentiatorConfig):
    """Taylor exp(a*A) v with SPLIT-COMPLEX accumulation: the real scaled
    terms are summed (backward) into separate re/im accumulators with the
    real/imaginary parts of the unit phases, so no complex dtype ever
    reaches the device.  Real operator/storage only; returns
    ((out_re, out_im), term_count)."""
    dtype = np.dtype(v.dtype)
    if is_complex_dtype(dtype):
        raise TypeError("split taylor expm needs a real storage dtype")
    a = complex(a)
    if a == 0:
        return (v, jnp.zeros_like(v)), 1
    terms, phase = _taylor_terms(op, a, v, cfg)
    out_re = jnp.zeros(v.shape, dtype)
    out_im = jnp.zeros(v.shape, dtype)
    for kk in range(len(terms) - 1, -1, -1):
        ph = phase**kk
        out_re = out_re + terms[kk] * ph.real
        out_im = out_im + terms[kk] * ph.imag
    return (out_re, out_im), len(terms)


def _taylor_terms(op, a, v, cfg: ExponentiatorConfig):
    """The scaled-term build shared by the dense and split Taylor paths:
    returns ``(terms, phase)`` with ``terms[k] = (|a|^k / k!) A^k v`` (real
    when v is real) and ``phase = a/|a|``."""
    dtype = np.dtype(v.dtype)
    cfg = cfg.resolved(dtype)
    a = complex(a)
    mag = abs(a)
    phase = a / mag  # unit complex; exactly +-1 for real a
    rdtype = np.dtype(real_dtype(dtype))

    terms = [v]
    k = 1
    while True:
        # op is a jit ARGUMENT (a closure would bake its arrays into the
        # HLO — oversized remote-compile payloads — and defeat the jit cache).
        t = _scaled_matvec_jit(op, terms[-1], jnp.asarray(mag / k, rdtype))
        terms.append(t)
        tn = float(linalg.norm(t))
        if not np.isfinite(tn):
            raise OverflowError(
                f"taylor_expm_apply: term {k} overflowed {dtype} storage. "
                f"The peak intermediate term grows like exp(|a|*||A||) even "
                f"when the final result is small (e.g. large negative a on a "
                f"PSD operator), and a non-finite input surfaces here too — "
                f"use a smaller time step, f64 storage, or prefer the Krylov "
                f"exponentiator, which never forms the raw series terms."
            )
        if tn < cfg.eps:
            break
        k += 1
    return terms, phase
