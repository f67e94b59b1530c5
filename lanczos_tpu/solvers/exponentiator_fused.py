"""Fused (device-resident) Krylov exponentiator.

The hybrid engine (exponentiator.py) mirrors the reference loop exactly —
including a host tridiagonal *eigenpair* solve every iteration
(reference: include/lambda_lanczos/exponentiator.hpp:124-126) — which costs a
device->host sync per matvec.  Redesign: the Krylov build runs as
one ``lax.while_loop`` (matvec + three-term recurrence + optional CGS2
reorthogonalization + breakdown exit), and the per-iteration convergence
decision is **replayed on host afterwards**: from the stored alpha/beta the
host recomputes the Krylov coefficient vector for every prefix k and applies
the reference's successive-overlap criterion (:147-158) to find the same
iteration count the reference would have stopped at.  If no prefix converged,
the build *resumes on device* with doubled capacity (the loop state is
carried over, no matvec is repeated).

Cost model: the device never waits on the host inside the loop; the host
replay is O(m^2)-per-prefix on an m ~ tens problem (microseconds); resumes
retrace only O(log m_max) times.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import linalg
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from .exponentiator import ExponentiatorConfig, _krylov_coefficients, _recombine

__all__ = [
    "krylov_expm_apply_fused", "krylov_expm_apply_batch",
    "krylov_expm_apply_split", "evolve_split", "evolve_hermitian_split",
]


class _BuildState(NamedTuple):
    u_buf: jax.Array  # (cap+1, n)
    alpha: jax.Array  # (cap,)
    beta: jax.Array  # (cap,)
    k: jax.Array  # next 1-based iteration index
    breakdown: jax.Array  # bool


@functools.partial(jax.jit, static_argnames=("m_target", "full_orth"))
def _build(op, state: _BuildState, m_target: int, full_orth: bool):
    """Advance the Krylov build to ``m_target`` iterations (or breakdown)."""
    dtype = state.u_buf.dtype
    rdtype = np.dtype(real_dtype(dtype))
    cap = state.alpha.shape[0]
    beta_threshold = jnp.asarray(machine_eps(rdtype), rdtype)  # exponentiator.hpp:154
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)

    def cond(st: _BuildState):
        return (st.k <= m_target) & (~st.breakdown)

    def body(st: _BuildState) -> _BuildState:
        k = st.k
        u_prev = jax.lax.dynamic_index_in_dim(st.u_buf, k - 1, axis=0, keepdims=False)
        u_pp = jax.lax.dynamic_index_in_dim(st.u_buf, jnp.maximum(k - 2, 0), axis=0, keepdims=False)

        au = op.matvec(u_prev)
        alpha_k = jnp.real(linalg.inner_prod(u_prev, au)).astype(rdtype)
        beta_prev = jax.lax.dynamic_index_in_dim(st.beta, jnp.maximum(k - 2, 0), keepdims=False)
        b = jnp.where(k >= 2, beta_prev, jnp.asarray(0, rdtype))
        w = au - alpha_k * u_prev - b * u_pp

        if full_orth:  # exponentiator.hpp:120-122
            # Chunked live-rows BCGS: traffic scales with k, not capacity
            # (see linalg.orthogonalize_bcgs_dyn).
            w = linalg.orthogonalize_bcgs_dyn(w, st.u_buf, k)

        beta_k = linalg.norm(w).astype(rdtype)
        u_buf = jax.lax.dynamic_update_slice_in_dim(
            st.u_buf, (w / jnp.maximum(beta_k, tiny))[None], k, axis=0
        )
        alpha = jax.lax.dynamic_update_slice_in_dim(st.alpha, alpha_k[None], k - 1, axis=0)
        beta = jax.lax.dynamic_update_slice_in_dim(st.beta, beta_k[None], k - 1, axis=0)
        return _BuildState(u_buf, alpha, beta, k + 1, beta_k < beta_threshold)

    return jax.lax.while_loop(cond, body, state)


def _grow_state(state: _BuildState, new_cap: int) -> _BuildState:
    n = state.u_buf.shape[1]
    pad_rows = new_cap + 1 - state.u_buf.shape[0]
    pad_s = new_cap - state.alpha.shape[0]
    return _BuildState(
        jnp.concatenate([state.u_buf, jnp.zeros((pad_rows, n), state.u_buf.dtype)]),
        jnp.concatenate([state.alpha, jnp.zeros((pad_s,), state.alpha.dtype)]),
        jnp.concatenate([state.beta, jnp.zeros((pad_s,), state.beta.dtype)]),
        state.k,
        state.breakdown,
    )


def _replay_convergence(a_host, alphas, betas, eps, backend, beta_eps=None, start_state=None):
    """Host replay of the reference's per-iteration overlap test
    (exponentiator.hpp:128-158) over all prefixes; returns (k*, coeff at k*)
    or (None, last coeff).

    ``beta_eps`` must be the breakdown threshold of the *storage* dtype the
    device loop used (exponentiator.hpp:154 semantics) — with f32 storage a
    device-side breakdown at ~1e-7 would otherwise be invisible to an
    f64-eps replay and the grow/retry driver would spin forever.

    ``start_state`` = (next_k, coeff_prev) from a previous call resumes the
    replay incrementally across capacity-growth rounds (each prefix solve is
    O(k^2); restarting from 1 every round would make it O(m^3) per round).
    """
    if beta_eps is None:
        beta_eps = machine_eps(np.float64)
    coeff_prev = start_state[1] if start_state is not None else None
    start_k = start_state[0] if start_state is not None else 1
    for k in range(start_k, len(alphas) + 1):
        coeff = _krylov_coefficients(a_host, alphas[:k], betas[: k - 1], backend)
        if coeff_prev is not None:
            overlap = np.vdot(coeff_prev, coeff[: coeff_prev.shape[0]])
            if abs(1.0 - abs(overlap)) < eps:
                return k, coeff
        # Reference also exits on beta breakdown *after* computing coeff
        # (:154-158); betas[k-1] is the beta pushed this iteration.
        if k <= len(betas) and betas[k - 1] < beta_eps:
            return k, coeff
        coeff_prev = coeff
    return None, coeff_prev


def krylov_expm_apply_fused(op, a, v, cfg: ExponentiatorConfig):
    """exp(a*A) v with the device-resident build; returns (output, itern)."""
    dtype = np.dtype(v.dtype)
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    n = cfg.matrix_size
    max_iter = min(cfg.max_iteration, max(n, 1))
    a = complex(a)
    a_host = a if (a.imag != 0 or is_complex_dtype(dtype)) else a.real

    input_norm = linalg.norm(v)
    if float(jax.device_get(input_norm)) == 0.0:
        # exp(a*A) @ 0 = 0; dividing by the zero norm would launch a NaN
        # build (the batch path guards this identically, see
        # krylov_expm_apply_batch's trivial-row mask).
        return jnp.zeros_like(v), 0
    cap = min(max(cfg.initial_buffer_size, 8), max_iter)
    u0 = jnp.zeros((cap + 1, n), dtype).at[0].set(v / input_norm)
    state = _BuildState(
        u0,
        jnp.zeros((cap,), np.dtype(rdtype)),
        jnp.zeros((cap,), np.dtype(rdtype)),
        jnp.asarray(1, jnp.int32),
        jnp.asarray(False),
    )

    beta_eps = machine_eps(rdtype)  # storage-dtype threshold (device loop uses it)
    replay_state = None
    while True:
        m_target = state.alpha.shape[0]
        state = _build(op, state, m_target, bool(cfg.full_orthogonalize))
        # ONE batched device_get: each separate get is a full device round
        # trip — same convention as lanczos_fused/thick_restart.
        _k, _bd, _a, _b = jax.device_get((state.k, state.breakdown, state.alpha, state.beta))
        m_done = int(_k) - 1
        broke_down = bool(_bd)
        alphas = np.asarray(_a, np.float64)[:m_done]
        betas = np.asarray(_b, np.float64)[:m_done]

        kstar, coeff = _replay_convergence(
            a_host, alphas, betas, cfg.eps, cfg.tridiag_backend, beta_eps, start_state=replay_state
        )
        if kstar is not None or m_done >= max_iter or broke_down:
            itern = kstar if kstar is not None else m_done
            break
        replay_state = (m_done + 1, coeff)
        state = _grow_state(state, min(4 * m_target, max_iter))  # 4x: fewer retraces

    coeff_pad = np.zeros(state.u_buf.shape[0], dtype=np.complex128 if np.iscomplexobj(coeff) else np.float64)
    coeff_pad[: coeff.shape[0]] = coeff

    out_dtype = dtype
    u_buf = state.u_buf
    if np.iscomplexobj(coeff) and not is_complex_dtype(dtype):
        out_dtype = np.dtype(np.complex64) if np.dtype(rdtype) == np.float32 else np.dtype(np.complex128)
        u_buf = u_buf.astype(out_dtype)
    output = _recombine(jnp.asarray(coeff_pad, out_dtype), u_buf, input_norm)
    return output, itern



def _batched_builds(op, v_normed, trivial, cfg, a_host):
    """Shared driver for the vmapped batch builds: grow/replay loop over B
    normalized start vectors.  ``trivial[i]`` marks rows whose input was
    (numerically) zero — they are done immediately with a unit coefficient.
    Returns (final state, [(iters_i, coeff_i)])."""
    dtype = np.dtype(v_normed.dtype)
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    bsz = v_normed.shape[0]
    max_iter = min(cfg.max_iteration, max(n, 1))
    cap = min(max(cfg.initial_buffer_size, 8), max_iter)

    def init_one(v):
        return _BuildState(
            jnp.zeros((cap + 1, n), dtype).at[0].set(v),
            jnp.zeros((cap,), np.dtype(rdtype)),
            jnp.zeros((cap,), np.dtype(rdtype)),
            jnp.asarray(1, jnp.int32),
            jnp.asarray(False),
        )

    state = jax.vmap(init_one)(v_normed)
    build = jax.vmap(_build, in_axes=(None, 0, None, None))

    beta_eps = machine_eps(rdtype)
    done_results = [
        (1, np.ones(1, np.float64)) if trivial[i] else None for i in range(bsz)
    ]
    replay_states = [None] * bsz
    while True:
        m_target = state.alpha.shape[1]
        state = build(op, state, m_target, bool(cfg.full_orthogonalize))
        # ONE batched device_get (each separate get is a device round trip).
        _k, _bd, _a, _b = jax.device_get((state.k, state.breakdown, state.alpha, state.beta))
        ks = np.asarray(_k) - 1
        broke = np.asarray(_bd)
        alphas = np.asarray(_a, np.float64)
        betas = np.asarray(_b, np.float64)

        results = []
        all_done = True
        for i in range(bsz):
            if done_results[i] is not None:  # converged in an earlier round
                results.append(done_results[i])
                continue
            m_done = int(ks[i])
            kstar, coeff = _replay_convergence(
                a_host, alphas[i, :m_done], betas[i, :m_done], cfg.eps, cfg.tridiag_backend,
                beta_eps, start_state=replay_states[i],
            )
            if kstar is not None or m_done >= max_iter or bool(broke[i]):
                done_results[i] = (kstar if kstar is not None else m_done, coeff)
                results.append(done_results[i])
            else:
                all_done = False
                replay_states[i] = (m_done + 1, coeff)
                results.append((m_done, coeff))
        if all_done or m_target >= max_iter:
            break
        state = jax.vmap(lambda s: _grow_state(s, min(4 * m_target, max_iter)))(state)
    return state, results


def krylov_expm_apply_batch(op, a, v_batch, cfg: ExponentiatorConfig):
    """exp(a*A) applied to a whole batch of states at once.

    An extension (no reference counterpart): the B independent Krylov
    builds run as ONE vmapped device program — every matvec becomes a
    batched (B, n) op and the reorthogonalization/inner products become
    matmuls, so B states cost far less than B sequential runs.  Each state's
    convergence is replayed on host from its own alpha/beta (identical
    iteration counts to running it alone); if any state needs a deeper
    Krylov space the whole batch resumes device-side with doubled capacity
    (converged states just replay from their stored prefix — no wasted
    matvec results are discarded).

    Returns (out_batch (B, n[, complex]), iterations (B,) int).
    """
    dtype = np.dtype(v_batch.dtype)
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    bsz = v_batch.shape[0]
    a = complex(a)
    a_host = a if (a.imag != 0 or is_complex_dtype(dtype)) else a.real

    input_norms = jnp.sqrt(jnp.sum(jnp.abs(v_batch) ** 2, axis=1))
    tiny = np.finfo(np.dtype(rdtype)).tiny
    v_normed = v_batch / jnp.maximum(input_norms[:, None], tiny)
    trivial = [bool(x < tiny * 10) for x in np.asarray(jax.device_get(input_norms))]

    state, results = _batched_builds(op, v_normed, trivial, cfg, a_host)

    host_c = np.complex128 if any(np.iscomplexobj(c) for _, c in results) else np.float64
    coeff_pad = np.zeros((bsz, state.u_buf.shape[1]), dtype=host_c)
    iters = np.zeros((bsz,), np.int64)
    for i, (it, coeff) in enumerate(results):
        coeff_pad[i, : coeff.shape[0]] = coeff
        iters[i] = it

    out_dtype = dtype
    u_bufs = state.u_buf
    if host_c == np.complex128 and not is_complex_dtype(dtype):
        out_dtype = np.dtype(np.complex64) if np.dtype(rdtype) == np.float32 else np.dtype(np.complex128)
        u_bufs = u_bufs.astype(out_dtype)
    out = jnp.einsum(
        "bm,bmn->bn", jnp.asarray(coeff_pad, out_dtype), u_bufs,
        precision=jax.lax.Precision.HIGHEST,
    )
    out = out * input_norms[:, None].astype(out_dtype)
    return out, iters


def krylov_expm_apply_batch_split(op, a, v_batch, cfg: ExponentiatorConfig):
    """Batch variant recombined in SPLIT real arithmetic: the complex host
    coefficients' real and imaginary parts each einsum against the REAL
    Krylov bases, so no complex dtype ever reaches the device.  Real
    operator/batch only.  Returns
    ((out_re (B, n), out_im (B, n)), iterations (B,))."""
    dtype = np.dtype(v_batch.dtype)
    if is_complex_dtype(dtype):
        raise TypeError("split batch expm needs a real storage dtype")
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    bsz = v_batch.shape[0]
    a = complex(a)

    input_norms = jnp.sqrt(jnp.sum(v_batch * v_batch, axis=1))
    tiny = np.finfo(np.dtype(rdtype)).tiny
    v_normed = v_batch / jnp.maximum(input_norms[:, None], tiny)
    trivial = [bool(x < tiny * 10) for x in np.asarray(jax.device_get(input_norms))]

    state, results = _batched_builds(op, v_normed, trivial, cfg, a)

    cap_now = state.u_buf.shape[1]
    cr = np.zeros((bsz, cap_now), dtype=np.dtype(rdtype))
    ci = np.zeros((bsz, cap_now), dtype=np.dtype(rdtype))
    iters = np.zeros((bsz,), np.int64)
    for i, (it, coeff) in enumerate(results):
        c = np.asarray(coeff, np.complex128)
        cr[i, : c.shape[0]] = c.real
        ci[i, : c.shape[0]] = c.imag
        iters[i] = it

    prec = jax.lax.Precision.HIGHEST
    out_re = jnp.einsum("bm,bmn->bn", jnp.asarray(cr), state.u_buf, precision=prec)
    out_im = jnp.einsum("bm,bmn->bn", jnp.asarray(ci), state.u_buf, precision=prec)
    out_re = out_re * input_norms[:, None]
    out_im = out_im * input_norms[:, None]
    return (out_re, out_im), iters


def krylov_expm_apply_split(op, a, v_re, v_im, cfg: ExponentiatorConfig):
    """exp(a*A) (v_re + i v_im) for a REAL symmetric operator, with all
    device work in real arithmetic (split complex).

    The Krylov basis built from a real start vector under a real operator is
    itself real, so each part gets its own real (f32-friendly) build — a
    2-row call into the shared batched driver — and only the (m,)
    coefficient vectors ``exp(a T) e1`` are complex, on host.  With U_r/U_i
    the real bases and c_r/c_i the complex coefficients:

        out_re = Re(c_r) @ U_r - Im(c_i) @ U_i
        out_im = Im(c_r) @ U_r + Re(c_i) @ U_i

    Returns ((out_re, out_im), (iters_re, iters_im)).
    """
    dtype = np.dtype(v_re.dtype)
    if is_complex_dtype(dtype):
        raise TypeError("split expm takes the real and imaginary parts as separate real arrays")
    rdtype = real_dtype(dtype)
    cfg = cfg.resolved(dtype)
    a = complex(a)

    batch = jnp.stack([jnp.asarray(v_re, dtype), jnp.asarray(v_im, dtype)])
    input_norms = jnp.sqrt(jnp.sum(batch * batch, axis=1))
    tiny = np.finfo(np.dtype(rdtype)).tiny
    v_normed = batch / jnp.maximum(input_norms[:, None], tiny)
    trivial = [bool(x < tiny * 10) for x in np.asarray(jax.device_get(input_norms))]

    state, results = _batched_builds(op, v_normed, trivial, cfg, a)

    cap_now = state.u_buf.shape[1]
    cpads = np.zeros((2, 2, cap_now), dtype=np.dtype(rdtype))  # [part][re/im]
    for i, (_it, coeff) in enumerate(results):
        c = np.asarray(coeff, np.complex128)
        cpads[i, 0, : c.shape[0]] = c.real
        cpads[i, 1, : c.shape[0]] = c.imag

    out_re, out_im = _split_recombine(state.u_buf, jnp.asarray(cpads, dtype), input_norms)
    return (out_re, out_im), (int(results[0][0]), int(results[1][0]))


@jax.jit
def _split_recombine(u_bufs, cpads_dev, norms):
    prec = jax.lax.Precision.HIGHEST
    er = jnp.matmul(cpads_dev[0, 0], u_bufs[0], precision=prec) * norms[0]
    ei = jnp.matmul(cpads_dev[0, 1], u_bufs[0], precision=prec) * norms[0]
    fr = jnp.matmul(cpads_dev[1, 0], u_bufs[1], precision=prec) * norms[1]
    fi = jnp.matmul(cpads_dev[1, 1], u_bufs[1], precision=prec) * norms[1]
    return er - fi, ei + fr


# ---------------------------------------------------------------------------
# Fully device-resident multi-step evolution (fixed Krylov dimension)
# ---------------------------------------------------------------------------


def _krylov_build_fixed(op, v, m: int, full_orth: bool):
    """m-step real Lanczos from (unnormalized) v: returns (U (m, n), alpha,
    beta, norm0).  Fixed size, no convergence logic — fully jit-friendly."""
    rdtype = np.dtype(real_dtype(v.dtype))
    n = v.shape[0]
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    norm0 = linalg.norm(v)
    u0 = v / jnp.maximum(norm0, tiny)

    u_buf = jnp.zeros((m + 1, n), v.dtype).at[0].set(u0)
    alpha = jnp.zeros((m,), rdtype)
    beta = jnp.zeros((m,), rdtype)

    def body(k, carry):
        u_buf, alpha, beta = carry
        u_prev = jax.lax.dynamic_index_in_dim(u_buf, k, axis=0, keepdims=False)
        u_pp = jax.lax.dynamic_index_in_dim(u_buf, jnp.maximum(k - 1, 0), axis=0, keepdims=False)
        au = op.matvec(u_prev)
        a_k = jnp.real(linalg.inner_prod(u_prev, au)).astype(rdtype)
        b_prev = jax.lax.dynamic_index_in_dim(beta, jnp.maximum(k - 1, 0), keepdims=False)
        b = jnp.where(k >= 1, b_prev, jnp.asarray(0, rdtype))
        w = au - a_k * u_prev - b * u_pp
        if full_orth:
            # Live-rows BCGS on accelerators (traffic ∝ k); masked CGS on CPU.
            w = linalg.orthogonalize_bcgs_dyn(w, u_buf, k + 1)
        b_k = linalg.norm(w).astype(rdtype)
        u_buf = jax.lax.dynamic_update_slice_in_dim(u_buf, (w / jnp.maximum(b_k, tiny))[None], k + 1, axis=0)
        alpha = alpha.at[k].set(a_k)
        beta = beta.at[k].set(b_k)
        return (u_buf, alpha, beta)

    u_buf, alpha, beta = jax.lax.fori_loop(0, m, body, (u_buf, alpha, beta))
    return u_buf[:m], alpha, beta, norm0


def _expm_coeff_split(alpha, beta, a_re, a_im, *, squarings: int = 12):
    """(re, im) of exp((a_re + i a_im) T) e1 for the small tridiagonal T —
    entirely real arithmetic.

    exp(aT) = exp(a_re T) (cos(a_im T) + i sin(a_im T)) with all three
    factors of the SAME T (they commute).  cos/sin come from a
    scaling-squaring of (C, S) pairs (C'=C^2-S^2, S'=2CS), exp(a_re T) from
    ordinary squaring; base case is an 8-term Taylor on T/2^squarings.
    """
    m = alpha.shape[0]
    rdtype = alpha.dtype
    t = jnp.diag(alpha) + jnp.diag(beta[: m - 1], 1) + jnp.diag(beta[: m - 1], -1)
    eye = jnp.eye(m, dtype=rdtype)
    prec = jax.lax.Precision.HIGHEST

    scale = jnp.asarray(2.0 ** (-squarings), rdtype)
    ts_im = t * (a_im * scale)
    ts_re = t * (a_re * scale)

    def taylor(mat, kind):
        # kind: 'cos'/'sin'/'exp' Taylor to 8 terms of the scaled matrix.
        acc = eye if kind != "sin" else mat
        term = acc
        start = 1
        for k in range(start, 8):
            if kind == "exp":
                term = jnp.matmul(term, mat, precision=prec) / (k)
                acc = acc + term
            else:
                # cos: sum (-1)^k mat^(2k)/(2k)!; sin: sum (-1)^k mat^(2k+1)/(2k+1)!
                m2 = jnp.matmul(mat, mat, precision=prec)
                denom = (2 * k) * (2 * k - 1) if kind == "cos" else (2 * k + 1) * (2 * k)
                term = -jnp.matmul(term, m2, precision=prec) / denom
                acc = acc + term
        return acc

    c = taylor(ts_im, "cos")
    s = taylor(ts_im, "sin")
    e = taylor(ts_re, "exp")

    def dbl(carry, _):
        c, s, e = carry
        c2 = jnp.matmul(c, c, precision=prec) - jnp.matmul(s, s, precision=prec)
        s2 = 2.0 * jnp.matmul(c, s, precision=prec)
        e2 = jnp.matmul(e, e, precision=prec)
        return (c2, s2, e2), None

    (c, s, e), _ = jax.lax.scan(dbl, (c, s, e), None, length=squarings)
    # exp(aT) e1 = E (C + iS) e1
    ce1 = c[:, 0]
    se1 = s[:, 0]
    return jnp.matmul(e, ce1, precision=prec), jnp.matmul(e, se1, precision=prec)


@functools.partial(jax.jit, static_argnames=("steps", "m", "fo", "renorm"))
def _evolve_run(op, vr, vi, a_re, a_im, steps: int, m: int, fo: bool, renorm: bool):
    """Module-level jitted evolution body: ``op`` is a pytree ARGUMENT (a
    closure would bake its arrays into the HLO — oversized remote-compile
    payloads and a fresh trace per call)."""
    prec = jax.lax.Precision.HIGHEST

    def one_part(v):
        u, al, be, n0 = _krylov_build_fixed(op, v, m, fo)
        cr, ci = _expm_coeff_split(al, be, a_re, a_im)
        out_re = n0 * jnp.matmul(cr, u, precision=prec)
        out_im = n0 * jnp.matmul(ci, u, precision=prec)
        return out_re, out_im

    def step(carry, _):
        vr, vi = carry
        pr, pi = one_part(vr)  # exp(aA) vr
        qr, qi = one_part(vi)  # exp(aA) vi
        # out = (pr + i pi) + i (qr + i qi)
        out_re, out_im = pr - qi, pi + qr
        if renorm:  # unitary evolution: cancel f32 norm drift per step
            nrm = jnp.sqrt(jnp.sum(out_re * out_re) + jnp.sum(out_im * out_im))
            out_re = out_re / nrm
            out_im = out_im / nrm
        return (out_re, out_im), None

    (vr, vi), _ = jax.lax.scan(step, (vr, vi), None, length=steps)
    return vr, vi


def evolve_split(op, v_re, v_im, a, steps: int, krylov_dim: int = 12, *, full_orth: bool = True, renormalize: bool = False):
    """``steps`` applications of exp(a*A) to (v_re + i v_im), ALL on device.

    One jitted program: lax.scan over steps, each step a fixed
    ``krylov_dim`` Lanczos build per part plus a small-matrix split-complex
    exponential — zero host round-trips between steps (the per-step Krylov
    truncation error is O((|a| ||A||)^m / m!); pick krylov_dim ~ 2-4x
    |a|*spectral-radius).  Returns (out_re, out_im).
    """
    a = complex(a)
    rdtype = np.dtype(real_dtype(np.dtype(v_re.dtype)))
    return _evolve_run(
        op,
        jnp.asarray(v_re), jnp.asarray(v_im),
        jnp.asarray(a.real, rdtype), jnp.asarray(a.imag, rdtype),
        int(steps), int(krylov_dim), bool(full_orth), bool(renormalize),
    )


@functools.partial(jax.jit, static_argnames=("steps", "m", "fo", "renorm"))
def _evolve_herm_run(op, w, a_re, a_im, steps: int, m: int, fo: bool, renorm: bool):
    """Evolution of a COMPLEX Hermitian state through the real embedding.

    The carried state is the REAL 2n embedding ``w = [psi_re; psi_im]`` of
    the complex n-state, so each step needs ONE Krylov build — the generic
    split path (:func:`_evolve_run`) needs two.  The Krylov approximation of
    ``exp(a*M) w`` is a polynomial in M with complex coefficients applied to
    w, and real polynomials commute with the embedding, so with
    ``u = ur + i*ui`` the split Krylov output the new complex state is
    ``psi' = u[:n] + i*u[n:]`` — re-embedded as ``w' = ur + J ui`` with J
    the multiply-by-i embedding [[0, -I], [I, 0]].
    """
    prec = jax.lax.Precision.HIGHEST
    half = w.shape[0] // 2

    def step(w, _):
        u, al, be, n0 = _krylov_build_fixed(op, w, m, fo)
        cr, ci = _expm_coeff_split(al, be, a_re, a_im)
        ur = n0 * jnp.matmul(cr, u, precision=prec)
        ui = n0 * jnp.matmul(ci, u, precision=prec)
        w2 = jnp.concatenate([ur[:half] - ui[half:], ur[half:] + ui[:half]])
        if renorm:  # ||w|| IS the complex state norm
            w2 = w2 / jnp.sqrt(jnp.sum(w2 * w2))
        return w2, None

    w, _ = jax.lax.scan(step, w, None, length=steps)
    return w


def evolve_hermitian_split(split_op, psi_re, psi_im, a, steps: int,
                           krylov_dim: int = 12, *, full_orth: bool = True,
                           renormalize: bool = False):
    """``steps`` applications of exp(a*H) to the complex n-state
    ``psi_re + i psi_im`` of a complex Hermitian H given as its real
    embedding (:class:`~lanczos_tpu.ops.hermitian_split.HermitianSplitOperator`).
    All on device, one jitted scan; returns n-dim ``(out_re, out_im)``.
    """
    a = complex(a)
    rdtype = np.dtype(real_dtype(np.dtype(split_op.dtype)))
    w = jnp.concatenate([jnp.asarray(psi_re, rdtype), jnp.asarray(psi_im, rdtype)])
    w = _evolve_herm_run(
        split_op, w, jnp.asarray(a.real, rdtype), jnp.asarray(a.imag, rdtype),
        int(steps), int(krylov_dim), bool(full_orth), bool(renormalize),
    )
    half = split_op.op_r.n
    return w[:half], w[half:]
