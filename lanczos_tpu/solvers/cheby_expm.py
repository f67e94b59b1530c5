"""Chebyshev propagator: exp(a*A) @ v as a single polynomial matvec chain.

The Tal-Ezer/Kosloff expansion (the standard long-time quantum propagator):
with the spectrum of A enclosed in [lo, hi], map x = (A - c)/e (c, e the
window center/half-width) and

    exp(a*A) v = exp(a*c) * [ I_0(z) + 2 * sum_{k>=1} I_k(z) T_k(x) ] v,
    z = a*e,

where I_k is the modified Bessel function of the first kind (complex
argument supported — a = i*t gives the unitary propagator, real a the heat
kernel).  |I_k(z)| decays SUPEREXPONENTIALLY once k > |z|, so the number of
matvecs for the WHOLE evolution is ~|a|*e + O(|z|^(1/3)) — independent of
any step count.  Compare the Krylov exponentiator (exponentiator_fused.py):
~krylov_dim matvecs plus a basis build + orthogonalization PER STEP, with
the step count set by dt accuracy.  For long evolutions the Chebyshev chain
does the same job in one lax.scan of cheap matvecs with O(1) extra memory —
the same trade that makes the filtered eigensolver fast: matvec chains
stream, basis traffic does not.

Details: split-complex state (the codebase convention, see
exponentiator_fused.run_split),
the whole chain is ONE jitted lax.scan (coefficients are a (K, 2) operand,
never baked into the HLO), and a GRID of times reuses one T_k chain (time
enters only through the host Bessel coefficients — the exact analogue of
``Exponentiator.run_grid``'s shared-basis trick).

Stability contract: [lo, hi] MUST enclose the spectrum (|x| > 1 makes T_k
blow up like cosh — the same rule as the Chebyshev filter's damp window);
the default bounds are +-Gershgorin, which always satisfy it.

No reference counterpart (the reference's exponentiator is Krylov-only,
exponentiator.hpp:87-173); this is the standard spectral method for a
bandwidth-bound device.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.operators import as_operator
from ..utils import estimate

__all__ = [
    "chebyshev_expm_coeffs",
    "chebyshev_expm_apply_split",
    "chebyshev_expm_apply_split_precise",
    "chebyshev_expm_apply_hermitian",
    "chebyshev_expm_grid_split",
    "chebyshev_expm_grid_hermitian",
]


def chebyshev_expm_coeffs(a, c, e, tol: float = 1e-16, kmax: int = 100_000):
    """Host-side expansion coefficients exp(a*c) * (2 - delta_k0) * I_k(a*e).

    Returns a complex128 array cut where the superexponential tail falls
    below ``tol`` relative to the largest term.  ``kmax`` bounds the term
    count (|z| ~ 1e5 means ~1e5 matvecs — almost certainly a wrong window,
    not a legitimate request).
    """
    from scipy.special import iv

    z = complex(a) * float(e)
    K = int(min(abs(z) + 20.0 * (abs(z) ** (1.0 / 3.0) + 2.0), kmax))
    ks = np.arange(K + 1)
    with np.errstate(over="ignore", invalid="ignore"):
        ck = iv(ks, z).astype(np.complex128)
    if not np.all(np.isfinite(ck)):
        # |z| large enough to overflow iv's internals: scaled fallback.
        # scipy defines ive(k, z) = iv(k, z) * exp(-abs(Re z)) for all
        # complex z, so the exact unscale is exp(abs(Re z)) — NOT exp(z)
        # (which for Im(z) != 0 injects a spurious global phase and for
        # Re(z) < 0 is off in magnitude by exp(2|Re z|)).
        from scipy.special import ive

        ck = ive(ks, z).astype(np.complex128)
        pref = np.exp(complex(a) * float(c) + abs(z.real))
        if not np.isfinite(pref):
            raise OverflowError(
                f"chebyshev_expm_coeffs: prefactor exp(a*c + |Re(a*e)|) "
                f"overflows for a={a!r}, window center {c}, half-width {e} "
                f"— the requested evolution amplifies beyond float range; "
                f"split the time interval or shrink the window.")
    else:
        pref = np.exp(complex(a) * float(c))
    mag = np.abs(ck)
    floor = tol * max(mag.max(), 1e-300)
    keep = np.nonzero(mag > floor)[0]
    kcut = int(keep[-1]) + 1 if keep.size else 1
    coef = ck[:kcut] * 2.0 * pref
    coef[0] *= 0.5
    return coef


@functools.partial(jax.jit, static_argnames=())
def _cheby_chain(op, c, e, coef_re, coef_im, v_re, v_im):
    """acc = sum_k coef_k * T_k(x) (v_re + i v_im), one lax.scan.

    T_k is real, so it acts on the re/im words independently; the complex
    coefficient mixes them into the split accumulator.
    """
    inv_e = 1.0 / e

    def xmv(w):
        return (op.matvec(w) - c * w) * inv_e

    def accumulate(acc_re, acc_im, cr, ci, tr, ti):
        acc_re = acc_re + cr * tr - ci * ti
        acc_im = acc_im + cr * ti + ci * tr
        return acc_re, acc_im

    t0_re, t0_im = v_re, v_im
    acc_re = jnp.zeros_like(v_re)
    acc_im = jnp.zeros_like(v_im)
    acc_re, acc_im = accumulate(acc_re, acc_im, coef_re[0], coef_im[0], t0_re, t0_im)

    def with_t1(_):
        t1_re, t1_im = xmv(t0_re), xmv(t0_im)
        a_re, a_im = accumulate(acc_re, acc_im, coef_re[1], coef_im[1], t1_re, t1_im)

        def step(carry, ck):
            (pr, pi, qr, qi, ar, ai) = carry
            nr = 2.0 * xmv(qr) - pr
            ni = 2.0 * xmv(qi) - pi
            ar, ai = accumulate(ar, ai, ck[0], ck[1], nr, ni)
            return (qr, qi, nr, ni, ar, ai), None

        ck_tail = jnp.stack([coef_re[2:], coef_im[2:]], axis=1)
        (_, _, _, _, ar, ai), _ = jax.lax.scan(
            step, (t0_re, t0_im, t1_re, t1_im, a_re, a_im), ck_tail)
        return ar, ai

    # coef length is static (host-cut), so plain Python branching is fine
    if coef_re.shape[0] == 1:
        return acc_re, acc_im
    return with_t1(None)


@functools.partial(jax.jit, static_argnames=())
def _cheby_chain_df(op, c_df, inv_e_df, coef_re_df, coef_im_df, v_re, v_im):
    """df64 variant of ``_cheby_chain``: the recurrence, accumulator, and
    coefficient products all run as double-float word pairs through the
    operator's ``matvec_df`` — f64-grade propagation on f32 hardware (the
    same trick as evolve(..., precise=True), without the per-step Krylov
    pipeline).  Inputs: c/inv_e/coefs as (hi, lo) pairs; the state enters
    as f32 (hi word), lo words start at zero."""
    from ..core import df64

    def xmv(wh, wl):
        ah, al = op.matvec_df(wh, wl)
        ch, cl = df64.df_mul((wh, wl), c_df)
        sh, sl = df64.df_sub((ah, al), (ch, cl))
        return df64.df_mul((sh, sl), inv_e_df)

    def acc_add(acc, cr, ci, tr, ti):
        (arh, arl), (aih, ail) = acc
        tr_cr = df64.df_mul(tr, cr)
        ti_ci = df64.df_mul(ti, ci)
        tr_ci = df64.df_mul(tr, ci)
        ti_cr = df64.df_mul(ti, cr)
        ar = df64.df_add((arh, arl), df64.df_sub(tr_cr, ti_ci))
        ai = df64.df_add((aih, ail), df64.df_add(ti_cr, tr_ci))
        return (ar, ai)

    (v_re, v_re_lo), (v_im, v_im_lo) = v_re, v_im
    z = jnp.zeros_like(v_re)
    t0r, t0i = (v_re, v_re_lo), (v_im, v_im_lo)
    acc = ((z, z), (z, z))
    c0r = (coef_re_df[0][0], coef_re_df[1][0])
    c0i = (coef_im_df[0][0], coef_im_df[1][0])
    acc = acc_add(acc, c0r, c0i, t0r, t0i)
    t1r = xmv(*t0r)
    t1i = xmv(*t0i)
    c1r = (coef_re_df[0][1], coef_re_df[1][1])
    c1i = (coef_im_df[0][1], coef_im_df[1][1])
    acc = acc_add(acc, c1r, c1i, t1r, t1i)

    def step(carry, ck):
        (pr, pi, qr, qi, acc) = carry
        wr = xmv(*qr)
        wi = xmv(*qi)
        nr = df64.df_sub((2.0 * wr[0], 2.0 * wr[1]), pr)
        ni = df64.df_sub((2.0 * wi[0], 2.0 * wi[1]), pi)
        acc = acc_add(acc, (ck[0], ck[1]), (ck[2], ck[3]), nr, ni)
        return (qr, qi, nr, ni, acc), None

    ck_tail = jnp.stack(
        [coef_re_df[0][2:], coef_re_df[1][2:], coef_im_df[0][2:], coef_im_df[1][2:]],
        axis=1)
    (_, _, _, _, acc), _ = jax.lax.scan(step, (t0r, t0i, t1r, t1i, acc), ck_tail)
    (arh, arl), (aih, ail) = acc
    return arh, arl, aih, ail


def _df_split_host(x64, rdt):
    hi = np.asarray(x64, rdt)
    lo = np.asarray(np.asarray(x64, np.float64) - np.asarray(hi, np.float64), rdt)
    return hi, lo


def chebyshev_expm_apply_split_precise(op, a, v_re, v_im, *, lo=None, hi=None,
                                       tol: float = 1e-16):
    """df64 Chebyshev propagator: exp(a*A)(v_re + i v_im) at f64-grade
    fidelity from f32 hardware, ONE chain (needs ``op.matvec_df``).
    Returns ((re, im) host float64 arrays, n_terms)."""
    from ..core.types import real_dtype

    op = as_operator(op)
    c, e = _window(op, lo, hi)
    coef = chebyshev_expm_coeffs(a, c, e, tol=tol)
    rdt = np.dtype(real_dtype(op.dtype))
    cr_hi, cr_lo = _df_split_host(np.real(coef), rdt)
    ci_hi, ci_lo = _df_split_host(np.imag(coef), rdt)
    c_hi, c_lo = _df_split_host(c, rdt)
    inv_hi, inv_lo = _df_split_host(np.float64(1.0) / np.float64(e), rdt)
    # host f64 inputs are df-split in NUMPY (an x64-disabled runtime
    # silently truncates a traced f64 — the evolve(..., precise) lesson)
    vr_hi, vr_lo = _df_split_host(np.asarray(v_re, np.float64), rdt)
    vi_hi, vi_lo = _df_split_host(np.asarray(v_im, np.float64), rdt)
    arh, arl, aih, ail = _cheby_chain_df(
        op,
        (jnp.asarray(c_hi), jnp.asarray(c_lo)),
        (jnp.asarray(inv_hi), jnp.asarray(inv_lo)),
        (jnp.asarray(cr_hi), jnp.asarray(cr_lo)),
        (jnp.asarray(ci_hi), jnp.asarray(ci_lo)),
        (jnp.asarray(vr_hi), jnp.asarray(vr_lo)),
        (jnp.asarray(vi_hi), jnp.asarray(vi_lo)))
    re = np.asarray(arh, np.float64) + np.asarray(arl, np.float64)
    im = np.asarray(aih, np.float64) + np.asarray(ail, np.float64)
    return (re, im), int(coef.shape[0])


def _window(op, lo, hi):
    if lo is None or hi is None:
        try:
            g = float(estimate.gershgorin_bound(op))
        except Exception:
            # matrix-free / composite operator: stochastic power bound with
            # a safety factor (an UNDERestimated window makes T_k blow up)
            g = 1.1 * float(estimate.power_bound(op))
        lo = -g if lo is None else float(lo)
        hi = g if hi is None else float(hi)
    if not (hi > lo):
        raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def chebyshev_expm_apply_split(op, a, v_re, v_im, *, lo=None, hi=None,
                               tol: float = 1e-16):
    """exp(a*A) (v_re + i v_im) -> ((out_re, out_im), n_terms).

    ``a`` may be complex (a = i*t is the unitary propagator).  ``lo``/``hi``
    default to +-Gershgorin; they MUST enclose the spectrum.
    """
    op = as_operator(op)
    c, e = _window(op, lo, hi)
    coef = chebyshev_expm_coeffs(a, c, e, tol=tol)
    rdt = jnp.asarray(v_re).dtype
    coef_re = jnp.asarray(np.real(coef), rdt)
    coef_im = jnp.asarray(np.imag(coef), rdt)
    out_re, out_im = _cheby_chain(
        op, jnp.asarray(c, rdt), jnp.asarray(e, rdt), coef_re, coef_im,
        jnp.asarray(v_re, rdt), jnp.asarray(v_im, rdt))
    return (out_re, out_im), int(coef.shape[0])


def chebyshev_expm_apply_hermitian(split_op, a, psi_re, psi_im, *, lo=None,
                                   hi=None, tol: float = 1e-16,
                                   precise: bool = False):
    """exp(a*H) psi for a COMPLEX Hermitian H given as its real embedding
    (:class:`~lanczos_tpu.ops.hermitian_split.HermitianSplitOperator`).

    T_k has REAL coefficients, so the embedding homomorphism gives
    T_k(M_emb) [psi_re; psi_im] = [Re(T_k(H) psi); Im(T_k(H) psi)] — the
    ordinary chain on the symmetric 2n embedding computes every complex
    T_k(H) psi for free, and the complex expansion coefficients recombine
    LINEARLY afterwards: with acc = sum c_k T_k(M) w accumulated as a
    split-complex 2n pair, out_re = acc_re[:n] - acc_im[n:] and
    out_im = acc_re[n:] + acc_im[:n].  Returns ((out_re, out_im),
    n_terms) over the ORIGINAL n-dim complex problem.
    """
    n = split_op.op_r.n
    if precise:
        # Concatenate in NUMPY float64: routing a host f64 state through
        # jnp on an x64-disabled runtime silently truncates it to f32
        # BEFORE the numpy df-split inside the precise path (the
        # evolve(..., precise) lesson — measured 2.6e-8 instead of ~1e-12).
        w64 = np.concatenate([np.asarray(psi_re, np.float64),
                              np.asarray(psi_im, np.float64)])
        (acc_re, acc_im), terms = chebyshev_expm_apply_split_precise(
            split_op, a, w64, np.zeros(2 * n),
            lo=lo, hi=hi, tol=tol)
    else:
        w = jnp.concatenate([jnp.asarray(psi_re), jnp.asarray(psi_im)])
        (acc_re, acc_im), terms = chebyshev_expm_apply_split(
            split_op, a, w, jnp.zeros_like(w), lo=lo, hi=hi, tol=tol)
    out_re = acc_re[:n] - acc_im[n:]
    out_im = acc_re[n:] + acc_im[:n]
    return (out_re, out_im), terms


def chebyshev_expm_grid_hermitian(split_op, a_list, psi_re, psi_im, *,
                                  lo=None, hi=None, tol: float = 1e-16):
    """Grid variant of :func:`chebyshev_expm_apply_hermitian`: every a_j of
    a COMPLEX Hermitian evolution from one chain on the real embedding,
    recombined per time row.  Returns ((out_re (num, n), out_im (num, n)),
    n_terms) over the original n-dim problem."""
    n = split_op.op_r.n
    w = jnp.concatenate([jnp.asarray(psi_re), jnp.asarray(psi_im)])
    (acc_re, acc_im), terms = chebyshev_expm_grid_split(
        split_op, a_list, w, jnp.zeros_like(w), lo=lo, hi=hi, tol=tol)
    out_re = acc_re[:, :n] - acc_im[:, n:]
    out_im = acc_re[:, n:] + acc_im[:, :n]
    return (out_re, out_im), terms


@functools.partial(jax.jit, static_argnames=())
def _cheby_chain_grid(op, c, e, coef_re, coef_im, v_re, v_im):
    """Grid variant: coef_* are (num_t, K); ONE T_k chain feeds every time
    point (acc is (num_t, n))."""
    inv_e = 1.0 / e

    def xmv(w):
        return (op.matvec(w) - c * w) * inv_e

    t0_re, t0_im = v_re, v_im
    t1_re, t1_im = xmv(t0_re), xmv(t0_im)
    acc_re = coef_re[:, 0:1] * t0_re[None, :] - coef_im[:, 0:1] * t0_im[None, :]
    acc_im = coef_re[:, 0:1] * t0_im[None, :] + coef_im[:, 0:1] * t0_re[None, :]
    acc_re = acc_re + coef_re[:, 1:2] * t1_re[None, :] - coef_im[:, 1:2] * t1_im[None, :]
    acc_im = acc_im + coef_re[:, 1:2] * t1_im[None, :] + coef_im[:, 1:2] * t1_re[None, :]

    def step(carry, ck):
        (pr, pi, qr, qi, ar, ai) = carry
        nr = 2.0 * xmv(qr) - pr
        ni = 2.0 * xmv(qi) - pi
        cr, ci = ck[:, 0], ck[:, 1]
        ar = ar + cr[:, None] * nr[None, :] - ci[:, None] * ni[None, :]
        ai = ai + cr[:, None] * ni[None, :] + ci[:, None] * nr[None, :]
        return (qr, qi, nr, ni, ar, ai), None

    ck_tail = jnp.stack([coef_re[:, 2:], coef_im[:, 2:]], axis=2).transpose(1, 0, 2)
    (_, _, _, _, ar, ai), _ = jax.lax.scan(
        step, (t0_re, t0_im, t1_re, t1_im, acc_re, acc_im), ck_tail)
    return ar, ai


def chebyshev_expm_grid_split(op, a_list, v_re, v_im, *, lo=None, hi=None,
                              tol: float = 1e-16):
    """exp(a_j*A) (v_re + i v_im) for every a_j from ONE matvec chain.

    The chain length is set by max_j |a_j*e|; each extra time point costs
    only a coefficient row and an (n,) accumulator.  Returns
    ((out_re (num, n), out_im (num, n)), n_terms).
    """
    op = as_operator(op)
    c, e = _window(op, lo, hi)
    per = [chebyshev_expm_coeffs(a, c, e, tol=tol) for a in a_list]
    K = max(p.shape[0] for p in per)
    K = max(K, 2)
    coef = np.zeros((len(per), K), np.complex128)
    for j, p in enumerate(per):
        coef[j, : p.shape[0]] = p
    rdt = jnp.asarray(v_re).dtype
    out_re, out_im = _cheby_chain_grid(
        op, jnp.asarray(c, rdt), jnp.asarray(e, rdt),
        jnp.asarray(np.real(coef), rdt), jnp.asarray(np.imag(coef), rdt),
        jnp.asarray(v_re, rdt), jnp.asarray(v_im, rdt))
    return (out_re, out_im), int(K)
