"""Double-float (df64) Krylov exponentiation: f64-grade evolution in f32 storage.

Why this exists (round 4, VERDICT r3 item 4): the f32 ``evolve_split`` loop
drifts ~1e-7 in state ANGLE per step — the overlap metric the reference uses
(exponentiator.hpp:58) is quadratic in that angle error and hides it (2.5e-15
overlap == ~5e-8 angle), and over a 100-step chain the drift compounds to
~1e-5 (measured, bench `expm_evolve100_angle_err`).  The error budget has
four equal ~1e-7 contributors — carried-state f32 representation, f32 build
arithmetic (alpha/beta/CGS), the f32 small-matrix exponential, and the f32
recombination — so fixing any one alone is pointless.  This module fixes all
four with the df64 machinery the eigensolver's ``precise_vectors`` mode
already relies on:

* the state is carried as (hi, lo) word pairs through the whole scan,
* the fixed-m Lanczos build runs on the operator's EFT ``matvec_df`` with
  df inner products and df CGS2 (core/linalg.py),
* alpha/beta are df pairs and the split-complex small-matrix exponential
  (Taylor + scaling-squaring, mirroring ``_expm_coeff_split``) runs entirely
  in df arithmetic via ``df64.df_matmul`` (m x m elementwise scan — tiny),
* the Krylov recombination is a df_matmul against the df basis.

Reference anchor: exponentiator.hpp:87-173 (the f64 CPU engine whose
per-apply state error is ~1e-15; this is the f32-storage way to match it).
Real symmetric operators only (the documented pv restriction); complex
states go through the split (re, im) embedding like ``evolve_split``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import df64, linalg
from ..core.types import real_dtype

__all__ = ["evolve_split_precise", "evolve_hermitian_split_precise"]


def _split_host(x: float, rdtype) -> tuple[np.ndarray, np.ndarray]:
    """Split a host f64 scalar into (hi, lo) rdtype words IN NUMPY — an
    x64-disabled jax runtime silently downcasts f64 operands (CLAUDE.md),
    which would round ``a`` to f32 before the split and defeat the df path."""
    hi = np.asarray(x, rdtype)
    lo = np.asarray(np.float64(x) - np.float64(hi), rdtype)
    return hi, lo


def _df_const(value: int, like):
    """Small exact integer as a df scalar pair."""
    return (jnp.asarray(value, like), jnp.zeros((), like))


def _cgs_dfdf_exact(w_df, u_hi, u_lo, live, passes: int = 2):
    """CGS of a df vector against a df basis with DF-EXACT coefficients.

    ``linalg.orthogonalize_cgs2_dfdf_coeffs`` computes its projection
    coefficients as a plain f32 ``rows_hi @ w_hi`` dot — each coefficient
    carries ~2^-24 ABSOLUTE error, which caps the basis orthonormality at
    ~2.6e-8 no matter how many passes run (measured; fine for the pv
    eigensolver, whose exact-relation bookkeeping records what was actually
    subtracted, fatal for the exponentiator whose apply accuracy is the
    basis quality itself).  Here each coefficient is an EFT df dot
    (inner_prod_df_df vmapped over rows), driving the post-CGS2 overlap to
    the df floor (~1e-13 orthonormality, measured in the build probe).
    """
    coeff = jax.vmap(
        lambda rh, rl, wh, wl: linalg.inner_prod_df_df((rh, rl), (wh, wl)),
        in_axes=(0, 0, None, None),
    )
    for _ in range(passes):
        c_hi, c_lo = coeff(u_hi, u_lo, w_df[0], w_df[1])
        c_hi = c_hi * live
        c_lo = c_lo * live

        def step(acc, inp):
            ch, cl, bh, bl = inp
            prod = df64.df_mul((ch[None], cl[None]), (bh, bl))
            return df64.df_add(acc, (prod[0], prod[1])), None

        init = (jnp.zeros_like(w_df[0]), jnp.zeros_like(w_df[1]))
        (ph, pl), _ = jax.lax.scan(step, init, (c_hi, c_lo, u_hi, u_lo))
        w_df = df64.df_sub(w_df, (ph, pl))
    return w_df


def _krylov_build_fixed_df(op, v_df, m: int, full_orth: bool):
    """m-step df Lanczos build from the (unnormalized) df vector ``v_df``.

    Returns ``((U_hi, U_lo) (m, n), (alpha_hi, alpha_lo), (beta_hi,
    beta_lo), norm0_df)``.  The df analogue of ``_krylov_build_fixed``
    (exponentiator_fused.py): fixed size, no convergence logic, every
    arithmetic step in df64.
    """
    rdtype = np.dtype(real_dtype(v_df[0].dtype))
    n = v_df[0].shape[0]
    tiny = jnp.asarray(np.finfo(rdtype).tiny * 1e4, rdtype)

    n0sq = linalg.inner_prod_df_df(v_df, v_df)
    norm0 = df64.df_sqrt(n0sq)
    inv0 = df64.df_recip((jnp.maximum(norm0[0], tiny), norm0[1]))
    u0_hi, u0_lo = df64.df_mul(v_df, inv0)

    u_hi = jnp.zeros((m + 1, n), rdtype).at[0].set(u0_hi)
    u_lo = jnp.zeros((m + 1, n), rdtype).at[0].set(u0_lo)
    al_hi = jnp.zeros((m,), rdtype)
    al_lo = jnp.zeros((m,), rdtype)
    be_hi = jnp.zeros((m,), rdtype)
    be_lo = jnp.zeros((m,), rdtype)
    zero = jnp.zeros((), rdtype)

    def body(k, carry):
        u_hi, u_lo, al_hi, al_lo, be_hi, be_lo = carry
        up_hi = jax.lax.dynamic_index_in_dim(u_hi, k, axis=0, keepdims=False)
        up_lo = jax.lax.dynamic_index_in_dim(u_lo, k, axis=0, keepdims=False)
        upp_hi = jax.lax.dynamic_index_in_dim(u_hi, jnp.maximum(k - 1, 0), axis=0, keepdims=False)
        upp_lo = jax.lax.dynamic_index_in_dim(u_lo, jnp.maximum(k - 1, 0), axis=0, keepdims=False)

        au = op.matvec_df(up_hi, up_lo)
        a_df = linalg.inner_prod_df_df((up_hi, up_lo), au)

        bsel = k >= 1
        bp_hi = jax.lax.dynamic_index_in_dim(be_hi, jnp.maximum(k - 1, 0), keepdims=False)
        bp_lo = jax.lax.dynamic_index_in_dim(be_lo, jnp.maximum(k - 1, 0), keepdims=False)
        b_df = (jnp.where(bsel, bp_hi, zero), jnp.where(bsel, bp_lo, zero))

        w_df = df64.df_sub(
            au,
            df64.df_add(
                df64.df_mul(a_df, (up_hi, up_lo)),
                df64.df_mul(b_df, (upp_hi, upp_lo)),
            ),
        )
        if full_orth:
            live = (jnp.arange(m + 1) <= k).astype(rdtype)
            # ONE pass suffices here (measured: orthonormality 1.08e-14 at
            # passes=1 vs 1.11e-14 at 2): a CGS re-pass exists to clean the
            # ~2^-24 absolute error of f32 projection coefficients, and
            # these coefficients are EFT df dots with ~2^-48 error — the
            # first subtraction already lands at the df floor.
            w_df = _cgs_dfdf_exact(w_df, u_hi, u_lo, live, passes=1)
        bsq = linalg.inner_prod_df_df(w_df, w_df)
        b_k = df64.df_sqrt((jnp.maximum(bsq[0], tiny), jnp.where(bsq[0] > tiny, bsq[1], zero)))
        inv_b = df64.df_recip(b_k)
        un_hi, un_lo = df64.df_mul(w_df, inv_b)

        u_hi = jax.lax.dynamic_update_slice_in_dim(u_hi, un_hi[None], k + 1, axis=0)
        u_lo = jax.lax.dynamic_update_slice_in_dim(u_lo, un_lo[None], k + 1, axis=0)
        al_hi = al_hi.at[k].set(a_df[0])
        al_lo = al_lo.at[k].set(a_df[1])
        be_hi = be_hi.at[k].set(b_k[0])
        be_lo = be_lo.at[k].set(b_k[1])
        return (u_hi, u_lo, al_hi, al_lo, be_hi, be_lo)

    u_hi, u_lo, al_hi, al_lo, be_hi, be_lo = jax.lax.fori_loop(
        0, m, body, (u_hi, u_lo, al_hi, al_lo, be_hi, be_lo)
    )
    return (u_hi[:m], u_lo[:m]), (al_hi, al_lo), (be_hi, be_lo), norm0


def _df_mm(a_df, b_df):
    return df64.df_matmul(a_df, b_df)


def _df_small_expm_split(alpha_df, beta_df, a_re_df, a_im_df, *, squarings: int = 12):
    """df64 (re, im) of ``exp((a_re + i a_im) T) e1`` for the small
    tridiagonal T built from df alpha/beta.

    Mirrors ``_expm_coeff_split`` (exponentiator_fused.py) — cos/sin/exp
    Taylor base cases on T/2^squarings, then the (C, S, E) squaring chain —
    but every matrix product is a df64.df_matmul and every scalar a df pair,
    so the coefficients carry ~2^-48 relative error instead of f32's 2^-24.
    m x m with m ~ 12-24: the elementwise scans are tiny.
    """
    al_hi, al_lo = alpha_df
    be_hi, be_lo = beta_df
    m = al_hi.shape[0]
    rdtype = al_hi.dtype

    t_hi = jnp.diag(al_hi) + jnp.diag(be_hi[: m - 1], 1) + jnp.diag(be_hi[: m - 1], -1)
    t_lo = jnp.diag(al_lo) + jnp.diag(be_lo[: m - 1], 1) + jnp.diag(be_lo[: m - 1], -1)

    eye_df = (jnp.eye(m, dtype=rdtype), jnp.zeros((m, m), rdtype))
    scale = jnp.asarray(2.0 ** (-squarings), rdtype)  # exact power of two
    ts_im = df64.df_mul((t_hi, t_lo), (a_im_df[0] * scale, a_im_df[1] * scale))
    ts_re = df64.df_mul((t_hi, t_lo), (a_re_df[0] * scale, a_re_df[1] * scale))

    def taylor(mat_df, kind):
        acc = eye_df if kind != "sin" else mat_df
        term = acc
        m2 = _df_mm(mat_df, mat_df) if kind != "exp" else None
        for k in range(1, 8):
            if kind == "exp":
                term = df64.df_mul(_df_mm(term, mat_df), df64.df_recip(_df_const(k, rdtype)))
                acc = df64.df_add(acc, term)
            else:
                denom = (2 * k) * (2 * k - 1) if kind == "cos" else (2 * k + 1) * (2 * k)
                term = df64.df_mul(_df_mm(term, m2), df64.df_recip(_df_const(-denom, rdtype)))
                acc = df64.df_add(acc, term)
        return acc

    c = taylor(ts_im, "cos")
    s = taylor(ts_im, "sin")
    e = taylor(ts_re, "exp")

    def dbl(carry, _):
        c, s, e = carry
        c2 = df64.df_sub(_df_mm(c, c), _df_mm(s, s))
        ss = _df_mm(c, s)
        s2 = (2.0 * ss[0], 2.0 * ss[1])  # exact doubling
        e2 = _df_mm(e, e)
        return (c2, s2, e2), None

    (c, s, e), _ = jax.lax.scan(dbl, (c, s, e), None, length=squarings)
    ce1 = (c[0][:, :1], c[1][:, :1])  # (m, 1) df column 0
    se1 = (s[0][:, :1], s[1][:, :1])
    cr = _df_mm(e, ce1)
    ci = _df_mm(e, se1)
    return (cr[0][:, 0], cr[1][:, 0]), (ci[0][:, 0], ci[1][:, 0])


@functools.partial(jax.jit, static_argnames=("steps", "m", "renorm"))
def _evolve_run_precise(op, vr_hi, vr_lo, vi_hi, vi_lo, ar_hi, ar_lo, ai_hi, ai_lo, steps: int, m: int, renorm: bool):
    """Module-level jitted df evolution body (op is a pytree argument)."""
    a_re_df = (ar_hi, ar_lo)
    a_im_df = (ai_hi, ai_lo)

    def one_part(v_df):
        u_df, al_df, be_df, n0 = _krylov_build_fixed_df(op, v_df, m, True)
        cr_df, ci_df = _df_small_expm_split(al_df, be_df, a_re_df, a_im_df)
        out_r = df64.df_matmul((cr_df[0][None, :], cr_df[1][None, :]), u_df)
        out_i = df64.df_matmul((ci_df[0][None, :], ci_df[1][None, :]), u_df)
        out_r = df64.df_mul((out_r[0][0], out_r[1][0]), n0)
        out_i = df64.df_mul((out_i[0][0], out_i[1][0]), n0)
        return out_r, out_i

    def step(carry, _):
        vr_df, vi_df = carry
        pr, pi = one_part(vr_df)  # exp(aA) vr
        qr, qi = one_part(vi_df)  # exp(aA) vi
        out_re = df64.df_sub(pr, qi)
        out_im = df64.df_add(pi, qr)
        if renorm:
            nsq = df64.df_add(
                linalg.inner_prod_df_df(out_re, out_re),
                linalg.inner_prod_df_df(out_im, out_im),
            )
            inv = df64.df_recip(df64.df_sqrt(nsq))
            out_re = df64.df_mul(out_re, inv)
            out_im = df64.df_mul(out_im, inv)
        return (out_re, out_im), None

    ((vr_df, vi_df)), _ = jax.lax.scan(
        step, (((vr_hi, vr_lo)), ((vi_hi, vi_lo))), None, length=steps
    )
    return vr_df[0], vr_df[1], vi_df[0], vi_df[1]


def evolve_split_precise(op, v_re, v_im, a, steps: int, krylov_dim: int = 16, *, renormalize: bool = False):
    """``steps`` df64-carried applications of exp(a*A) to (v_re + i v_im).

    Same contract as :func:`exponentiator_fused.evolve_split` (one jitted
    lax.scan, zero host syncs between steps) at ~2^-48-grade per-step
    arithmetic: the carried state, Krylov build, small-matrix exponential
    and recombination are all double-float.  Requires an operator with an
    EFT ``matvec_df`` (BSR/DIA/COO/CSR/DenseDF — the pv operator set).

    Returns ``((re_hi, re_lo), (im_hi, im_lo))`` df word pairs; fold with
    ``np.float64(hi) + np.float64(lo)`` on host for the f64 state.
    """
    if np.dtype(v_re.dtype).kind == "c":
        raise TypeError("evolve_split_precise takes split (re, im) REAL arrays")
    rdtype = np.dtype(real_dtype(np.dtype(op.dtype)))
    a = complex(a)
    ar_hi, ar_lo = _split_host(a.real, rdtype)
    ai_hi, ai_lo = _split_host(a.imag, rdtype)

    def split_vec(v):
        # An f64 host input is df-split IN NUMPY (an x64-disabled runtime
        # would silently round it to f32 first — CLAUDE.md): the input state
        # enters at full f64 fidelity, not with a ~1e-8 cast error baked in.
        v = np.asarray(v) if not isinstance(v, jax.Array) else v
        if isinstance(v, np.ndarray) and v.dtype == np.float64 and rdtype == np.float32:
            hi = v.astype(np.float32)
            lo = (v - hi.astype(np.float64)).astype(np.float32)
            return jnp.asarray(hi), jnp.asarray(lo)
        vj = jnp.asarray(v, rdtype)
        return vj, jnp.zeros_like(vj)

    vr, vr_lo = split_vec(v_re)
    vi, vi_lo = split_vec(v_im)
    rh, rl, ih, il = _evolve_run_precise(
        op, vr, vr_lo, vi, vi_lo,
        jnp.asarray(ar_hi), jnp.asarray(ar_lo), jnp.asarray(ai_hi), jnp.asarray(ai_lo),
        int(steps), int(krylov_dim), bool(renormalize),
    )
    return (rh, rl), (ih, il)


@functools.partial(jax.jit, static_argnames=("steps", "m", "renorm"))
def _evolve_herm_run_precise(op, w_hi, w_lo, ar_hi, ar_lo, ai_hi, ai_lo,
                             steps: int, m: int, renorm: bool):
    """df64 Hermitian-split evolution body: ONE df Krylov build per step on
    the real 2n embedding, with the embedding-homomorphism recombination
    ``w' = ur + J ui`` (see exponentiator_fused._evolve_herm_run) carried as
    df word pairs."""
    a_re_df = (ar_hi, ar_lo)
    a_im_df = (ai_hi, ai_lo)
    half = w_hi.shape[0] // 2

    def step(w_df, _):
        u_df, al_df, be_df, n0 = _krylov_build_fixed_df(op, w_df, m, True)
        cr_df, ci_df = _df_small_expm_split(al_df, be_df, a_re_df, a_im_df)
        ur = df64.df_matmul((cr_df[0][None, :], cr_df[1][None, :]), u_df)
        ui = df64.df_matmul((ci_df[0][None, :], ci_df[1][None, :]), u_df)
        ur = df64.df_mul((ur[0][0], ur[1][0]), n0)
        ui = df64.df_mul((ui[0][0], ui[1][0]), n0)
        top = df64.df_sub((ur[0][:half], ur[1][:half]), (ui[0][half:], ui[1][half:]))
        bot = df64.df_add((ur[0][half:], ur[1][half:]), (ui[0][:half], ui[1][:half]))
        w2 = (jnp.concatenate([top[0], bot[0]]), jnp.concatenate([top[1], bot[1]]))
        if renorm:
            inv = df64.df_recip(df64.df_sqrt(linalg.inner_prod_df_df(w2, w2)))
            w2 = df64.df_mul(w2, inv)
        return w2, None

    w_df, _ = jax.lax.scan(step, (w_hi, w_lo), None, length=steps)
    return w_df[0], w_df[1]


def evolve_hermitian_split_precise(split_op, psi_re, psi_im, a, steps: int,
                                   krylov_dim: int = 16, *,
                                   renormalize: bool = False):
    """df64-carried ``steps`` applications of exp(a*H) to the complex
    n-state of a complex Hermitian H given as its real embedding (needs the
    embedding's composed ``matvec_df``).  Host f64 inputs keep full
    fidelity (numpy df split); returns host float64 n-dim ``(re, im)``."""
    rdtype = np.dtype(real_dtype(np.dtype(split_op.dtype)))
    a = complex(a)
    ar_hi, ar_lo = _split_host(a.real, rdtype)
    ai_hi, ai_lo = _split_host(a.imag, rdtype)
    # Concatenate + df-split IN NUMPY f64: routing through jnp on an
    # x64-disabled runtime silently truncates the state to f32 first.
    w64 = np.concatenate([np.asarray(psi_re, np.float64),
                          np.asarray(psi_im, np.float64)])
    hi = w64.astype(rdtype)
    lo = (w64 - hi.astype(np.float64)).astype(rdtype)
    wh, wl = _evolve_herm_run_precise(
        split_op, jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(ar_hi), jnp.asarray(ar_lo),
        jnp.asarray(ai_hi), jnp.asarray(ai_lo),
        int(steps), int(krylov_dim), bool(renormalize),
    )
    half = split_op.op_r.n
    wh = np.asarray(wh, np.float64)
    wl = np.asarray(wl, np.float64)
    return wh[:half] + wl[:half], wh[half:] + wl[half:]
