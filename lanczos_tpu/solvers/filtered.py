"""Chebyshev-filtered Lanczos solve: extremal eigenpairs at huge n.

``filtered_lanczos`` wraps the operator in a
:class:`~lanczos_tpu.ops.filters.ChebyshevFilterOperator`, runs the ordinary
(deflation-driven, thick-restart) engine on the FILTERED operator — where
the wanted mu-band is an exponentially separated top cluster, so the Krylov
basis stays tiny and reorthogonalization cost vanishes — and recovers the
A-space eigenvalues by a small subspace Rayleigh-Ritz over the converged
filtered Ritz vectors (df64 inner products on device, k x k host f64 solve).

Use when: n is large enough that basis traffic dominates (>= ~1e6) and the
target is an extremal EDGE (the flagship chain solve is the canonical
case), OR — with ``precise=True`` — whenever reference-grade (<=1e-12)
eigenVALUES are wanted at ANY n: the spectral inverse-map refinement
returns f64-exact values from f32 storage.  ``sigma=`` targets interior eigenvalues without
linear solves.  For df-grade eigenVECTORS or spectra where no safe far
bound exists use ``precise_vectors`` on the plain engines instead.

No reference counterpart (the reference's only spectral transform is the
scalar ``eigenvalue_offset`` shift, lambda_lanczos.hpp:163-170; this is the
generalization of that idea to a polynomial of the operator).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from ..core import df64
from ..ops.filters import ChebyshevFilterOperator
from ..ops.operators import as_operator
from ..utils import estimate
from . import lanczos as _lanczos

__all__ = ["filtered_lanczos"]


def _safe_bound(op) -> float:
    try:
        return float(estimate.gershgorin_bound(op))
    except Exception:
        return float(estimate.power_bound(op))


def _edge_estimate(op, find_maximum: bool) -> float:
    """Cheap plain-Lanczos estimate of the WANTED spectral edge.

    Ritz values converge to the edge from INSIDE the spectrum, which is
    exactly the safe side for the filter window: an estimate above the true
    minimum leaves the true edge outside the damp window, where T_p is
    monotone and LARGER — separation only improves.  (The far side is the
    dangerous one; it gets the safe Gershgorin bound.)
    """
    from ..api import LambdaLanczos

    eng = LambdaLanczos(op, find_maximum=find_maximum, num_eigs=1)
    eng.eps = 1e-3
    eng.max_iteration = min(48, op.n)
    eng.max_restarts = 1
    import warnings

    with warnings.catch_warnings():
        # The 48-row budget cap is INTENTIONAL here (a coarse edge estimate
        # is all the filter window needs) — the engine's budget-exhausted
        # warning would misdirect the user at every auto-bounds solve.
        # Filtered by CLASS (diagnostics.BudgetExhaustedWarning), robust to
        # message rewording.
        from ..diagnostics import BudgetExhaustedWarning

        warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
        val, _ = eng.run_one()
    return float(val)


def _spectrum_bounds(op, lo, hi, find_maximum: bool):
    """Target-side bound: tight edge estimate; far side: safe bound."""
    if lo is None:
        lo = _edge_estimate(op, False) if not find_maximum else -_safe_bound(op)
    if hi is None:
        hi = _safe_bound(op) if not find_maximum else _edge_estimate(op, True)
    return float(lo), float(hi)


@jax.jit
def _rr_grams(V, AV):
    """All pairwise df64 inner products for the k x k subspace projections
    S = V A V^T and G = V V^T, ONE device dispatch.  (The eager per-pair
    ``inner_prod_df`` loop this replaces dispatched every df64 primitive
    separately.)"""
    gram = jax.vmap(lambda u: jax.vmap(lambda w: df64.dot_df(u, w))(AV))
    S_hi, S_lo = gram(V)
    gram_g = jax.vmap(lambda u: jax.vmap(lambda w: df64.dot_df(u, w))(V))
    G_hi, G_lo = gram_g(V)
    return S_hi, S_lo, G_hi, G_lo


@jax.jit
def _rr_combine(V, AV, Y, theta):
    """Rotate the basis to the Ritz vectors and compute their A-space
    residual norms WITHOUT new matvecs: A(Y^T V) = Y^T (AV) by linearity,
    so ``AV`` from the gram step is reused.  One device dispatch."""
    Q = jnp.einsum("sk,sn->kn", Y, V, precision=jax.lax.Precision.HIGHEST)
    AQ = jnp.einsum("sk,sn->kn", Y, AV, precision=jax.lax.Precision.HIGHEST)
    norms = jnp.sqrt(jnp.sum(Q * Q, axis=1, keepdims=True))
    Qn = Q / norms
    AQn = AQ / norms
    R = AQn - theta[:, None] * Qn
    res = jnp.sqrt(jnp.sum(R * R, axis=1))
    return Qn, res


def _rayleigh_ritz(op, V, num_eigs, find_maximum):
    """A-space subspace Rayleigh-Ritz over the (row-stacked) basis ``V``.

    The B-space Ritz values are useless as A eigenvalues (the filter is
    not invertible on the band at f32 resolution); project A onto the
    small converged subspace instead.  df64 inner products keep the k x k
    projections at ~2^-45 even though the vectors are f32.  Returns the
    best ``num_eigs`` (engine order), their normalized Ritz vectors, and
    the A-space residual norms ||A q - theta q||.
    """
    import scipy.linalg as sla

    k = V.shape[0]
    AV = jnp.stack([op.matvec(V[i]) for i in range(k)])
    S_hi, S_lo, G_hi, G_lo = _rr_grams(V, AV)
    S = np.asarray(S_hi, np.float64) + np.asarray(S_lo, np.float64)
    G = np.asarray(G_hi, np.float64) + np.asarray(G_lo, np.float64)
    S = 0.5 * (S + S.T)
    G = 0.5 * (G + G.T)
    theta, Y = sla.eigh(S, G)
    order = np.argsort(theta) if not find_maximum else np.argsort(theta)[::-1]
    theta = theta[order][:num_eigs]
    Y = Y[:, order][:, :num_eigs]
    vecs_out, res_dev = _rr_combine(
        V, AV, jnp.asarray(Y, V.dtype), jnp.asarray(theta, V.dtype))
    res = [float(r) for r in np.asarray(res_dev)]
    return theta, vecs_out, res


# ---------------------------------------------------------------------------
# df64 eigenvector refinement (VERDICT r4 item 4)
# ---------------------------------------------------------------------------


@jax.jit
def _df_block_apply(aop, Xh, Xl):
    """Row-wise df64 matvec of a (k, n) df block (static-k unroll: works for
    sharded operators whose matvec_df contains shard_map, where vmap may
    not)."""
    outs = [aop.matvec_df(Xh[i], Xl[i]) for i in range(Xh.shape[0])]
    return jnp.stack([o[0] for o in outs]), jnp.stack([o[1] for o in outs])


@jax.jit
def _df_gram_pair(Xh, Xl, Yh, Yl):
    """k x k df-df gram G[i, j] = <X_i, Y_j> as (hi, lo) — ONE dispatch."""
    from ..core import linalg

    k = Xh.shape[0]
    hs = []
    ls = []
    for i in range(k):
        row = [linalg.inner_prod_df_df((Xh[i], Xl[i]), (Yh[j], Yl[j])) for j in range(Yh.shape[0])]
        hs.append(jnp.stack([r[0] for r in row]))
        ls.append(jnp.stack([r[1] for r in row]))
    return jnp.stack(hs), jnp.stack(ls)


@jax.jit
def _df_rotate_normalize(Ch, Cl, Xh, Xl):
    """X' = C @ X in df64, rows normalized in df64."""
    from ..core import linalg

    Yh, Yl = df64.df_matmul((Ch, Cl), (Xh, Xl))
    k = Yh.shape[0]
    nsq = [linalg.inner_prod_df_df((Yh[i], Yl[i]), (Yh[i], Yl[i])) for i in range(k)]
    nh = jnp.stack([s[0] for s in nsq])
    nl = jnp.stack([s[1] for s in nsq])
    ih, il = df64.df_recip(df64.df_sqrt((nh, nl)))
    return df64.df_mul((Yh, Yl), (ih[:, None], il[:, None]))


@jax.jit
def _df_block_residuals(Xh, Xl, AXh, AXl, th_h, th_l):
    """||A x_i - theta_i x_i|| in df64 per row."""
    from ..core import linalg

    tX = df64.df_mul((Xh, Xl), (th_h[:, None], th_l[:, None]))
    Rh, Rl = df64.df_sub((AXh, AXl), tX)
    k = Rh.shape[0]
    nsq = [linalg.inner_prod_df_df((Rh[i], Rl[i]), (Rh[i], Rl[i])) for i in range(k)]
    return jnp.sqrt(jnp.maximum(jnp.stack([s[0] for s in nsq]), 0.0))


def _split_host_mat(c64, rdt):
    hi = np.asarray(c64, rdt)
    lo = np.asarray(np.asarray(c64, np.float64) - np.asarray(hi, np.float64), rdt)
    return jnp.asarray(hi), jnp.asarray(lo)


def _whiten_coeffs(G):
    """Host f64 combination rows C with C G C^T = I, robust to a (near-)
    collapsed gram: inverse Cholesky when PD, eigen-whitening with a
    floored spectrum otherwise (a steep filter apply can align block rows
    to ~1e-17 — the gram then loses PD at f64 resolution)."""
    try:
        return np.linalg.inv(np.linalg.cholesky(G)), False
    except np.linalg.LinAlgError:
        w, E = np.linalg.eigh(0.5 * (G + G.T))
        floor = max(float(w.max()), 1.0) * 1e-28
        w = np.maximum(w, floor)
        return (E / np.sqrt(w)).T, True


def _df_orthonormalize_block(Xh, Xl, rdt):
    """df64 block orthonormalization: df gram -> host whitening rows ->
    df rotation.  Keeps k independent directions through steep filter
    applies (plain row normalization lets the block collapse onto the
    most-amplified direction)."""
    Gh, Gl = _df_gram_pair(Xh, Xl, Xh, Xl)
    G = np.asarray(Gh, np.float64) + np.asarray(Gl, np.float64)
    C, _degenerate = _whiten_coeffs(0.5 * (G + G.T))
    ch, cl = _split_host_mat(C, rdt)
    return _df_rotate_normalize(ch, cl, Xh, Xl)


def _refine_filter(base_op, lo, hi, mu, find_maximum):
    """A much STEEPER filter dedicated to vector refinement.

    The refinement decay per sweep is T_p(contaminant)/T_p(target), and the
    dangerous contaminants are IN-BAND non-target states barely shallower
    than the targets (the n=4000 chain: lambda_4..12 inside the 16x-spread
    mu band; depth separation only ~2.5% of theta_mu) — at the solve
    filter's d*theta ~ 3 that ratio is ~0.95 and residuals plateau at
    ~1e-10 (measured).  The solve's d*theta <= 40 cap exists because the
    B-ENGINE squares vector norms; refinement controls its own arithmetic
    and renormalizes after every apply; the binding cap is the df norm
    computation, which SQUARES the amplified components — cosh(d*theta)^2
    must stay inside f32, i.e. d*theta <= ~40 per apply (the same wall the
    B-engine's cap guards).  The sweep therefore chains TWO normalized
    applies of a d*theta ~ 36 filter — e^1.8 ~ 6x decay per sweep on the
    2.5%-separated in-band contaminant, df-floor residuals in <= 8
    sweeps."""
    e_half = 0.5 * ((hi - lo) - mu)
    theta = float(np.arccosh(1.0 + mu / max(e_half, mu)))
    # Degree past ~n buys nothing (a degree-n polynomial already spans the
    # full Krylov space) and only inflates the scan compile — bound by 2n
    # so small problems (tests, dryruns) stay cheap.
    d_cap = int(min(8192, max(64, 2 * int(getattr(base_op, "n", 8192)))))
    degree = int(np.clip(np.ceil(36.0 / max(theta, 1e-9)), 16, d_cap))
    degree = ((degree + 31) // 32) * 32
    if degree * theta > 40.0:
        degree = max(2, int(40.0 / max(theta, 1e-9)))
    degree = int(degree) + (int(degree) % 2)
    return ChebyshevFilterOperator.from_interval(
        base_op, degree, lo, hi, mu, find_maximum=find_maximum)


def _refine_vectors_df(op, fop, vecs, find_maximum, span, *,
                       tol: float | None = None, max_sweeps: int = 8):
    """Push the returned Ritz vectors from f32-grade to df-grade A-space
    residuals by df64 FILTER-subspace iteration (VERDICT r4 item 4).

    The values already come back f64-exact through the analytic inverse
    map, but the subspace has no attenuation mechanism — the RR combine is
    capped by the f32 basis.  The filter itself fixes that: each df64
    ``T_p(A)`` application amplifies the band over every damped direction
    by >= cosh(d*theta) (~10 in precise mode), so a handful of sweeps —
    each ``k * degree`` df matvecs plus a k x k df Rayleigh-Ritz that
    splits the within-band directions — drives the bulk contamination from
    ~res_bar to the df floor.  Sweeps stop adaptively at ``tol``
    (default ``1e-11 * max(span, 1)``).

    Returns ``(theta (k,) f64, X (k, n) host f64, res list, sweeps)`` or
    ``None`` when the operator lacks ``matvec_df``.  Matches the
    reference's eigenvector bar (|lambda|*eps*10 elementwise,
    test/lambda_lanczos_test.cpp:156-159) on f32 hardware.
    """
    import scipy.linalg as sla

    if not hasattr(op, "matvec_df") or not hasattr(fop, "matvec_df"):
        return None
    rdt = np.dtype(vecs.dtype)
    Xh = jnp.asarray(vecs)
    Xl = jnp.zeros_like(Xh)
    if tol is None:
        tol = 1e-11 * max(float(span), 1.0)
    theta = None
    res = None
    sweeps = 0
    for sweep in range(max_sweeps):
        sweeps = sweep + 1
        AXh, AXl = _df_block_apply(op, Xh, Xl)
        Sh, Sl = _df_gram_pair(Xh, Xl, AXh, AXl)
        Gh, Gl = _df_gram_pair(Xh, Xl, Xh, Xl)
        S = np.asarray(Sh, np.float64) + np.asarray(Sl, np.float64)
        G = np.asarray(Gh, np.float64) + np.asarray(Gl, np.float64)
        S = 0.5 * (S + S.T)
        G = 0.5 * (G + G.T)
        try:
            theta_all, Y = sla.eigh(S, G)
        except np.linalg.LinAlgError:
            # near-collapsed block: whiten explicitly, solve the standard
            # problem in the whitened coordinates
            W, _deg = _whiten_coeffs(G)
            theta_all, Z = np.linalg.eigh(0.5 * ((W @ S @ W.T) + (W @ S @ W.T).T))
            Y = W.T @ Z
        order = np.argsort(theta_all)
        if find_maximum:
            order = order[::-1]
        theta = theta_all[order]
        C = Y[:, order].T  # (k, k): G-orthonormal combination rows
        ch, cl = _split_host_mat(C, rdt)
        Xh, Xl = _df_rotate_normalize(ch, cl, Xh, Xl)
        AXh, AXl = _df_block_apply(op, Xh, Xl)
        th_h, th_l = _split_host_mat(theta, rdt)
        res_dev = _df_block_residuals(Xh, Xl, AXh, AXl, th_h, th_l)
        res = [float(r) for r in np.asarray(res_dev)]
        if max(res) <= tol:
            break
        if sweep < max_sweeps - 1:
            # TWO filter applies per sweep (one apply is capped at cosh(40)
            # by the squared norms; chaining doubles the decay exponent
            # without touching the f32 range), each followed by a df BLOCK
            # orthonormalization — within-band amplification ratios reach
            # e^20 per apply on a tight band, and a merely row-normalized
            # block would collapse onto the deepest direction.
            for _rep in range(2):
                Xh, Xl = _df_block_apply(fop, Xh, Xl)
                Xh, Xl = _df_orthonormalize_block(Xh, Xl, rdt)
    X64 = np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)
    return np.asarray(theta, np.float64), X64, res, sweeps


@functools.partial(jax.jit, static_argnames=("steps",))
def _probe_remaining_band(fop, V, w0, steps: int):
    """Power-iterate the FILTER on a vector deflated against the held
    subspace: the growth rate converges to the largest B-value among band
    directions NOT captured — i.e. the amplification of the best MISSED
    state.  Re-deflates every step (f32 projection leakage of captured
    band directions would otherwise regrow by b per step and false-fire).
    One jitted dispatch."""
    def body(_, carry):
        w, _r = carry
        bw = fop.matvec(w)
        coef = jnp.einsum("kn,n->k", V, bw, precision=jax.lax.Precision.HIGHEST)
        bw = bw - jnp.einsum("kn,k->n", V, coef, precision=jax.lax.Precision.HIGHEST)
        rn = jnp.sqrt(jnp.sum(bw * bw))
        return bw / jnp.maximum(rn, 1e-30), rn

    _w, r = jax.lax.fori_loop(0, steps, body, (w0, jnp.asarray(1.0, w0.dtype)))
    return r


def _missed_copy_probe(fop, V, vals_b, theta_worst, margin, find_maximum, num_eigs):
    """True when no MISSED band state beats the worst returned value.

    The stop_when_full fast path skips the reference's confirming
    deflation round, and a single Krylov start cannot see the second copy
    of a DEGENERATE eigenvalue (measured: ring-50 precise returned
    {-2, -1.984, -1.937} for the true {-2, -1.984, -1.984}).  This probe
    closes that hole for ~steps filter applications: the deflated power
    iteration's growth rate r estimates the best missed state's B-value,
    and ``invert_value(r)`` is that state's A-value — an extra deflated
    round fires only when it beats ``theta_worst`` by more than the
    mu-scale budget.  Underconvergence of the power iteration
    UNDERestimates r (maps to a worse A-value), so weak-amplification
    regimes (b ~ 1.2, the coarse flagship) degrade to never firing — the
    safe direction; the precise mode's b ~ 10 detects in a handful of
    steps."""
    b_kept = float(np.asarray(vals_b)[: max(num_eigs, 1)].min())
    n = V.shape[1]
    steps = int(np.ceil(np.log(8.0 * np.sqrt(n)) / np.log(max(b_kept, 1.2))))
    steps = min(max(((steps + 3) // 4) * 4, 4), 32)
    from ..utils.random import random_initializer

    w0 = jnp.asarray(random_initializer(V.dtype)(n), V.dtype)
    r = float(_probe_remaining_band(fop, V, w0, steps))
    a_probe = float(np.asarray(fop.invert_value(np.asarray(r, np.float64))))
    if not np.isfinite(a_probe):
        return True
    if find_maximum:
        return not (a_probe > theta_worst + margin)
    return not (a_probe < theta_worst - margin)


def _auto_mu(op, num_eigs, find_maximum, lo, hi, guard):
    """Two-stage auto windowing: a coarse (f32, mu-grade) SCOUT pass
    measures WHERE the targets sit, then the caller's pass gets a band
    wide enough to hold them DEEP inside (distance from the window edge is
    what T_p' — the error attenuator — grows on; the mu=1.3e-5 starvation
    case measured 2532-5703 B iterations at n=4000 where 16x-the-spread mu
    measured 128).  The scout runs with a WIDE band (1% of the span,
    escalating to 5% if its residuals say the targets still fell outside)
    — it only needs rough locations, and a too-narrow scout band is the
    one way it fails; its warnings are suppressed because the ladder and
    the main pass's own checks supersede them.  The result snaps to a
    factor-2 grid (anchored at the span): the scout's dist carries
    up-to-~2x measurement noise, and an unquantized mu feeds an
    unquantized degree — a fresh compile per solve.  The 16x margin makes
    a factor-sqrt(2) rounding free."""
    import warnings as _warnings

    edge = lo if not find_maximum else hi
    span = hi - lo
    dist = None
    for frac in (0.01, 0.05):
        with _warnings.catch_warnings():
            # scout pass: suppress only the library's own warnings (the
            # ladder and the main pass's checks supersede them)
            from ..diagnostics import LanczosWarning

            _warnings.simplefilter("ignore", LanczosWarning)
            vals0, _v0, i0 = filtered_lanczos(
                op, num_eigs, find_maximum, mu=frac * span, lo=lo, hi=hi,
                guard=guard)
        dist = max(abs(float(v) - edge) for v in np.asarray(vals0))
        bar0 = 0.5 * float(np.sqrt(frac * span * span))
        if max(i0["residuals"]) <= bar0 and dist <= 0.5 * frac * span:
            break
    mu = float(np.clip(16.0 * dist, 2.5e-6 * span, 0.05 * span))
    return float(span * 2.0 ** np.round(np.log2(mu / span)))


def _filtered_interior(op, num_eigs, *, sigma, degree, mu, lo, hi, guard,
                       residual_bound, max_extra_rounds, precise,
                       refine_vectors=None, checkpoint_path=None,
                       configure=None):
    """k eigenvalues of A NEAREST an interior ``sigma`` — via the squared
    transform, NO linear solves (contrast eigsh(sigma=...) shift-invert).

    ``(A - sigma)^2`` maps "nearest sigma" to the BOTTOM edge (with the
    exact lower bound 0), where the whole filtered machinery applies —
    including ``precise`` inverse-map refinement.  sigma-symmetric pairs
    merge in the squared spectrum (one degenerate value, two directions);
    the subspace still spans both A-eigenvectors, so a final A-space
    Rayleigh-Ritz splits them.  precise values: the f64 squared values map
    back as sigma + sign(theta - sigma)*sqrt(v2), pairing each RR theta
    with its nearest inverse value; absolute error grows like
    err_v2 / (2|lambda - sigma|), so the closer the target to sigma the
    BETTER (sigma exactly on an eigenvalue is the best-conditioned case —
    the one that breaks shift-invert).
    """
    from ..ops.operators import ShiftSquaredOperator

    base = as_operator(op)
    if lo is None or hi is None:
        g = _safe_bound(base)
        lo = -g if lo is None else lo
        hi = g if hi is None else hi
    sq = ShiftSquaredOperator(base, float(sigma))
    hi2 = max((hi - sigma) ** 2, (sigma - lo) ** 2)
    if mu is None:
        # The static mu default (2.5e-6*span) is calibrated for an EDGE
        # cluster; interior spacings in squared units vary wildly with
        # sigma, so both modes scout here.
        mu = _auto_mu(sq, num_eigs, False, 0.0, float(hi2), guard)
    vals2, vecs, info = filtered_lanczos(
        sq, num_eigs, False, degree=degree, mu=mu, lo=0.0, hi=float(hi2),
        guard=guard, residual_bound=residual_bound,
        max_extra_rounds=max_extra_rounds, precise=precise,
        refine_vectors=False,  # refined below against the BASE operator
        checkpoint_path=checkpoint_path, configure=configure)
    # A-space RR over the returned subspace: splits sigma-symmetric merged
    # pairs and orients each vector; order nearest-sigma first.
    theta, vecs_out, res = _rayleigh_ritz(
        base, jnp.asarray(vecs, base.dtype), num_eigs, False)
    order = np.argsort(np.abs(np.asarray(theta) - sigma))
    theta = np.asarray(theta)[order]
    vecs_out = vecs_out[np.asarray(order)]
    res = [res[i] for i in order]
    if precise:
        v2 = np.asarray(vals2, np.float64)
        vals = np.empty(len(theta), np.float64)
        for j, t in enumerate(theta):
            k = int(np.argmin(np.abs(v2 - (t - sigma) ** 2)))
            vals[j] = sigma + np.sign(t - sigma) * np.sqrt(max(v2[k], 0.0))
        info["rr_values"] = [float(t) for t in theta]
    else:
        vals = theta
    if refine_vectors is None:
        refine_vectors = precise
    if refine_vectors:
        # Refine against the SQUARED-operator filter (the band amplifier for
        # this target), RR against the BASE operator (splits the
        # sigma-symmetric pairs at df resolution).  The returned values are
        # (near-)exact, so the refinement band can hug the targets: a band
        # ending at 2x the deepest target depth usually EXCLUDES the next
        # level ((k+2)^2/k^2 > 2 for k <= 4 in even-ladder units), turning
        # its per-sweep decay from the slow in-band depth ratio into the
        # full cosh(d*theta) band/damp separation.
        max_v2 = float(np.max((np.asarray(vals, np.float64) - sigma) ** 2))
        mu_ref = min(float(info["mu"]), max(2.0 * max_v2, 1e-3 * float(info["mu"])))
        fop_sq = _refine_filter(
            sq, 0.0, float(hi2), mu_ref,
            find_maximum=False)  # nearest-sigma = BOTTOM edge of (A-sigma)^2
        refined = _refine_vectors_df(base, fop_sq, vecs_out, False, hi - lo,
                                     max_sweeps=12)
        if refined is not None:
            theta_r, X64, res_r, sweeps = refined
            order_r = np.argsort(np.abs(theta_r - sigma))
            vals = theta_r[order_r]
            vecs_out = X64[order_r]
            res = [res_r[i] for i in order_r]
            info["residuals"] = res
            info["refine_sweeps"] = sweeps
    info["sigma"] = float(sigma)
    info["residuals"] = res
    # each squared-operator application is TWO base matvecs
    info["matvecs"] = 2 * int(info["matvecs"])
    return np.asarray(vals), vecs_out, info


def filtered_lanczos(op, num_eigs: int = 1, find_maximum: bool = False, *,
                     degree: int | None = None, mu: float | None = None,
                     lo: float | None = None, hi: float | None = None,
                     guard: int = 0, residual_bound: float | None = None,
                     max_extra_rounds: int | None = None, precise: bool = False,
                     sigma: float | None = None, auto_window: bool | None = None,
                     refine_vectors: bool | None = None,
                     checkpoint_path=None, configure=None):
    """(eigenvalues, eigenvectors, info) at the wanted spectral edge.

    Parameters mirror :class:`~lanczos_tpu.api.LambdaLanczos` where they
    overlap.  ``mu`` is the amplified band width and does double duty: it is
    the eigenvalue-error budget AND the window that must CONTAIN every
    wanted eigenvalue — a target outside [edge, edge+mu] is damped like the
    bulk and comes back as noise (its entry in ``info['residuals']`` is
    O(1); a warning fires).  Default ``2.5e-6 * (hi - lo)``, the f32
    production regime for a clustered edge.  ``degree`` is the filter
    polynomial degree (amplification grows like ``cosh(degree *
    sqrt(2*mu/e))``, so deeper filters buy fewer filtered iterations at
    more matvecs each; coerced even so both edges amplify positively).
    ``lo``/``hi`` default to a tight pre-pass estimate on the TARGET side
    and Gershgorin on the far side (the far side must never underestimate —
    an eigenvalue beyond the damp window is amplified exponentially).
    ``configure(engine)`` tweaks the B-space engine (e.g. ``block_size``)
    before it runs.  ``guard`` oversamples the B-space solve by that many
    extra eigenpairs and returns the best ``num_eigs`` after the final
    Rayleigh-Ritz — the last-converged pair of a deflation run is the
    noisiest, so ``guard=1`` trades ~one extra B-space round for a much
    tighter tail pair (measured: n=2^16 3rd-pair error 5e-10..7.6e-6
    run-to-run at guard=0).  Round count is adaptive: after each
    deflation round the A-space residuals of the would-be-returned pairs
    are checked against ``residual_bound`` (default
    ``0.5*sqrt(mu*(hi-lo))``: err ~ res^2/gap_eff with gap_eff ~
    0.75*(hi-lo) measured, so the bound keeps errors at ~mu/3);
    rounds continue until all pass or ``max_extra_rounds`` (default
    ``num_eigs+2``) extra rounds have run (then a warning fires).

    ``precise=True`` — SPECTRAL INVERSE-MAP REFINEMENT, reference-grade
    eigenvalues (<= 1e-12, typically f64-exact) from f32 hardware: the
    B-space solve runs with df64 vectors and its Ritz values are mapped
    back through the ANALYTIC inverse of the filter polynomial instead of
    Rayleigh-Ritz quotients.  The filter's steepness attenuates B-space
    error by 1/T_p' (~1e-5..1e-6 at the band), so drift-eps_b ~1e-8 B
    values already return ~1e-14 A values.  With ``mu=None`` the window is
    fully automatic (a coarse scout pass measures the target spread; mu
    snaps to 16x that distance on a factor-2 grid).

    ``refine_vectors`` (default: on when ``precise``) additionally pushes
    the returned eigenVECTORS to the df floor — df64 filter-subspace
    iteration with a steep dedicated filter, block orthonormalization, and
    a df Rayleigh-Ritz (needs ``matvec_df``; silently skipped otherwise).
    Chip-measured (round 5): A-space residuals 1e-12..4e-12 at ~1.4x the
    values-only wall (1.7/1.8/2.1 s on the zoo above) — the reference's
    elementwise eigenvector tolerance on f32 hardware.  The refined
    vectors return as HOST float64 rows.  ``checkpoint_path`` saves the
    B-space manager + round state after every deflation round and resumes
    from it (same npz discipline as utils/checkpoint.py).

    ``sigma`` targets INTERIOR eigenvalues (the ``num_eigs`` nearest
    ``sigma``) via the squared transform ``(A - sigma)^2``
    (:class:`~lanczos_tpu.ops.operators.ShiftSquaredOperator`) — two base
    matvecs per filter step, NO linear solves (contrast
    ``eigsh(sigma=...)`` shift-invert, whose inner MINRES caps accuracy at
    the f32 solve floor and breaks when sigma sits ON an eigenvalue; here
    that is the best-conditioned case).  sigma-symmetric merged pairs are
    split by a final A-space Rayleigh-Ritz; returned nearest-sigma first.
    Coarse mode gives rough locations (the squaring halves the achievable
    digits); ``precise=True`` is the production interior mode (~1e-12).

    ``auto_window=True`` runs the scout-based window sizing for the
    COARSE mode too (default: only ``precise`` scouts) — the static
    ``mu`` default is calibrated for a clustered edge and can miss the
    2nd+ requested state on a well-separated spectrum.

    Returns ascending eigenvalues (nearest-``sigma``-first when ``sigma``
    is given; row-layout eigenvectors, engine convention) and an ``info``
    dict with the B-space iteration counts and the A-space residual norms.
    """
    from ..api import LambdaLanczos  # late import: api imports solvers

    if sigma is not None:
        if find_maximum:
            raise ValueError("sigma (interior targets) and find_maximum are exclusive")
        return _filtered_interior(
            op, num_eigs, sigma=float(sigma), degree=degree, mu=mu, lo=lo,
            hi=hi, guard=guard, residual_bound=residual_bound,
            max_extra_rounds=max_extra_rounds, precise=precise,
            refine_vectors=refine_vectors, checkpoint_path=checkpoint_path,
            configure=configure)
    scout = (auto_window if auto_window is not None else precise)

    op = as_operator(op)
    lo, hi = _spectrum_bounds(op, lo, hi, find_maximum)
    if scout and mu is None:
        mu = _auto_mu(op, num_eigs, find_maximum, lo, hi, guard)
    if mu is None:
        mu = 2.5e-6 * (hi - lo)
    theta = float(np.arccosh(1.0 + 2.0 * mu / max((hi - lo) - mu, mu)))
    if degree is None:
        # Amplification exponent d*theta ~ 1.3 for the coarse mode (the
        # measured flagship optimum: d=400 at mu=1e-5/span=4 — deeper
        # filters cost matvecs the span-RR doesn't need) and ~3 (cosh~10)
        # for precise mode, where band/bulk SEPARATION drives both the
        # B-space Krylov rate and the inverse-map attenuation.
        target_exp = 3.0 if precise else 1.3
        degree = int(np.clip(np.ceil(target_exp / max(theta, 1e-9)), 16, 2400))
        # Quantize UP to a 32-grid: the scan length is compile-static, and
        # the scout-derived mu jitters run-to-run — unquantized degrees
        # (166/168/186 across three identical solves) force a recompile
        # per solve.  mu itself is a traced operand (window retargeting
        # reuses the program), so degree is the only recompile axis.
        degree = ((degree + 31) // 32) * 32
    # Overflow guard: the amplified band tops out at cosh(d*theta), and the
    # engine SQUARES norms of B-vectors in f32 — cap the exponent at 40
    # (amplification 1.2e17, squared 1.4e34 < f32 max; far more separation
    # than any solve needs) rather than let the B-space solve go inf.
    if degree * theta > 40.0:
        import warnings as _warnings

        from ..diagnostics import OverflowGuardWarning

        clipped = max(2, int(40.0 / max(theta, 1e-9)))
        _warnings.warn(
            f"filtered_lanczos: degree {degree} would amplify the mu-band to "
            f"cosh({degree * theta:.0f}) — beyond f32 range once squared; "
            f"clipping to {clipped} (widen mu or lower degree to silence)",
            OverflowGuardWarning,
            stacklevel=2,
        )
        degree = clipped
    # Even degree only: T_p is +cosh on BOTH sides outside the window for
    # even p, so the amplified band is a top cluster in B-space regardless
    # of which edge is targeted (odd p maps the bottom band to -cosh).
    degree = int(degree) + (int(degree) % 2)

    fop = ChebyshevFilterOperator.from_interval(
        op, degree, lo, hi, mu, find_maximum=find_maximum)

    # ``guard`` oversamples the B-space solve: the LAST-converged eigenpair
    # of a deflation run is the noisiest (it converges on the noise
    # timescale — measured at n=2^16/mu=1e-5 the 3rd-pair error ranges
    # 5e-10..7.6e-6 run-to-run at guard=0), and extra guard pairs push
    # that noise off the returned set: the final Rayleigh-Ritz spans
    # num_eigs+guard vectors and the best num_eigs are returned.  Same
    # trick as the block engine's candidate rows joining the final RR
    # (solvers/block_thick.py).  Cost: ~guard extra budget-capped B-space
    # deflation rounds.
    eng = LambdaLanczos(fop, find_maximum=True, num_eigs=num_eigs + max(int(guard), 0))
    # In B-space the band is a separated top cluster: a shallow basis and a
    # loose eps suffice (the A-space accuracy comes from mu + the final
    # Rayleigh-Ritz, not from B-space drift resolution).  At f32 large-n
    # the B-space eps never fires (drift noise), so every round runs to
    # this budget and round wall ~ max_restarts*max_iteration rows; the
    # adaptive residual loop below decides HOW MANY rounds run, so the
    # budget is per-round depth, not total cost.  On the flagship chain
    # one 2x48-row round suffices with the span-RR; the default keeps the
    # 4x48 depth for unknown spectra — rounds stop adaptively anyway.
    eng.eps = 1e-4
    eng.max_iteration = 48
    eng.max_restarts = 4
    if precise:
        # SPECTRAL INVERSE-MAP REFINEMENT: run the B-space solve with df64
        # vectors (the filter has matvec_df) to drift eps_b, then map the
        # df-accurate B Ritz values back through the ANALYTIC filter
        # inverse instead of taking Rayleigh-Ritz quotients.  The filter's
        # steepness ATTENUATES B-space value errors on the way back:
        # a_err = b_err / T_p'(lambda), and across the band
        # a_err <= eps_b * e * max(1, d*theta_mu) / d^2 (T_p' >= d^2/e at
        # the band's inner edge, growing outward) — so a drift gate of
        # eps_b ~ 1e-8 already returns reference-grade (1e-12) A values
        # from a bounded tiny basis at filter cost.  Eigenvectors stay
        # f32/RR-grade (the subspace, unlike the values, has no
        # attenuation mechanism).
        a_target = 1e-12
        e_half = 0.5 * ((hi - lo) - mu)  # window half-width
        theta_mu = float(np.arccosh(1.0 + mu / e_half))
        eng.precise_vectors = True
        eng.eps = max(
            1e-13,
            a_target * degree**2 / (e_half * 8.0 * max(1.0, degree * theta_mu)),
        )
        # Deeper unrestarted basis than the coarse mode: restart cycles are
        # the expensive way to gain depth (thick keep is ~nroot+2 rows), and
        # the df64 basis is 2 words x cap x n — cap 512 at n=4000 is 16 MB,
        # while huge-n solves fall back to the bounded 96-row regime.
        eng.max_iteration = int(max(96, min(512, (1 << 28) // max(op.n, 1))))
        eng.max_restarts = 64
    # Stop each driver call as soon as the manager is full: round count is
    # governed ADAPTIVELY below by the A-space residuals, not by the
    # B-space nothing_added fixed point (whose confirm round is a full
    # budget-capped round here — 25% of the flagship wall — and whose
    # round-1 multi-insertion can be shallow on B-degenerate clusters:
    # measured round-1-only flagship third pair 4.8e-5 vs 1.3e-6 after the
    # residual loop re-rolls it).  configure may still clear it to force
    # reference deflation semantics for the FIRST call.
    eng.stop_when_full = True
    eng.restart_policy = "thick"
    if configure is not None:
        configure(eng)
    import warnings

    # ---- B-space solve: adaptive deflation rounds ------------------------
    # Run the shared deflation driver (one manager across calls, same
    # pattern as utils/checkpoint.py): after each call, Rayleigh-Ritz in
    # A-space and CHECK THE RESIDUALS of the returned pairs.  A pair whose
    # residual exceeds ``residual_bound`` is a shallow/noise copy — run ONE more
    # deflated round (fresh entropy, orthogonal to everything kept) and
    # re-project.  Converged problems stop after a single round; hard
    # B-degenerate clusters (the n=4.19M flagship triple) get exactly the
    # rounds they need instead of a fixed budget.
    # err ~ res^2 / gap_eff with gap_eff ~ 0.75*(hi-lo) measured on the
    # n=4.19M chain (res 6.0e-3 -> err 1.2e-5; res 2.1e-3 -> 1.5e-6; both
    # give gap_eff ~ 3 on span 4), so res <= 0.5*sqrt(mu*(hi-lo)) keeps
    # the eigenvalue error at ~mu/3 — safely inside the mu budget.
    res_bar = float(residual_bound) if residual_bound is not None else float(
        0.5 * np.sqrt(mu * (hi - lo)))
    extra_cap = (num_eigs + 2) if max_extra_rounds is None else int(max_extra_rounds)
    # The engine/manager capacity exceeds the wanted count by extra_cap so
    # extra rounds GROW the Rayleigh-Ritz span: a shallow pair whose
    # B-space (filtered) value is large — an amplified noise copy — can
    # never be evicted by value ordering (measured at n=2^16: 6 capped
    # rounds left the same 1e-2-residual third pair in place), but a
    # larger span lets the RR demote it past position num_eigs instead.
    # stop_when_count starts at the wanted count and grows by one whenever
    # a round fails to improve the worst residual by >=1.5x (stagnation =
    # value-eviction cannot help; growth is shape-stable because the
    # deflation buffer is sized by cfg.num_eigs = capacity from the start,
    # so no recompile happens on the unlucky path).
    k_want = num_eigs + max(int(guard), 0)
    capacity = int(eng.num_eigs) + max(extra_cap, 0)
    eng.num_eigs = capacity
    cfg = eng._config().resolved(eng.dtype)
    cfg.stop_when_count = min(k_want, capacity)
    iterate_one, v0_rows, use_warm = eng._iterate_factory(cfg)
    manager = _lanczos.EigenPairManager(cfg.find_maximum, cfg.num_eigs)
    iter_counts: list[int] = []
    extra = 0
    prev_worst = np.inf
    skip_round = False
    if checkpoint_path is not None:
        # Round-boundary checkpoint/resume (VERDICT r4 item 8): the state
        # of the adaptive loop is exactly the B-space manager content plus
        # three loop scalars; a resumed run replays the post-round checks
        # first (skip_round) instead of burning a fresh deflation round.
        import os as _os

        from ..utils import checkpoint as _ckpt

        if _os.path.exists(_ckpt._npz_path(checkpoint_path)):
            mgr_l, counts_l, extras_l = _ckpt.load_state(
                checkpoint_path, eng.dtype, with_extras=True)
            if mgr_l.num_eigs != capacity or mgr_l.find_maximum != cfg.find_maximum:
                raise ValueError(
                    f"checkpoint at {checkpoint_path} was written for "
                    f"capacity={mgr_l.num_eigs}/find_maximum={mgr_l.find_maximum}, "
                    f"this solve needs {capacity}/{cfg.find_maximum} — the "
                    "num_eigs/guard/max_extra_rounds configuration changed; "
                    "delete the file or restore the original parameters")
            manager, iter_counts = mgr_l, counts_l
            extra = int(extras_l.get("round", 0))
            prev_worst = float(extras_l.get("prev_worst", np.inf))
            cfg.stop_when_count = int(extras_l.get("stop_when_count", cfg.stop_when_count))
            skip_round = len(manager.pairs) > 0
    while True:
        if not skip_round:
            with warnings.catch_warnings():
                # B-space eps-convergence is NOT this solve's accuracy
                # contract (the A-space answer comes from the final
                # Rayleigh-Ritz and the checks below), and degenerate band
                # copies routinely exhaust the B-space deflation budget at
                # f32 drift noise — that budget warning is noise here.
                # Everything else surfaces.
                from ..diagnostics import BudgetExhaustedWarning

                warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
                _lanczos.deflation_driver(
                    iterate_one, cfg, eng._init_fn(), eng.dtype,
                    v0_rows=v0_rows, use_warm_restarts=use_warm,
                    manager=manager, iter_counts=iter_counts,
                )
            if checkpoint_path is not None:
                from ..utils import checkpoint as _ckpt

                _ckpt.save_state(
                    checkpoint_path, manager, iter_counts,
                    extra={"round": extra, "prev_worst": prev_worst,
                           "stop_when_count": cfg.stop_when_count})
        skip_round = False
        vals_b = np.asarray(manager.eigenvalues())
        V = jnp.stack(manager.eigenvectors())
        theta, vecs_out, res = _rayleigh_ritz(op, V, num_eigs, find_maximum)
        worst = max(res)
        if extra >= extra_cap:
            break
        if worst <= res_bar:
            # Residuals passed — but a DEGENERATE copy the Krylov space
            # never saw leaves no residual trace; the deflated band-weight
            # probe (see _missed_copy_probe) detects one for ~a dozen
            # filter applications and buys the copy an extra deflated
            # round (with held capacity grown to make room for it).
            theta_worst = float(np.asarray(theta)[num_eigs - 1])
            # Probe margin: the probe can only OVERestimate a missed
            # state's quality by the f32 deflation-leakage level, so the
            # margin just needs to cover the returned values' own error —
            # ~mu/3 in coarse mode, ~1e-6*span in precise mode (where the
            # inverse map makes values near-exact).  A margin wider than
            # the spacing would hide genuinely missed copies (the ring-50
            # case: spacing 0.047 vs the 0.2 clipped mu).
            margin = (1e-6 * (hi - lo)) if precise else mu
            if _missed_copy_probe(
                    fop, V, vals_b, theta_worst, margin, find_maximum, num_eigs):
                break
            cfg.stop_when_count = min(cfg.stop_when_count + 1, capacity)
        elif worst > prev_worst / 1.5:
            cfg.stop_when_count = min(cfg.stop_when_count + 1, capacity)
        prev_worst = worst
        extra += 1
    eng._iteration_counts = iter_counts
    if extra >= extra_cap and max(res) <= res_bar:
        # Exited on the round cap with clean residuals.  The cap can be hit
        # purely through residual-stagnation rounds where the probe never
        # ran, so probe the FINAL subspace once before claiming a miss —
        # warning only when the probe actually detects one.
        theta_worst = float(np.asarray(theta)[num_eigs - 1])
        margin = (1e-6 * (hi - lo)) if precise else mu
        if not _missed_copy_probe(
                fop, V, vals_b, theta_worst, margin, find_maximum, num_eigs):
            from ..diagnostics import MissedCopyWarning

            warnings.warn(
                "filtered_lanczos: the deflated band-weight probe detects a "
                f"missed band state after {extra} extra round(s) — a "
                "degenerate copy may be absent from the returned set; raise "
                "max_extra_rounds or check multiplicities",
                MissedCopyWarning,
                stacklevel=2,
            )
    if max(res) > res_bar:
        from ..diagnostics import AccuracyWarning

        warnings.warn(
            f"filtered_lanczos: A-space residuals {[f'{r:.2g}' for r in res]} "
            f"still exceed the mu-scale bound {res_bar:.2g} after "
            f"{extra} extra deflation round(s) — eigenvalue errors may "
            f"exceed the ~mu budget; raise degree/mu or max_extra_rounds",
            AccuracyWarning,
            stacklevel=2,
        )
    # Scale-free band check: the damped bulk satisfies |T_p| <= 1, so a
    # returned vector whose B-space Ritz value is not well above 1 never
    # lived in the amplified band — its A-space value is bulk noise.
    # (A weak-but-valid filter can sit at e.g. 1.9 — the flagship p=400
    # regime — so the cut is just above the bulk ceiling, not at "well
    # amplified".)
    # Guard pairs are EXPECTED to be the noisiest — only the best num_eigs
    # (engine order: best first) gate the warning; a bulk-level guard is
    # exactly the oversampling working as intended.
    vals_b = [float(v) for v in np.asarray(vals_b)]
    if any(v < 1.1 for v in vals_b[:num_eigs]):
        import warnings

        from ..diagnostics import BandCoverageWarning

        warnings.warn(
            f"filtered_lanczos: B-space Ritz values {[f'{v:.2g}' for v in vals_b]} "
            f"include entries at the damped-bulk level (|T_p| <= 1) — some wanted "
            f"eigenvalues likely lie OUTSIDE the amplified mu-band; raise mu to "
            f"cover the wanted spread (mu={mu:g}), raise degree for more "
            f"amplification, or lower num_eigs (check info['residuals'])",
            BandCoverageWarning,
            stacklevel=2,
        )
    # ``theta`` is already in engine order (best first: ascending when
    # minimizing, descending when maximizing — EigenPairManager semantics).
    vals = [float(t) for t in theta]
    info = {
        "iteration_counts": list(eng.iteration_counts),
        "filter_degree": degree,
        "mu": mu,
        "interval": (lo, hi),
        "residuals": res,
        "matvecs": int(sum(eng.iteration_counts)) * degree * max(int(eng.block_size), 1),
    }
    if precise:
        # Values from the analytic inverse of the df-accurate B Ritz
        # values (best-first manager order = engine value order on the
        # A side).  theta stays in info as the mu-grade cross-check; a
        # disagreement beyond the mu budget means the pairing broke
        # (bulk-level value, unresolved cluster) — warn and keep the
        # RR value for that entry.
        lam = np.asarray(fop.invert_value(vals_b[:num_eigs]), np.float64)
        info["rr_values"] = list(vals)
        bad = [
            i for i in range(len(lam))
            if not np.isfinite(lam[i]) or abs(lam[i] - vals[i]) > 4.0 * mu
        ]
        if bad:
            from ..diagnostics import AccuracyWarning

            warnings.warn(
                f"filtered_lanczos(precise=True): inverse-map values at indices "
                f"{bad} disagree with the Rayleigh-Ritz values beyond the mu "
                f"budget (or fell below the bulk ceiling) — returning the RR "
                f"values there; raise degree or tighten the window",
                AccuracyWarning,
                stacklevel=2,
            )
            for i in bad:
                lam[i] = vals[i]
        vals = lam
    if refine_vectors is None:
        refine_vectors = precise
    if refine_vectors:
        # Tighten the refinement band around the (near-exact) returned
        # values: the solve band holds ~(16x)^0.5 levels, and an IN-band
        # non-target level is the slow-decay contaminant (depth-ratio
        # decay only).  Cutting the band at max target depth + 0.8x the
        # observed target spacing usually pushes the next level OUTSIDE,
        # where it gets the full band/damp separation; degenerate targets
        # (zero spacing) keep a 1.3x-depth band.  min() against the solve
        # mu means a loose user window only forgoes the speedup.
        vals_arr = np.asarray(vals, np.float64)
        depth_max = float((hi - np.min(vals_arr)) if find_maximum
                          else (np.max(vals_arr) - lo))
        gaps = np.diff(np.sort(vals_arr))
        gap_est = float(np.max(gaps)) if gaps.size else 0.0
        mu_ref = float(mu)
        if depth_max > 0:
            mu_ref = min(mu_ref, depth_max + max(0.8 * gap_est, 0.3 * depth_max))
        fop_ref = _refine_filter(op, lo, hi, mu_ref, find_maximum)
        refined = _refine_vectors_df(op, fop_ref, vecs_out, find_maximum, hi - lo)
        if refined is not None:
            theta_r, X64, res_r, sweeps = refined
            vecs_out = X64
            res = res_r
            info["residuals"] = res_r
            info["refine_sweeps"] = sweeps
            info["rr_values_refined"] = [float(t) for t in theta_r]
            # Refined RR values carry err ~ res^2/gap — at the df-floor
            # residuals this beats BOTH the coarse mu-grade values and the
            # inverse map (whose accuracy needs the B Ritz value itself to
            # have converged: a noise-seeded degenerate copy can pass the
            # residual gate with its B value still ~1e-6 off — measured on
            # the 2x3 embedded Hermitian solve).  Adopt per entry when the
            # measured residual supports it.
            if precise:
                info["inverse_map_values"] = [float(v) for v in np.asarray(vals)]
            scale = max(1.0, float(np.max(np.abs(theta_r))))
            vals = np.asarray(vals, np.float64).copy()
            for i in range(len(theta_r)):
                if res_r[i] <= 1e-8 * scale:
                    vals[i] = theta_r[i]
    return np.asarray(vals), vecs_out, info
