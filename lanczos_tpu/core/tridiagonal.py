"""Tridiagonal eigensolvers (the reference's L3 layer).

Reference counterparts:
* implicit-shift QR:  include/lambda_lanczos/lambda_lanczos_tridiagonal_impl.hpp:181-343
* Sturm bisection:    include/lambda_lanczos/lambda_lanczos_tridiagonal_impl.hpp:22-134
* LAPACK ?stev:       include/lambda_lanczos/lambda_lanczos_tridiagonal_lapack.hpp:22-88

Like the reference, the solver layer is a swappable backend behind one
interface (reference selects by compile flags, lambda_lanczos_tridiagonal.hpp:4-20;
we select at runtime):

``host`` backends (numpy in / numpy out, always float64 — the m x m problem is
tiny relative to the n-dimensional matvec, so full double precision here is
free and is what lets the f32 device build match the reference's 1e-12..1e-14
eigenvalue tolerances):

* ``lapack`` — scipy's ``eigh_tridiagonal``/``eigh`` (LAPACK stev/steqr).
* ``native`` — the C++ implicit-shift QR in lanczos_tpu/native (ctypes), the
  analogue of the reference's self-contained impl backend.
* ``numpy``  — densify + ``numpy.linalg.eigh`` (always available fallback).

``device`` backend (jit-friendly, used inside the fused `lax.while_loop`
Lanczos engine where a host round-trip per iteration would stall the device):

* :func:`extremal_eigenvalues_device` — vectorized Sturm-count bisection for
  the ``nroot`` smallest/largest eigenvalues with a *dynamic* active size on a
  *static* buffer, the shape discipline XLA needs.

Eigenvector layout matches the reference convention: ``vecs[k, :]`` is the
k-th eigenvector (tridiagonal_impl.hpp:177-179), eigenvalues ascending
(tridiagonal_impl.hpp:340).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "eigh_tridiagonal_host",
    "eigvals_tridiagonal_host",
    "extremal_eigenvalues_device",
    "extremal_eigenvalues_device_df",
    "eigenvectors_backward_device",
    "set_default_host_backend",
    "unconverged_total",
]


def unconverged_total() -> int:
    """Accumulated count of small-solve blocks that hit the native QL
    iteration cap (reference's forced-break count, tridiagonal_impl.hpp:342).
    api.run() snapshots the delta into RunStats."""
    mod = _native_module()
    return mod.consume_unconverged() if mod is not None else 0

_DEFAULT_HOST_BACKEND = "auto"


def set_default_host_backend(name: str) -> None:
    """Set the process-wide default host backend ('auto', 'lapack', 'native',
    'numpy')."""
    global _DEFAULT_HOST_BACKEND
    if name not in ("auto", "lapack", "native", "numpy", "bisect"):
        raise ValueError(f"unknown tridiagonal backend {name!r}")
    _DEFAULT_HOST_BACKEND = name


def _resolve_backend(backend: str | None) -> str:
    backend = backend or _DEFAULT_HOST_BACKEND
    if backend != "auto":
        return backend
    if _native_available():
        return "native"
    try:
        import scipy.linalg  # noqa: F401

        return "lapack"
    except Exception:  # pragma: no cover
        return "numpy"


@functools.cache
def _native_module():
    try:
        from ..native import host_kernels

        return host_kernels if host_kernels.available() else None
    except Exception:
        return None


def _native_available() -> bool:
    return _native_module() is not None


def eigh_tridiagonal_host(alpha, beta, *, eigvals_only: bool = False, backend: str | None = None):
    """Eigen-decompose the symmetric tridiagonal (diag=alpha, offdiag=beta).

    Returns ``(eigvals,)`` if ``eigvals_only`` else ``(eigvals, eigvecs)``
    with ``eigvecs[k]`` the k-th eigenvector, eigenvalues ascending.
    """
    alpha = np.asarray(alpha, dtype=np.float64).reshape(-1)
    beta = np.asarray(beta, dtype=np.float64).reshape(-1)
    m = alpha.shape[0]
    if beta.shape[0] not in (max(m - 1, 0), m):
        raise ValueError(f"beta must have length m-1 (or m with a trailing slot), got {beta.shape[0]} for m={m}")
    beta = beta[: m - 1]

    if m == 0:
        raise ValueError("empty tridiagonal matrix")
    if m == 1:
        if eigvals_only:
            return (alpha.copy(),)
        return alpha.copy(), np.ones((1, 1), dtype=np.float64)

    backend = _resolve_backend(backend)
    if backend == "bisect":
        # Bisection eigenpairs: Sturm-count eigenvalues + backward-recurrence
        # eigenvectors (reference tridiagonal_impl.hpp:93-134).  Native C++
        # when built; numpy fallback otherwise.
        mod = _native_module()
        if mod is not None:
            vals, vecs = mod.tridiagonal_eigh_bisect(alpha, beta, 0, m)
            if eigvals_only:
                return (vals,)
            return vals, vecs
        # numpy fallback: pin a CONCRETE inner backend — backend=None would
        # re-resolve to the process default and recurse forever when that
        # default is 'bisect' itself (set_default_host_backend('bisect')
        # with no compiled extension).
        (vals,) = eigh_tridiagonal_host(alpha, beta, eigvals_only=True, backend="numpy")
        if eigvals_only:
            return (vals,)
        vecs = np.stack(
            [
                _inverse_iter_np(
                    alpha, beta, lam,
                    _inverse_iter_np(alpha, beta, lam, _eigvec_backward_np(alpha, beta, lam)),
                )
                for lam in vals
            ]
        )
        return vals, vecs
    if backend == "native":
        mod = _native_module()
        if mod is None:
            raise RuntimeError("native tridiagonal backend requested but the C++ extension is not built")
        return mod.tridiagonal_eigh(alpha, beta, eigvals_only=eigvals_only)

    if backend == "lapack":
        from scipy.linalg import eigh_tridiagonal as _stev

        if eigvals_only:
            w = _stev(alpha, beta, eigvals_only=True)
            return (np.asarray(w),)
        w, z = _stev(alpha, beta)
        # scipy returns column eigenvectors; reference layout is row-per-vector
        # (tridiagonal_impl.hpp:177-179, mirrored by the LAPACK backend's
        # unpack at lambda_lanczos_tridiagonal_lapack.hpp:63-69).
        return np.asarray(w), np.ascontiguousarray(z.T)

    # numpy fallback: densify (m is the Krylov dimension — small).
    t = np.diag(alpha)
    if m > 1:
        t += np.diag(beta, 1) + np.diag(beta, -1)
    if eigvals_only:
        return (np.linalg.eigvalsh(t),)
    w, z = np.linalg.eigh(t)
    return w, np.ascontiguousarray(z.T)


def eigvals_tridiagonal_host(alpha, beta, *, backend: str | None = None):
    """Eigenvalues only (ascending)."""
    return eigh_tridiagonal_host(alpha, beta, eigvals_only=True, backend=backend)[0]


def extremal_eigvals_host(alpha, beta, nroot: int, find_maximum: bool, *, backend: str | None = None):
    """The ``nroot`` smallest (or largest) eigenvalues, cheaply.

    The per-iteration convergence test (reference lambda_lanczos.hpp:267-277)
    only consumes the extremal roots, so computing the full spectrum every
    iteration is wasted work once m grows.  The native Sturm bisection
    (host_kernels.cpp lt_tridiagonal_eigvals_bisect, counterpart of
    tridiagonal_impl.hpp:63-88) gets exactly the wanted index range in
    O(nroot * m * bisect_iters); falls back to the full solve otherwise.

    Returns ``out[i]`` = i-th largest eigenvalue when ``find_maximum`` else
    i-th smallest (the order the convergence test consumes).
    """
    alpha = np.asarray(alpha, dtype=np.float64).reshape(-1)
    beta = np.asarray(beta, dtype=np.float64).reshape(-1)[: max(alpha.shape[0] - 1, 0)]
    m = alpha.shape[0]
    k = min(int(nroot), m)

    resolved = _resolve_backend(backend)
    if resolved == "native" and m > 1:
        mod = _native_module()
        if mod is not None:
            first = m - k if find_maximum else 0
            vals = mod.tridiagonal_eigvals_bisect(alpha, beta, first, k)  # ascending
            return vals[::-1].copy() if find_maximum else vals

    full = eigvals_tridiagonal_host(alpha, beta, backend=backend)
    return full[::-1][:k].copy() if find_maximum else full[:k]


def _eigvec_backward_np(alpha, beta, lam):
    """Backward three-term-recurrence eigenvector (numpy; mirrors the native
    lt_tridiagonal_eigvec_backward contract)."""
    m = alpha.shape[0]
    eps = np.finfo(np.float64).eps
    v = np.zeros(m, np.float64)
    v[m - 1] = 1.0
    if m > 1:
        b = beta[m - 2] if beta[m - 2] != 0 else eps
        v[m - 2] = (lam - alpha[m - 1]) / b
        for k in range(m - 2, 0, -1):
            bkm1 = beta[k - 1] if beta[k - 1] != 0 else eps
            w = ((lam - alpha[k]) * v[k] - beta[k] * v[k + 1]) / bkm1
            if abs(w) > 1e100:
                v[k:] /= abs(w)
                w = np.sign(w) * 1.0
            v[k - 1] = w
    nrm = np.linalg.norm(v)
    return v / nrm if nrm > 0 else v


def _inverse_iter_np(alpha, beta, lam, v):
    """One inverse-iteration refinement (numpy fallback: dense solve with a
    pivot-floor perturbation; m is the small Krylov dimension so O(m^3) is
    irrelevant here — the native path does the O(m) pivoted solve)."""
    m = alpha.shape[0]
    t = np.diag(alpha) + (np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1) if m > 1 else 0)
    scale = max(np.max(np.abs(alpha)), np.max(np.abs(beta)) if beta.size else 0.0, 1.0)
    shift = lam + np.finfo(np.float64).eps * scale
    try:
        w = np.linalg.solve(t - shift * np.eye(m), v)
    except np.linalg.LinAlgError:
        return v
    nrm = np.linalg.norm(w)
    return w / nrm if (nrm > 0 and np.isfinite(nrm)) else v


# ---------------------------------------------------------------------------
# Device (jittable) Sturm bisection
# ---------------------------------------------------------------------------


def _sturm_counts(cs, alpha, beta_sq, size):
    """Eigenvalue counts below each point of ``cs`` — log-depth, batched.

    The reference Sturm count (tridiagonal_impl.hpp:22-43) is the sequential
    ratio recurrence ``q_i = (a_i - c) - b2_{i-1}/q_{i-1}``; on a device a
    sequential scalar scan is latency-bound.  Equivalent parallel form: the
    leading principal minors obey the *linear* two-term recurrence
    ``d_k = (a_{k-1} - c) d_{k-1} - b2_{k-2} d_{k-2}``, i.e.
    ``[d_k, d_{k-1}] = M_k [d_{k-1}, d_{k-2}]`` with
    ``M_k = [[a_{k-1}-c, -b2_{k-2}], [1, 0]]``, so all minors come from one
    ``associative_scan`` of 2x2 matrix products (log2(cap) batched einsums).
    Each partial product is rescaled by its max-abs entry — a positive
    scalar, so the minor *signs* (all the count needs) are exact.
    Rows past ``size`` use the identity, contributing no sign changes.

    cs: (K,) evaluation points; returns (K,) int32 counts.
    """
    rdtype = alpha.dtype
    tiny = np.finfo(np.dtype(rdtype)).tiny
    cap = alpha.shape[0]
    i = jnp.arange(cap)
    active = (i < size)[:, None]  # (cap, 1)

    a_c = alpha[:, None] - cs[None, :]  # (cap, K)
    b2 = jnp.concatenate([jnp.zeros((1,), rdtype), beta_sq[: cap - 1]])  # b2[i] couples rows i-1, i
    zeros = jnp.zeros_like(a_c)
    ones = jnp.ones_like(a_c)
    m00 = jnp.where(active, a_c, ones)
    m01 = jnp.where(active, -jnp.broadcast_to(b2[:, None], a_c.shape), zeros)
    m10 = jnp.where(active, ones, zeros)
    m11 = jnp.where(active, zeros, ones)
    mats = jnp.stack(
        [jnp.stack([m00, m01], axis=-1), jnp.stack([m10, m11], axis=-1)], axis=-2
    )  # (cap, K, 2, 2)

    def combine(x, y):
        # z = y @ x (prefix: apply x first), written as elementwise ops: an
        # accelerator's default f32 matmul may use reduced-precision passes,
        # and that fuzz in the minor signs stalls the bisection at ~1e-3.
        # The elementwise form is exact f32.
        a, bq = y[..., 0, 0], y[..., 0, 1]
        c, d = y[..., 1, 0], y[..., 1, 1]
        e, f = x[..., 0, 0], x[..., 0, 1]
        g, h = x[..., 1, 0], x[..., 1, 1]
        z = jnp.stack(
            [
                jnp.stack([a * e + bq * g, a * f + bq * h], axis=-1),
                jnp.stack([c * e + d * g, c * f + d * h], axis=-1),
            ],
            axis=-2,
        )
        scale = jnp.max(jnp.abs(z), axis=(-2, -1), keepdims=True)
        return z / jnp.maximum(scale, tiny)

    pref = jax.lax.associative_scan(combine, mats, axis=0)  # (cap, K, 2, 2)
    # [d_k, d_{k-1}] = pref_k @ [d_0, d_{-1}] = pref_k @ [1, 0]
    d_k = pref[..., 0, 0]
    d_km1 = pref[..., 1, 0]
    # q_k = d_k / d_{k-1} < 0  <=>  sign change.  An exactly-zero leading
    # minor takes the reference's +eps substitution semantics
    # (tridiagonal_impl.hpp:37-39): treat sign(d_{k-1})==0 as +1 so the next
    # ratio -b2/eps < 0 is counted instead of silently dropping a root.
    s_km1 = jnp.sign(d_km1)
    s_km1 = jnp.where(s_km1 == 0, jnp.ones_like(s_km1), s_km1)
    neg = (jnp.sign(d_k) * s_km1) < 0
    return jnp.sum(neg & (i < size)[:, None], axis=0).astype(jnp.int32)


def extremal_eigenvalues_device(alpha, beta, size, nroot: int, find_maximum: bool, *, iters: int | None = None, points: int = 15):
    """The ``nroot`` smallest (or largest) eigenvalues of the leading
    ``size`` x ``size`` tridiagonal block, fully on device.

    MULTIsection per root over the Gershgorin-style interval
    ``|lambda| <= m_norm(alpha) + 2 m_norm(beta)``
    (reference: tridiagonal_impl.hpp:52-58, :63-88).  The root search is
    latency-bound on a device: each round is a batched log-depth Sturm
    minor scan of sequential steps and the rounds are sequential, so plain
    bisection (46 rounds for f32) can dominate the fused engine's
    iteration.  Evaluating ``points``
    equally spaced cuts per root per round shrinks the interval by
    (points+1)x at essentially the SAME per-round cost (the Sturm scan is
    already batched over evaluation points; the extra lanes are free), so
    points=15 needs only ceil(46/4)=12 rounds — measured ~3.5x faster with
    bit-identical bracketing guarantees (counts are monotone in the
    evaluation point).

    ``iters`` is specified in equivalent bisection HALVINGS (default 46
    f32 / 110 f64); the round count is ``ceil(iters / log2(points+1))``.

    Returns an (nroot,) array ordered the way the Lanczos convergence test
    consumes it (reference: lambda_lanczos.hpp:267-277): ``result[i]`` is the
    i-th largest eigenvalue when ``find_maximum`` else the i-th smallest.
    Roots with index >= ``size`` are duplicates of the closest valid root
    (callers mask them out of the convergence test).
    """
    rdtype = alpha.dtype
    if iters is None:
        iters = 110 if np.dtype(rdtype) == np.float64 else 46
    rounds = int(np.ceil(iters / np.log2(points + 1)))
    cap = alpha.shape[0]
    mask = (jnp.arange(cap) < size).astype(rdtype)
    beta_mask = (jnp.arange(cap) < size - 1).astype(rdtype)
    beta_sq = (beta * beta_mask) ** 2
    limit = jnp.sum(jnp.abs(alpha) * mask) + 2.0 * jnp.sum(jnp.abs(beta * beta_mask))

    # Target eigenvalue indices (ascending order index m): i-th largest is
    # size-1-i; i-th smallest is i.  Clamp into the valid range.
    idx = jnp.arange(nroot)
    if find_maximum:
        m_indices = jnp.clip(size - 1 - idx, 0, None)
    else:
        m_indices = jnp.minimum(idx, size - 1)

    fracs = (jnp.arange(1, points + 1, dtype=rdtype) / (points + 1))[:, None]  # (P, 1)

    # All roots refine together: one batched log-depth Sturm evaluation over
    # all P*nroot points per round instead of a per-root sequential scan.
    def body(_, lu):
        lower, upper = lu  # (nroot,) each
        pts = jnp.clip(lower[None, :] + fracs * (upper - lower)[None, :], lower, upper)
        smaller = _sturm_counts(pts.reshape(-1), alpha, beta_sq, size).reshape(points, nroot)
        ge = smaller >= m_indices[None, :] + 1  # target root lies below pts
        # Counts are monotone in the point, so the bracket is the smallest
        # ge point (new upper) and the largest non-ge point (new lower).
        new_upper = jnp.min(jnp.where(ge, pts, upper[None, :]), axis=0)
        new_lower = jnp.max(jnp.where(~ge, pts, lower[None, :]), axis=0)
        return new_lower, new_upper

    init = (jnp.full((nroot,), -limit, rdtype), jnp.full((nroot,), limit, rdtype))
    lower, _ = jax.lax.fori_loop(0, rounds, body, init)
    return lower


def _sturm_counts_df(cs_df, alpha_df, bsq_df, size):
    """Double-float Sturm counts: the associative minor scan of
    :func:`_sturm_counts` with every 2x2 entry carried as an (hi, lo) f32
    pair, so eigenvalue bisection resolves to ~2^-46 relative in pure f32
    arithmetic.  Rescaling uses the nearest power of two of the hi word —
    exact division for both words, so the minor signs stay exact.

    cs_df: ((K,), (K,)) evaluation points; alpha_df: ((cap,), (cap,));
    bsq_df: df beta^2 (the engine stores ||w||^2 words directly).
    Returns (K,) int32 counts of eigenvalues < c.
    """
    from . import df64

    rdtype = alpha_df[0].dtype
    tiny = np.finfo(np.dtype(rdtype)).tiny
    cap = alpha_df[0].shape[0]
    i = jnp.arange(cap)
    active = (i < size)[:, None]  # (cap, 1)

    def bc(x):
        return jnp.broadcast_to(x, (cap, cs_df[0].shape[0]))

    a_c = df64.df_sub(
        (alpha_df[0][:, None] + jnp.zeros_like(cs_df[0])[None, :], bc(alpha_df[1][:, None])),
        (bc(cs_df[0][None, :]), bc(cs_df[1][None, :])),
    )
    b2_hi = jnp.concatenate([jnp.zeros((1,), rdtype), bsq_df[0][: cap - 1]])
    b2_lo = jnp.concatenate([jnp.zeros((1,), rdtype), bsq_df[1][: cap - 1]])
    zeros = jnp.zeros_like(a_c[0])
    ones = jnp.ones_like(a_c[0])

    def sel(cond, x, y):
        return (jnp.where(cond, x[0], y[0]), jnp.where(cond, x[1], y[1]))

    m00 = sel(active, a_c, (ones, zeros))
    m01 = sel(active, (bc(-b2_hi[:, None]), bc(-b2_lo[:, None])), (zeros, zeros))
    m10 = sel(active, (ones, zeros), (zeros, zeros))
    m11 = sel(active, (zeros, zeros), (ones, zeros))
    # Pack as two stacked (cap, K, 2, 2) arrays (hi, lo).
    mats_hi = jnp.stack(
        [jnp.stack([m00[0], m01[0]], axis=-1), jnp.stack([m10[0], m11[0]], axis=-1)], axis=-2
    )
    mats_lo = jnp.stack(
        [jnp.stack([m00[1], m01[1]], axis=-1), jnp.stack([m10[1], m11[1]], axis=-1)], axis=-2
    )

    def combine(x, y):
        # z = y @ x in df arithmetic, elementwise (VPU-exact).
        xh, xl = x
        yh, yl = y

        def ent(mat, r, c):
            return (mat[0][..., r, c], mat[1][..., r, c])

        def muladd(a, b, c, d):
            return df64.df_add(df64.df_mul(a, b), df64.df_mul(c, d))

        z00 = muladd(ent(y, 0, 0), ent(x, 0, 0), ent(y, 0, 1), ent(x, 1, 0))
        z01 = muladd(ent(y, 0, 0), ent(x, 0, 1), ent(y, 0, 1), ent(x, 1, 1))
        z10 = muladd(ent(y, 1, 0), ent(x, 0, 0), ent(y, 1, 1), ent(x, 1, 0))
        z11 = muladd(ent(y, 1, 0), ent(x, 0, 1), ent(y, 1, 1), ent(x, 1, 1))
        zh = jnp.stack([jnp.stack([z00[0], z01[0]], axis=-1), jnp.stack([z10[0], z11[0]], axis=-1)], axis=-2)
        zl = jnp.stack([jnp.stack([z00[1], z01[1]], axis=-1), jnp.stack([z10[1], z11[1]], axis=-1)], axis=-2)
        # Power-of-two rescale: exact for both words, positive -> signs exact.
        mag = jnp.max(jnp.abs(zh), axis=(-2, -1), keepdims=True)
        scale = jnp.exp2(jnp.floor(jnp.log2(jnp.maximum(mag, tiny))))
        return zh / scale, zl / scale

    pref_hi, _ = jax.lax.associative_scan(combine, (mats_hi, mats_lo), axis=0)
    d_k = pref_hi[..., 0, 0]
    d_km1 = pref_hi[..., 1, 0]
    s_km1 = jnp.sign(d_km1)
    s_km1 = jnp.where(s_km1 == 0, jnp.ones_like(s_km1), s_km1)
    neg = (jnp.sign(d_k) * s_km1) < 0
    return jnp.sum(neg & (i < size)[:, None], axis=0).astype(jnp.int32)


def extremal_eigenvalues_device_df(alpha_df, bsq_df, size, nroot: int, find_maximum: bool, *, iters: int = 96):
    """df64 variant of :func:`extremal_eigenvalues_device`: bisection over
    double-float interval endpoints with df Sturm counts, resolving the
    wanted extremal eigenvalues to ~2^-46 relative — the convergence test the
    fused engine's ``precise_vectors`` mode needs (an f32 Sturm saturates at
    1e-7 and would either stop early or never settle).

    Returns ((nroot,) hi, (nroot,) lo).
    """
    from . import df64

    rdtype = alpha_df[0].dtype
    cap = alpha_df[0].shape[0]
    mask = (jnp.arange(cap) < size).astype(rdtype)
    bmask = (jnp.arange(cap) < size - 1).astype(rdtype)
    beta_abs = jnp.sqrt(jnp.maximum(bsq_df[0] * bmask, 0.0))
    limit = jnp.sum(jnp.abs(alpha_df[0]) * mask) + 2.0 * jnp.sum(beta_abs) + 1.0

    idx = jnp.arange(nroot)
    if find_maximum:
        m_indices = jnp.clip(size - 1 - idx, 0, None)
    else:
        m_indices = jnp.minimum(idx, size - 1)

    # Multisection (see extremal_eigenvalues_device): P df evaluation points
    # per root per round shrink the bracket (P+1)x at ~the same latency as
    # one bisection round — the df Sturm scan is already batched over points.
    points = 15
    rounds = int(np.ceil(iters / np.log2(points + 1)))
    fracs = (jnp.arange(1, points + 1, dtype=rdtype) / (points + 1))[:, None]  # (P,1)
    zero2 = jnp.zeros((points, nroot), rdtype)

    def body(_, lu):
        lo_df, up_df = lu  # ((nroot,), (nroot,)) each
        width = df64.df_sub(up_df, lo_df)
        # pts = lo + frac * width, in df (frac exact dyadic k/16; the point
        # PLACEMENT rounding is harmless — counting and bracket update use
        # the same pts values, so the bracket invariant holds exactly).
        step_df = df64.df_mul((jnp.broadcast_to(width[0][None, :], zero2.shape),
                               jnp.broadcast_to(width[1][None, :], zero2.shape)),
                              (jnp.broadcast_to(fracs, zero2.shape), zero2))
        pts = df64.df_add((jnp.broadcast_to(lo_df[0][None, :], zero2.shape),
                           jnp.broadcast_to(lo_df[1][None, :], zero2.shape)), step_df)
        pts_flat = (pts[0].reshape(-1), pts[1].reshape(-1))
        smaller = _sturm_counts_df(pts_flat, alpha_df, bsq_df, size).reshape(points, nroot)
        ge = smaller >= m_indices[None, :] + 1  # target root lies below pts

        # Monotone counts: bracket = (largest non-ge point, smallest ge
        # point).  df select via the hi-word comparison after masking.
        big = jnp.asarray(np.finfo(np.dtype(rdtype)).max, rdtype)
        up_cand_hi = jnp.where(ge, pts[0], big)
        iu = jnp.argmin(up_cand_hi, axis=0)  # (nroot,)
        lo_cand_hi = jnp.where(ge, -big, pts[0])
        il = jnp.argmax(lo_cand_hi, axis=0)
        j = jnp.arange(nroot)
        any_ge = jnp.any(ge, axis=0)
        any_lt = jnp.any(~ge, axis=0)
        new_up = (jnp.where(any_ge, pts[0][iu, j], up_df[0]), jnp.where(any_ge, pts[1][iu, j], up_df[1]))
        new_lo = (jnp.where(any_lt, pts[0][il, j], lo_df[0]), jnp.where(any_lt, pts[1][il, j], lo_df[1]))
        return new_lo, new_up

    z = jnp.zeros((nroot,), rdtype)
    init = ((jnp.full((nroot,), -limit, rdtype), z), (jnp.full((nroot,), limit, rdtype), z))
    lower, _ = jax.lax.fori_loop(0, rounds, body, init)
    return lower


def eigenvectors_backward_device(alpha, beta, size, lams):
    """Eigenvectors of the leading ``size`` x ``size`` tridiagonal block for
    given (converged) eigenvalues ``lams`` — fully on device, jittable.

    The device counterpart of the reference's bisection eigenvector path
    (tridiagonal_impl.hpp:93-115): for each eigenvalue the backward three-term
    recurrence starting from the last row

        v[size-1] = 1
        v[k-1] = ((lam - alpha[k]) v[k] - beta[k] v[k+1]) / beta[k-1]

    expressed as a ``lax.scan`` over a *static* capacity with a dynamic
    active size, overflow handled by a carried log-scale (components are
    stored as ``u * exp(logscale)``; the final renormalization subtracts the
    running maximum, so graded eigenvectors underflow gracefully to 0 in the
    negligible entries instead of overflowing the recurrence).

    alpha: (cap,), beta: (cap,) (entries >= size-1 ignored), size: dynamic
    int, lams: (K,).  Returns (K, cap) rows, zero-padded past ``size`` and
    2-normalized.  Intended for well-separated converged Ritz values (the
    same caveat as the reference's recurrence).
    """
    rdtype = alpha.dtype
    cap = alpha.shape[0]
    eps = jnp.asarray(machine_eps_value(rdtype), rdtype)
    big = jnp.asarray(1e15 if np.dtype(rdtype) == np.float32 else 1e100, rdtype)

    def single(lam):
        def step(carry, j):
            u_prev, u_pp, ls = carry  # u_{j-1}, u_{j-2}, cumulative log-scale
            k = jnp.clip(size - j, 0, cap - 1)  # recurrence row index
            km1 = jnp.clip(size - 1 - j, 0, cap - 1)
            a_k = alpha[k]
            b_k = jnp.where(j == 1, jnp.zeros((), rdtype), beta[k])
            b_km1 = beta[km1]
            b_km1 = jnp.where(b_km1 == 0, eps, b_km1)
            w = ((lam - a_k) * u_prev - b_k * u_pp) / b_km1
            mag = jnp.abs(w)
            rescale = mag > big
            scale = jnp.where(rescale, 1.0 / jnp.maximum(mag, eps), jnp.ones((), rdtype))
            ls_new = ls + jnp.where(rescale, jnp.log(jnp.maximum(mag, eps)), jnp.zeros((), rdtype))
            w = w * scale
            u_prev_s = u_prev * scale
            active = j <= size - 1
            u_out = jnp.where(active, w, jnp.zeros((), rdtype))
            carry = (
                jnp.where(active, w, u_prev),
                jnp.where(active, u_prev_s, u_pp),
                jnp.where(active, ls_new, ls),
            )
            return carry, (u_out, jnp.where(active, ls_new, ls))

        init = (jnp.ones((), rdtype), jnp.zeros((), rdtype), jnp.zeros((), rdtype))
        _, (u_tail, ls_tail) = jax.lax.scan(step, init, jnp.arange(1, cap))
        u = jnp.concatenate([jnp.ones((1,), rdtype), u_tail])  # u_j, j = 0..cap-1
        ls = jnp.concatenate([jnp.zeros((1,), rdtype), ls_tail])
        # v[p] = u[size-1-p] * exp(ls[size-1-p] - ls_max) for p < size.
        p = jnp.arange(cap)
        jidx = jnp.clip(size - 1 - p, 0, cap - 1)
        in_range = p < size
        ls_p = jnp.where(in_range, ls[jidx], -jnp.inf)
        ls_max = jnp.max(ls_p)
        ls_max = jnp.where(jnp.isfinite(ls_max), ls_max, jnp.zeros((), rdtype))
        v = jnp.where(in_range, u[jidx] * jnp.exp(ls_p - ls_max), jnp.zeros((), rdtype))
        nrm = jnp.sqrt(jnp.sum(v * v))
        return v / jnp.maximum(nrm, eps)

    return jax.vmap(single)(jnp.asarray(lams, rdtype))


def machine_eps_value(dtype) -> float:
    return float(np.finfo(np.dtype(dtype)).eps)
