"""Block Lanczos eigensolver (an extension; no reference counterpart).

The reference resolves degenerate eigenvalues by *repeated deflated restarts*
(lambda_lanczos.hpp:330-366): each restart leaks into the degenerate subspace
through a fresh random vector.  On an accelerator a block method fits well:

* the hot op becomes a block matvec ``A @ [v_1..v_b]`` — an (n, b) matmul
  that reads the operator once instead of b bandwidth-bound matvecs,
* a block of size b captures eigenvalue multiplicity <= b in ONE Krylov
  build instead of b restarts,
* all reductions (block overlap A_k, reorthogonalization) are (m, n) x (n, b)
  matmuls — exactly the shapes XLA/GSPMD shards well.

Algorithm (standard block Lanczos with full reorthogonalization):
  W     = A U_k                      (block matvec)
  A_k   = U_k^H W                    (b x b, Hermitian)
  W     = W - U_k A_k - U_{k-1} B_{k-1}^H
  W     = reorth(W, all previous basis rows + deflated eigenvectors)
  U_{k+1}, B_k = QR(W)               (tall-skinny QR, b x b upper-tri B)
Convergence and Ritz extraction run on host float64 over the (k b x k b)
block-tridiagonal band matrix, mirroring the reference's per-iteration
eigenvalue test (lambda_lanczos.hpp:267-309) with the same relative-change
criterion; B_k rank collapse (diag(R) ~ 0) is the block analogue of beta
breakdown (:279-283).

Row-layout convention: a block is stored as (b, n) rows, and the Krylov
basis as a flat (cap*b, n) row buffer so reorthogonalization reuses the
masked CGS matmuls from :mod:`lanczos_tpu.core.linalg`.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import linalg
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from .lanczos import EigenPairManager, LanczosConfig, LanczosResult

__all__ = ["block_lanczos_iteration", "block_lanczos_run"]


def _block_matvec(op, u_rows):
    """Apply the operator to every row of a (b, n) block."""
    return jax.vmap(op.matvec)(u_rows)


def _orthonormalize_block(rows, defl, defl_mask, basis, live_rows):
    """Orthonormalize the b rows against deflated eigenvectors, the first
    ``live_rows`` Krylov basis rows, and each other; rows with no surviving
    component become ZERO (never arbitrary).

    This is the safety pass that plain QR lacks: QR of a rank-deficient
    block fills the null directions with *arbitrary* orthonormal columns
    that may overlap the deflation space or the basis, silently breaking
    the restart orthogonality (the reference's scalar analogue keeps
    orthogonality by construction, lambda_lanczos.hpp:231-234, :259-260).
    Zero rows are inert downstream: zero matvec, zero couplings, and the
    generalized Rayleigh-Ritz drops them via the S ~ 0 canonical cut.

    Basis reorthogonalization is live-rows BCGS on accelerators (HBM
    traffic scales with the filled row count, not the buffer capacity);
    masked CGS on CPU — same dispatch as the hybrid engine.
    """
    b = rows.shape[0]
    rdtype = np.dtype(real_dtype(rows.dtype))
    tol = jnp.asarray(machine_eps(rdtype) * 100.0, rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    out = []
    norms = []
    for j in range(b):  # b is small and static: unrolled under jit
        v = rows[j]
        v = linalg.orthogonalize_cgs2(v, defl, defl_mask)
        v = linalg.orthogonalize_bcgs_dyn(v, basis, live_rows)
        for u in out:
            v = v - linalg.inner_prod(u, v) * u
        nrm = linalg.norm(v).astype(rdtype)
        live = nrm > tol
        out.append(jnp.where(live, v / jnp.maximum(nrm, tiny), jnp.zeros_like(v)))
        norms.append(jnp.where(live, nrm, jnp.asarray(0, rdtype)))
    return jnp.stack(out), jnp.stack(norms)


@functools.partial(jax.jit, donate_argnums=(1,), static_argnames=("passes",))
def _block_step(op, basis, defl, defl_mask, u_k, u_km1, b_km1, k, offset, passes=2):
    """One block iteration; returns (basis', u_next, a_k, b_k, rdiag).

    basis: (cap*b, n) flat row buffer; rows [0, k*b) are valid.
    u_k/u_km1: (b, n) current/previous blocks; b_km1: (b, b) previous R.
    """
    dtype = basis.dtype
    rdtype = np.dtype(real_dtype(dtype))
    b = u_k.shape[0]

    w = _block_matvec(op, u_k)
    w = w + offset.astype(rdtype) * u_k

    # Block overlap A_k[i, j] = <u_i, w_j> (Hermitian up to rounding).
    prec = jax.lax.Precision.HIGHEST
    uc = jnp.conj(u_k) if is_complex_dtype(dtype) else u_k
    a_k = jnp.matmul(uc, w.T, precision=prec)

    w = w - jnp.matmul(a_k.T, u_k, precision=prec)
    w = w - jnp.matmul(jnp.conj(b_km1), u_km1, precision=prec)  # B_{k-1}^H as rows

    # Full reorthogonalization: deflated eigenvectors, then the live basis
    # rows (BCGS on accelerators — traffic ∝ filled rows, not capacity).
    def orth_one(v):
        v = linalg.orthogonalize_cgs2(v, defl, defl_mask, passes=passes)
        return linalg.orthogonalize_bcgs_dyn(v, basis, k * b, passes=passes)

    w = jax.vmap(orth_one)(w)

    # Tall-skinny QR: W^T = Q R with Q (n, b) orthonormal columns.
    q, r = jnp.linalg.qr(w.T, mode="reduced")
    basis = jax.lax.dynamic_update_slice_in_dim(basis, u_k, k * b, axis=0)

    # Safety orthonormalization (see _orthonormalize_block): QR's arbitrary
    # null-space columns are replaced by zero rows; live-row norms are the
    # rank signal (|diag R| up to rounding).
    u_next, live_norms = _orthonormalize_block(q.T.astype(dtype), defl, defl_mask, basis, (k + 1) * b)
    return basis, u_next, a_k, r.astype(dtype), live_norms


def _band_matrix(a_blocks, b_blocks, dtype=np.complex128):
    """Assemble the (m b x m b) Hermitian band matrix on host."""
    m = len(a_blocks)
    b = a_blocks[0].shape[0]
    t = np.zeros((m * b, m * b), dtype=dtype)
    for k, a in enumerate(a_blocks):
        blk = np.asarray(a, dtype=dtype)
        blk = (blk + blk.conj().T) / 2
        t[k * b : (k + 1) * b, k * b : (k + 1) * b] = blk
    for k, r in enumerate(b_blocks):  # couples block k and k+1
        rb = np.asarray(r, dtype=dtype)
        t[(k + 1) * b : (k + 2) * b, k * b : (k + 1) * b] = rb
        t[k * b : (k + 1) * b, (k + 1) * b : (k + 2) * b] = rb.conj().T
    return t


@jax.jit
def _repair_block(u_next, defl, defl_mask, basis, live_rows, fresh, deficient):
    """Replace dead rows of a block with fresh random directions and re-run
    the safety orthonormalization.  Replacement directions carry zero band
    coupling (their true residual was ~0) — "restart inside the block", the
    block analogue of the reference's deflated random restarts
    (lambda_lanczos.hpp:231-234).  Rows that stay dead (space exhausted)
    remain zero."""
    mixed = jnp.where(deficient[:, None], fresh.astype(u_next.dtype), u_next)
    return _orthonormalize_block(mixed, defl, defl_mask, basis, live_rows)


def block_lanczos_iteration(op, v0_block, nroot: int, defl, defl_mask, cfg: LanczosConfig, block_size: int, rng=None):
    """One deflated block restart; same return contract as
    :func:`lanczos_tpu.solvers.lanczos.lanczos_iteration`."""
    dtype = np.dtype(v0_block.dtype)
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    b = int(block_size)
    max_blocks = max(min(cfg.max_iteration, -(-n // b)), 1)
    host_dtype = np.complex128 if is_complex_dtype(dtype) else np.float64
    # Fresh entropy by default: a fixed seed replays the same repair
    # directions every deflated restart (the CLAUDE.md fixed-seed pathology).
    rng = rng if rng is not None else np.random.default_rng()

    basis = jnp.zeros((max_blocks * b, n), dtype)

    # Orthonormalize the start block against accepted pairs; repair rank
    # deficiency (e.g. the fixed-seed initializer returns identical rows)
    # with independent random directions.
    u_k, live = _orthonormalize_block(v0_block, defl, defl_mask, basis, 0)
    if np.any(np.asarray(jax.device_get(live)) < 0.5):
        fresh = jnp.asarray(rng.uniform(-1, 1, (b, n)), dtype)
        if is_complex_dtype(dtype):
            fresh = fresh + 1j * jnp.asarray(rng.uniform(-1, 1, (b, n)), dtype)
        u_k, live = _repair_block(
            u_k, defl, defl_mask, basis, 0, fresh,
            jnp.asarray(np.asarray(jax.device_get(live)) < 0.5),
        )

    u_km1 = jnp.zeros((b, n), dtype)
    b_km1 = jnp.zeros((b, b), dtype)

    a_blocks: list[np.ndarray] = []
    b_blocks: list[np.ndarray] = []
    pevs: np.ndarray | None = None
    itern = max_blocks

    offset = jnp.asarray(cfg.eigenvalue_offset, np.dtype(rdtype))
    for k in range(max_blocks):
        basis, u_next, a_k, r_k, rdiag = _block_step(
            op, basis, defl, defl_mask, u_k, u_km1, b_km1, k, offset, passes=int(cfg.reorth_passes)
        )
        a_blocks.append(np.asarray(jax.device_get(a_k)))
        rd = np.asarray(jax.device_get(rdiag))

        t = _band_matrix(a_blocks, b_blocks, host_dtype)
        evs_all = np.linalg.eigvalsh(t)
        m_want = min(nroot, t.shape[0])
        evs = evs_all[::-1][:m_want] if cfg.find_maximum else evs_all[:m_want]

        deficient = rd < 0.5  # live-norm signal from the safety pass
        if np.any(deficient):
            if (k + 1) * b >= n:  # basis spans the whole space: exact exit
                itern = k + 1
                break
            # Krylov direction exhausted but space remains: repair the block
            # with fresh random directions (zeroing their B coupling).
            fresh = jnp.asarray(rng.uniform(-1, 1, (b, n)), dtype)
            if is_complex_dtype(dtype):
                fresh = fresh + 1j * jnp.asarray(rng.uniform(-1, 1, (b, n)), dtype)
            u_next, live2 = _repair_block(
                u_next, defl, defl_mask, basis, (k + 1) * b, fresh, jnp.asarray(deficient)
            )
            r_k = jnp.where(jnp.asarray(deficient)[:, None], jnp.zeros_like(r_k), r_k)
            if np.all(np.asarray(jax.device_get(live2)) < 0.5):
                itern = k + 1  # nothing left to explore
                break
        if pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            diffs = np.abs(evs - pevs)
            tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
            if np.all(diffs < tol):
                itern = k + 1
                break
        pevs = evs

        b_blocks.append(np.asarray(jax.device_get(r_k)))
        u_km1, u_k, b_km1 = u_k, u_next, r_k

    # Ritz extraction: generalized Rayleigh-Ritz over the stored rows.
    #
    # The band-matrix Ritz values drive the *convergence test* above (cheap,
    # reference semantics), but the final extraction recomputes T = V A V^H
    # and S = V V^H directly: after a rank repair the basis can contain
    # directions whose orthogonality against everything is not guaranteed,
    # and the generalized problem with canonical orthogonalization (drop
    # S-eigenvalues ~ 0) is exact for any spanning set.  Costs one extra
    # block-matvec sweep per restart.
    m_rows = len(a_blocks) * b
    v_rows = basis[:m_rows]
    w_rows = _block_matvec(op, v_rows)
    if cfg.eigenvalue_offset:
        w_rows = w_rows + jnp.asarray(cfg.eigenvalue_offset, np.dtype(rdtype)).astype(dtype) * v_rows
    _hp = jax.lax.Precision.HIGHEST  # default f32 matmul may be TF32 on the GPU
    if is_complex_dtype(dtype):
        t_small = np.asarray(jax.device_get(jnp.matmul(jnp.conj(v_rows), w_rows.T, precision=_hp)), host_dtype)
        s_small = np.asarray(jax.device_get(jnp.matmul(jnp.conj(v_rows), v_rows.T, precision=_hp)), host_dtype)
    else:
        t_small = np.asarray(jax.device_get(jnp.matmul(v_rows, w_rows.T, precision=_hp)), host_dtype)
        s_small = np.asarray(jax.device_get(jnp.matmul(v_rows, v_rows.T, precision=_hp)), host_dtype)
    t_small = (t_small + t_small.conj().T) / 2
    s_small = (s_small + s_small.conj().T) / 2

    s_w, s_v = np.linalg.eigh(s_small)
    keep = s_w > 1e-10
    x = s_v[:, keep] / np.sqrt(s_w[keep])
    t_proj = x.conj().T @ t_small @ x
    t_proj = (t_proj + t_proj.conj().T) / 2
    w_all, y = np.linalg.eigh(t_proj)
    coeff = x @ y  # (m_rows, n_kept) basis-row coefficients per Ritz pair

    n_kept = coeff.shape[1]
    num_out = min(nroot, n_kept)
    sel = [n_kept - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))

    q_pad = np.zeros((num_out, basis.shape[0]), dtype=host_dtype)
    q_pad[:, :m_rows] = coeff[:, sel].T
    if not is_complex_dtype(dtype):
        q_pad = q_pad.real
    vecs = jnp.matmul(jnp.asarray(q_pad, dtype), basis, precision=jax.lax.Precision.HIGHEST)
    norms = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2, axis=1, keepdims=True))
    eigvecs = vecs / norms

    eigenvalues = [float(w_all[s]) - cfg.eigenvalue_offset for s in sel]
    converged = itern < max_blocks or max_blocks * b >= n
    return eigenvalues, eigvecs, itern, converged


def block_lanczos_run(op, cfg: LanczosConfig, init_vector, dtype, block_size: int) -> LanczosResult:
    """Block engine under the shared deflation driver (v0 is a block of
    ``block_size`` rows; warm restarts reuse the top-b Ritz vectors)."""
    from .lanczos import deflation_driver

    cfg = cfg.resolved(dtype)
    b = max(int(block_size), 1)
    return deflation_driver(
        lambda v0, nroot, defl, mask: block_lanczos_iteration(op, v0, nroot, defl, mask, cfg, b),
        cfg, init_vector, dtype, v0_rows=b,
    )
