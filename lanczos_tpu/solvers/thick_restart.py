"""Thick-restart Lanczos (TRLan-style) — bounded memory with subspace reuse.

The plain bounded-memory mode (``run_restarted``) restarts from a single Ritz
vector and loses the rest of the subspace — fine for gapped spectra, slow for
clustered ones (the n=400 chain stalls at ~1e-4).  Thick restart keeps the
best ``l`` Ritz vectors *with their exact couplings* and continues the build,
recovering near-unrestarted convergence at O(max_iteration * n) memory
(Wu & Simon, SIAM J. Matrix Anal. 2000).

Formulation: instead of carrying the three-term alpha/beta recurrence plus an
arrowhead correction, this engine maintains the **projected matrix**
``T = V^H (A + offset) V`` directly on host — each iteration's CGS
projection coefficients (computed anyway for the full reorthogonalization)
ARE the new T column, so after a restart the Ritz-vector couplings appear
automatically when the next column is projected.  T is Hermitian by
symmetrization; eigh(T) on host float64 drives the same relative-drift
convergence test as the reference (lambda_lanczos.hpp:267-309).

Device work per iteration: one matvec + the same CGS matmuls as the full
engines; host work: one small eigh.  The projection coefficients are pulled
to host each iteration (hybrid-style; this engine targets memory-bound
convergence, not minimum host traffic — use mode='fused' when the basis fits).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import df64, linalg
from ..core.types import is_complex_dtype, machine_eps, real_dtype
from .lanczos import LanczosConfig, _prepare_init_vector

__all__ = [
    "thick_lanczos_iteration",
    "thick_lanczos_iteration_fused",
    "thick_lanczos_iteration_fused_pv",
    "lanczos_run_thick",
]


@functools.partial(jax.jit, donate_argnums=(1,))
def _project_step(op, basis, defl, defl_mask, nb, offset):
    """w = (A + offset) v_{nb-1}; project against defl and the basis rows
    [0, nb); returns (basis', c (cap,), beta) with basis' holding the
    normalized residual at row nb.

    ``c`` are the FIRST-pass CGS coefficients — the new column of the
    projected matrix T (the second pass only polishes orthogonality and its
    coefficients are O(eps), irrelevant to T at solver precision).
    """
    dtype = basis.dtype
    rdtype = np.dtype(real_dtype(dtype))

    v = jax.lax.dynamic_index_in_dim(basis, nb - 1, axis=0, keepdims=False)
    w = op.matvec(v)
    w = w + offset.astype(rdtype) * v

    w = linalg.orthogonalize_cgs2(w, defl, defl_mask)

    # Live-rows BCGS2 on accelerators (HBM traffic ∝ nb, not capacity);
    # masked CGS2 on CPU.  The accumulated coefficients over both passes are
    # the new T column (chunk cross terms are O(eps·|c|), the same order as
    # the polish-pass contribution the masked formulation also summed).
    w, c = linalg.orthogonalize_bcgs_dyn_coeffs(w, basis, nb)

    beta = linalg.norm(w).astype(rdtype)
    tiny = jnp.asarray(np.finfo(rdtype).tiny, rdtype)
    basis = jax.lax.dynamic_update_slice_in_dim(basis, (w / jnp.maximum(beta, tiny))[None], nb, axis=0)
    return basis, c, beta


@jax.jit
def _rotate_basis(q, basis):
    """New basis rows = q @ basis (Ritz recombination on device)."""
    return jnp.matmul(q.astype(basis.dtype), basis, precision=jax.lax.Precision.HIGHEST)


def thick_lanczos_iteration(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """One deflated solve with internal thick restarts; same return contract
    as :func:`lanczos_tpu.solvers.lanczos.lanczos_iteration`:
    (eigenvalues, eigenvectors, total_iterations, converged)."""
    dtype = np.dtype(v0.dtype)
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    m_max = max(min(cfg.max_iteration, n), 2)
    l_keep = cfg.resolve_thick_keep(nroot + 2, m_max - 2)
    host_c = np.complex128 if is_complex_dtype(dtype) else np.float64

    v0 = _prepare_init_vector(v0, defl, defl_mask)
    basis = jnp.zeros((m_max + 1, n), dtype).at[0].set(v0)
    t_host = np.zeros((m_max + 1, m_max + 1), dtype=host_c)

    # Invariant: rows [0, m_val] of ``basis`` are orthonormal; rows
    # [0, m_val) span the Rayleigh-Ritz space with completed projected
    # matrix t_host[:m_val, :m_val]; row m_val is the next candidate
    # (the newest normalized residual).
    m_val = 0
    total_iters = 0
    pevs: np.ndarray | None = None
    converged = False
    breakdown_eps = machine_eps(rdtype) * 10.0  # beta is a storage-dtype norm
    offset = jnp.asarray(cfg.eigenvalue_offset, np.dtype(rdtype))

    for _restart in range(max(cfg.max_restarts, 1)):
        while m_val < m_max:
            nb = m_val + 1  # process candidate row m_val, write residual at row nb
            basis, c, beta = _project_step(op, basis, defl, defl_mask, nb, offset)
            # ONE batched device_get (each separate get is a device round trip).
            _c, _beta = jax.device_get((c, beta))
            c_host = np.asarray(_c, host_c)
            beta_f = float(_beta)
            total_iters += 1
            m_val = nb

            t_host[: m_val, m_val - 1] = c_host[: m_val]
            t_host[m_val - 1, : m_val] = np.conj(c_host[: m_val])

            tk = t_host[: m_val, : m_val]
            tk = (tk + tk.conj().T) / 2
            evs_all = np.linalg.eigvalsh(tk)
            m_want = min(nroot, m_val)
            evs = evs_all[::-1][:m_want] if cfg.find_maximum else evs_all[:m_want]

            if beta_f < breakdown_eps:
                converged = True
                break
            if pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
                diffs = np.abs(evs - pevs)
                tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
                if np.all(diffs < tol):
                    converged = True
                    break
            pevs = evs

        if converged or m_val >= n:
            converged = converged or m_val >= n
            break

        # --- thick restart: keep the l best Ritz vectors + the residual ----
        tk = t_host[:m_val, :m_val]
        tk = (tk + tk.conj().T) / 2
        theta, q = np.linalg.eigh(tk)
        sel = (
            list(range(m_val - 1, m_val - 1 - l_keep, -1))
            if cfg.find_maximum
            else list(range(l_keep))
        )
        q_keep = np.zeros((l_keep + 1, m_max + 1), dtype=host_c)
        q_keep[:l_keep, :m_val] = q[:, sel].T
        q_keep[l_keep, m_val] = 1.0  # the candidate residual row, already orthonormal
        basis_new = _rotate_basis(jnp.asarray(q_keep if is_complex_dtype(dtype) else q_keep.real, dtype), basis)
        # In-place overwrite of the leading rows (a fresh zeros buffer would
        # double peak memory — 8 GB transient at n=4M/cap=256); stale rows
        # beyond l_keep are never read: every consumer masks rows < nb.
        basis = basis.at[: l_keep + 1].set(basis_new)

        t_host = np.zeros((m_max + 1, m_max + 1), dtype=host_c)
        t_host[np.arange(l_keep), np.arange(l_keep)] = theta[sel]
        # Couplings <y_i, A r> appear automatically when the next column is
        # projected; the symmetric fill happens in the loop above.
        m_val = l_keep
        # The kept Ritz values are *identical* across the restart boundary by
        # construction — comparing against pre-restart values would declare
        # convergence instantly.  Only in-cycle drift counts.
        pevs = None

    # Final Rayleigh-Ritz extraction from the current projected matrix.
    m_val = max(m_val, 1)
    tk = t_host[:m_val, :m_val]
    tk = (tk + tk.conj().T) / 2
    theta, q = np.linalg.eigh(tk)
    num_out = min(nroot, m_val)
    sel = [m_val - 1 - i for i in range(num_out)] if cfg.find_maximum else list(range(num_out))
    q_pad = np.zeros((num_out, m_max + 1), dtype=host_c)
    q_pad[:, :m_val] = q[:, sel].T
    vecs = _rotate_basis(jnp.asarray(q_pad if is_complex_dtype(dtype) else q_pad.real, dtype), basis)
    norms = jnp.sqrt(jnp.sum(jnp.abs(vecs) ** 2, axis=1, keepdims=True))
    eigvecs = vecs / norms

    eigenvalues = [float(theta[s]) - cfg.eigenvalue_offset for s in sel]
    return eigenvalues, eigvecs, total_iters, converged


def lanczos_run_thick(op, cfg: LanczosConfig, init_vector, dtype):
    """Thick-restart engine under the shared deflation driver (the engine
    restarts internally, so no warm-restart wrapper)."""
    from .lanczos import deflation_driver

    cfg = cfg.resolved(dtype)
    return deflation_driver(
        lambda v0, nroot, defl, mask: thick_lanczos_iteration(op, v0, nroot, defl, mask, cfg),
        cfg, init_vector, dtype, use_warm_restarts=False,
    )


# ---------------------------------------------------------------------------
# Fused-cycle thick restart: device-resident cycles, host only at boundaries
# ---------------------------------------------------------------------------


@jax.jit
def _coupling_row(op, y_rows, y_mask, r, offset):
    """s_i = <Y_i, (A + offset) r> — the arrowhead couplings, one matvec."""
    ar = op.matvec(r) + offset.astype(r.dtype) * r
    yc = jnp.conj(y_rows) if is_complex_dtype(y_rows.dtype) else y_rows
    s = jnp.matmul(yc, ar, precision=jax.lax.Precision.HIGHEST)
    return s * y_mask.astype(s.dtype)


def thick_lanczos_iteration_fused(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """Thick restart with fused (lax.while_loop) Krylov cycles.

    With ``cfg.precise_vectors`` the double-float variant below runs instead
    (df64 basis carried across restart cycles — bounded memory AND
    reference-grade eigenvalues on the f32-native chip).

    Each cycle builds ``m_max - l`` pure-Lanczos vectors ON DEVICE with the
    kept Ritz vectors riding in the deflation slot (so the existing fused
    stage orthogonalizes against them for free); the host touches the device
    only at cycle boundaries: once for the arrowhead couplings
    ``s_i = <Y_i, A r>`` and once for the restart rotation.  The cycle's
    projected matrix is the standard TRLan arrowhead
    ``[[diag(theta), s], [s^H, tridiag(alpha, beta)]]`` assembled on host in
    float64.  ~3 host syncs per m_max iterations vs one per iteration for
    the host-driven engine — the production device form of bounded-memory
    convergence.
    """
    from .lanczos_fused import _add_reorth, _fused_stage, _init_state

    if getattr(cfg, "precise_vectors", False):
        return thick_lanczos_iteration_fused_pv(op, v0, nroot, defl, defl_mask, cfg)

    dtype = np.dtype(v0.dtype)
    rdtype = real_dtype(dtype)
    n = cfg.matrix_size
    m_max = max(min(cfg.max_iteration, n), 4)
    l_keep = cfg.resolve_thick_keep(nroot + 2, m_max - 2)
    host_c = np.complex128 if is_complex_dtype(dtype) else np.float64
    nd_cap = defl.shape[0]
    precise = bool(cfg.precise_reductions)

    # Deflation slot = true deflation + kept Ritz vectors (cycle >= 1).
    defl_big = jnp.zeros((nd_cap + l_keep, n), dtype).at[:nd_cap].set(defl)
    mask_big = jnp.zeros((nd_cap + l_keep,), np.dtype(rdtype)).at[:nd_cap].set(defl_mask)

    v0 = _prepare_init_vector(v0, defl, defl_mask)
    theta_kept = np.zeros(0, dtype=np.float64)
    y_rows = jnp.zeros((l_keep, n), dtype)
    s_host = np.zeros(0, dtype=host_c)

    total_iters = 0
    pevs: np.ndarray | None = None
    converged = False
    offset = jnp.asarray(cfg.eigenvalue_offset, np.dtype(rdtype))

    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_kept.shape[0]
        m_new = m_max - l_cur

        def read_state(state):
            # ONE batched device_get for EVERYTHING a boundary needs — loop
            # scalars AND the alpha/beta buffers (each separate get is a full
            # device round trip; boundaries run dozens of times per solve,
            # and the buffers are tiny next to the round trip).
            if precise:
                _stop, _itern, _k, _nro, a_hi, a_lo, b_hi, b_lo = jax.device_get(
                    (state.stop, state.itern, state.k, state.n_reorth,
                     state.alpha, state.alpha_lo, state.bsq_hi, state.bsq_lo)
                )
                a = np.asarray(a_hi, np.float64) + np.asarray(a_lo, np.float64)
                bsq = np.asarray(b_hi, np.float64) + np.asarray(b_lo, np.float64)
                b = np.sqrt(np.maximum(bsq, 0.0))
            else:
                _stop, _itern, _k, _nro, a_raw, b_raw = jax.device_get(
                    (state.stop, state.itern, state.k, state.n_reorth,
                     state.alpha, state.beta)
                )
                a = np.asarray(a_raw, np.float64)
                b = np.asarray(b_raw, np.float64)
            return bool(_stop), int(_itern), int(_k), _nro, a, b

        def resid_ok(theta_all, q_all, beta_last, m_done):
            """Free a-posteriori bound: a Ritz pair's residual is
            |beta_last * q[last row]| (only the candidate row leaks — the
            arrowhead is exact).  Gating the drift tests on
            res <= sqrt(eps)*scale prevents plateau false-convergence (the
            same guard the block engine carries; the production flagship
            sits at res/scale ~ 2e-5 << sqrt(1e-6), so its behavior is
            unchanged)."""
            m_tot = l_cur + m_done
            n_want = min(int(nroot), m_tot)
            sel = (
                list(range(m_tot - 1, m_tot - 1 - n_want, -1))
                if cfg.find_maximum
                else list(range(n_want))
            )
            res = np.abs(beta_last * q_all[m_tot - 1, sel])
            scale = max(np.max(np.abs(theta_all)), np.finfo(np.float64).tiny)
            return bool(np.all(res <= np.sqrt(cfg.eps) * scale))

        def assemble_t(alphas, betas, m_done):
            """Arrowhead projected matrix over [Y (l_cur), U (m_done)]:
            [[diag(theta), s], [s^H, tridiag]] (Wu & Simon TRLan form)."""
            m_tot = l_cur + m_done
            t = np.zeros((m_tot, m_tot), dtype=host_c)
            if l_cur:
                t[np.arange(l_cur), np.arange(l_cur)] = theta_kept
                t[:l_cur, l_cur] = s_host[:l_cur]
                t[l_cur, :l_cur] = np.conj(s_host[:l_cur])
            t[np.arange(l_cur, m_tot), np.arange(l_cur, m_tot)] = alphas
            for j in range(m_done - 1):
                t[l_cur + j, l_cur + j + 1] = betas[j]
                t[l_cur + j + 1, l_cur + j] = betas[j]
            return (t + t.conj().T) / 2

        # Every cycle (and every segment inside a cycle) runs through the SAME
        # full-capacity compiled while_loop: the state is allocated at m_max
        # and the per-cycle/per-segment iteration budget is the *dynamic*
        # ``k_limit`` operand of ``_fused_stage``.  A static per-segment shape
        # ladder recompiled the n-scale loop ~6 times per solve, and those
        # compiles dominated the production wall time.
        if cycle == 0:
            # No arrowhead yet: the in-loop device Sturm test is exact.
            check = max(int(cfg.convergence_check_interval), 1)
            state = _init_state(v0, m_max, int(nroot))
            state = _fused_stage(
                op, state, defl_big, mask_big, cfg.eps, cfg.eigenvalue_offset,
                int(nroot), bool(cfg.find_maximum), check,
                int(cfg.reorth_passes), str(cfg.reorth_policy), precise,
                k_limit=jnp.asarray(m_new, jnp.int32),
            )
            stopped, _itern, _k, _nro, a_full, b_full = read_state(state)
            _add_reorth(_nro)
            m_done = _itern if stopped else _k - 1
        else:
            # Cycles >= 1: the device Sturm cannot see the arrowhead, so run
            # the cycle in geometrically growing SEGMENTS and test the full
            # bordered matrix on host (float64) at each boundary — converged
            # mid-cycle budgets are no longer burned (VERDICT item 8).
            seg = min(m_new, max(2 * (l_cur + int(nroot)), (m_new + 7) // 8, 2))
            state = _init_state(v0, m_max, int(nroot))
            pseg: np.ndarray | None = None
            while True:
                # eps=0: only breakdown can stop the device loop; the device
                # Sturm check never fires mid-segment (throttle > any k) —
                # convergence is judged on host at segment boundaries.
                state = _fused_stage(
                    op, state, defl_big, mask_big, 0.0, cfg.eigenvalue_offset,
                    int(nroot), bool(cfg.find_maximum), 1 << 30,
                    int(cfg.reorth_passes), str(cfg.reorth_policy), precise,
                    k_limit=jnp.asarray(seg, jnp.int32),
                )
                stopped, _itern, _k, _nro, a_full, b_full = read_state(state)
                m_done = _itern if stopped else _k - 1
                if stopped or seg >= m_new:
                    break
                th_seg, q_seg = np.linalg.eigh(
                    assemble_t(a_full[:m_done], b_full[:m_done], m_done)
                )
                want = min(int(nroot), th_seg.shape[0])
                evs_seg = th_seg[::-1][:want] if cfg.find_maximum else th_seg[:want]
                if (
                    pseg is not None
                    and pseg.shape[0] == evs_seg.shape[0]
                    and evs_seg.shape[0] == nroot
                    and np.all(
                        np.abs(evs_seg - pseg)
                        < np.minimum(np.abs(evs_seg), np.abs(pseg)) * cfg.eps
                    )
                    and resid_ok(th_seg, q_seg, b_full[m_done - 1], m_done)
                ):
                    break  # converged mid-cycle: skip the rest of the budget
                pseg = evs_seg
                seg = min(2 * seg, m_new)

        if cycle != 0:
            _add_reorth(_nro)  # cumulative over the cycle's segments
        total_iters += m_done
        # a_full/b_full already fetched at the last boundary (same m_done).
        alphas, betas = a_full[:m_done], b_full[:m_done]
        m_tot = l_cur + m_done
        theta_all, q_all = np.linalg.eigh(assemble_t(alphas, betas, m_done))

        m_want = min(nroot, m_tot)
        evs = theta_all[::-1][:m_want] if cfg.find_maximum else theta_all[:m_want]

        in_cycle_converged = stopped and cycle == 0
        breakdown = stopped and cycle > 0  # only breakdown can stop at eps=0
        if in_cycle_converged or breakdown:
            converged = True
        elif pevs is not None and pevs.shape[0] == evs.shape[0] and evs.shape[0] == nroot:
            diffs = np.abs(evs - pevs)
            tol = np.minimum(np.abs(evs), np.abs(pevs)) * cfg.eps
            if np.all(diffs < tol) and resid_ok(theta_all, q_all, betas[m_done - 1], m_done):
                converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1
        sel = (
            [m_tot - 1 - i for i in range(l_keep if not last_cycle else min(nroot, m_tot))]
            if cfg.find_maximum
            else list(range(l_keep if not last_cycle else min(nroot, m_tot)))
        )

        # Rotate [Y; U[:m_done]] into the selected Ritz vectors on device —
        # as two matmuls: a concatenated basis would materialize a second
        # (m_max, n) buffer (4+ GB at n=4M) and OOM the chip.
        n_sel = len(sel)
        q_y = np.zeros((n_sel, l_keep), dtype=host_c)
        q_y[:, :l_cur] = q_all[:l_cur, sel].T
        q_u = np.zeros((n_sel, state.u_buf.shape[0]), dtype=host_c)
        q_u[:, :m_done] = q_all[l_cur:, sel].T
        if not is_complex_dtype(dtype):
            q_y, q_u = q_y.real, q_u.real
        ritz = jnp.matmul(
            jnp.asarray(q_y, dtype), y_rows, precision=jax.lax.Precision.HIGHEST
        ) + jnp.matmul(jnp.asarray(q_u, dtype), state.u_buf, precision=jax.lax.Precision.HIGHEST)

        if last_cycle:
            norms = jnp.sqrt(jnp.sum(jnp.abs(ritz) ** 2, axis=1, keepdims=True))
            eigvecs = ritz / norms
            eigenvalues = [float(theta_all[s]) - cfg.eigenvalue_offset for s in sel]
            converged = converged or m_tot >= n
            return eigenvalues, eigvecs, total_iters, converged

        # Thick restart: Y' = selected Ritz vectors, r' = last residual row.
        theta_kept = theta_all[sel]
        y_rows = ritz
        r_new = jax.lax.dynamic_index_in_dim(state.u_buf, m_done, axis=0, keepdims=False)
        defl_big = defl_big.at[nd_cap : nd_cap + l_keep].set(y_rows)
        mask_big = mask_big.at[nd_cap : nd_cap + l_keep].set(1.0)
        s_dev = _coupling_row(op, y_rows, jnp.ones((l_keep,), np.dtype(rdtype)), r_new, offset)
        s_host = np.asarray(jax.device_get(s_dev), host_c)
        v0 = r_new


# ---------------------------------------------------------------------------
# Precise-vector (df64 basis) thick restart: bounded memory at reference-grade
# accuracy on the f32-native chip
# ---------------------------------------------------------------------------


@jax.jit
def _df_rotate(qy_hi, qy_lo, qu_hi, qu_lo, y_df, u_df):
    """Rows of the new df64 basis: Q^T [Y; U] computed entirely in df
    arithmetic (an f32 matmul rotation would inject ~1e-7 noise into the carried
    basis and break the exact-relation bookkeeping the pv engines rely on).
    Split as two products to avoid materializing a concatenated (m, n) df
    buffer (doubling peak memory at large n)."""
    a = df64.df_matmul((qy_hi, qy_lo), y_df)
    b = df64.df_matmul((qu_hi, qu_lo), u_df)
    return df64.df_add(a, b)


def _split_rotation_host(a64, dtype):
    """Host float64 rotation matrix -> (hi, lo) device pair in the storage
    dtype.  Done in numpy: ``jnp.asarray(f64)`` silently downcasts on an
    x64-disabled runtime, which would corrupt the lo word."""
    rd = np.dtype(real_dtype(dtype))
    hi = a64.astype(rd)
    lo = (a64 - hi.astype(np.float64)).astype(rd)
    return jnp.asarray(hi, dtype), jnp.asarray(lo, dtype)


def _select_invariant_pv(m_host, n_sel: int, find_maximum: bool, allow_overshoot: bool = False):
    """Real orthonormal basis Q of the invariant subspace of the (mildly
    nonsymmetric) relation matrix M spanned by its ``n_sel`` extremal
    eigenvalues, plus the block representation Theta = Q^T M Q.

    Computed by ORDERED REAL SCHUR (scipy): ``M Z = Z T`` with Z orthogonal
    and the selected eigenvalues sorted into the leading block, so
    ``M Q = Q Theta`` holds to machine precision REGARDLESS of eigenvector
    conditioning.  (A QR-of-eigenvectors formulation was measured leaving
    ~5e-9 invariance residual on clustered spectra — near-degenerate Ritz
    values make the eigenvector matrix ill-conditioned — which leaked
    straight into the carried relation and floored the engine at ~1e-11.)

    A complex-conjugate pair straddling the selection boundary stays whole
    (its 2x2 block cannot be split): the boundary moves down (restart keeps:
    the basis must fit fixed buffers) or up (``allow_overshoot=True``, final
    extraction: trimmed after the block eigensolve).  Returns (q, theta_blk);
    q may have fewer (or +1 more, overshoot) columns than ``n_sel``.
    """
    import scipy.linalg as sla

    m_tot = m_host.shape[0]
    n_sel = min(n_sel, m_tot)
    if n_sel >= m_tot:
        return np.eye(m_tot), m_host.copy()
    w = np.linalg.eigvals(m_host)
    re = np.sort(w.real)
    if find_maximum:
        re = re[::-1]
    cap = n_sel + 1 if allow_overshoot else n_sel

    def clean_split(j_target: int) -> int:
        """Largest j <= j_target with re[j-1] != re[j] (a separable cutoff);
        0 if the leading values are one bit-identical block."""
        j = min(j_target, m_tot - 1)
        while j > 0 and re[j - 1] == re[j]:
            j -= 1
        return j

    j = clean_split(n_sel)
    if j < n_sel and allow_overshoot:
        j_up = n_sel
        while j_up < m_tot and re[j_up - 1] == re[j_up]:
            j_up += 1
        if j_up <= cap or j == 0:
            j = min(j_up, m_tot)
    if j == 0:
        # No separable boundary at all below cap: keep nothing (the caller
        # degrades to a plain restart) — pathological bit-identical spectrum.
        return np.zeros((m_tot, 0)), np.zeros((0, 0))

    while True:
        if j >= m_tot:
            return np.eye(m_tot), m_host.copy()
        cutoff = (re[j - 1] + re[j]) / 2
        if find_maximum:
            t, z, sdim = sla.schur(m_host, output="real", sort=lambda wre, wim: wre > cutoff)
        else:
            t, z, sdim = sla.schur(m_host, output="real", sort=lambda wre, wim: wre < cutoff)
        if sdim <= cap or j <= 1:
            break
        # Schur's internal eigenvalues flipped across the (tiny) cutoff gap:
        # move the boundary one clean split down and retry.
        j = clean_split(j - 1)
        if j == 0:
            return np.zeros((m_tot, 0)), np.zeros((0, 0))
    sdim = int(sdim)
    if sdim > cap:
        # j reached 1 with Schur still classifying a whole near-bit-identical
        # cluster below every midpoint cutoff (ulp-spaced degenerate values).
        # The leading columns of a real Schur basis stay an invariant
        # subspace at any truncation that does not split a 2x2 block
        # (T[m, m-1] != 0 marks a straddle) — trim to the largest such
        # m <= cap so the fixed-size keep buffers are never overrun.
        m = cap
        while m > 0 and abs(t[m, m - 1]) > 0:
            m -= 1
        if m == 0:
            return np.zeros((m_tot, 0)), np.zeros((0, 0))
        sdim = m
    return z[:, :sdim], t[:sdim, :sdim]


def _pv_converged(m_host, res_spec, nroot: int, find_maximum: bool, eps: float, pevs, n_protect: int | None = None):
    """(evs, converged): drift + first-order eigenvalue-error gate.

    Drift: all ``nroot`` selected Ritz values stable to relative ``eps``
    across checks (reference semantics, lambda_lanczos.hpp:290-309).

    Error gate: ``err_est_i = min(res_i, res_i^2 / gap_i)`` with ``res_i``
    the exact-relation leak through the candidate row(s): ``res_spec`` is
    either the scalar ``beta_last`` (res_i = |beta_last * q_right[last, i]|)
    or a callable mapping the right-eigenvector matrix to per-value
    residuals (the block engine passes ||R_last @ q[last-block rows]||),
    and ``gap_i`` the distance to the nearest
    NON-selected Ritz value — the symmetric a-posteriori bound, guarding
    against plateau false-convergence (the hazard VERDICT r2 flagged for the
    drift-only scalar thick test).  It applies only to the first
    ``n_protect`` values — the ones that can persist into the user's final
    answer.  Trailing values are drift-gated only: on degenerate spectra a
    single-vector Krylov build grows extra copies of an eigenvalue solely
    from reorthogonalization noise, their residuals converge on the noise
    timescale (not the Kaniel-Paige rate), and duplicate copies just outside
    the selected set collapse ``gap_i`` — demanding eps-level err_est of
    them burns the entire restart budget for values the deflation driver
    will re-derive (and displace) anyway."""
    w, v = np.linalg.eig(m_host)
    order = np.argsort(w.real)
    if find_maximum:
        order = order[::-1]
    m_tot = m_host.shape[0]
    n_want = min(nroot, m_tot)
    sel = order[:n_want]
    evs = w.real[sel]
    scale = max(np.max(np.abs(w.real)), np.finfo(np.float64).tiny)

    drift_ok = (
        pevs is not None
        and pevs.shape[0] == evs.shape[0]
        and evs.shape[0] == nroot
        and np.all(np.abs(evs - pevs) < np.minimum(np.abs(evs), np.abs(pevs)) * eps)
    )
    if not drift_ok:
        return evs, False

    # Cluster-robust second-order bound (Parlett ch. 11 cluster form): for
    # each protected value, group it with every Ritz value co-converging to
    # the same eigenvalue (single-linkage at 10*(res_i+res_j) — degenerate
    # copies land here and must not crush the gap), take the gap to the
    # nearest value OUTSIDE the cluster (selected or not — a neighboring
    # selected value IS this value's convergence-limiting gap), and bound by
    # ||R_cluster||^2 / gap.  Falls back to the first-order |theta-lambda|
    # <= res bound when everything links into one cluster.
    th = w.real
    if callable(res_spec):
        res_all = np.asarray(res_spec(v), np.float64)
    else:
        res_all = np.abs(res_spec) * np.abs(v[m_tot - 1, :])
    tinyf = np.finfo(np.float64).tiny
    err_ok = True
    for i in sel[: n_want if n_protect is None else min(n_protect, n_want)]:
        cluster = {int(i)}
        changed = True
        while changed:
            changed = False
            for j in range(m_tot):
                if j in cluster:
                    continue
                if any(abs(th[j] - th[c]) <= 10.0 * (res_all[j] + res_all[c]) for c in cluster):
                    cluster.add(j)
                    changed = True
        outside_idx = [j for j in range(m_tot) if j not in cluster]
        if outside_idx:
            gap = min(abs(th[j] - th[i]) for j in outside_idx)
            res_eff_sq = float(sum(res_all[j] ** 2 for j in cluster))
            err_est = min(res_all[i], res_eff_sq / max(gap, tinyf))
        else:
            err_est = res_all[i]  # no gap information at all
        if err_est > eps * scale:
            err_ok = False
            break
    return evs, err_ok



def _pv_final_select(m_host, num_out: int, find_maximum: bool):
    """Final pv extraction, shared by the scalar and block thick engines:
    Schur-selected invariant subspace (overshoot allowed, trimmed after),
    VALUES from eig of the block (the exact-relation-certified quantities),
    VECTORS from the symmetrized block eigensolve (orthonormal within the
    subspace; the discarded antisymmetric within-cluster rotation only
    affects vectors at the f32 floor they already carry), paired by sort
    order.  Returns ``(values (num_out,), qz (m_tot, num_out))``."""
    m_tot = m_host.shape[0]
    q, theta_out = _select_invariant_pv(m_host, num_out, find_maximum, allow_overshoot=True)
    if q.shape[1] == 0:  # bit-identical-spectrum corner
        q, theta_out = np.eye(m_tot), m_host.copy()
    num_out = min(num_out, q.shape[1]) or 1
    w_blk = np.sort(np.linalg.eigvals(theta_out).real)
    if find_maximum:
        w_blk = w_blk[::-1]
    w2, z = np.linalg.eigh((theta_out + theta_out.T) / 2)
    ord2 = np.argsort(w2)[::-1] if find_maximum else np.argsort(w2)
    ord2 = ord2[:num_out]
    return w_blk[:num_out], q @ z[:, ord2]


def thick_lanczos_iteration_fused_pv(op, v0, nroot: int, defl, defl_mask, cfg: LanczosConfig):
    """Thick-restart Lanczos with a DOUBLE-FLOAT Krylov basis: bounded
    O(max_iteration * n) memory AND reference-grade (~1e-11) eigenvalues
    with f32 storage — the two round-2 headline results merged (they were
    previously mutually exclusive; VERDICT r2 item 1).

    How the pieces fit (reference bar: lambda_lanczos.hpp:150 eps~2.2e-13 and
    the 1e-14 zoo entries, lambda_lanczos_test.cpp:290, :519, :739):

    * In-cycle, the fused pv stage carries the basis as df64 (hi, lo) word
      pairs and RECAPTURES every CGS coupling (``coup``) — including, new
      here, the couplings against the deflation slot (``coup_d``) where the
      kept Ritz vectors ride.  The computed relation
      ``A V = V M + beta r e_last^T`` then holds to df64 precision.
    * At a restart the selected Ritz subspace is carried as an exact
      invariant subspace of the nonsymmetric relation matrix M (realified
      pairs + QR + Theta = Q^T M Q), the basis rows are rotated in df64
      arithmetic (:func:`lanczos_tpu.core.df64.df_matmul` — an f32 matmul
      rotation would re-inject the very noise pv removes), and the next
      cycle's bordered matrix is ``[[Theta, *], [s, T + C]]`` with
      ``s = beta_final * Q[last, :]`` (exact from the relation — no extra
      matvec needed, unlike the f32 engine's ``_coupling_row``).
    * Convergence is judged on host from M at geometrically growing segment
      boundaries (drift + first-order error estimate res^2/gap — the
      residual gate the f32 scalar thick engine lacked).

    Real dtypes only; requires ``op.matvec_df`` (all shipped structured
    operators provide it; HermitianSplitOperator covers complex Hermitian).
    Same return contract as :func:`thick_lanczos_iteration`.
    """
    from .lanczos_fused import _add_reorth, _fused_stage, _init_state

    dtype = np.dtype(v0.dtype)
    rdtype = real_dtype(dtype)
    if is_complex_dtype(dtype):
        raise TypeError(
            "precise_vectors supports real dtypes only (use HermitianSplitOperator for complex)"
        )
    n = cfg.matrix_size
    m_max = max(min(cfg.max_iteration, n), 4)
    l_keep = cfg.resolve_thick_keep(nroot + 2, m_max - 2)
    nd_cap = defl.shape[0]
    nd_tot = nd_cap + l_keep
    # Values that can persist into the final answer this round: the best
    # (num_eigs - already_deflated) — the err_est convergence gate protects
    # exactly these (see _pv_converged).
    nd_live = int(np.sum(np.asarray(jax.device_get(defl_mask)) > 0))
    n_protect = max(1, min(int(nroot), int(cfg.num_eigs) - nd_live))

    defl_big = jnp.zeros((nd_tot, n), dtype).at[:nd_cap].set(defl)
    # Low words of the deflation slot: zero for the true (f32) deflation
    # rows, the kept Ritz rows' df64 lo words after each restart — consumed
    # by the k=1 df-exact arrowhead correction in the fused stage.
    defl_lo_big = jnp.zeros((nd_tot, n), dtype)
    mask_big = jnp.zeros((nd_tot,), np.dtype(rdtype)).at[:nd_cap].set(defl_mask)

    v0 = _prepare_init_vector(v0, defl, defl_mask)
    v0_lo = jnp.zeros_like(v0)
    theta_blk = np.zeros((0, 0), np.float64)  # kept-block representation of M
    s_kept = np.zeros(0, np.float64)  # A y_j = sum_i Theta[i,j] y_i + s_j r
    y_df = (jnp.zeros((l_keep, n), dtype), jnp.zeros((l_keep, n), dtype))

    total_iters = 0
    pevs: np.ndarray | None = None
    converged = False

    def read_state(state):
        (_stop, _itern, _k, _nro, a_hi, a_lo, b_hi, b_lo, _coup, _cd_hi, _cd_lo) = jax.device_get(
            (state.stop, state.itern, state.k, state.n_reorth,
             state.alpha, state.alpha_lo, state.bsq_hi, state.bsq_lo,
             state.coup, state.coup_d, state.coup_d_lo)
        )
        a = np.asarray(a_hi, np.float64) + np.asarray(a_lo, np.float64)
        bsq = np.asarray(b_hi, np.float64) + np.asarray(b_lo, np.float64)
        b = np.sqrt(np.maximum(bsq, 0.0))
        coup_d = np.asarray(_cd_hi, np.float64) + np.asarray(_cd_lo, np.float64)
        return (
            bool(_stop), int(_itern), int(_k), _nro, a, b,
            np.asarray(_coup, np.float64), coup_d,
        )

    for cycle in range(max(cfg.max_restarts, 1)):
        l_cur = theta_blk.shape[0]
        m_new = m_max - l_cur

        def assemble_m(alphas, betas, coup, coup_d, m_done):
            """Bordered exact-relation matrix over [Y (l_cur), U (m_done)]:
            every entry is either carried from the previous cycle's relation
            (Theta, s) or recaptured in-loop (T + C, coup_d rows)."""
            m_tot = l_cur + m_done
            m = np.zeros((m_tot, m_tot), np.float64)
            if l_cur:
                m[:l_cur, :l_cur] = theta_blk
                m[l_cur, :l_cur] = s_kept
                m[:l_cur, l_cur:m_tot] += coup_d[nd_cap : nd_cap + l_cur, :m_done]
            idx = np.arange(m_done)
            m[l_cur + idx, l_cur + idx] = alphas[:m_done]
            for j in range(m_done - 1):
                m[l_cur + j, l_cur + j + 1] = betas[j]
                m[l_cur + j + 1, l_cur + j] = betas[j]
            m[l_cur:m_tot, l_cur:m_tot] += coup[:m_done, :m_done]
            return m

        # Whole cycle through ONE compiled while_loop (dynamic k_limit), in
        # geometrically growing segments judged on host: eps=0 and a huge
        # check throttle mean only breakdown can stop the device loop.
        state = _init_state(v0, m_max, int(nroot), precise_vectors=True, nd=nd_tot)
        state = state._replace(u_lo=state.u_lo.at[0].set(v0_lo))
        seg = min(m_new, max(2 * (l_cur + int(nroot)), (m_new + 7) // 8, 2))
        while True:
            state = _fused_stage(
                op, state, defl_big, mask_big, 0.0, cfg.eigenvalue_offset,
                int(nroot), bool(cfg.find_maximum), 1 << 30,
                int(cfg.reorth_passes), "full", False, True,
                k_limit=jnp.asarray(seg, jnp.int32), defl_lo=defl_lo_big,
            )
            stopped, _itern, _k, _nro, a_full, b_full, coup, coup_d = read_state(state)
            m_done = _itern if stopped else _k - 1
            if stopped or seg >= m_new:
                break
            m_seg = assemble_m(a_full, b_full, coup, coup_d, m_done)
            evs_seg, seg_conv = _pv_converged(
                m_seg, b_full[m_done - 1], int(nroot), bool(cfg.find_maximum), cfg.eps, pevs,
                n_protect=n_protect,
            )
            if seg_conv:
                break
            pevs = evs_seg
            seg = min(2 * seg, m_new)

        _add_reorth(_nro)
        total_iters += m_done
        m_tot = l_cur + m_done
        m_host = assemble_m(a_full, b_full, coup, coup_d, m_done)
        beta_last = b_full[m_done - 1] if m_done >= 1 else 0.0

        evs, cyc_conv = _pv_converged(
            m_host, beta_last, int(nroot), bool(cfg.find_maximum), cfg.eps, pevs,
            n_protect=n_protect,
        )
        # Breakdown in the pv body fires at the f32 CGS noise floor: the
        # residual is at orthogonalization noise, i.e. as converged as this
        # basis can certify.
        if stopped or cyc_conv:
            converged = True
        pevs = evs

        last_cycle = converged or m_tot >= n or cycle == max(cfg.max_restarts, 1) - 1

        if last_cycle:
            w_blk, qz = _pv_final_select(m_host, min(nroot, m_tot), bool(cfg.find_maximum))
            num_out = qz.shape[1]
            qy = np.zeros((num_out, l_keep), np.float64)
            qy[:, :l_cur] = qz[:l_cur].T
            qu = np.zeros((num_out, m_max + 1), np.float64)
            qu[:, :m_done] = qz[l_cur:].T
            vec_hi, vec_lo = _df_rotate(
                *_split_rotation_host(qy, dtype), *_split_rotation_host(qu, dtype),
                y_df, (state.u_buf, state.u_lo),
            )
            vecs = vec_hi + vec_lo
            norms = jnp.sqrt(jnp.sum(vecs * vecs, axis=1, keepdims=True))
            tiny = np.finfo(np.dtype(rdtype)).tiny
            eigvecs = vecs / jnp.maximum(norms, tiny)
            eigenvalues = [float(w_blk[i]) - cfg.eigenvalue_offset for i in range(num_out)]
            converged = converged or m_tot >= n
            return eigenvalues, eigvecs, total_iters, converged

        # ---- restart: carry an exact invariant subspace of M in df64 ------
        q, theta_blk = _select_invariant_pv(m_host, l_keep, bool(cfg.find_maximum))
        l_new = q.shape[1]
        qy = np.zeros((l_keep, l_keep), np.float64)
        qy[:l_new, :l_cur] = q[:l_cur].T
        qu = np.zeros((l_keep, m_max + 1), np.float64)
        qu[:l_new, :m_done] = q[l_cur:].T
        y_df = _df_rotate(
            *_split_rotation_host(qy, dtype), *_split_rotation_host(qu, dtype),
            y_df, (state.u_buf, state.u_lo),
        )
        # The relation A V = V M + beta_last r e_last^T restricted to the kept
        # subspace: A Y = Y Theta + r (beta_last * Q[last U row, :]).
        s_kept = beta_last * q[l_cur + m_done - 1, :]
        defl_big = defl_big.at[nd_cap : nd_cap + l_keep].set(y_df[0])
        defl_lo_big = defl_lo_big.at[nd_cap : nd_cap + l_keep].set(y_df[1])
        mask_big = mask_big.at[nd_cap : nd_cap + l_keep].set(
            (jnp.arange(l_keep) < l_new).astype(np.dtype(rdtype))
        )
        v0 = jax.lax.dynamic_index_in_dim(state.u_buf, m_done, axis=0, keepdims=False)
        v0_lo = jax.lax.dynamic_index_in_dim(state.u_lo, m_done, axis=0, keepdims=False)

    # max_restarts exhausted without last_cycle triggering (unreachable: the
    # final loop iteration always sets last_cycle) — defensive return.
    raise AssertionError("pv thick restart exited without extraction")
