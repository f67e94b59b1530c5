"""User-facing API mirroring the reference surface.

``LambdaLanczos`` <-> reference class of the same name
(include/lambda_lanczos/lambda_lanczos.hpp:109-415): constructor
``(mv_mul, matrix_size, find_maximum, num_eigs)`` (:200-208), mutable config
fields (:126-181), ``run()`` returning (eigenvalues, eigenvectors) (:330-386),
single-pair ``run_one`` (:394-407) and ``iteration_counts`` (:412-414).

``Exponentiator`` <-> reference Exponentiator
(include/lambda_lanczos/exponentiator.hpp:24-211): ``run(a, input)`` computes
``exp(a*A) @ input`` (:87-173), ``taylor_run`` the Taylor fallback (:175-210).

Differences by design: the matvec can be any
:class:`~lanczos_tpu.ops.operators.LinearOperator` (dense / COO / CSR / BSR /
DIA / matrix-free / sharded) instead of a ``std::function`` over
``std::vector``; vectors are jnp arrays that may carry a mesh sharding; and
the execution engine is selectable — hybrid (per-iteration host solve,
reference semantics), fused (whole Krylov build in one ``lax.while_loop``),
block (block matvecs), thick restart (TRLan bounded memory).  Engine
dispatch for every path (including :class:`CheckpointedRun`) goes through
``_iterate_factory`` and the shared ``deflation_driver``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .core.types import default_lanczos_eps, default_exponentiator_eps
from .ops.operators import LinearOperator, as_operator
from .solvers import lanczos as _lanczos
from .solvers import exponentiator as _expm
from .utils.random import random_initializer

__all__ = ["LambdaLanczos", "Exponentiator"]


def _coerce_operator(mv_mul, matrix_size, dtype):
    """Shared operator/size/dtype resolution for both engines (one place for
    the LinearOperator / matrix-free-callable / array coercion rules)."""
    if isinstance(mv_mul, LinearOperator):
        op = mv_mul
    elif callable(mv_mul):
        if matrix_size is None or dtype is None:
            raise ValueError("matrix-free usage needs matrix_size and dtype")
        op = as_operator(mv_mul, matrix_size, dtype)
    else:
        op = as_operator(mv_mul)
    n = int(matrix_size if matrix_size is not None else op.n)
    dt = np.dtype(dtype if dtype is not None else op.dtype)
    return op, n, dt


class LambdaLanczos:
    """Extremal-eigenpair Lanczos engine with deflated restarts."""

    def __init__(self, mv_mul, matrix_size=None, find_maximum: bool = False, num_eigs: int = 1, *, dtype=None, mode: str = "auto"):
        self.operator, self.matrix_size, self.dtype = _coerce_operator(mv_mul, matrix_size, dtype)

        # Public tunables (reference lambda_lanczos.hpp:126-181).
        self.find_maximum = bool(find_maximum)
        self.num_eigs = int(num_eigs)
        self.max_iteration: int | None = None  # None -> matrix_size
        self.eps: float = default_lanczos_eps(self.dtype)
        self.eigenvalue_offset: float = 0.0
        self.num_eigs_per_iteration: int = 5
        self.init_vector = None  # callable(n)->vec, array, or None (random)
        self.tridiag_backend: str | None = None
        self.precise_reductions: bool | None = None
        # Double-float Krylov vectors (fused engine): reference-grade
        # eigenvalue accuracy (~1e-11) in pure f32 arithmetic.  Set eps
        # accordingly (e.g. 1e-10); requires a df-capable operator.
        self.precise_vectors: bool = False
        self.convergence_check_interval: int | None = None  # fused: solve cadence (None=auto)
        # None=auto (1 for selective policy — classical single triggered
        # pass; 2 otherwise), 2=CGS2 (robust), 1=single sweep (fast).
        self.reorth_passes: int | None = None
        self.reorth_policy: str = "full"  # fused: 'full' | 'selective' (omega recurrence)
        # Initial Krylov-buffer capacity; doubles on demand (the analogue of
        # the reference's initial_vector_size, lambda_lanczos.hpp:181).
        self.initial_buffer_size: int = 64
        # Block Lanczos: >1 runs the block engine (block matvecs; a
        # block of size b captures multiplicity <= b in one restart).
        self.block_size: int = 1
        # Warm restarts when max_iteration caps the basis below convergence
        # (bounded-memory mode); 1 disables.
        self.max_restarts: int = 16
        self.restart_policy: str = "warm"  # 'warm' | 'thick' (TRLan)
        # Skip the confirming nothing_added deflation round once num_eigs
        # pairs are held (see LanczosConfig.stop_when_full; opt-in — only
        # when an independent check verifies the returned set).
        self.stop_when_full: bool = False
        # Thick restart: Ritz vectors kept across a restart (None = engine
        # default; wider keeps converge degenerate clusters deeper per cycle).
        self.thick_keep: int | None = None
        self.mode = mode

        self._iteration_counts: list[int] = []
        self._stats = None

    # -- config plumbing ----------------------------------------------------

    def _config(self) -> _lanczos.LanczosConfig:
        return _lanczos.LanczosConfig(
            matrix_size=self.matrix_size,
            find_maximum=self.find_maximum,
            num_eigs=self.num_eigs,
            max_iteration=self.max_iteration,
            eps=self.eps,
            eigenvalue_offset=self.eigenvalue_offset,
            num_eigs_per_iteration=self.num_eigs_per_iteration,
            tridiag_backend=self.tridiag_backend,
            precise_reductions=self.precise_reductions,
            precise_vectors=self.precise_vectors,
            convergence_check_interval=self.convergence_check_interval,
            reorth_passes=self.reorth_passes,
            reorth_policy=self.reorth_policy,
            initial_buffer_size=self.initial_buffer_size,
            max_restarts=self.max_restarts,
            restart_policy=self.restart_policy,
            thick_keep=self.thick_keep,
            stop_when_full=self.stop_when_full,
        )

    def _init_fn(self):
        iv = self.init_vector
        if iv is None:
            return random_initializer(self.dtype)
        if callable(iv):
            return iv
        arr = jnp.asarray(iv, self.dtype)
        return lambda n: arr

    def _resolve_mode(self) -> str:
        """'auto' -> fused on accelerators (host syncs are the bottleneck),
        hybrid on CPU (host tridiagonal solves are cheap there).
        ``precise_vectors`` is a fused-engine feature and forces it."""
        if self.mode not in ("auto", "fused", "hybrid"):
            raise ValueError(
                f"mode must be 'auto', 'fused' or 'hybrid', got {self.mode!r}"
            )
        if self.precise_vectors:
            if self.mode not in ("auto", "fused"):
                raise ValueError("precise_vectors is implemented by the fused engine; use mode='fused' or 'auto'")
            return "fused"
        if self.mode != "auto":
            return self.mode
        import jax

        return "hybrid" if jax.default_backend() == "cpu" else "fused"

    def _iterate_factory(self, cfg):
        """(iterate_one, v0_rows, use_warm_restarts) for the configured
        engine — the single dispatch point shared by run() and
        CheckpointedRun so every execution path selects engines identically.
        ``iterate_one(v0, nroot, defl, defl_mask) -> (vals, vecs, itern,
        converged)``."""
        op = self.operator
        if self.precise_vectors and self.block_size > 1 and self.restart_policy != "thick":
            raise ValueError(
                "precise_vectors with block_size > 1 requires "
                "restart_policy='thick' (the plain block engine has no pv path)"
            )
        if self.block_size > 1:
            b = int(self.block_size)
            if self.restart_policy == "thick":
                # Fused block thick restart: multiplicity-<=b clusters in one
                # build, bounded memory, device-resident cycles.
                from .solvers import block_thick

                return (
                    lambda v0, nroot, defl, mask: block_thick.block_thick_iteration_fused(
                        op, v0, nroot, defl, mask, cfg, b
                    ),
                    b,
                    False,
                )
            from .solvers import block_lanczos

            return (
                lambda v0, nroot, defl, mask: block_lanczos.block_lanczos_iteration(
                    op, v0, nroot, defl, mask, cfg, b
                ),
                b,
                True,
            )
        if self.restart_policy == "thick":
            from .solvers import thick_restart

            if self._resolve_mode() == "fused":
                return (
                    lambda v0, nroot, defl, mask: thick_restart.thick_lanczos_iteration_fused(
                        op, v0, nroot, defl, mask, cfg
                    ),
                    1,
                    False,
                )
            return (
                lambda v0, nroot, defl, mask: thick_restart.thick_lanczos_iteration(
                    op, v0, nroot, defl, mask, cfg
                ),
                1,
                False,
            )
        if self._resolve_mode() == "fused":
            from .solvers import lanczos_fused

            return (
                lambda v0, nroot, defl, mask: lanczos_fused.lanczos_iteration_fused(
                    op, v0, nroot, defl, mask, cfg
                ),
                1,
                True,
            )
        return (
            lambda v0, nroot, defl, mask: _lanczos.lanczos_iteration(op, v0, nroot, defl, mask, cfg),
            1,
            True,
        )

    # -- execution ----------------------------------------------------------

    def run(self):
        """Full deflation-driven solve; returns (eigenvalues, eigenvectors)
        with ``eigenvectors[k]`` the k-th eigenvector (reference run(),
        lambda_lanczos.hpp:330-386)."""
        import time

        from .utils.stats import RunStats, trace_span

        from .core.tridiagonal import unconverged_total
        from .solvers.lanczos_fused import reorth_total

        t0 = time.perf_counter()
        unconv0 = unconverged_total()
        reorth0 = reorth_total()
        with trace_span("lanczos_tpu.run"):
            cfg = self._config().resolved(self.dtype)
            iterate_one, v0_rows, use_warm = self._iterate_factory(cfg)
            result = _lanczos.deflation_driver(
                iterate_one, cfg, self._init_fn(), self.dtype,
                v0_rows=v0_rows, use_warm_restarts=use_warm,
            )
        self._iteration_counts = result.iteration_counts
        unconv = unconverged_total() - unconv0
        if unconv:
            import warnings

            from .diagnostics import AccuracyWarning

            warnings.warn(
                f"{unconv} tridiagonal block(s) hit the native QL iteration cap; "
                "small-solve results may be inaccurate (see RunStats.tridiag_unconverged)",
                AccuracyWarning,
                stacklevel=2,
            )
        if result.unconverged_rounds:
            import warnings

            msg = (
                f"{result.unconverged_rounds} deflation round(s) exhausted the "
                "max_restarts/max_iteration budget with the Ritz values still "
                "moving — results may be budget-limited, not eps-converged; "
                "check residuals() or raise the budgets"
            )
            # Engine-economics hint:
            # thick-restart convergence DEPTH per cycle is rows/block_size,
            # so on targets that are distinct at the requested eps the block
            # engine pays block_size x the row budget for equal depth and
            # budget-stalls where the scalar engine converges.  Block wins
            # only on EXACT degeneracy (multiplicity <= b per round).
            if self.block_size > 1 and len(result.eigenvalues) > 1:
                ev = np.sort(np.asarray(result.eigenvalues, np.float64))
                gaps = np.diff(ev)
                # "distinct" means resolvable at the ACHIEVABLE accuracy:
                # values closer than max(eps, machine_eps*1e3)*scale (the
                # reference's own default tolerance floor,
                # lambda_lanczos.hpp:150) are effectively degenerate — a
                # budget-starved degenerate run must not trigger the hint
                # just because its copies carry fp noise.
                from .core.types import real_dtype as _real_dtype

                floor = float(np.finfo(_real_dtype(self.dtype)).eps) * 1e3
                # scale by the SPECTRAL magnitude, not pairwise magnitudes:
                # a degenerate cluster at/near 0 would otherwise get tol ~ 0
                # and its fp noise would read as "distinct" (round-4 review)
                scale = float(np.max(np.abs(ev)))
                tol = max(cfg.eps, floor) * scale
                if scale > 0.0 and np.all(gaps > tol):
                    msg += (
                        ". The best Ritz values came out DISTINCT "
                        f"(min gap {gaps.min():.1e}): if your targets are "
                        "clustered-but-distinct, block_size=1 converges faster — "
                        "block thick restart needs block_size x the iteration "
                        "budget for equal convergence depth and wins only on "
                        "exact degeneracy (then keep block_size and raise the "
                        "budgets; see docs/API.md, engine economics)"
                    )
            from .diagnostics import BudgetExhaustedWarning

            warnings.warn(msg, BudgetExhaustedWarning, stacklevel=2)
        self._stats = RunStats(
            list(result.iteration_counts), time.perf_counter() - t0, tridiag_unconverged=unconv,
            reorth_count=reorth_total() - reorth0,
            unconverged_rounds=result.unconverged_rounds,
        )
        return result.eigenvalues, result.eigenvectors

    def run_one(self):
        """Single best eigenpair regardless of ``num_eigs``
        (reference run(eigenvalue, eigenvector), lambda_lanczos.hpp:394-407)."""
        saved = self.num_eigs
        self.num_eigs = 1
        try:
            vals, vecs = self.run()
        finally:
            self.num_eigs = saved
        return float(vals[0]), vecs[0]

    @property
    def iteration_counts(self) -> list[int]:
        """Per-restart Lanczos iteration counts of the latest run
        (reference getIterationCounts, lambda_lanczos.hpp:412-414)."""
        return self._iteration_counts

    @property
    def stats(self):
        """:class:`~lanczos_tpu.utils.stats.RunStats` of the latest run
        (iteration counts + wall time); None before the first run."""
        return self._stats

    def residuals(self, eigenvalues, eigenvectors):
        """||A v_k - lambda_k v_k|| for each returned pair — the a-posteriori
        quality metric (costs one matvec per pair).  Accepts the outputs of
        :meth:`run` directly."""
        import jax.numpy as _jnp

        out = []
        for k in range(len(eigenvalues)):
            v = _jnp.asarray(eigenvectors[k])
            r = self.operator.matvec(v) - _jnp.asarray(eigenvalues[k], v.dtype) * v
            out.append(float(_jnp.linalg.norm(r)))
        return out


class Exponentiator:
    """Krylov exponentiation engine: output = exp(a*A) @ input."""

    def __init__(self, mv_mul, matrix_size=None, *, dtype=None, mode: str = "hybrid"):
        self.operator, self.matrix_size, self.dtype = _coerce_operator(mv_mul, matrix_size, dtype)

        # Public tunables (reference exponentiator.hpp:41-71).
        self.max_iteration: int | None = None
        self.eps: float = default_exponentiator_eps(self.dtype)
        self.full_orthogonalize: bool = False
        self.tridiag_backend: str | None = None
        self.initial_buffer_size: int = 16  # Krylov buffer start capacity
        self.mode = mode  # 'hybrid' (per-iteration host solve) | 'fused'

    def _config(self) -> _expm.ExponentiatorConfig:
        return _expm.ExponentiatorConfig(
            matrix_size=self.matrix_size,
            max_iteration=self.max_iteration,
            eps=self.eps,
            full_orthogonalize=self.full_orthogonalize,
            tridiag_backend=self.tridiag_backend,
            initial_buffer_size=self.initial_buffer_size,
        )

    def _herm_split(self):
        """The operator when it is a HermitianSplitOperator, else None."""
        from .ops.hermitian_split import HermitianSplitOperator

        op = self.operator
        return op if isinstance(op, HermitianSplitOperator) else None

    def _herm_embed(self, v_re, v_im=None):
        """Embed a complex n-state (complex array, or split re/im pair) as
        the real 2n vector [psi_re; psi_im]."""
        import numpy as _np

        if v_im is None:
            v = _np.asarray(v_re)
            v_re, v_im = _np.real(v), _np.imag(v)
        return jnp.concatenate([
            jnp.asarray(v_re, self.dtype), jnp.asarray(v_im, self.dtype)])

    @staticmethod
    def _herm_recombine(out_re, out_im, half):
        """Map the SPLIT ``q(M) w`` output rows on the real embedding back
        to complex n-states: real polynomials commute with the embedding,
        so with u = out_re + i*out_im the split output,
        psi = u[..., :n] + i*u[..., n:].  Host complex output (complex
        dtypes never touch the device)."""
        import numpy as _np

        ur = _np.asarray(out_re, _np.float64)
        ui = _np.asarray(out_im, _np.float64)
        return (ur[..., :half] - ui[..., half:]) + 1j * (ur[..., half:] + ui[..., :half])

    def run(self, a, input_vector):
        """(output, iteration_count) = exp(a*A) @ input (exponentiator.hpp:87-173).

        On a :class:`~lanczos_tpu.ops.hermitian_split.HermitianSplitOperator`
        the input is the ORIGINAL n-dim complex state; the Krylov build runs
        on the real 2n embedding (the complex scalar enters only through the
        host coefficients — a polynomial in the embedding with complex
        coefficients, which commutes back to exp(a*H) psi) and a complex
        n-dim host array is returned."""
        if self._herm_split() is not None:
            half = self.operator.op_r.n
            w = self._herm_embed(input_vector)
            (ur, ui), itern = _expm.krylov_expm_apply_grid_split(
                self.operator, [a], w, self._config())
            return self._herm_recombine(ur[0], ui[0], half), itern
        v = jnp.asarray(input_vector, self.dtype)
        if self.mode == "fused":
            from .solvers import exponentiator_fused

            return exponentiator_fused.krylov_expm_apply_fused(self.operator, a, v, self._config())
        return _expm.krylov_expm_apply(self.operator, a, v, self._config())

    def run_grid(self, a_list, input_vector):
        """exp(a_i*A) @ input for a grid of scalars from ONE Krylov build
        (time enters only through the host coefficients, so the basis is
        shared; the grid recombination is one batched device matmul).
        Returns (outputs (num, n), iteration_count).  A
        HermitianSplitOperator takes/returns complex n-dim states (see
        :meth:`run`)."""
        if self._herm_split() is not None:
            half = self.operator.op_r.n
            w = self._herm_embed(input_vector)
            (ur, ui), itern = _expm.krylov_expm_apply_grid_split(
                self.operator, list(a_list), w, self._config())
            return self._herm_recombine(ur, ui, half), itern
        v = jnp.asarray(input_vector, self.dtype)
        return _expm.krylov_expm_apply_grid(self.operator, list(a_list), v, self._config())

    def run_split(self, a, v_re, v_im):
        """exp(a*A) (v_re + i v_im) for a REAL operator with all device work
        in real arithmetic (split complex: two real Krylov builds).  Returns
        ((out_re, out_im), (iters_re, iters_im)).

        On a HermitianSplitOperator, (v_re, v_im) is the ORIGINAL n-dim
        complex state; ONE build on the real 2n embedding covers it, so the
        second tuple element is a single iteration count."""
        if self._herm_split() is not None:
            half = self.operator.op_r.n
            w = self._herm_embed(v_re, v_im)
            (ur, ui), itern = _expm.krylov_expm_apply_grid_split(
                self.operator, [a], w, self._config())
            res = self._herm_recombine(ur[0], ui[0], half)
            return (res.real, res.imag), itern
        from .solvers import exponentiator_fused

        return exponentiator_fused.krylov_expm_apply_split(
            self.operator, a,
            jnp.asarray(v_re, self.dtype), jnp.asarray(v_im, self.dtype),
            self._config(),
        )

    def evolve(self, a, v_re, v_im, steps, krylov_dim: int = 12, renormalize: bool = False, precise: bool = False):
        """``steps`` applications of exp(a*A) entirely on device (split
        complex, fixed Krylov dimension, lax.scan over steps — zero host
        syncs between steps).  Real operator only; ``renormalize`` cancels
        f32 norm drift for unitary evolution.  Returns (re, im).

        ``precise=True`` carries the state (and the whole per-step Krylov
        pipeline) as df64 word pairs — f64-grade evolution fidelity on the
        f32 chip (the f32 path drifts ~1e-7 in state angle per step; see
        solvers/exponentiator_precise.py).  Needs an operator with
        ``matvec_df``; returns host f64 (re, im) arrays.

        On a HermitianSplitOperator, (v_re, v_im) is the ORIGINAL n-dim
        complex state: each step runs ONE Krylov build on the real 2n
        embedding and recombines through the embedding homomorphism
        (solvers/exponentiator_fused.evolve_hermitian_split)."""
        if self._herm_split() is not None:
            if precise:
                from .solvers import exponentiator_precise

                return exponentiator_precise.evolve_hermitian_split_precise(
                    self.operator, v_re, v_im, a, int(steps),
                    int(max(krylov_dim, 16)), renormalize=renormalize)
            from .solvers import exponentiator_fused

            return exponentiator_fused.evolve_hermitian_split(
                self.operator,
                jnp.asarray(v_re, self.dtype), jnp.asarray(v_im, self.dtype),
                a, int(steps), int(krylov_dim), renormalize=renormalize)
        if precise:
            import numpy as _np

            from .solvers import exponentiator_precise

            # pass the raw inputs: host f64 states are df-split in numpy by
            # the precise path (casting to self.dtype here would round them
            # to f32 first and bake a ~1e-8 error into the initial state)
            (rh, rl), (ih, il) = exponentiator_precise.evolve_split_precise(
                self.operator, v_re, v_im,
                a, int(steps), int(krylov_dim), renormalize=renormalize,
            )
            re = _np.asarray(rh, _np.float64) + _np.asarray(rl, _np.float64)
            im = _np.asarray(ih, _np.float64) + _np.asarray(il, _np.float64)
            return re, im
        from .solvers import exponentiator_fused

        return exponentiator_fused.evolve_split(
            self.operator,
            jnp.asarray(v_re, self.dtype), jnp.asarray(v_im, self.dtype),
            a, int(steps), int(krylov_dim), full_orth=True, renormalize=renormalize,
        )

    def run_chebyshev(self, a, v_re, v_im=None, *, lo=None, hi=None,
                      tol: float = 1e-16, precise: bool = False):
        """exp(a*A) (v_re + i v_im) by the Chebyshev propagator — ONE
        matvec chain of ~|a|*e terms for the WHOLE evolution, no Krylov
        basis (solvers/cheby_expm.py; no reference counterpart — the
        reference's exponentiator is Krylov-only, exponentiator.hpp:
        87-173).  Real operator; ``lo``/``hi`` default to ±Gershgorin and
        MUST enclose the spectrum.  ``precise=True`` runs the chain as
        df64 word pairs (needs ``matvec_df``; f64-grade fidelity on f32
        hardware, host f64 in/out).  Returns ((out_re, out_im), n_terms).
        """
        from .ops.hermitian_split import HermitianSplitOperator
        from .solvers import cheby_expm

        if isinstance(self.operator, HermitianSplitOperator):
            # Complex Hermitian given as its real embedding: the state is
            # the ORIGINAL n-dim complex vector (re/im words), not the 2n
            # embedding — dispatch to the homomorphism-recombined chain.
            import numpy as _np

            if v_im is None:
                v_im = _np.zeros_like(_np.asarray(v_re))
            return cheby_expm.chebyshev_expm_apply_hermitian(
                self.operator, a, v_re, v_im, lo=lo, hi=hi, tol=tol,
                precise=precise)
        if precise:
            import numpy as _np

            if v_im is None:
                v_im = _np.zeros_like(_np.asarray(v_re, _np.float64))
            return cheby_expm.chebyshev_expm_apply_split_precise(
                self.operator, a, v_re, v_im, lo=lo, hi=hi, tol=tol)
        if v_im is None:
            v_im = jnp.zeros_like(jnp.asarray(v_re, self.dtype))
        return cheby_expm.chebyshev_expm_apply_split(
            self.operator, a, jnp.asarray(v_re, self.dtype),
            jnp.asarray(v_im, self.dtype), lo=lo, hi=hi, tol=tol)

    def run_chebyshev_grid(self, a_list, v_re, v_im=None, *, lo=None, hi=None,
                           tol: float = 1e-16):
        """exp(a_j*A) (v_re + i v_im) for every a_j from ONE Chebyshev
        chain (time enters only through the host Bessel coefficients — the
        chain-sharing analogue of :meth:`run_grid`).  Returns
        ((out_re (num, n), out_im (num, n)), n_terms)."""
        from .ops.hermitian_split import HermitianSplitOperator
        from .solvers import cheby_expm

        if v_im is None:
            v_im = jnp.zeros_like(jnp.asarray(v_re, self.dtype))
        if isinstance(self.operator, HermitianSplitOperator):
            return cheby_expm.chebyshev_expm_grid_hermitian(
                self.operator, list(a_list), v_re, v_im, lo=lo, hi=hi, tol=tol)
        return cheby_expm.chebyshev_expm_grid_split(
            self.operator, list(a_list), jnp.asarray(v_re, self.dtype),
            jnp.asarray(v_im, self.dtype), lo=lo, hi=hi, tol=tol)

    def run_batch(self, a, input_batch):
        """Apply exp(a*A) to a (B, n) batch of states in one vmapped device
        program (no reference counterpart; per-state iteration counts match
        single-state runs).  Returns (outputs (B, n), iterations (B,)).

        On a HermitianSplitOperator the batch rows are the ORIGINAL n-dim
        complex states; each row embeds as a real 2n vector (one build per
        row, vmapped) and complex (B, n) rows come back."""
        from .solvers import exponentiator_fused

        if self._herm_split() is not None:
            import numpy as _np

            half = self.operator.op_r.n
            vb = _np.asarray(input_batch)
            w = jnp.concatenate([
                jnp.asarray(_np.real(vb), self.dtype),
                jnp.asarray(_np.imag(vb), self.dtype)], axis=1)
            (ur, ui), iters = exponentiator_fused.krylov_expm_apply_batch_split(
                self.operator, a, w, self._config())
            return self._herm_recombine(ur, ui, half), iters
        v = jnp.asarray(input_batch, self.dtype)
        return exponentiator_fused.krylov_expm_apply_batch(self.operator, a, v, self._config())

    def taylor_run(self, a, input_vector):
        """(output, term_count): Taylor-series fallback (exponentiator.hpp:175-210).
        A HermitianSplitOperator takes/returns complex n-dim states (the
        series is a complex-coefficient polynomial in the embedding — the
        same homomorphism as :meth:`run`)."""
        if self._herm_split() is not None:
            half = self.operator.op_r.n
            w = self._herm_embed(input_vector)
            (ur, ui), terms = _expm.taylor_expm_apply_split(
                self.operator, a, w, self._config())
            return self._herm_recombine(ur, ui, half), terms
        v = jnp.asarray(input_vector, self.dtype)
        return _expm.taylor_expm_apply(self.operator, a, v, self._config())
