"""Complex Hermitian eigenproblems in pure real arithmetic.

Any Hermitian ``H = Hr + i Hi`` (``Hr`` symmetric, ``Hi`` antisymmetric) embeds
as the real symmetric 2n x 2n matrix

    H~ = [[Hr, -Hi],
          [Hi,  Hr]]

whose spectrum is that of ``H`` with every eigenvalue doubled: if
``H (vr + i vi) = lam (vr + i vi)`` then both ``[vr; vi]`` and
``[-vi; vr]`` are eigenvectors of ``H~``.  All of the framework's REAL
machinery (fused engine, df64, selective reorth, sharding) then applies
unchanged; :func:`solve_hermitian` runs the embedded solve and folds the
doubled pairs back into complex eigenvectors on host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .operators import LinearOperator

__all__ = ["HermitianSplitOperator", "solve_hermitian"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HermitianSplitOperator(LinearOperator):
    """Real embedding of a complex Hermitian operator.

    ``op_r`` applies the (symmetric) real part, ``op_i`` the (antisymmetric)
    imaginary part; the embedded dimension is ``2 * op_r.n``.  ``op_i=None``
    means a real symmetric operator (embedding still useful for uniformity).
    """

    op_r: LinearOperator
    op_i: LinearOperator | None = None

    @property
    def n(self):
        return 2 * self.op_r.n

    @n.setter
    def n(self, value):  # derived
        pass

    @property
    def dtype(self):
        return self.op_r.dtype

    def matvec(self, x):
        half = self.op_r.n
        vr, vi = x[:half], x[half:]
        yr = self.op_r.matvec(vr)
        yi = self.op_r.matvec(vi)
        if self.op_i is not None:
            yr = yr - self.op_i.matvec(vi)
            yi = yi + self.op_i.matvec(vr)
        return jnp.concatenate([yr, yi])

    def matvec_df(self, x_hi, x_lo):
        """Double-float embedded matvec, composed from the sub-operators'
        ``matvec_df`` — this is what makes ``precise_vectors`` available for
        complex Hermitian problems (the pv engines are real-only by design;
        the embedding is the complex route, so it must carry df64 too)."""
        from ..core import df64

        half = self.op_r.n
        yr = self.op_r.matvec_df(x_hi[:half], x_lo[:half])
        yi = self.op_r.matvec_df(x_hi[half:], x_lo[half:])
        if self.op_i is not None:
            yr = df64.df_sub(yr, self.op_i.matvec_df(x_hi[half:], x_lo[half:]))
            yi = df64.df_add(yi, self.op_i.matvec_df(x_hi[:half], x_lo[:half]))
        return jnp.concatenate([yr[0], yi[0]]), jnp.concatenate([yr[1], yi[1]])

    def to_complex(self, vec):
        """Map an embedded eigenvector [vr; vi] back to vr + i vi (host)."""
        half = self.op_r.n
        v = np.asarray(vec)
        c = v[:half] + 1j * v[half:]
        nrm = np.linalg.norm(c)
        return c / nrm if nrm > 0 else c

    def tree_flatten(self):
        return (self.op_r, self.op_i), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def solve_hermitian(op_r, op_i, num_eigs: int = 1, find_maximum: bool = False, *,
                    method: str = "lanczos", precise: bool = False,
                    configure=None, **filtered_kwargs):
    """Extremal eigenpairs of the complex Hermitian ``Hr + i Hi`` via the
    real embedding, entirely in real device arithmetic.

    Returns ``(eigenvalues (k,), eigenvectors complex (k, n))`` with the
    doubled embedded pairs folded: within each (near-)equal-eigenvalue
    group the complex images are orthonormalized and half of them kept.
    ``configure(engine)`` may set any LambdaLanczos knob before the run.

    ``method="filtered"`` routes the embedded solve through
    :func:`~lanczos_tpu.solvers.filtered.filtered_lanczos` (the embedding
    carries ``matvec_df``, so ``precise=True`` gives the f64-exact values
    + df-refined vectors path); every doubled pair is an EXACT degeneracy
    in the embedding, which is the filtered driver's probe-covered case.
    Extra ``filtered_kwargs`` (mu, degree, lo, hi, ...) pass through.
    """
    from ..api import LambdaLanczos

    emb = HermitianSplitOperator(op_r, op_i)
    if method == "filtered":
        from ..solvers.filtered import filtered_lanczos

        vals, vecs, _info = filtered_lanczos(
            emb, 2 * num_eigs, find_maximum, precise=precise,
            configure=configure, **filtered_kwargs)
        eng_eps = 1e-10 if precise else 1e-5  # pair tolerance scale below
        vals = np.asarray(vals, np.float64)
        return _fold_pairs(emb, vals, np.asarray(vecs), num_eigs, eng_eps)
    elif method != "lanczos":
        raise ValueError(f"method must be 'lanczos' or 'filtered', got {method!r}")
    eng = LambdaLanczos(emb, find_maximum=find_maximum, num_eigs=2 * num_eigs)
    if configure is not None:
        configure(eng)
    vals, vecs = eng.run()

    return _fold_pairs(emb, np.asarray(vals), vecs, num_eigs, float(eng.eps))


def _fold_pairs(emb, vals, vecs, num_eigs, eps):
    """Fold doubled embedded pairs into complex eigenpairs.

    Every eigenvalue of H appears EXACTLY twice in the embedding, so the
    sorted output is v1,v1,v2,v2,...: selection is positional (every other
    entry), never tolerance-based — a relative tolerance would merge
    genuinely distinct but close eigenvalues on the f32 path and mislabel
    them.  The only subtlety is independence of the complex images: the
    two real partners of one complex eigenvector map to phase multiples of
    the same complex direction, so each selected image is orthogonalized
    against everything kept so far and, if it collapses (it was a
    duplicate direction), its positional partner is used instead.

    Positional pairing is only valid when vals[i+1] actually IS the
    doubled copy of vals[i]; if the solve terminated before finding both
    embedded copies of some eigenvalue, position i+1 holds a *different*
    eigenvalue and must not be attached to vals[i] as a complex image.
    """
    pair_tol = 1e3 * float(eps) * max(1.0, float(np.max(np.abs(vals))) if len(vals) else 1.0)
    out_vals: list[float] = []
    out_vecs: list[np.ndarray] = []
    kept: list[np.ndarray] = []
    i = 0
    while i < min(len(vals), 2 * num_eigs) and len(out_vals) < num_eigs:
        candidates = [emb.to_complex(np.asarray(vecs[i]))]
        paired = i + 1 < len(vals) and abs(vals[i + 1] - vals[i]) <= pair_tol
        if paired:
            candidates.append(emb.to_complex(np.asarray(vecs[i + 1])))
        chosen = None
        for g in candidates:
            for u in kept:
                g = g - np.vdot(u, g) * u
            nrm = np.linalg.norm(g)
            if nrm > 1e-6:
                chosen = g / nrm
                break
        if chosen is not None:
            kept.append(chosen)
            out_vals.append(float(vals[i]))
            out_vecs.append(chosen)
        # Advance past the PARTNER only when vals[i+1] really was the doubled
        # copy — when pairing is broken (a round found only one embedded
        # copy), index i+1 holds a DIFFERENT eigenvalue that must be
        # examined as a primary, not skipped.
        i += 2 if paired else 1
    return np.asarray(out_vals), np.asarray(out_vecs)
