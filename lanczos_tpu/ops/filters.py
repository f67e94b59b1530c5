"""Chebyshev spectral-filter operator: B = T_p((A - c)/e).

An acceleration with no reference counterpart: at production scale the
Lanczos hot loop is REORTHOGONALIZATION-bound (streaming k live basis rows
from device memory moves ~k/2 times the bytes of a two-diagonal stencil
matvec), so the right trade is to spend MORE matvecs to need FEWER Lanczos
iterations.  Wrapping the operator in a degree-p
Chebyshev polynomial does exactly that: the filter damps the unwanted part
of the spectrum into [-1, 1] and grows the wanted mu-band like
cosh(p*sqrt(2*mu/e)), manufacturing a huge spectral gap.  Lanczos on B then
converges in tens of iterations with a tiny (<=48-row) basis — reorth cost
vanishes — and each filtered iteration is a ``lax.scan`` chain of p cheap
matvecs that XLA fuses without any basis traffic.

The classic reference for the approach is Chebyshev-filtered subspace
iteration (Zhou & Saad, 2006) / the ChASE library; here the filter composes
with the existing engines as just another ``LinearOperator``.

Accuracy semantics: every eigenvalue inside the amplified mu-band maps above
T_p(1)=1 while the damped rest stays within [-1, 1]; a converged B-space
Ritz vector therefore lives in the span of A-eigenvectors whose eigenvalues
are within mu of the wanted edge, so its A-space Rayleigh quotient is within
~mu of the true eigenvalue (exactly the coarse-eps / huge-n regime — for
reference-grade 1e-13 work use ``precise_vectors``, where the df64 basis is
the cost that matters).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .operators import LinearOperator

__all__ = ["ChebyshevFilterOperator"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ChebyshevFilterOperator(LinearOperator):
    """B = T_p((A - c)/e) for a Hermitian ``op`` (degree is compile-static).

    ``c`` and ``e`` are traced leaves: re-targeting the damp window reuses
    the compiled program; changing ``degree`` retraces (it is the scan
    length).  Build with :meth:`from_interval`.
    """

    op: LinearOperator
    c: jax.Array          # window center (scalar, real dtype of op)
    e: jax.Array          # window half-width (scalar)
    degree: int = 8
    # Which side of the damp window holds the amplified band: -1 = below
    # (find_maximum=False), +1 = above.  Needed by ``invert_value`` — with
    # even degree BOTH sides amplify positively, so the map is two-valued
    # until the target side is pinned.
    side: int = -1

    @property
    def n(self):
        return self.op.n

    @n.setter
    def n(self, value):  # derived
        pass

    @property
    def dtype(self):
        return self.op.dtype

    @classmethod
    def from_interval(cls, op, degree: int, lo: float, hi: float, mu: float, *, find_maximum: bool = False):
        """Filter amplifying the mu-band at the wanted end of [lo, hi].

        ``find_maximum=False`` damps [lo+mu, hi] (bottom band amplified);
        ``find_maximum=True`` damps [lo, hi-mu].  ``[lo, hi]`` MUST enclose
        the whole spectrum (use a safe bound like Gershgorin for the far
        end: an eigenvalue outside the damp window on the far side is
        amplified exponentially and destroys the solve).
        """
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        if not (0 < mu < (hi - lo)):
            raise ValueError(f"mu must lie in (0, hi-lo), got {mu}")
        if degree < 2:
            raise ValueError("degree must be >= 2")
        rdt = np.dtype(op.dtype)
        if rdt.kind == "c":
            rdt = np.dtype(np.float32) if rdt == np.complex64 else np.dtype(np.float64)
        a, b = (lo + mu, hi) if not find_maximum else (lo, hi - mu)
        c = jnp.asarray(0.5 * (a + b), rdt)
        e = jnp.asarray(0.5 * (b - a), rdt)
        return cls(op, c, e, int(degree), side=(1 if find_maximum else -1))

    def matvec(self, x):
        c, e = self.c, self.e  # real scalars; broadcasting handles complex x
        op = self.op

        def step(carry, _):
            t_prev, t_cur = carry
            t_next = 2.0 * (op.matvec(t_cur) - c * t_cur) / e - t_prev
            return (t_cur, t_next), None

        t1 = (op.matvec(x) - c * x) / e
        (_, tp), _ = jax.lax.scan(step, (x, t1), None, length=self.degree - 1)
        return tp

    def matvec_df(self, x_hi, x_lo):
        """Double-float filter application: the same 3-term recurrence with
        every add/mul as a df64 operation and the base operator's
        ``matvec_df``.  The effective applied operator is then
        T_p(A) + E with ||E|| ~ 2^-45 * (amplified scale) — the precision
        floor that ``invert_value``-based eigenvalues inherit (attenuated
        by 1/T_p', so it is negligible in A-space; see filtered_lanczos
        ``precise=True``)."""
        from ..core import df64

        op = self.op
        zero = jnp.zeros_like(self.c)
        c_df = (self.c, zero)
        inv_e = df64.df_recip((self.e, zero))

        def amc(h, l):
            ah, al = op.matvec_df(h, l)
            ch, cl = df64.df_mul((h, l), c_df)
            sh, sl = df64.df_sub((ah, al), (ch, cl))
            return df64.df_mul((sh, sl), inv_e)

        t1 = amc(x_hi, x_lo)

        def step(carry, _):
            (ph, pl), (ch_, cl_) = carry
            wh, wl = amc(ch_, cl_)
            # 2*w is exact (power-of-two scale), so plain scaling keeps df
            nh, nl = df64.df_sub((2.0 * wh, 2.0 * wl), (ph, pl))
            return ((ch_, cl_), (nh, nl)), None

        (_, (th, tl)), _ = jax.lax.scan(
            step, ((x_hi, x_lo), t1), None, length=self.degree - 1)
        return th, tl

    def invert_value(self, b):
        """Host-side inverse of the filter map on the amplified side:
        the A-eigenvalue lambda with T_p((lambda - c)/e) = b.

        THE SPECTRAL ERROR ATTENUATOR: an eigenvalue error eps_b in
        filtered space maps back as eps_b / T_p'(lambda), and near the
        band T_p' ~ b * degree / sqrt(mu * span) ~ 1e5-1e6 — so B-space
        Ritz values at mere f32/df accuracy return A-values at
        1e-12..1e-18 absolute.  Evaluated stably in f64:
        |y| - 1 = 2*sinh^2(acosh(b)/(2p)) (all positive, no
        cancellation), lambda = window_edge -/+ e*(|y| - 1).
        Values b <= 1 (damped bulk — never a band member) return NaN.
        """
        b = np.asarray(b, np.float64)
        p = float(self.degree)
        c = float(self.c)
        e = float(self.e)
        with np.errstate(invalid="ignore"):
            u = np.arccosh(np.maximum(b, 1.0))
            ym1 = 2.0 * np.sinh(u / (2.0 * p)) ** 2  # |y| - 1 >= 0
            lam = np.where(
                np.asarray(b) > 1.0,
                (c - e - e * ym1) if self.side < 0 else (c + e + e * ym1),
                np.nan,
            )
        return lam

    def eval_scalar(self, x):
        """Host-side T_p((x - c)/e) — the filter's action on an eigenvalue
        at ``x`` (diagnostics / tests).  Uses the cosh/cos closed forms so
        |y| > 1 does not overflow the recurrence order."""
        y = (np.asarray(x, np.float64) - float(self.c)) / float(self.e)
        p = self.degree
        out = np.empty_like(y)
        inside = np.abs(y) <= 1.0
        out[inside] = np.cos(p * np.arccos(np.clip(y[inside], -1.0, 1.0)))
        yo = y[~inside]
        out[~inside] = np.sign(yo) ** p * np.cosh(p * np.arccosh(np.abs(yo)))
        return out

    def tree_flatten(self):
        return (self.op, self.c, self.e), (self.degree, self.side)

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, c, e = children
        return cls(op, c, e, *aux)
