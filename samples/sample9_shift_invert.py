"""Shift-invert sample: interior eigenvalues near a target sigma.

The reference library only steers convergence with a spectral shift
(``eigenvalue_offset``, lambda_lanczos.hpp:160-165) — extremal eigenvalues
only.  This framework adds true shift-invert: eigenvalues NEAREST an
interior ``sigma`` via Lanczos on ``(A - sigma I)^{-1}``, with the inverse
applied matrix-free by a jittable MINRES loop (no factorization — works for
any LinearOperator, any size).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

_platform = os.environ.get("LT_SAMPLE_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
import jax

jax.config.update("jax_platforms", _platform)
if _platform == "cpu":
    jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from lanczos_tpu.scipy_compat import eigsh, minres

# A hopping chain with a linear potential: a dense interior spectrum.
n = 500
main = np.linspace(0.0, 5.0, n)
a = np.diag(main) + np.diag(-np.ones(n - 1), 1) + np.diag(-np.ones(n - 1), -1)

sigma = 2.5  # target: eigenvalues nearest the middle of the spectrum
w, v = eigsh(jnp.asarray(a), k=4, sigma=sigma, which="LM", tol=1e-10)
res = [float(np.linalg.norm(a @ v[:, i] - w[i] * v[:, i])) for i in range(4)]
print(f"4 eigenvalues nearest sigma={sigma}:", " ".join(f"{x:.10g}" for x in w))
print("residuals:", " ".join(f"{r:.1e}" for r in res))

exact = np.linalg.eigvalsh(a)
nearest = np.sort(exact[np.argsort(np.abs(exact - sigma))[:4]])
print("max |err| vs dense eigensolver:", f"{np.abs(np.sort(w) - nearest).max():.2e}")

# The underlying solver is scipy-compatible MINRES (indefinite-safe):
b = np.random.default_rng(0).normal(size=n)
x, info = minres(jnp.asarray(a), b, shift=sigma, rtol=1e-10, maxiter=4 * n)
print(f"minres solve: info={info}, true residual "
      f"{np.linalg.norm((a - sigma * np.eye(n)) @ x - b):.1e}")

# --- round 4: the filtered interior mode (no linear solves) -----------------
# eigsh(method='filtered') routes sigma through the squared spectral
# transform instead of shift-invert: no inner MINRES (and sigma exactly ON
# an eigenvalue — fatal for any shift-invert — is the best-conditioned
# case), with precise (inverse-map) values selected automatically at tight
# tol.
wf, vf = eigsh(jnp.asarray(a), k=4, sigma=sigma, which="LM", method="filtered")
print("filtered interior:", " ".join(f"{x:.10g}" for x in wf))
print("max |err| vs dense eigensolver:", f"{np.abs(np.sort(wf) - nearest).max():.2e}")
