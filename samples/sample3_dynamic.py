"""Matrix-free sample (reference: src/samples/sample3_dynamic.cpp).

The matrix is never materialized: the operator is a jax-traceable function
computing the 1D hopping stencil  (A x)_i = -x_{i-1} - x_{i+1}.
Minimum eigenvalue of the n-site chain is -2 cos(pi/(n+1)).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

# Samples default to CPU f64 for exact-tolerance output; set
# LT_SAMPLE_PLATFORM=cuda (or any jax platform) to run on an accelerator.
_platform = os.environ.get("LT_SAMPLE_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
import jax

jax.config.update("jax_platforms", _platform)
if _platform == "cpu":
    jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from lanczos_tpu import LambdaLanczos

n = 100


def mv_mul(x):
    left = jnp.concatenate([x[1:], jnp.zeros((1,), x.dtype)])
    right = jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])
    return -left - right


dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
engine = LambdaLanczos(mv_mul, n, find_maximum=False, dtype=dtype)
engine.eigenvalue_offset = -4.0  # Gershgorin bound of the stencil, negated
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.16g}")
print(f"Exact:      {-2 * np.cos(np.pi / (n + 1)):.16g}")
