"""Sparse (COO triplet) minimum-eigenvalue sample
(reference: src/samples/sample2_sparse.cpp).

The 3x3 antisymmetric-pattern matrix
    0  1  1
    1  0 -1
    1 -1  0
has eigenvalues {1, 1, -2}; find the minimum.  ``eigenvalue_offset`` shifts
the spectrum so the wanted end has the largest magnitude — the Gershgorin
bound from :func:`lanczos_tpu.utils.estimate.suggest_eigenvalue_offset` is a
safe choice (reference: src/determine_eigenvalue_offset).
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
import jax.numpy as jnp

from lanczos_tpu import COOOperator, LambdaLanczos
from lanczos_tpu.utils.estimate import suggest_eigenvalue_offset

rows = [0, 0, 1, 1, 2, 2]
cols = [1, 2, 0, 2, 0, 1]
vals = [1.0, 1.0, 1.0, -1.0, 1.0, -1.0]

op = COOOperator.from_arrays(rows, cols, jnp.asarray(vals), 3)

engine = LambdaLanczos(op, find_maximum=False)
engine.eigenvalue_offset = suggest_eigenvalue_offset(op, find_maximum=False)  # -2.0
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.16g}")  # expect -2
print("Eigenvector:", " ".join(f"{float(x):.16g}" for x in eigenvector))
