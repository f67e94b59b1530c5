"""Dense maximum-eigenpair sample (reference: src/samples/sample1_simple.cpp).

Find the largest eigenvalue of
    [[2, 1, 1],
     [1, 2, 1],
     [1, 1, 2]]   ->  lambda = 4, v = (1,1,1)/sqrt(3).
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

from lanczos_tpu import LambdaLanczos

matrix = jnp.asarray([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])

engine = LambdaLanczos(matrix, find_maximum=True)
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.16g}")
print("Eigenvector:", " ".join(f"{float(x):.16g}" for x in eigenvector))
