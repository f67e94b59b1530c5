"""Foreign-array interop sample (reference: src/samples/sample4_use_Eigen_library.cpp).

The reference shows Eigen::Map interop; the analogue here is zero-copy-ish
interop with numpy / any array protocol: pass the array straight in, or wrap
an existing matmul routine as the matvec.
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

matrix = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])

# a) numpy array directly (converted to a DenseOperator)
val_a, _ = LambdaLanczos(matrix, find_maximum=True).run_one()

# b) an existing "library" matvec wrapped as a matrix-free operator
a_dev = jnp.asarray(matrix)
val_b, _ = LambdaLanczos(lambda x: a_dev @ x, 3, find_maximum=True, dtype=a_dev.dtype).run_one()

print(f"Eigenvalue (array): {val_a:.16g}")
print(f"Eigenvalue (matvec): {val_b:.16g}")
