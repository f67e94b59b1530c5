"""Multiple-eigenpair sample (reference: src/samples/sample5_multiroot.cpp).

Find the 2 largest eigenpairs of an 8x8 matrix with deflated restarts.
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

n = 8
rng = np.random.default_rng(42)
a = rng.standard_normal((n, n))
a = (a + a.T) / 2

engine = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=2)
eigenvalues, eigenvectors = engine.run()

print("Eigenvalues:", " ".join(f"{v:.12g}" for v in eigenvalues))
print("numpy check:", " ".join(f"{v:.12g}" for v in np.linalg.eigvalsh(a)[::-1][:2]))
for k in range(len(eigenvalues)):
    r = np.linalg.norm(a @ np.asarray(eigenvectors[k]) - eigenvalues[k] * np.asarray(eigenvectors[k]))
    print(f"residual[{k}] = {r:.3e}")
