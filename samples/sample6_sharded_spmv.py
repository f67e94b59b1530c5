"""Sample with no reference counterpart: a row-partitioned sparse
Hamiltonian solved over a device mesh (8 virtual CPU devices here; the same
code runs unchanged on several GPUs).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

# Defaults to CPU with 8 virtual devices; set LT_SAMPLE_PLATFORM=cuda to run
# on real chips instead (then XLA_FLAGS is left alone).
_platform = os.environ.get("LT_SAMPLE_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
if _platform == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", _platform)
if _platform == "cpu":
    jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from lanczos_tpu import LambdaLanczos
from lanczos_tpu.parallel.mesh import make_mesh
from lanczos_tpu.parallel.sharded import ShardedBSROperator

n = 4096
i = np.arange(n - 1)
rows = np.concatenate([i, i + 1])
cols = np.concatenate([i + 1, i])
vals = np.full(2 * (n - 1), -1.0)

mesh = make_mesh()
print(f"mesh: {mesh.devices.size} devices")
op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64)

engine = LambdaLanczos(op, find_maximum=False, mode="fused")
engine.eigenvalue_offset = -4.0
# Cap the Krylov space: the default (= n) sizes the on-device buffers for a
# worst case this well-conditioned problem never reaches.
engine.max_iteration = 256
eigenvalue, eigenvector = engine.run_one()

print(f"Eigenvalue: {eigenvalue:.12g}")
print(f"Exact:      {-2 * np.cos(np.pi / (n + 1)):.12g}")
