"""Advanced engines sample (extensions; no reference counterpart):

* block Lanczos — a triple-degenerate eigenvalue captured in one restart,
* thick restart (TRLan) — full accuracy on a clustered spectrum under a
  hard memory cap,
* checkpoint/resume around either.
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

from lanczos_tpu import LambdaLanczos

rng = np.random.default_rng(7)

# --- block Lanczos on a triple-degenerate top eigenvalue --------------------
n = 60
q, _ = np.linalg.qr(rng.standard_normal((n, n)))
w = np.concatenate([[9.0, 9.0, 9.0], rng.uniform(-2, 2, n - 3)])
a = (q * w) @ q.T

eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
eng.block_size = 3
vals, vecs = eng.run()
print("block Lanczos, triple eigenvalue 9:", " ".join(f"{v:.12g}" for v in vals),
      f"({len(eng.iteration_counts)} restart(s))")

# --- thick restart under a memory cap ---------------------------------------
n = 400
chain = np.zeros((n, n))
i = np.arange(n - 1)
chain[i, i + 1] = chain[i + 1, i] = -1.0

eng = LambdaLanczos(jnp.asarray(chain), find_maximum=False)
eng.eigenvalue_offset = -4.0
eng.max_iteration = 30          # hard cap: 30-vector basis for an n=400 problem
eng.max_restarts = 64
eng.restart_policy = "thick"
val, vec = eng.run_one()
print(f"thick restart: eigenvalue {val:.14g} (exact {-2*np.cos(np.pi/(n+1)):.14g}, "
      f"{eng.iteration_counts[0]} total iterations in a 30-vector basis)")

# --- block + thick: a degenerate cluster under the same memory cap -----------
# Width-3 block cycles (device-resident) with TRLan arrowhead restarts: the
# three lowest chain eigenvalues converge together in ONE deflation round
# (+1 confirmation), with every reorthogonalization pass shared by the block.
eng = LambdaLanczos(jnp.asarray(chain), find_maximum=False, num_eigs=3)
eng.eigenvalue_offset = -4.0
eng.max_iteration = 48          # basis ROWS (16 width-3 blocks)
eng.max_restarts = 64
eng.restart_policy = "thick"
eng.block_size = 3
vals, vecs = eng.run()
exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
print("block+thick:", " ".join(f"{v:.12g}" for v in sorted(vals)),
      f"(exact {' '.join(f'{e:.12g}' for e in exact)}, "
      f"{len(eng.iteration_counts)} deflation round(s))")

# --- precise_vectors + thick: reference-grade accuracy, bounded memory -------
# Double-float (hi, lo) Krylov basis carried across thick-restart cycles: in
# f32 storage this reaches the reference's f64 tolerance regime
# (~1e-13, lambda_lanczos.hpp:150) with a FIXED 40-row basis.  On the CPU
# sample path it runs the same engine in f32 storage.
eng = LambdaLanczos(jnp.asarray(chain, jnp.float32), find_maximum=False,
                    num_eigs=2, dtype=np.float32, mode="fused")
eng.precise_vectors = True
eng.restart_policy = "thick"
eng.max_iteration = 40
eng.max_restarts = 64
eng.eps = 1e-12
eng.eigenvalue_offset = -4.0
vals, vecs = eng.run()
exact2 = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
err = max(abs(v - e) for v, e in zip(sorted(vals), exact2))
print(f"precise_vectors+thick (f32 storage, 40-row basis): "
      f"{' '.join(f'{v:.14g}' for v in sorted(vals))} — max err {err:.2e}")
