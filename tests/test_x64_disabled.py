"""The x64-DISABLED runtime paths, locked in CI.

JAX's default runtime has jax_enable_x64 OFF, where a traced f64 is
SILENTLY truncated to f32 — the bug class that bit three separate times
(ScaledOperator's shift words, api.evolve's initial state, the
Chebyshev coefficient splits).  The suite otherwise runs
with x64 ON (conftest), so those host-split code paths were only ever
exercised on real hardware.  This test runs the precise paths in a FRESH
interpreter with x64 off and asserts they still reach df64-grade accuracy
— i.e. every f64 quantity crossing the trace boundary was split in numpy
first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

_SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("JAX_ENABLE_X64", None)
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import json
import numpy as np
import scipy.linalg as sla
from lanczos_tpu import DIAOperator, Exponentiator, filtered_lanczos

out = {}
n = 512
op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)

# precise filtered eigenvalues (df64 B solve + inverse map, f32 runtime)
# + round-5 refined vectors (df64 filter-subspace iteration, numpy splits)
exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
vals, vv, _i = filtered_lanczos(op, num_eigs=2, lo=-2.0, hi=2.0, precise=True)
out["eig_err"] = float(max(abs(float(vals[i]) - exact[i]) for i in range(2)))
vv = np.asarray(vv, np.float64)
res_v = 0.0
for i in range(2):
    av = np.empty(n)
    av[0] = -vv[i][1]
    av[-1] = -vv[i][-2]
    av[1:-1] = -(vv[i][:-2] + vv[i][2:])
    res_v = max(res_v, float(np.linalg.norm(av - float(vals[i]) * vv[i])))
out["vec_res"] = res_v

# precise Chebyshev propagation (df coefficient + state splits)
A = np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 1, -1.0), 1)
rng = np.random.default_rng(0)
psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
psi /= np.linalg.norm(psi)
truth = sla.expm(3j * A) @ psi
ex = Exponentiator(op, dtype=np.float32)
(re, im), _K = ex.run_chebyshev(3j, psi.real, psi.imag, lo=-2.0, hi=2.0, precise=True)
out["expm_rel"] = float(np.linalg.norm((re + 1j * im) - truth) / np.linalg.norm(truth))

# precise Chebyshev propagation of a COMPLEX Hermitian (split embedding):
# the state must be concatenated in NUMPY f64 before the df split — routing
# it through jnp on this x64-disabled runtime truncates it to f32 first
# (measured 2.6e-8 instead of ~1e-12 before the fix)
from lanczos_tpu import DenseOperator
from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator
rng = np.random.default_rng(3)
m = 80
H = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
H = (H + H.conj().T) / 2
Hr = np.real(H).astype(np.float32)
Hi = np.imag(H).astype(np.float32)
H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
H32 = (H32 + H32.conj().T) / 2
hop = HermitianSplitOperator(DenseOperator(Hr, m), DenseOperator(Hi, m))
phi = rng.standard_normal(m) + 1j * rng.standard_normal(m)
phi /= np.linalg.norm(phi)
htruth = sla.expm(1j * H32) @ phi
hex_ = Exponentiator(hop, dtype=np.float32)
(hre, him), _K2 = hex_.run_chebyshev(1j, phi.real, phi.imag, precise=True)
out["herm_expm_rel"] = float(
    np.linalg.norm((hre + 1j * him) - htruth) / np.linalg.norm(htruth))

# precise Hermitian-split Krylov evolve (df64 carried through the embedding).
# Direct norm metric: the angle/overlap floors at sqrt(eps_f64) ~ 2e-8 and
# cannot distinguish a truncated input (measured clean 1.4e-9 vs
# f32-truncated-input 2.6e-8 on this problem).
ere, eim = hex_.evolve(0.5j, phi.real, phi.imag, steps=4, krylov_dim=24,
                       renormalize=True, precise=True)
etruth = sla.expm(2j * H32) @ phi
eout = ere + 1j * eim
out["herm_evolve_rel"] = float(np.linalg.norm(eout - etruth) / np.linalg.norm(etruth))
print(json.dumps(out))
"""


def test_precise_paths_with_x64_disabled():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], env=env, capture_output=True,
        text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # df64-grade floors: an unsplit f64 crossing the trace boundary caps
    # these at ~1e-7/1e-8 instead
    assert out["eig_err"] < 1e-10, out
    assert out["vec_res"] < 1e-10, out  # refined vectors, x64-off runtime
    assert out["expm_rel"] < 1e-10, out
    assert out["herm_expm_rel"] < 1e-10, out
    assert out["herm_evolve_rel"] < 1e-8, out
