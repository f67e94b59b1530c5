"""What the GPU bring-up guarantees and the CPU can check: no TPU-only code
is left in the package, every f32 contraction on the fused solve path asks
for full precision (the GPU's default f32 matmul is TF32), and the entry
points that time the card refuse to run anywhere else."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax

from lanczos_tpu.core import linalg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "lanczos_tpu"


def _package_sources():
    return sorted(PACKAGE.rglob("*.py"))


def test_no_module_imports_tpu_pallas_or_tests_for_tpu():
    """No module imports ``jax.experimental.pallas.tpu`` and no code
    compares anything with the string ``"tpu"``."""
    offenders = []
    for path in _package_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                names = []
            if any("pallas.tpu" in n for n in names):
                offenders.append(f"{path.name}:{node.lineno} imports pallas.tpu")
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.lower() == "tpu":
                offenders.append(f"{path.name}:{node.lineno} uses the string 'tpu'")
    assert not offenders, offenders


def _dot_precisions(jaxpr, out):
    """Collect (operand dtypes, precision) of every dot_general, recursing
    into the sub-jaxprs of while/cond/scan/pjit."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = tuple(str(v.aval.dtype) for v in eqn.invars)
            out.append((dts, eqn.params.get("precision")))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _dot_precisions(sub, out)
    return out


def _is_highest(prec):
    if prec is None:
        return False
    precs = prec if isinstance(prec, tuple) else (prec,)
    return all(p == lax.Precision.HIGHEST for p in precs)


def _chain(kind, n):
    from lanczos_tpu import BSROperator, DenseOperator, DIAOperator

    off = np.full(n, -1.0, np.float32)
    if kind == "dia":
        return DIAOperator.from_diagonals([-1, 1], [off, off], n)
    a = (np.diag(off[:-1], 1) + np.diag(off[:-1], -1)).astype(np.float32)
    if kind == "dense":
        return DenseOperator(jnp.asarray(a))
    rows, cols = np.nonzero(a)
    return BSROperator.from_coo(rows, cols, a[rows, cols], n, bm=8, bk=8)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("policy", ["full", "selective"])
@pytest.mark.parametrize("kind", ["dia", "bsr", "dense"])
def test_fused_step_f32_dots_are_highest(kind, policy, backend, monkeypatch):
    """Every f32 dot_general in the fused Lanczos build carries HIGHEST, on
    the CPU path and on the chunked accelerator path (forced here)."""
    from lanczos_tpu.solvers.lanczos_fused import fused_krylov

    monkeypatch.setattr(linalg.jax, "default_backend", lambda: backend)
    n = 64
    op = _chain(kind, n)
    v0 = jnp.ones(n, jnp.float32) / np.sqrt(n)
    defl = jnp.zeros((1, n), jnp.float32)
    mask = jnp.zeros((1,), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda o, v, d, m: fused_krylov(o, v, d, m, 1e-5, 0.0, nroot=1, m_cap=16, find_maximum=False,
                                        reorth_policy=policy)
    )(op, v0, defl, mask)
    dots = _dot_precisions(jaxpr.jaxpr, [])
    assert dots, "no contraction traced"
    loose = [d for d in dots if "float32" in d[0] and not _is_highest(d[1])]
    assert not loose, loose


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_device_entry_points_refuse_cpu(script, tmp_path):
    """With only a CPU visible the scripts that time the card exit non-zero
    and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(ROOT / script)], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "{" not in proc.stdout
    assert "needs a GPU" in proc.stderr
