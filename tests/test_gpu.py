"""Numerics that only a GPU can get wrong: FMA contraction in the
error-free transformations and TF32 in f32 contractions.  Marked ``gpu``;
they skip without one (run: LT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu.core import df64, linalg

pytestmark = pytest.mark.gpu


def test_gpu_two_prod_two_sum_exact(gpu):
    rng = np.random.default_rng(0)
    n = 1 << 16
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    p, e = jax.jit(df64.two_prod)(jnp.asarray(a), jnp.asarray(b))
    s, f = jax.jit(df64.two_sum)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(np.asarray(p, np.float64) + np.asarray(e, np.float64), a64 * b64)
    np.testing.assert_array_equal(np.asarray(s, np.float64) + np.asarray(f, np.float64), a64 + b64)


def test_gpu_f32_contractions_full_precision(gpu):
    """inner_prod and the CGS projection on f32 data agree with float64 to
    f32 rounding.  The bars sit between f32 (~1e-10 relative here) and TF32
    (~1e-6: its 2^-11 input rounding over 2^16 terms)."""
    rng = np.random.default_rng(1)
    n = 1 << 16
    v = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    got = float(jax.jit(linalg.inner_prod)(jnp.asarray(v), jnp.asarray(w)))
    want = float(v.astype(np.float64) @ w.astype(np.float64))
    assert abs(got - want) <= 1e-7 * np.linalg.norm(v) * np.linalg.norm(w)
    basis = np.linalg.qr(rng.standard_normal((n, 8)))[0].T.astype(np.float32)
    out = np.asarray(jax.jit(lambda u, bs: linalg.orthogonalize_bcgs_dyn(u, bs, 8, passes=1))(
        jnp.asarray(v), jnp.asarray(basis)), np.float64)
    overlap = basis.astype(np.float64) @ out  # what one exact pass leaves: ~0
    assert np.abs(overlap).max() <= 1e-7 * np.linalg.norm(v)


def test_gpu_bsr_matvec_full_precision(gpu):
    from lanczos_tpu import BSROperator

    r, s, b = 16, 4, 128
    n = r * b
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((r, s, b, b)).astype(np.float32)
    cols = rng.integers(0, n // b, (r, s)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(BSROperator(jnp.asarray(blocks), jnp.asarray(cols), n).matvec(jnp.asarray(x)), np.float64)
    ref = np.einsum("rsmk,rsk->rm", blocks.astype(np.float64), x.astype(np.float64).reshape(-1, b)[cols]).reshape(-1)
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()
