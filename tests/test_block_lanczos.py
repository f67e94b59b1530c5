"""Block Lanczos tests (an extension; validated against numpy and the
scalar engine on the reference matrix zoo)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lanczos_tpu import LambdaLanczos
from lanczos_tpu.utils.random import fixed_seed_initializer


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def test_block_simple_3x3():
    a = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True)
    eng.block_size = 2
    eng.init_vector = fixed_seed_initializer(np.float64, seed=1)
    val, vec = eng.run_one()
    assert abs(val - 4.0) < 1e-12
    np.testing.assert_allclose(np.abs(np.asarray(vec)), 1 / np.sqrt(3), atol=1e-10)


@pytest.mark.parametrize("block_size", [2, 4])
def test_block_multiroot(block_size):
    n = 24
    a = _sym(n, 7)
    w = np.linalg.eigvalsh(a)
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=False, num_eigs=4)
    eng.block_size = block_size
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[:4], atol=1e-9)
    for i in range(4):
        r = a @ np.asarray(vecs[i]) - vals[i] * np.asarray(vecs[i])
        assert np.linalg.norm(r) < 1e-8


def test_block_degenerate_pair_single_restart():
    """A doubly degenerate extremal eigenvalue is resolved by one block
    restart (the scalar engine needs repeated deflated restarts)."""
    rng = np.random.default_rng(5)
    n = 20
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([[5.0, 5.0], rng.uniform(-1, 1, n - 2)])
    a = (q * w) @ q.T

    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=2)
    eng.block_size = 2
    eng.init_vector = fixed_seed_initializer(np.float64, seed=2)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, [5.0, 5.0], atol=1e-9)
    # The two Ritz vectors span the degenerate subspace: residuals vanish.
    for i in range(2):
        r = a @ np.asarray(vecs[i]) - vals[i] * np.asarray(vecs[i])
        assert np.linalg.norm(r) < 1e-8
    # And they are mutually orthogonal.
    assert abs(np.vdot(np.asarray(vecs[0]), np.asarray(vecs[1]))) < 1e-8
    # Resolved in a single restart.
    assert len(eng.iteration_counts) <= 2


def test_block_hermitian():
    n = 12
    rng = np.random.default_rng(11)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    w = np.linalg.eigvalsh(h)
    eng = LambdaLanczos(jnp.asarray(h), find_maximum=False, num_eigs=3)
    eng.block_size = 2
    eng.init_vector = fixed_seed_initializer(np.complex128, seed=4)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[:3], atol=1e-9)


def test_block_matches_scalar_engine():
    a = _sym(16, 9)
    eng_s = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng_s.init_vector = fixed_seed_initializer(np.float64, seed=6)
    vals_s, _ = eng_s.run()

    eng_b = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng_b.block_size = 3
    eng_b.init_vector = fixed_seed_initializer(np.float64, seed=6)
    vals_b, _ = eng_b.run()
    np.testing.assert_allclose(vals_b, vals_s, atol=1e-9)


def test_block_with_sharded_dia_operator():
    """Block engine composes with a shard_map'd operator (vmap over the
    ppermute halo matvec)."""
    import jax

    from lanczos_tpu.parallel.mesh import make_mesh
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 256
    mesh = make_mesh(jax.devices()[:8])
    op = ShardedDIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh
    )
    eng = LambdaLanczos(op, find_maximum=False, num_eigs=2)
    eng.block_size = 2
    eng.eigenvalue_offset = -4.0
    eng.init_vector = fixed_seed_initializer(np.float64, seed=8)
    vals, vecs = eng.run()
    expected = [-2 * np.cos(np.pi / (n + 1)), -2 * np.cos(2 * np.pi / (n + 1))]
    np.testing.assert_allclose(vals, expected, atol=1e-9)
