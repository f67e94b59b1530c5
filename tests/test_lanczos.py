"""End-to-end eigensolver tests: the reference DIAGONALIZE_TEST matrix zoo
(test/lambda_lanczos_test.cpp:128-755) reproduced with the same analytic
ground truths, tolerances and gauge-invariant comparisons."""

import numpy as np
import jax.numpy as jnp
import pytest

from lanczos_tpu import LambdaLanczos, DenseOperator, COOOperator, FunctionOperator
from lanczos_tpu.utils.random import fixed_seed_initializer

MODES = ["hybrid", "fused"]


def _simple3(dtype):
    return np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]], dtype=dtype)


@pytest.mark.parametrize("mode", MODES)
def test_simple_matrix(mode):
    # Reference DIAGONALIZE_TEST.SIMPLE_MATRIX (lambda_lanczos_test.cpp:128-161):
    # 3x3 dense, eigvals {4,1,1}, offset 6, fixed seed, exactly 1 restart.
    engine = LambdaLanczos(DenseOperator(jnp.asarray(_simple3(np.float64))), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    engine.eigenvalue_offset = 6.0

    eigvalue, eigvec = engine.run_one()

    sign = np.sign(np.asarray(eigvec)[0])
    correct = sign / np.sqrt(3.0) * np.ones(3)
    assert eigvalue == pytest.approx(4.0, abs=4.0 * engine.eps)
    np.testing.assert_allclose(np.asarray(eigvec), correct, atol=4.0 * engine.eps * 10)
    assert len(engine.iteration_counts) == 1


@pytest.mark.parametrize("mode", MODES)
def test_simple_matrix_float32(mode):
    # Reference DIAGONALIZE_TEST.SIMPLE_MATRIX_FLOAT (lambda_lanczos_test.cpp:163-193).
    engine = LambdaLanczos(DenseOperator(jnp.asarray(_simple3(np.float32))), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float32)
    eigvalue, eigvec = engine.run_one()
    sign = np.sign(np.asarray(eigvec)[0])
    assert eigvalue == pytest.approx(4.0, abs=4.0 * engine.eps)
    np.testing.assert_allclose(np.asarray(eigvec), sign / np.sqrt(3.0) * np.ones(3), atol=4.0 * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_tuple_return_interface(mode):
    # Reference ...MULTIPLE_VALUE_RETURN_FEATURE (lambda_lanczos_test.cpp:195-227).
    engine = LambdaLanczos(DenseOperator(jnp.asarray(_simple3(np.float64))), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    vals, vecs = engine.run()
    assert vals.shape == (1,)
    assert vecs.shape == (1, 3)
    assert vals[0] == pytest.approx(4.0, abs=4.0 * engine.eps)


@pytest.mark.parametrize("mode", MODES)
def test_default_random_seed(mode):
    # Reference ...NOT_FIX_RANDOM_SEED (lambda_lanczos_test.cpp:229-260):
    # default nondeterministic init must still converge.
    engine = LambdaLanczos(DenseOperator(jnp.asarray(_simple3(np.float64))), find_maximum=True, num_eigs=1, mode=mode)
    eigvalue, _ = engine.run_one()
    assert eigvalue == pytest.approx(4.0, abs=4.0 * engine.eps)


@pytest.mark.parametrize("mode", MODES)
def test_dynamic_stencil_min_eig(mode):
    # Reference DIAGONALIZE_TEST.DYNAMIC_MATRIX (lambda_lanczos_test.cpp:262-308):
    # matrix-free -1 hopping chain n=10, min eig -2cos(pi/11), eps=1e-14,
    # negative offset.
    n = 10

    def matmul(x):
        y = jnp.zeros_like(x)
        y = y.at[:-1].add(-1.0 * x[1:])
        y = y.at[1:].add(-1.0 * x[:-1])
        return y

    engine = LambdaLanczos(FunctionOperator(matmul, n, np.float64), find_maximum=False, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    engine.eps = 1e-14
    engine.eigenvalue_offset = -10.0

    eigvalue, eigvec = engine.run_one()

    correct = -2.0 * np.cos(np.pi / (n + 1))
    assert eigvalue == pytest.approx(correct, abs=abs(correct) * engine.eps)

    vec = np.asarray(eigvec)
    sign = np.sign(vec[0])
    expected = np.sin((np.arange(n) + 1) * np.pi / (n + 1))
    expected = sign * expected / np.linalg.norm(expected)
    np.testing.assert_allclose(vec, expected, atol=abs(correct) * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_complex_type_real_matrix(mode):
    # Reference ...USE_COMPLEX_TYPE (lambda_lanczos_test.cpp:310-341).
    a = jnp.asarray(_simple3(np.complex128))
    engine = LambdaLanczos(DenseOperator(a), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.complex128)
    eigvalue, eigvec = engine.run_one()

    vec = np.asarray(eigvec)
    phase = np.exp(1j * np.angle(vec[0]))
    correct = phase / np.sqrt(3.0) * np.ones(3)
    assert eigvalue == pytest.approx(4.0, abs=4.0 * engine.eps)
    np.testing.assert_allclose(vec.real, correct.real, atol=4.0 * engine.eps * 10)
    np.testing.assert_allclose(vec.imag, correct.imag, atol=4.0 * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_hermitian_matrix(mode):
    # Reference DIAGONALIZE_TEST.HERMITIAN_MATRIX (lambda_lanczos_test.cpp:375-409):
    # eigvals {-2, 1, 1}, min eigvec prop. to (1, i, -1).
    i_ = 1.0j
    a = jnp.array([[0.0, i_, 1.0], [-i_, 0.0, i_], [1.0, -i_, 0.0]], dtype=jnp.complex128)
    engine = LambdaLanczos(DenseOperator(a), find_maximum=False, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.complex128)
    eigvalue, eigvec = engine.run_one()

    vec = np.asarray(eigvec)
    correct = np.array([1.0, 1.0j, -1.0])
    correct /= np.linalg.norm(correct)
    correct *= np.exp(1j * np.angle(vec[0]))
    assert eigvalue == pytest.approx(-2.0, abs=2.0 * engine.eps)
    np.testing.assert_allclose(vec.real, correct.real, atol=2.0 * engine.eps * 10)
    np.testing.assert_allclose(vec.imag, correct.imag, atol=2.0 * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_single_element_matrix(mode):
    # Reference DIAGONALIZE_TEST.SINGLE_ELEMENT_MATRIX (lambda_lanczos_test.cpp:411-440).
    a = jnp.array([[2.0]], dtype=jnp.float64)
    engine = LambdaLanczos(DenseOperator(a), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    eigvalue, eigvec = engine.run_one()
    assert eigvalue == pytest.approx(2.0, abs=2.0 * engine.eps)
    assert abs(np.asarray(eigvec)[0]) == pytest.approx(1.0, abs=2.0 * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_multiple_eigenpairs(mode):
    # Reference DIAGONALIZE_TEST.MULTIPLE_EIGENPAIRS (lambda_lanczos_test.cpp:442-488):
    # 8x8, 3 lowest eigenpairs vs 8-digit ground truth, eps=1e-7.
    a = np.array(
        [
            [6, -3, -3, 0, -1, 1, -1, 1],
            [-3, -4, 2, 2, -1, -5, 0, -4],
            [-3, 2, 2, -3, 0, 0, -1, -1],
            [0, 2, -3, 0, -3, 3, 2, 2],
            [-1, -1, 0, -3, -2, 0, -5, -4],
            [1, -5, 0, 3, 0, -4, 5, 0],
            [-1, 0, -1, 2, -5, 5, -4, 4],
            [1, -4, -1, 2, -4, 0, 4, 2],
        ],
        dtype=np.float64,
    )
    engine = LambdaLanczos(DenseOperator(jnp.asarray(a)), find_maximum=False, num_eigs=3, mode=mode)
    engine.eps = 1e-7

    vals, vecs = engine.run()

    correct_vals = [-13.21508597, -8.50033154, -4.26674892]
    correct_vecs = np.array(
        [
            [0.02081752, -0.49222707, 0.13202088, 0.24048092, 0.15089223, -0.60850056, 0.48079787, -0.24043829],
            [0.16645991, 0.51818471, -0.00646562, -0.09493495, 0.60595718, 0.02042567, 0.52346924, 0.23043415],
            [0.03381669, -0.07999997, 0.32090331, 0.61650970, 0.41812886, -0.01782613, -0.45571810, 0.35575946],
        ]
    )
    assert len(vals) == 3
    for i in range(3):
        assert vals[i] == pytest.approx(correct_vals[i], abs=abs(correct_vals[i]) * engine.eps)
        vec = np.asarray(vecs[i])
        sign = np.sign(vec[0]) * np.sign(correct_vecs[i, 0])
        np.testing.assert_allclose(vec, sign * correct_vecs[i], atol=abs(correct_vals[i]) * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_degenerate_ring(mode):
    # Reference DIAGONALIZE_TEST.MULTIPLE_DEGENERATE_EIGENPAIRS
    # (lambda_lanczos_test.cpp:490-536): ring graph n=50, doubly degenerate
    # spectrum -2cos(2*pi*i/n), 26 lowest eigenvalues at eps=1e-14 (abs).
    n = 50

    def matmul(x):
        y = jnp.zeros_like(x)
        y = y.at[:-1].add(-1.0 * x[1:])
        y = y.at[1:].add(-1.0 * x[:-1])
        y = y.at[0].add(-1.0 * x[n - 1])
        y = y.at[n - 1].add(-1.0 * x[0])
        return y

    num_eigs = 26
    engine = LambdaLanczos(FunctionOperator(matmul, n, np.float64), find_maximum=False, num_eigs=num_eigs, mode=mode)
    engine.eps = 1e-14

    vals, _ = engine.run()

    ks = np.arange(-num_eigs // 2, num_eigs // 2)
    correct = np.sort(-2.0 * np.cos(2.0 * np.pi * ks / n))
    assert len(vals) == num_eigs
    np.testing.assert_allclose(np.asarray(vals), correct, atol=engine.eps)


def _random_symmetric_with_known_max(n, rand_n, seed):
    """Random symmetric matrix with a known maximum eigenpair, built by
    rotating a random diagonal (the reference generator's strategy,
    lambda_lanczos_test.cpp:538-599)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, n * 10, n)
    a = np.diag(d)
    idx = int(np.argmax(d))
    vec = np.zeros(n)
    vec[idx] = 1.0
    q = np.eye(n)
    for _ in range(rand_n):
        k, ell = rng.choice(n, size=2, replace=False)
        theta = rng.uniform(0, 2 * np.pi)
        g = np.eye(n)
        g[k, k] = np.cos(theta)
        g[ell, ell] = np.cos(theta)
        g[k, ell] = -np.sin(theta)
        g[ell, k] = np.sin(theta)
        a = g @ a @ g.T
        q = g @ q
    a = (a + a.T) / 2
    return a, q @ vec, float(np.max(d))


@pytest.mark.parametrize("mode", MODES)
def test_random_symmetric_matrix(mode):
    # Reference DIAGONALIZE_TEST.RANDOM_SYMMETRIC_MATRIX (lambda_lanczos_test.cpp:601-637).
    n = 50
    a, correct_vec, correct_val = _random_symmetric_with_known_max(n, n * 10, seed=1)
    engine = LambdaLanczos(DenseOperator(jnp.asarray(a)), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    eigvalue, eigvec = engine.run_one()
    assert eigvalue == pytest.approx(correct_val, abs=abs(correct_val) * engine.eps)
    vec = np.asarray(eigvec)
    sign = 1.0 if vec[0] * correct_vec[0] > 0 else -1.0
    np.testing.assert_allclose(vec, sign * correct_vec, atol=abs(correct_val) * engine.eps * n * n)


def _random_hermitian_with_known_max(n, rand_n, seed):
    """Random Hermitian matrix with known max eigenpair via random 2x2
    unitary rotations (reference generator, lambda_lanczos_test.cpp:639-713)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, n * 10, n)
    a = np.diag(d).astype(np.complex128)
    idx = int(np.argmax(d))
    vec = np.zeros(n, dtype=np.complex128)
    vec[idx] = 1.0
    for _ in range(rand_n):
        k, ell = rng.choice(n, size=2, replace=False)
        theta, phi1, phi2 = rng.uniform(0, 2 * np.pi, 3)
        u = np.eye(n, dtype=np.complex128)
        u[k, k] = np.exp(1j * phi1) * np.cos(theta)
        u[k, ell] = -np.exp(1j * phi2) * np.sin(theta)
        u[ell, k] = np.exp(-1j * phi2) * np.sin(theta)
        u[ell, ell] = np.exp(-1j * phi1) * np.cos(theta)
        a = u @ a @ u.conj().T
        vec = u @ vec
    a = (a + a.conj().T) / 2
    return a, vec, float(np.max(d))


@pytest.mark.parametrize("mode", MODES)
def test_random_hermitian_matrix(mode):
    # Reference DIAGONALIZE_TEST.RANDOM_HERMITIAN_MATRIX (lambda_lanczos_test.cpp:715-755):
    # n=10, eps=1e-14, phase-gauged eigenvector comparison.
    n = 10
    a, correct_vec, correct_val = _random_hermitian_with_known_max(n, n * 10, seed=1)
    engine = LambdaLanczos(DenseOperator(jnp.asarray(a)), find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.complex128)
    engine.eps = 1e-14
    eigvalue, eigvec = engine.run_one()
    assert eigvalue == pytest.approx(correct_val, abs=abs(correct_val) * engine.eps)
    vec = np.asarray(eigvec)
    phase = np.exp(1j * (np.angle(vec[0]) - np.angle(correct_vec[0])))
    expected = correct_vec * phase
    np.testing.assert_allclose(vec.real, expected.real, atol=abs(correct_val) * engine.eps * 10)
    np.testing.assert_allclose(vec.imag, expected.imag, atol=abs(correct_val) * engine.eps * 10)


@pytest.mark.parametrize("mode", MODES)
def test_coo_operator_end_to_end(mode):
    # COO sparse analogue of the reference sparse sample (sample2_sparse.cpp).
    a = _simple3(np.float64)
    rows, cols = np.nonzero(a)
    op = COOOperator.from_arrays(rows, cols, a[rows, cols], 3)
    engine = LambdaLanczos(op, find_maximum=True, num_eigs=1, mode=mode)
    engine.init_vector = fixed_seed_initializer(np.float64)
    eigvalue, _ = engine.run_one()
    assert eigvalue == pytest.approx(4.0, abs=4.0 * engine.eps)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_bounded_memory_warm_restarts(mode):
    """max_iteration caps the basis far below convergence; warm restarts
    from the best Ritz vector still reach full accuracy (bounded-memory
    mode — the reference's basis grows without limit instead,
    lambda_lanczos.hpp:221-250)."""
    n = 300
    rng = np.random.default_rng(2)
    matrix = rng.standard_normal((n, n))
    matrix = (matrix + matrix.T) / 2
    w = np.linalg.eigvalsh(matrix)

    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=True, mode=mode)
    eng.max_iteration = 30  # far below the single-build need at this eps
    eng.eps = 1e-12
    eng.init_vector = fixed_seed_initializer(np.float64, seed=13)
    val, vec = eng.run_one()

    assert abs(val - w[-1]) < 1e-11
    r = matrix @ np.asarray(vec) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-6
    # Total iterations recorded include the warm restarts.
    assert eng.iteration_counts[0] > 30


def test_selective_reorthogonalization_matches_full():
    """reorth_policy='selective' (omega-recurrence triggered CGS) reaches
    the same eigenvalues as full reorthogonalization."""
    n = 500
    matrix = np.zeros((n, n))
    i = np.arange(n - 1)
    matrix[i, i + 1] = matrix[i + 1, i] = -1.0
    expected = -2 * np.cos(np.pi / (n + 1))

    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=False, mode="fused")
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-13
    eng.reorth_policy = "selective"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=21)
    val, vec = eng.run_one()
    assert abs(val - expected) < 1e-10
    r = matrix @ np.asarray(vec) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-7


def test_reorth_count_surfaced():
    """RunStats.reorth_count: == total iterations under 'full', and the
    omega-trigger count (0 <= count <= iterations, and strictly fewer on a
    well-separated spectrum) under 'selective'."""
    n = 300
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.linspace(1.0, 2.0, n)) @ q.T  # well-separated spectrum

    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, mode="fused")
    eng.init_vector = fixed_seed_initializer(np.float64, seed=4)
    eng.run_one()
    assert eng.stats.reorth_count == eng.stats.total_iterations > 0

    eng2 = LambdaLanczos(jnp.asarray(a), find_maximum=True, mode="fused")
    eng2.reorth_policy = "selective"
    eng2.init_vector = fixed_seed_initializer(np.float64, seed=4)
    eng2.run_one()
    assert 0 <= eng2.stats.reorth_count < eng2.stats.total_iterations


def test_selective_multiroot():
    n = 200
    rng = np.random.default_rng(17)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w = np.linalg.eigvalsh(a)
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3, mode="fused")
    eng.reorth_policy = "selective"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=22)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[::-1][:3], atol=1e-9)


def test_f32_df64_fused_accuracy():
    """f32 storage + df64 alpha/beta reconstruction: the fused engine must
    beat the plain-f32 accuracy floor (~1e-5) by orders of magnitude."""
    import jax

    n = 1024
    from lanczos_tpu import DIAOperator

    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32)], n
    )
    eng = LambdaLanczos(op, find_maximum=False, mode="fused")
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-9
    eng.init_vector = fixed_seed_initializer(np.float32, seed=3)
    val, vec = eng.run_one()
    expected = -2 * np.cos(np.pi / (n + 1))
    assert abs(val - expected) < 5e-6  # observed ~1.7e-7; plain f32 was ~5e-4


def test_precise_vectors_reference_grade_f32():
    """Double-float Krylov vectors: the fused engine in pure f32 arithmetic
    must reach ~1e-12 eigenvalue accuracy — the reference's f64 tolerance
    zoo regime (VERDICT round-1 item 1).  The n=256 chain runs to space
    exhaustion (clustered spectrum), which exercises the full pipeline:
    EFT matvec, df recurrence, coupling recapture, df Sturm convergence.
    (The n=1024 chain reaches 1.5e-14 the same way; kept at 256 for CI
    speed.)"""
    n = 256
    from lanczos_tpu import DIAOperator

    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32)], n
    )
    eng = LambdaLanczos(op, find_maximum=False, num_eigs=2, dtype=np.float32)
    eng.precise_vectors = True
    eng.eps = 1e-13
    eng.init_vector = fixed_seed_initializer(np.float32, seed=7)
    vals, vecs = eng.run()
    exact = np.sort(-2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))[:2]
    err = np.max(np.abs(np.sort(np.asarray(vals)) - exact))
    assert err < 1e-12, err  # plain f32 floors at ~5e-4, df64-scalars at ~5e-7
    assert eng.stats.tridiag_unconverged == 0


def test_precise_vectors_dense_and_guards():
    from lanczos_tpu import LambdaLanczos as LL

    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    a = (a + a.T) / 2
    ref = np.linalg.eigvalsh(a.astype(np.float64))
    eng = LL(jnp.asarray(a), find_maximum=True, dtype=np.float32)
    eng.precise_vectors = True
    eng.eps = 1e-12
    val, vec = eng.run_one()
    assert abs(val - ref[-1]) < 1e-10

    # complex dtype is rejected (use HermitianSplitOperator instead)
    engc = LL(jnp.asarray(a, jnp.complex64) + 0j, find_maximum=True, dtype=np.complex64)
    engc.precise_vectors = True
    with pytest.raises(TypeError):
        engc.run()

    # hybrid mode is rejected
    engh = LL(jnp.asarray(a), find_maximum=True, dtype=np.float32, mode="hybrid")
    engh.precise_vectors = True
    with pytest.raises(ValueError):
        engh.run()

    # matrix-free operators without matvec_df fail with guidance
    engf = LL(lambda x: x * 2.0, 16, dtype=np.float32)
    engf.precise_vectors = True
    with pytest.raises(NotImplementedError):
        engf.run()


def test_thick_restart_beats_warm_on_clustered_spectrum():
    """The n=400 chain (gap-less bottom of spectrum) under a 30-vector
    memory cap: warm restarts stall at ~1e-4, thick restart converges to
    full accuracy (Wu & Simon TRLan behavior)."""
    n = 400
    matrix = np.zeros((n, n))
    i = np.arange(n - 1)
    matrix[i, i + 1] = matrix[i + 1, i] = -1.0
    expected = -2 * np.cos(np.pi / (n + 1))

    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 30
    eng.eps = 1e-13
    eng.max_restarts = 64
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=13)
    val, vec = eng.run_one()

    assert abs(val - expected) < 1e-10
    r = matrix @ np.asarray(vec) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-7


def test_thick_restart_multiroot():
    n = 120
    rng = np.random.default_rng(19)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w = np.linalg.eigvalsh(a)
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=4)
    eng.max_iteration = 25
    eng.max_restarts = 40
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=23)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[::-1][:4], atol=1e-9)


def test_residuals_helper():
    a = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=2)
    vals, vecs = eng.run()
    res = eng.residuals(vals, vecs)
    assert len(res) == 2 and all(r < 1e-10 for r in res)


def test_thick_restart_fused_matches_host():
    """Fused-cycle thick restart (device cycles, host at boundaries only)
    reaches the same accuracy as the host-driven engine on the gap-less
    chain under a hard memory cap."""
    n = 400
    matrix = np.zeros((n, n))
    i = np.arange(n - 1)
    matrix[i, i + 1] = matrix[i + 1, i] = -1.0
    expected = -2 * np.cos(np.pi / (n + 1))

    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=False, mode="fused")
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 30
    eng.eps = 1e-13
    eng.max_restarts = 64
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=13)
    val, vec = eng.run_one()

    assert abs(val - expected) < 1e-10
    r = matrix @ np.asarray(vec) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-7


def test_thick_restart_fused_early_cycle_exit():
    """Cycles >= 1 run in growing segments with a host arrowhead test, so a
    mid-cycle-converged run stops early instead of burning the full cycle
    budget (VERDICT round-1 weak item 7).  This exact configuration took
    685 iterations with whole-cycle budgets; the segmented schedule must do
    at least as well, at the same accuracy."""
    n = 400
    matrix = np.zeros((n, n))
    i = np.arange(n - 1)
    matrix[i, i + 1] = matrix[i + 1, i] = -1.0
    expected = -2 * np.cos(np.pi / (n + 1))

    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=False, mode="fused")
    eng.eigenvalue_offset = -4.0
    eng.max_iteration = 120  # large cycles so segmentation has room to save
    eng.eps = 1e-13
    eng.max_restarts = 64
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=13)
    val, vec = eng.run_one()

    assert abs(val - expected) < 1e-12
    assert sum(eng.iteration_counts) <= 660  # measured: 620 segmented, 685 whole-cycle


def test_thick_restart_fused_multiroot():
    n = 120
    rng = np.random.default_rng(19)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w = np.linalg.eigvalsh(a)
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=4, mode="fused")
    eng.max_iteration = 25
    eng.max_restarts = 40
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.float64, seed=23)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[::-1][:4], atol=1e-9)


def test_thick_fused_complex():
    """Fused-cycle thick restart with complex storage (the facade routes
    complex problems through ops.hermitian_split instead)."""
    n = 60
    rng = np.random.default_rng(29)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    w = np.linalg.eigvalsh(h)
    eng = LambdaLanczos(jnp.asarray(h), find_maximum=False, num_eigs=2, mode="fused")
    eng.max_iteration = 20
    eng.max_restarts = 30
    eng.restart_policy = "thick"
    eng.init_vector = fixed_seed_initializer(np.complex128, seed=7)
    vals, vecs = eng.run()
    np.testing.assert_allclose(vals, w[:2], atol=1e-9)


def test_hermitian_split_with_thick_restart():
    """Composition: complex Hermitian via real embedding + bounded-memory
    thick restart — the full split-real production configuration, on CPU."""
    from lanczos_tpu.ops.hermitian_split import solve_hermitian

    n = 40
    rng = np.random.default_rng(31)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    w = np.linalg.eigvalsh(h)

    def cfg(eng):
        eng.max_iteration = 30
        eng.max_restarts = 40
        eng.restart_policy = "thick"
        eng.init_vector = fixed_seed_initializer(np.float64, seed=9)

    vals, vecs = solve_hermitian(
        DenseOperator(jnp.asarray(h.real)), DenseOperator(jnp.asarray(h.imag)),
        num_eigs=2, find_maximum=True, configure=cfg,
    )
    np.testing.assert_allclose(vals, w[::-1][:2], atol=1e-9)
    for k in range(2):
        assert np.linalg.norm(h @ vecs[k] - vals[k] * vecs[k]) < 1e-7


def test_deflation_noise_reshuffle_terminates():
    """A full manager whose kept values only reshuffle within relative eps
    terminates the deflation loop (noise-robust fixed point) — without it
    the ~1e-12-degenerate flagship spectrum burned 4-8 rounds by insertion
    luck.  A genuinely better eigenvalue must still count as progress."""
    from lanczos_tpu.solvers.lanczos import LanczosConfig, deflation_driver

    n = 8
    calls = []

    def iterate_one(v0, nroot, defl, mask):
        # A noise-degenerate doublet (the flagship regime: kept values and
        # candidates all within ~1e-13 of each other): every round's
        # insertions displace kept pairs without real progress.
        j = 1e-13 * (len(calls) + 1)
        calls.append(1)
        vals = [1.0 + j, 1.0 + 2e-13 + j]
        vecs = jnp.eye(2, n, dtype=jnp.float64)
        return vals, vecs, 5, True

    cfg = LanczosConfig(matrix_size=n, num_eigs=2, eps=1e-6, num_eigs_per_iteration=2)
    res = deflation_driver(
        iterate_one, cfg, fixed_seed_initializer(np.float64), np.float64,
        use_warm_restarts=False,
    )
    assert len(calls) == 2, "round 2 only confirms: kept values moved < eps"
    np.testing.assert_allclose(res.eigenvalues, [1.0, 1.0], atol=1e-9)

    # Control: a round that genuinely improves an eigenvalue keeps going.
    calls2 = []

    def iterate_better(v0, nroot, defl, mask):
        calls2.append(1)
        # Round 2 finds a genuinely lower eigenvalue (0.5); later rounds
        # repeat it until the exact multimap fixed point terminates.
        vals = [0.5 if len(calls2) >= 2 else 1.0, 2.0]
        vecs = jnp.eye(2, n, dtype=jnp.float64)
        return vals, vecs, 5, True

    deflation_driver(
        iterate_better, cfg, fixed_seed_initializer(np.float64), np.float64,
        use_warm_restarts=False,
    )
    assert len(calls2) > 2


def test_all_engines_agree_on_random_spectrum():
    """Property-style cross-ENGINE consistency: every engine configuration
    (hybrid, fused, thick host, thick fused, block+thick) solves one random
    symmetric matrix to the same eigenvalues — the 'same tests, different
    backend' discipline of the reference's 3-binary trick
    (test/CMakeLists.txt:5-12) applied to the engine axis."""
    n = 120
    rng = np.random.default_rng(123)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    exact = np.sort(np.linalg.eigvalsh(a))[:3]

    def solve(**kw):
        eng = LambdaLanczos(jnp.asarray(a), find_maximum=False, num_eigs=3,
                            mode=kw.pop("mode", "auto"))
        eng.eps = 1e-11
        for k, v in kw.items():
            setattr(eng, k, v)
        rng_iv = np.random.default_rng(7)
        eng.init_vector = lambda n_: jnp.asarray(rng_iv.uniform(-1, 1, n_))
        vals, _ = eng.run()
        return np.sort(vals)

    configs = [
        dict(mode="hybrid"),
        dict(mode="fused"),
        dict(mode="hybrid", restart_policy="thick", max_iteration=40, max_restarts=32),
        dict(mode="fused", restart_policy="thick", max_iteration=40, max_restarts=32),
        dict(restart_policy="thick", block_size=2, max_iteration=40, max_restarts=32),
    ]
    for kw in configs:
        got = solve(**kw)
        np.testing.assert_allclose(got, exact, atol=1e-8, err_msg=str(kw))


def test_unconverged_rounds_surfaced():
    """A budget-limited solve must say so: RunStats.unconverged_rounds > 0
    and a UserWarning — a silent budget exhaustion is indistinguishable from
    convergence otherwise."""
    import warnings

    n = 200
    matrix = np.zeros((n, n))
    i = np.arange(n - 1)
    matrix[i, i + 1] = matrix[i + 1, i] = -1.0
    eng = LambdaLanczos(jnp.asarray(matrix), find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-14
    eng.max_iteration = 10
    eng.max_restarts = 2  # nowhere near enough at this eps
    eng.init_vector = fixed_seed_initializer(np.float64, seed=5)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng.run_one()
    assert eng.stats.unconverged_rounds >= 1
    assert any("budget" in str(w.message) for w in rec)

    # and a converged solve stays silent
    eng2 = LambdaLanczos(jnp.asarray(matrix), find_maximum=False)
    eng2.eigenvalue_offset = -4.0
    eng2.init_vector = fixed_seed_initializer(np.float64, seed=5)
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        eng2.run_one()
    assert eng2.stats.unconverged_rounds == 0
    assert not any("budget" in str(w.message) for w in rec2)


def test_stop_when_full_skips_confirm_round():
    """stop_when_full=True terminates the deflation loop as soon as
    num_eigs pairs are held (solvers/lanczos.py deflation_driver); the
    default False keeps the reference's confirming nothing_added round
    (lambda_lanczos.hpp:346-353)."""
    m = np.diag([1.0, 2.0, 3.0, 4.0])
    eng = LambdaLanczos(m, find_maximum=True, num_eigs=2)
    eng.run()
    default_rounds = len(eng.iteration_counts)

    eng2 = LambdaLanczos(m, find_maximum=True, num_eigs=2)
    eng2.stop_when_full = True
    vals, vecs = eng2.run()
    assert len(eng2.iteration_counts) == default_rounds - 1
    np.testing.assert_allclose(np.asarray(vals), [4.0, 3.0], atol=1e-10)
    V = np.asarray(vecs)
    np.testing.assert_allclose(V @ V.T, np.eye(2), atol=1e-10)
