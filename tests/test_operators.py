"""Operator-layer tests: every format must agree with the dense matvec
(the reference's implicit contract across its sample zoo, src/samples/)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu.ops.operators import DenseOperator, COOOperator, BSROperator, FunctionOperator, as_operator, bsr_matvec


def _random_sparse(n, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(n, n)) < density
    mask = np.triu(mask)
    a = np.zeros((n, n), dtype=dtype)
    a[mask] = rng.normal(size=int(mask.sum()))
    a = a + a.T  # symmetric
    return a


def test_dense_matvec():
    a = _random_sparse(16, 0.5, 0)
    x = np.random.default_rng(1).normal(size=16)
    op = DenseOperator(jnp.asarray(a))
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), a @ x, rtol=1e-12)


def test_coo_matches_dense():
    a = _random_sparse(32, 0.2, 2)
    rows, cols = np.nonzero(a)
    op = COOOperator.from_arrays(rows, cols, a[rows, cols], 32)
    x = np.random.default_rng(3).normal(size=32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a, rtol=1e-14)


def test_coo_duplicates_summed():
    rows = np.array([0, 0, 1])
    cols = np.array([1, 1, 0])
    vals = np.array([2.0, 3.0, 5.0])
    op = COOOperator.from_arrays(rows, cols, vals, 2)
    x = jnp.asarray([1.0, 1.0])
    np.testing.assert_allclose(np.asarray(op.matvec(x)), [5.0, 5.0])


def test_bsr_non_dividing_tile_dims():
    """n_pad must be a multiple of lcm(bm, bk): max(bm, bk) alone crashed
    packing whenever the smaller dim does not divide the larger."""
    n = 5
    a = np.array([[2.0, 1, 0, 0, 0], [1, 2, 1, 0, 0], [0, 1, 2, 1, 0],
                  [0, 0, 1, 2, 1], [0, 0, 0, 1, 2]], np.float32)
    rows, cols = np.nonzero(a)
    op = BSROperator.from_coo(rows, cols, a[rows, cols], n, bm=6, bk=4)
    assert op.n_padded % 6 == 0 and op.n_padded % 4 == 0
    x = np.zeros(op.n_padded, np.float32)
    x[:n] = np.random.default_rng(2).normal(size=n)
    got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got[:n], a @ x[:n], rtol=1e-5, atol=1e-5)


def test_bisect_fallback_no_recursion(monkeypatch):
    """set_default_host_backend('bisect') with no native extension must use
    the numpy fallback, not recurse into the process default forever; and
    eigvals_only must skip the O(m^3)-per-eigenvalue vector computation."""
    from lanczos_tpu.core import tridiagonal as tdg

    monkeypatch.setattr(tdg, "_native_module", lambda: None)
    monkeypatch.setattr(tdg, "_DEFAULT_BACKEND", "bisect", raising=False)
    alpha = np.array([2.0, 2.0, 2.0, 2.0])
    beta = np.array([-1.0, -1.0, -1.0])
    (vals,) = tdg.eigh_tridiagonal_host(alpha, beta, eigvals_only=True, backend="bisect")
    want = np.sort(2.0 - 2.0 * np.cos(np.arange(1, 5) * np.pi / 5))
    np.testing.assert_allclose(np.sort(vals), want, atol=1e-12)
    vals2, vecs2 = tdg.eigh_tridiagonal_host(alpha, beta, backend="bisect")
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    for k in range(4):
        r = t @ vecs2[k] - vals2[k] * vecs2[k]
        assert np.linalg.norm(r) < 1e-10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,bm,bk", [(64, 8, 128), (200, 8, 128), (384, 16, 128)])
def test_bsr_matches_dense(n, bm, bk, dtype):
    a = _random_sparse(n, 0.1, 4, dtype=dtype)
    rows, cols = np.nonzero(a)
    op = BSROperator.from_coo(rows, cols, a[rows, cols], n, bm=bm, bk=bk, dtype=dtype)
    assert (op.bm, op.bk) == (bm, bk) and op.dtype == np.dtype(dtype)
    x = np.random.default_rng(5).normal(size=n).astype(dtype)
    got = np.asarray(op.matvec(jnp.asarray(x)))
    tol = 1e-4 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, a @ x, rtol=tol, atol=tol)


def test_bsr_reference_kernel_matches_einsum_path():
    """bsr_matvec on the packed tiles of the full padded vector equals the
    dense product (padding rows come out zero)."""
    n = 128
    a = _random_sparse(n, 0.15, 6, dtype=np.float32)
    rows, cols = np.nonzero(a)
    op = BSROperator.from_coo(rows, cols, a[rows, cols], n)
    n_pad = op.n_padded
    x = jnp.asarray(np.random.default_rng(7).normal(size=n_pad).astype(np.float32))
    y = bsr_matvec(op.blocks, op.col_blocks, x)
    expect = np.zeros(n_pad, dtype=np.float64)
    expect[:n] = a @ np.asarray(x)[:n]
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "n,bm,bk,empty_rows",
    [(1, 128, 128, False), (127, 128, 128, False), (129, 128, 128, True), (300, 8, 128, True), (77, 16, 8, True)],
)
def test_bsr_odd_n_padding_and_empty_rows(n, bm, bk, empty_rows):
    """Odd n (padded up to the tile grid), rows with no entries at all (their
    block rows hold only padding tiles), against a float64 dense product;
    matvec_df on the same operator reaches float64 accuracy."""
    rng = np.random.default_rng(n)
    a = _random_sparse(n, 0.2, n + 1, dtype=np.float32)
    a[np.diag_indices(n)] = 1.0
    if empty_rows and n > 2:
        dead = rng.choice(n, size=max(1, n // 4), replace=False)
        a[dead, :] = 0.0
        a[:, dead] = 0.0
    rows, cols = np.nonzero(a)
    op = BSROperator.from_coo(rows, cols, a[rows, cols], n, bm=bm, bk=bk)
    assert op.n_padded >= n and op.n_padded % bm == 0 and op.n_padded % bk == 0
    x = rng.standard_normal(n).astype(np.float32)
    want = a.astype(np.float64) @ x.astype(np.float64)
    got = np.asarray(op.matvec(jnp.asarray(x)), np.float64)
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if empty_rows and n > 2:
        assert np.all(got[dead] == 0.0)
    hi, lo = op.matvec_df(jnp.asarray(x), jnp.zeros(n, jnp.float32))
    np.testing.assert_allclose(np.asarray(hi, np.float64) + np.asarray(lo, np.float64), want, rtol=1e-12, atol=1e-12)


def test_function_operator_and_coercion():
    n = 8
    op = as_operator(lambda x: 2.0 * x, n, np.float64)
    assert isinstance(op, FunctionOperator)
    x = jnp.arange(n, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(op.matvec(x)), 2.0 * np.arange(n))

    m = as_operator(np.eye(4))
    assert isinstance(m, DenseOperator)
    assert m.n == 4


def test_csr_matches_dense():
    import scipy.sparse as sp
    from lanczos_tpu.ops.operators import CSROperator

    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 40))
    a[np.abs(a) < 1.0] = 0.0
    a = (a + a.T) / 2
    op = CSROperator.from_scipy(sp.csr_matrix(a))
    x = rng.standard_normal(40)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), a @ x, atol=1e-12)
    # BSR conversion keeps numerics
    bsr = op.to_bsr(dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(bsr.matvec(jnp.asarray(x))), a @ x, atol=1e-12)


def test_csr_through_jit_and_solver():
    import scipy.sparse as sp
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import CSROperator

    n = 30
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    op = CSROperator.from_scipy(sp.csr_matrix(a))
    val, vec = LambdaLanczos(op, find_maximum=True).run_one()
    assert abs(val - np.linalg.eigvalsh(a)[-1]) < 1e-10


def test_vector_to_string():
    from lanczos_tpu.utils.stats import vector_to_string

    assert vector_to_string(np.array([1.0, 2.5]), digits=3) == "1 2.5"


def test_dia_matches_dense():
    from lanczos_tpu.ops.operators import DIAOperator

    n = 50
    rng = np.random.default_rng(5)
    rows_l, cols_l, vals_l = [], [], []
    for d in (-2, 0, 1):
        for i in range(max(0, -d), n - max(0, d)):
            rows_l.append(i); cols_l.append(i + d); vals_l.append(rng.standard_normal())
    op = DIAOperator.from_coo(rows_l, cols_l, np.asarray(vals_l), n, dtype=np.float64)
    dense = np.zeros((n, n)); dense[rows_l, cols_l] = vals_l
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), dense @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), dense, atol=1e-14)


def test_dia_lanczos_stencil():
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DIAOperator

    n = 100
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n)
    eng = LambdaLanczos(op, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    val, vec = eng.run_one()
    assert abs(val - (-2 * np.cos(np.pi / (n + 1)))) < 1e-10


def test_dia_fused_mode():
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DIAOperator

    n = 64
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n)
    eng = LambdaLanczos(op, find_maximum=False, mode="fused")
    eng.eigenvalue_offset = -4.0
    val, _ = eng.run_one()
    assert abs(val - (-2 * np.cos(np.pi / (n + 1)))) < 1e-9


def _stencil_ops(n):
    """The same stencil Hamiltonian in every operator representation."""
    import jax

    from lanczos_tpu.ops.operators import (
        BSROperator, COOOperator, CSROperator, DenseOperator, DIAOperator, FunctionOperator,
    )
    from lanczos_tpu.parallel.mesh import make_mesh
    from lanczos_tpu.parallel.sharded import ShardedBSROperator, ShardedDIAOperator

    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1]); cols = np.concatenate([i + 1, i])
    vals = np.full(2 * (n - 1), -1.0)
    dense = np.zeros((n, n)); dense[rows, cols] = vals
    mesh = make_mesh(jax.devices()[:8])

    def stencil_fn(x):
        left = jnp.concatenate([x[1:], jnp.zeros((1,), x.dtype)])
        right = jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])
        return -left - right

    import scipy.sparse as sp

    return {
        "dense": DenseOperator(jnp.asarray(dense)),
        "coo": COOOperator.from_arrays(rows, cols, jnp.asarray(vals), n),
        "csr": CSROperator.from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(n, n))),
        "bsr": BSROperator.from_coo(rows, cols, vals, n, dtype=jnp.float64),
        "dia": DIAOperator.from_coo(rows, cols, vals, n),
        "function": FunctionOperator(stencil_fn, n, np.dtype(np.float64)),
        "sharded_bsr": ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64),
        "sharded_dia": ShardedDIAOperator.from_diagonals(
            [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh
        ),
    }


@pytest.mark.parametrize(
    "kind", ["dense", "coo", "csr", "bsr", "dia", "function", "sharded_bsr", "sharded_dia"]
)
def test_stencil_eigensolve_every_operator(kind):
    """Backend-equivalence: the same solve through every operator
    representation (the analogue of the reference's three-binaries
    trick, test/CMakeLists.txt:5-12)."""
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.utils.random import fixed_seed_initializer

    n = 64
    op = _stencil_ops(n)[kind]
    eng = LambdaLanczos(op, find_maximum=False)
    eng.eigenvalue_offset = -4.0
    eng.init_vector = fixed_seed_initializer(np.float64, seed=2)
    val, vec = eng.run_one()
    assert abs(val - (-2 * np.cos(np.pi / (n + 1)))) < 1e-11


def test_operator_algebra():
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.ops.operators import DIAOperator, ScaledOperator, SumOperator

    n = 40
    rng = np.random.default_rng(6)
    hop = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n)
    pot = DIAOperator.from_diagonals([0], [rng.uniform(0, 2, n)], n)
    h = SumOperator((hop, pot))

    dense = np.asarray(hop.to_dense()) + np.asarray(pot.to_dense())
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(h.matvec(jnp.asarray(x))), dense @ x, atol=1e-12)

    scaled = ScaledOperator(h, scale=2.0, shift=-1.0)
    np.testing.assert_allclose(
        np.asarray(scaled.matvec(jnp.asarray(x))), 2.0 * (dense @ x) - x, atol=1e-12
    )

    # composes with the solver (jit boundary as pytree)
    val, _ = LambdaLanczos(h, find_maximum=False).run_one()
    assert abs(val - np.linalg.eigvalsh(dense)[0]) < 1e-10


def test_hermitian_split_solve():
    """Complex Hermitian eigenproblem in pure real arithmetic (the facade's
    path for complex matrices): real embedding + pair folding."""
    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator, solve_hermitian
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    n = 24
    rng = np.random.default_rng(14)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    w, u = np.linalg.eigh(h)

    op_r = DenseOperator(jnp.asarray(h.real))
    op_i = DenseOperator(jnp.asarray(h.imag))

    def cfg(eng):
        eng.init_vector = fixed_seed_initializer(np.float64, seed=3)

    vals, vecs = solve_hermitian(op_r, op_i, num_eigs=3, find_maximum=True, configure=cfg)
    np.testing.assert_allclose(vals, w[::-1][:3], atol=1e-9)
    for k in range(3):
        r = h @ vecs[k] - vals[k] * vecs[k]
        assert np.linalg.norm(r) < 1e-7


def test_hermitian_split_embedding_symmetry():
    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator
    from lanczos_tpu.ops.operators import DenseOperator

    n = 10
    rng = np.random.default_rng(15)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (h + h.conj().T) / 2
    emb = HermitianSplitOperator(DenseOperator(jnp.asarray(h.real)), DenseOperator(jnp.asarray(h.imag)))
    x = rng.standard_normal(2 * n)
    y = rng.standard_normal(2 * n)
    # <y, H~ x> == <H~ y, x>  (embedding is symmetric)
    lhs = float(np.dot(y, np.asarray(emb.matvec(jnp.asarray(x)))))
    rhs = float(np.dot(np.asarray(emb.matvec(jnp.asarray(y))), x))
    assert abs(lhs - rhs) < 1e-10


def test_bsr_bfloat16_tiles():
    """bf16 tile storage (half the HBM traffic) with f32 accumulation."""
    n = 200
    rng = np.random.default_rng(16)
    a = rng.standard_normal((n, n)); a[np.abs(a) < 1.0] = 0.0
    a = (a + a.T) / 2
    rows, cols = np.nonzero(a)
    from lanczos_tpu.ops.operators import BSROperator

    op = BSROperator.from_coo(rows, cols, a[rows, cols], n, dtype=jnp.bfloat16)
    assert op.blocks.dtype == jnp.bfloat16
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(op.matvec(jnp.asarray(x)), np.float32)
    ref = (a.astype(np.float32) @ x).astype(np.float32)
    # bf16 tile rounding: ~0.4% relative per element
    np.testing.assert_allclose(y, ref, rtol=2e-2, atol=2e-2)


def test_scipy_compat_eigsh():
    import scipy.sparse as sp
    from lanczos_tpu.scipy_compat import eigsh

    n = 40
    rng = np.random.default_rng(33)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w_ref = np.linalg.eigvalsh(a)

    w, v = eigsh(jnp.asarray(a), k=3, which="SA")
    np.testing.assert_allclose(w, w_ref[:3], atol=1e-9)
    for i in range(3):
        r = a @ v[:, i] - w[i] * v[:, i]
        assert np.linalg.norm(r) < 1e-8

    # sparse input + engine kwargs + values-only
    w2 = eigsh(sp.csr_matrix(a), k=2, which="LA", return_eigenvectors=False,
               restart_policy="thick", maxiter=20, max_restarts=40)
    np.testing.assert_allclose(w2, w_ref[-2:], atol=1e-9)


def test_scipy_compat_expm_multiply():
    import scipy.linalg as sla
    from lanczos_tpu.scipy_compat import expm_multiply

    n = 30
    rng = np.random.default_rng(34)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    b = rng.standard_normal(n)
    got = expm_multiply(jnp.asarray(a), b, t=0.7)
    np.testing.assert_allclose(got, sla.expm(0.7 * a) @ b, rtol=1e-9, atol=1e-9)

    blk = rng.standard_normal((n, 3))
    got_blk = expm_multiply(jnp.asarray(a), blk, t=0.3)
    np.testing.assert_allclose(got_blk, sla.expm(0.3 * a) @ blk, rtol=1e-9, atol=1e-9)


def test_scipy_compat_eigsh_both_ends_and_sigma():
    from lanczos_tpu.scipy_compat import eigsh

    n = 40
    rng = np.random.default_rng(35)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w_ref = np.linalg.eigvalsh(a)

    # 'BE' k=5: 2 smallest + 3 largest (the extra from the high end), ascending.
    # Deterministic per-call-distinct init: fresh entropy occasionally leaves
    # a residual marginally above the bound (convergence-luck flake).
    rng_iv = np.random.default_rng(77)
    w, v = eigsh(jnp.asarray(a), k=5, which="BE", v0=lambda n_: jnp.asarray(rng_iv.uniform(-1, 1, n_)))
    expected = np.concatenate([w_ref[:2], w_ref[-3:]])
    np.testing.assert_allclose(w, expected, atol=1e-9)
    for i in range(5):
        r = a @ v[:, i] - w[i] * v[:, i]
        assert np.linalg.norm(r) < 1e-8

    with pytest.raises(ValueError):
        eigsh(jnp.asarray(a), k=2, sigma=1.5, which="BE")  # BE has no shift-invert sense


def test_scipy_compat_eigsh_shift_invert():
    """sigma= shift-invert: eigenvalues nearest an interior sigma via the
    matrix-free MINRES-backed ShiftInvertOperator (scipy's LM/LA/SA
    semantics on theta = 1/(lambda-sigma))."""
    from lanczos_tpu.scipy_compat import eigsh

    n = 80
    rng = np.random.default_rng(37)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    w_ref = np.linalg.eigvalsh(a)
    sigma = (w_ref[40] + w_ref[41]) / 2 + 0.011

    w, v = eigsh(jnp.asarray(a), k=4, sigma=sigma, which="LM", tol=1e-10)
    nearest = np.sort(w_ref[np.argsort(np.abs(w_ref - sigma))[:4]])
    np.testing.assert_allclose(np.sort(w), nearest, atol=1e-9)
    for i in range(4):
        r = a @ v[:, i] - w[i] * v[:, i]
        assert np.linalg.norm(r) < 1e-8

    w_la = eigsh(jnp.asarray(a), k=3, sigma=sigma, which="LA", tol=1e-10, return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(w_la), np.sort(w_ref[w_ref > sigma])[:3], atol=1e-9)
    w_sa = eigsh(jnp.asarray(a), k=3, sigma=sigma, which="SA", tol=1e-10, return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(w_sa), np.sort(w_ref[w_ref < sigma])[-3:], atol=1e-9)


def test_scipy_compat_minres():
    """scipy_compat.minres: scipy call shape (x, info), info=0 on success,
    matches scipy.sparse.linalg.minres on an indefinite system."""
    import scipy.sparse.linalg as sla
    from lanczos_tpu.scipy_compat import minres

    rng = np.random.default_rng(8)
    n = 60
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2  # indefinite
    b = rng.normal(size=n)
    x, info = minres(jnp.asarray(a), b, rtol=1e-10, maxiter=1000)
    assert info == 0
    assert np.linalg.norm(a @ x - b) < 1e-7
    x_sp, info_sp = sla.minres(a, b, rtol=1e-10)
    np.testing.assert_allclose(x, x_sp, atol=1e-6)
    # maxiter exhaustion reports the iteration count (scipy convention)
    x2, info2 = minres(jnp.asarray(a), b, rtol=1e-14, maxiter=3)
    assert info2 == 3


def test_shift_invert_fused_engine_nesting():
    """mode='fused' (the accelerator default): the MINRES while_loop nests
    inside the fused engine's while_loop — the compile structure the GPU runs."""
    from lanczos_tpu.scipy_compat import eigsh

    rng = np.random.default_rng(0)
    n = 80
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    w_all = np.linalg.eigvalsh(a)
    sigma = (w_all[40] + w_all[41]) / 2 + 0.009
    w, v = eigsh(a, k=3, sigma=sigma, which="LM", tol=1e-10, mode="fused")
    near = np.sort(w_all[np.argsort(np.abs(w_all - sigma))[:3]])
    np.testing.assert_allclose(np.sort(w), near, atol=1e-9)
    for i in range(3):
        assert np.linalg.norm(a @ v[:, i] - w[i] * v[:, i]) < 1e-9


def test_minres_indefinite_and_hermitian():
    """MINRES: indefinite shifted solve (interior sigma) and a complex
    Hermitian system both reach the requested residual."""
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.solvers.minres import minres

    rng = np.random.default_rng(2)
    n = 100
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    w_all = np.linalg.eigvalsh(a)
    sigma = (w_all[50] + w_all[51]) / 2
    op = DenseOperator(jnp.asarray(a), n)
    b = jnp.asarray(rng.normal(size=n))
    x, relres, _ = minres(op, b, shift=sigma, tol=1e-11, maxiter=800)
    err = np.linalg.norm((a - sigma * np.eye(n)) @ np.asarray(x) - np.asarray(b))
    assert err < 1e-8 and float(relres) < 1e-10

    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h = (h + h.conj().T) / 2
    oph = DenseOperator(jnp.asarray(h), n)
    bc = jnp.asarray(rng.normal(size=n) + 1j * rng.normal(size=n))
    xc, rc, _ = minres(oph, bc, shift=0.25, tol=1e-11, maxiter=800)
    errc = np.linalg.norm((h - 0.25 * np.eye(n)) @ np.asarray(xc) - np.asarray(bc))
    assert errc < 1e-8 and float(rc) < 1e-10


def test_scipy_compat_expm_multiply_time_grid():
    import scipy.linalg as sla
    from lanczos_tpu.scipy_compat import expm_multiply

    n = 30
    rng = np.random.default_rng(36)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    b = rng.standard_normal(n)
    ts = np.linspace(0.1, 1.0, 4)
    got = expm_multiply(jnp.asarray(a), b, start=0.1, stop=1.0, num=4)
    assert got.shape == (4, n)
    for i, t in enumerate(ts):
        np.testing.assert_allclose(got[i], sla.expm(t * a) @ b, rtol=1e-8, atol=1e-8)

    blk = rng.standard_normal((n, 2))
    got_blk = expm_multiply(jnp.asarray(a), blk, start=0.0, stop=0.5, num=3)
    assert got_blk.shape == (3, n, 2)
    for i, t in enumerate(np.linspace(0.0, 0.5, 3)):
        np.testing.assert_allclose(got_blk[i], sla.expm(t * a) @ blk, rtol=1e-8, atol=1e-8)


def test_scipy_compat_eigsh_precise_vectors_passthrough():
    """Engine kwargs reach the pv engines through the facade: an f32
    clustered problem solved to df64 accuracy via
    eigsh(..., precise_vectors=True, restart_policy='thick')."""
    from lanczos_tpu import DIAOperator
    from lanczos_tpu.scipy_compat import eigsh

    n = 1024
    d = np.linspace(2.0, 6.0, n).astype(np.float32)
    d[0], d[1] = 1.0, 1.0 + 3e-7  # unresolvable in plain f32
    op = DIAOperator.from_diagonals([0], jnp.asarray(d[None, :]), n)
    w, v = eigsh(
        op, k=2, which="SA", tol=1e-12,
        precise_vectors=True, restart_policy="thick", maxiter=64,
        max_restarts=64, mode="fused",
    )
    truth = np.sort(d.astype(np.float64))[:2]
    assert np.max(np.abs(np.sort(w) - truth)) < 1e-10
    assert v.shape == (n, 2)  # scipy column convention


def test_solve_hermitian_filtered_precise():
    """solve_hermitian(method='filtered', precise=True): complex Hermitian
    eigenpairs at the df floor through the real embedding — the doubled
    embedded copies are exact degeneracies, the filtered driver's
    probe-covered case; folding returns k complex pairs."""
    import numpy as np

    from lanczos_tpu.ops.hermitian_split import solve_hermitian

    rng = np.random.default_rng(2)
    n = 100
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    H64 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    H64 = (H64 + H64.conj().T) / 2
    w_true = np.linalg.eigvalsh(H64)
    vals, vecs = solve_hermitian(
        DenseOperator(jnp.asarray(Hr), n), DenseOperator(jnp.asarray(Hi), n),
        num_eigs=3, method="filtered", precise=True)
    assert len(vals) == 3
    assert max(abs(np.sort(vals) - w_true[:3])) < 1e-11
    for i in range(3):
        r = np.linalg.norm(H64 @ vecs[i] - vals[i] * vecs[i])
        assert r < 1e-10, (i, r)
    # complex images stay orthonormal
    G = vecs @ vecs.conj().T
    assert np.abs(G - np.eye(3)).max() < 1e-8
    # invalid method rejected
    import pytest

    with pytest.raises(ValueError, match="method"):
        solve_hermitian(DenseOperator(jnp.asarray(Hr), n),
                        DenseOperator(jnp.asarray(Hi), n), method="nope")
