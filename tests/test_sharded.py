"""Multi-chip (8 virtual CPU devices) sharded-path tests.

The reference has no distributed tests to mirror (single-process GTest only,
SURVEY.md §4); these validate the addition: row-partitioned
operators + GSPMD/shard_map solves agree with the single-device path to
solver precision.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lanczos_tpu.api import LambdaLanczos
from lanczos_tpu.ops.operators import BSROperator, DenseOperator
from lanczos_tpu.parallel import mesh as pmesh
from lanczos_tpu.parallel.sharded import ShardedBSROperator, shard_operator
from lanczos_tpu.utils.random import fixed_seed_initializer


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return pmesh.make_mesh(jax.devices()[:8])


def _stencil_coo(n):
    """1D Laplacian-like hopping stencil (reference sample3_dynamic.cpp:17-22)."""
    rows, cols, vals = [], [], []
    for i in range(n - 1):
        rows += [i, i + 1]
        cols += [i + 1, i]
        vals += [-1.0, -1.0]
    return np.array(rows), np.array(cols), np.array(vals)


def test_sharded_bsr_matvec_matches_dense(mesh):
    n = 300
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    rows, cols = np.nonzero(np.abs(a) > 1.0)
    vals = a[rows, cols]
    dense = np.zeros((n, n))
    dense[rows, cols] = vals

    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64)
    x = rng.standard_normal(n)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_ring_halo_matches_gather(mesh):
    """Overlapped halo schedule (SURVEY item 1): the ring-mode SpMV must be
    bit-compatible with the all_gather path on a banded operator, 'auto'
    must fall back to gather for scattered patterns, and explicit 'ring'
    must reject them."""
    n = 2048
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1, np.arange(n)])
    cols = np.concatenate([i + 1, i, np.arange(n)])
    vals = np.concatenate([np.full(n - 1, -1.0), np.full(n - 1, -1.0), 0.1 * np.arange(n)])

    og = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64, comm="gather")
    orr = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64, comm="ring")
    assert orr.comm == "ring" and orr.ring_groups is not None
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(orr.matvec(x)), np.asarray(og.matvec(x)), rtol=1e-13, atol=1e-13
    )

    rng = np.random.default_rng(1)
    r2 = rng.integers(0, n, 500)
    c2 = rng.integers(0, n, 500)
    v2 = rng.standard_normal(500)
    oa = ShardedBSROperator.from_coo(r2, c2, v2, n, mesh, dtype=jnp.float64, comm="auto")
    assert oa.comm == "gather"
    with pytest.raises(ValueError):
        ShardedBSROperator.from_coo(r2, c2, v2, n, mesh, dtype=jnp.float64, comm="ring")


def test_ring_halo_rectangular_tiles(mesh):
    """bk > bm ring geometry: the padding quantum must also divide ndev*bk
    (lcm(bk, ndev*bm) alone gave cols-per-device = 0 — a divide-by-zero in
    the owner classification and a misaligned local x reshape)."""
    n = 200
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1])
    cols = np.concatenate([i + 1, i])
    vals = np.full(2 * (n - 1), -1.0)
    op = ShardedBSROperator.from_coo(
        rows, cols, vals, n, mesh, bm=64, bk=128, dtype=jnp.float64, comm="ring"
    )
    assert op.comm == "ring"
    a = np.zeros((n, n))
    a[i, i + 1] = a[i + 1, i] = -1.0
    x = np.zeros(op.n_padded)
    x[:n] = np.random.default_rng(0).standard_normal(n)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-12, atol=1e-12)


def test_ring_halo_lanczos_solve(mesh):
    n = 1024
    rows, cols, vals = _stencil_coo(n)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64, comm="ring")
    eng = LambdaLanczos(op, find_maximum=False)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=5)
    val, vec = eng.run_one()
    expected = -2 * np.cos(np.pi / (n + 1))
    assert abs(val - expected) < 1e-10


def test_sharded_bsr_operator_is_row_partitioned(mesh):
    rows, cols, vals = _stencil_coo(256)
    op = ShardedBSROperator.from_coo(rows, cols, vals, 256, mesh, dtype=jnp.float64)
    shard_shapes = {s.data.shape for s in op.blocks.addressable_shards}
    assert len(shard_shapes) == 1
    assert next(iter(shard_shapes))[0] == op.blocks.shape[0] // 8


def test_sharded_dense_lanczos_matches_single_device(mesh):
    n = 64
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2

    ref = LambdaLanczos(DenseOperator(jnp.asarray(a)), find_maximum=True)
    ref.init_vector = fixed_seed_initializer(np.float64, seed=42)
    val_ref, _ = ref.run_one()

    sharded = shard_operator(DenseOperator(jnp.asarray(a)), mesh)
    eng = LambdaLanczos(sharded, find_maximum=True)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=42)
    val, vec = eng.run_one()

    assert abs(val - val_ref) < 1e-10
    np.testing.assert_allclose(np.asarray(DenseOperator(jnp.asarray(a)).matvec(vec)), val * np.asarray(vec), atol=1e-8)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_sharded_bsr_lanczos_stencil(mesh, mode):
    """Min eigenvalue of the n=100 hopping stencil: -2cos(pi/(n+1))
    (reference sample3_dynamic.cpp / lambda_lanczos_test.cpp:262-308)."""
    n = 100
    rows, cols, vals = _stencil_coo(n)
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float64)

    eng = LambdaLanczos(op, find_maximum=False, mode=mode)
    eng.eigenvalue_offset = -4.0
    eng.eps = 1e-12
    eng.init_vector = fixed_seed_initializer(np.float64, seed=7)
    val, vec = eng.run_one()

    expected = -2.0 * np.cos(np.pi / (n + 1))
    assert abs(val - expected) < 1e-10
    # Eigenvector residual through the *sharded* matvec.
    r = np.asarray(op.matvec(vec)) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-8


def test_sharded_vector_placement(mesh):
    v = jnp.arange(1024, dtype=jnp.float64)
    vs = pmesh.shard_vector(v, mesh)
    assert len(vs.addressable_shards) == 8
    np.testing.assert_array_equal(np.asarray(vs), np.asarray(v))


def test_sharded_dia_matvec_matches_dense(mesh):
    from lanczos_tpu.ops.operators import DIAOperator
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 512
    rng = np.random.default_rng(9)
    offs = [-3, -1, 0, 2]
    diags = [rng.standard_normal(n) for _ in offs]
    op = ShardedDIAOperator.from_diagonals(offs, diags, n, mesh)
    dense = np.asarray(DIAOperator.from_diagonals(offs, diags, n).to_dense())
    x = rng.standard_normal(n)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_sharded_dia_lanczos(mesh, mode):
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 256
    op = ShardedDIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh
    )
    eng = LambdaLanczos(op, find_maximum=False, mode=mode)
    eng.eigenvalue_offset = -4.0
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    val, vec = eng.run_one()
    assert abs(val - (-2.0 * np.cos(np.pi / (n + 1)))) < 1e-10
    r = np.asarray(op.matvec(vec)) - val * np.asarray(vec)
    assert np.linalg.norm(r) < 1e-8


def test_sharded_exponentiator(mesh):
    """Krylov time evolution over a row-partitioned operator."""
    from lanczos_tpu import Exponentiator
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 128
    op = ShardedDIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n, mesh
    )
    psi = np.zeros(n, dtype=complex)
    psi[n // 2] = 1.0

    expo = Exponentiator(op, dtype=np.complex128)
    out, iters = expo.run(-1.5j, jnp.asarray(psi))
    assert abs(float(jnp.linalg.norm(out)) - 1.0) < 1e-12

    dense = np.zeros((n, n))
    i = np.arange(n - 1)
    dense[i, i + 1] = dense[i + 1, i] = -1.0
    import scipy.linalg as sla

    truth = sla.expm(-1.5j * dense) @ psi
    ov = abs(np.vdot(truth, np.asarray(out)))
    assert 1 - ov < 1e-12


def test_sharded_dia_complex(mesh):
    """Complex Hermitian banded operator over the mesh (ppermute halos with
    complex dtype)."""
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 128
    rng = np.random.default_rng(12)
    t = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    # Hermitian: A[i, i+1] = t_i, A[i+1, i] = conj(t_i)
    upper = np.zeros(n, complex); upper[: n - 1] = t[: n - 1]
    lower = np.zeros(n, complex); lower[1:] = np.conj(t[: n - 1])
    op = ShardedDIAOperator.from_diagonals([1, -1], [upper, lower], n, mesh)

    dense = np.zeros((n, n), complex)
    i = np.arange(n - 1)
    dense[i, i + 1] = t[: n - 1]
    dense[i + 1, i] = np.conj(t[: n - 1])
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), dense @ x, atol=1e-12)

    eng = LambdaLanczos(op, find_maximum=True)
    eng.init_vector = fixed_seed_initializer(np.complex128, seed=5)
    val, vec = eng.run_one()
    w = np.linalg.eigvalsh(dense)
    assert abs(val - w[-1]) < 1e-10


def test_multislice_sparse_solve():
    """A stencil operator partitioned over the COMBINED ('hosts', 'rows')
    axes: halo ppermutes stay inside a host and cross hosts only at the
    host boundary; the full Lanczos solve must match the analytic chain
    eigenvalue (the 2D mesh exercised by a real sparse solve, not just
    mesh construction)."""
    from lanczos_tpu.parallel.mesh import make_multihost_mesh
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    mesh2d = make_multihost_mesh(2)
    assert dict(mesh2d.shape) == {"hosts": 2, "rows": 4}
    n = 1024
    off = np.full(n, -1.0)
    op = ShardedDIAOperator.from_diagonals([-1, 1], [off, off], n, mesh2d, axis_name=("hosts", "rows"))
    x = np.random.default_rng(0).standard_normal(n)
    d = np.diag(off[: n - 1], 1) + np.diag(off[: n - 1], -1)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), d @ x, atol=1e-12)

    eng = LambdaLanczos(op, find_maximum=False)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    val, vec = eng.run_one()
    assert abs(val - (-2 * np.cos(np.pi / (n + 1)))) < 1e-10


def test_multislice_mesh_cpu_fallback():
    """2D (hosts, rows) mesh construction; batched solves over the hosts
    axis via vmap with the rows axis carrying the per-solve collectives."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lanczos_tpu.parallel.mesh import make_multihost_mesh
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.solvers.lanczos_fused import fused_krylov

    m2 = make_multihost_mesh(2)
    assert m2.axis_names == ("hosts", "rows")
    assert m2.devices.shape == (2, 4)

    n, bsz = 32, 2
    rng = np.random.default_rng(0)
    a = rng.standard_normal((bsz, n, n))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    v0 = rng.standard_normal((bsz, n))
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)

    a_s = jax.device_put(jnp.asarray(a), NamedSharding(m2, P("hosts", "rows", None)))
    v_s = jax.device_put(jnp.asarray(v0), NamedSharding(m2, P("hosts", "rows")))
    defl = jnp.zeros((bsz, 1, n)); mask = jnp.zeros((bsz, 1))

    def one(a_i, v_i, d_i, m_i):
        return fused_krylov(
            DenseOperator(a_i, n), v_i, d_i, m_i, 1e-10, 0.0,
            nroot=1, m_cap=n, find_maximum=True,
        )[4]

    evs = jax.jit(jax.vmap(one))(a_s, v_s, defl, mask)
    ref = np.linalg.eigvalsh(a)[:, -1]
    np.testing.assert_allclose(np.asarray(evs)[:, 0], ref, atol=1e-8)


def test_dense_2d_tensor_parallel_matvec():
    """2D (rows x cols) dense partitioning: GSPMD inserts the partial-sum
    reduction over the cols axis; solve agrees with single-device."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.parallel.mesh import shard_dense_operator_2d

    n = 64
    rng = np.random.default_rng(21)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    mesh2 = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("rows", "cols"))
    a_s = shard_dense_operator_2d(jnp.asarray(a), mesh2)
    op = DenseOperator(a_s, n)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), a @ x, atol=1e-11)

    eng = LambdaLanczos(op, find_maximum=True)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=31)
    val, _ = eng.run_one()
    assert abs(val - np.linalg.eigvalsh(a)[-1]) < 1e-10


def test_sharded_bsr_matvec_df_matches_single_device(mesh):
    """ShardedBSROperator.matvec_df (VERDICT r3 missing item 1): the df
    sharded SpMV must agree with the single-device EFT matvec_df to the
    df64 floor (~2^-45 relative) on both comm schedules, in f32 storage."""
    n = 512
    rows, cols, vals = _stencil_coo(n)
    # add a diagonal so both words are exercised with non-trivial cancellation
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 1.0 / 3.0)])

    from lanczos_tpu.ops.operators import BSROperator

    single = BSROperator.from_coo(rows, cols, vals, n, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    xh = rng.uniform(-1, 1, n).astype(np.float32)
    xl = (rng.uniform(-1, 1, n) * 1e-8).astype(np.float32)
    ref_hi, ref_lo = single.matvec_df(jnp.asarray(xh), jnp.asarray(xl))
    ref = np.asarray(ref_hi, np.float64) + np.asarray(ref_lo, np.float64)

    for comm in ("gather", "ring"):
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float32, comm=comm)
        y_hi, y_lo = op.matvec_df(jnp.asarray(xh), jnp.asarray(xl))
        got = np.asarray(y_hi, np.float64) + np.asarray(y_lo, np.float64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=comm)


def test_pv_thick_sharded_bsr_mesh(mesh):
    """precise_vectors over the 8-device mesh on the PRODUCTION sparse
    format: the sharded BSR df matvec + the pv thick engine reach
    reference-grade eigenvalues, matching the single-device pv solve
    (the sharded analogue of the reference's mv_mul contract,
    lambda_lanczos.hpp:120-126)."""
    n = 256
    rows, cols, vals = _stencil_coo(n)
    vals = vals.astype(np.float32)
    exact = -2.0 * np.cos(np.pi / (n + 1))

    def solve(op):
        eng = LambdaLanczos(op, find_maximum=False, num_eigs=1, dtype=np.float32, mode="fused")
        eng.precise_vectors = True
        eng.restart_policy = "thick"
        eng.max_iteration = 40
        eng.max_restarts = 64
        eng.eps = 1e-11
        eng.eigenvalue_offset = -4.0
        eng.init_vector = fixed_seed_initializer(np.float32, seed=11)
        val, _ = eng.run_one()
        return float(val)

    from lanczos_tpu.ops.operators import BSROperator

    v_single = solve(BSROperator.from_coo(rows, cols, vals, n, dtype=jnp.float32))
    v_shard = solve(ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, dtype=jnp.float32))
    assert abs(v_single - exact) < 1e-9, v_single
    assert abs(v_shard - exact) < 1e-9, v_shard
    # same seed, same EFT arithmetic -> the sharded solve tracks the
    # single-device one to the df64 noise floor, not just the tolerance
    assert abs(v_shard - v_single) < 1e-11, (v_shard, v_single)


def test_precise_filtered_sharded_dia(mesh):
    """Round-4 headline path multi-chip: filtered_lanczos(precise=True)
    over the row-partitioned DIA operator — the df64 Chebyshev chain runs
    the sharded df halo matvec inside lax.scan, the pv B-space engine and
    the jitted RR grams lower against the mesh, and the inverse-mapped
    values land at the same f64-exact floor as single-device."""
    from lanczos_tpu import filtered_lanczos
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 1024
    off = jnp.full(n, -1.0, jnp.float32)
    op = ShardedDIAOperator.from_diagonals([-1, 1], [off, off], n, mesh)
    vals, _vecs, info = filtered_lanczos(
        op, num_eigs=2, lo=-2.0, hi=2.0, precise=True)
    exact = [-2.0 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
    assert max(abs(float(vals[i]) - exact[i]) for i in range(2)) < 1e-11


def test_chebyshev_propagator_sharded_dia(mesh):
    """The whole-evolution Chebyshev chain (solvers/cheby_expm.py) over a
    row-partitioned operator: the f32 and df64 chains both run the sharded
    halo matvec inside one lax.scan against the mesh, at the single-device
    accuracy floors."""
    import scipy.linalg as sla

    from lanczos_tpu import Exponentiator
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    n = 512
    off = jnp.full(n, -1.0, jnp.float32)
    op = ShardedDIAOperator.from_diagonals([-1, 1], [off, off], n, mesh)
    A = np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 1, -1.0), 1)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    truth = sla.expm(3j * A) @ v
    ex = Exponentiator(op, dtype=np.float32)
    (o_re, o_im), _K = ex.run_chebyshev(
        3j, v.real.astype(np.float32), v.imag.astype(np.float32), lo=-2.0, hi=2.0)
    out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert np.linalg.norm(out - truth) < 5e-6
    (p_re, p_im), _K2 = ex.run_chebyshev(
        3j, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)
    assert np.linalg.norm((p_re + 1j * p_im) - truth) < 1e-12


def test_bsr_footprint_matches_dense_and_gather(mesh):
    """Column-footprint halo (VERDICT r4 item 2): a scattered pattern whose
    long-range couplings break ring mode solves identically through
    gather, footprint, and the unsharded dense product — f64 exact — and
    the df path holds the EFT contract across the packed exchange."""
    rng = np.random.default_rng(0)
    n = 1024
    i = np.arange(n - 1)
    r = [i, i + 1]
    c = [i + 1, i]
    v = [np.full(n - 1, -1.0)] * 2
    for d, cnt in ((n // 2, 12), (n // 4, 8)):
        pos = rng.choice(n - d, cnt, replace=False)
        w = rng.standard_normal(cnt)
        r += [pos, pos + d]
        c += [pos + d, pos]
        v += [w, w]
    rows = np.concatenate(r)
    cols = np.concatenate(c)
    vals = np.concatenate(v)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)

    op_g = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8,
                                       dtype=jnp.float64, comm="gather")
    op_f = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8,
                                       dtype=jnp.float64, comm="auto")
    assert op_f.comm == "footprint"
    x = rng.standard_normal(n)
    ref = dense @ x
    yg = np.asarray(op_g.matvec(jnp.asarray(x)))
    yf = np.asarray(op_f.matvec(jnp.asarray(x)))
    assert np.abs(yg - ref).max() < 1e-12
    assert np.abs(yf - ref).max() < 1e-12
    # df EFT path across the packed exchange
    fh, fl = op_f.matvec_df(jnp.asarray(x), jnp.zeros(n))
    assert np.abs(np.asarray(fh) + np.asarray(fl) - ref).max() < 1e-12
    # jit with the operator as a pytree argument (tree_flatten round trip)
    yj = np.asarray(jax.jit(lambda o, w: o.matvec(w))(op_f, jnp.asarray(x)))
    assert np.abs(yj - ref).max() < 1e-12


def test_bsr_footprint_solve_through_engine(mesh):
    """A full LambdaLanczos solve over the footprint-mode operator matches
    the gather-mode solve to 1e-12 (same eigenvalues through a packed
    multi-hop exchange)."""
    rng = np.random.default_rng(3)
    n = 1024
    i = np.arange(n - 1)
    rows = np.concatenate([i, i + 1, [0, n // 2]])
    cols = np.concatenate([i + 1, i, [n // 2, 0]])
    vals = np.concatenate([np.full(2 * (n - 1), -1.0), [0.25, 0.25]])
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.utils.random import fixed_seed_initializer

    res = {}
    for comm in ("gather", "footprint"):
        op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8,
                                         dtype=jnp.float64, comm=comm)
        assert op.comm == comm
        eng = LambdaLanczos(op, find_maximum=False)
        eng.init_vector = fixed_seed_initializer(np.float64, 7)
        eng.eigenvalue_offset = -4.0
        eng.eps = 1e-12
        eng.max_iteration = 200
        val, _ = eng.run_one()
        res[comm] = float(val)
    assert abs(res["gather"] - res["footprint"]) < 1e-12, res


def test_bsr_footprint_dense_fallback(mesh):
    """A dense column footprint falls back to gather (the packed exchange
    would move >= n words)."""
    rng = np.random.default_rng(0)
    n = 1024
    nnz = 4000
    i = rng.integers(0, n, nnz)
    j = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    vals = np.concatenate([v, v])
    op = ShardedBSROperator.from_coo(rows, cols, vals, n, mesh, bm=8, bk=8, comm="footprint")
    assert op.comm == "gather"
    assert op.footprint is None
