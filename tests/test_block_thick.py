"""Fused block thick-restart engine (solvers/block_thick.py).

The scenarios mirror the reference test zoo's degeneracy coverage
(lambda_lanczos_test.cpp:490-536 ring graph; :442-488 multiroot) plus the
engine-specific contracts: thick restarts under a capped buffer, rank
breakdown on full-space builds, the scalar-tail delegation, and the
arrowhead coupling across restart boundaries.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lanczos_tpu import LambdaLanczos
from lanczos_tpu.ops.operators import DIAOperator


def _ring(n):
    a = np.zeros((n, n))
    i = np.arange(n - 1)
    a[i, i + 1] = a[i + 1, i] = 1.0
    a[0, n - 1] = a[n - 1, 0] = 1.0
    return a


def _engine(op_or_mat, num_eigs, block, **kw):
    eng = LambdaLanczos(op_or_mat, find_maximum=kw.pop("find_maximum", False), num_eigs=num_eigs)
    eng.block_size = block
    eng.restart_policy = "thick"
    for k, v in kw.items():
        setattr(eng, k, v)
    # Deterministic but per-call-distinct init (advancing generator): keeps
    # the degeneracy-resolving distinct-rows property without the
    # convergence-luck spread of fully fresh entropy.
    rng = np.random.default_rng(2024)

    def _init(n_):
        v = rng.uniform(-1, 1, n_)
        if np.dtype(eng.dtype).kind == "c":
            v = v + 1j * rng.uniform(-1, 1, n_)
        return jnp.asarray(v, eng.dtype)

    eng.init_vector = _init
    return eng


def test_ring_degenerate_pairs_restarted():
    """n=50 ring: doubly degenerate spectrum, buffer capped well below n so
    thick restarts are exercised (reference degeneracy test,
    lambda_lanczos_test.cpp:490-536)."""
    n = 50
    a = _ring(n)
    exact = np.sort(np.linalg.eigvalsh(a))
    eng = _engine(a, 5, 3, max_iteration=24, eps=1e-12)
    vals, vecs = eng.run()
    assert np.max(np.abs(np.sort(vals) - exact[:5])) < 1e-10
    assert max(eng.residuals(vals, vecs)) < 1e-6
    # internal restarts: the per-round step count must exceed one cycle
    assert len(eng.iteration_counts) >= 1


def test_exact_triple_multiplicity_one_round():
    """A multiplicity-3 eigenvalue is captured by a width-3 block in ONE
    deflation round (+1 confirmation round) — the motivating case; the
    scalar engines need >= 3 rounds of random-restart leakage."""
    n = 64
    dvals = np.concatenate([[1.0, 1.0, 1.0], np.linspace(2, 10, n - 3)])
    q, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(n, n)))
    a = (q * dvals) @ q.T
    eng = _engine(a, 3, 3, max_iteration=20, eps=1e-12)
    vals, vecs = eng.run()
    assert np.allclose(vals, 1.0, atol=1e-9)
    assert max(eng.residuals(vals, vecs)) < 1e-8
    assert len(eng.iteration_counts) <= 2
    # the 3 eigenvectors span the eigenspace: pairwise orthonormal
    g = np.asarray(vecs) @ np.asarray(vecs).T
    assert np.allclose(g, np.eye(3), atol=1e-8)


def test_complex_hermitian_find_maximum():
    rng = np.random.default_rng(42)
    n = 40
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h = (h + h.conj().T) / 2
    exact = np.sort(np.linalg.eigvalsh(h))[::-1]
    eng = _engine(h, 4, 2, find_maximum=True, max_iteration=16, eps=1e-12)
    vals, vecs = eng.run()
    assert np.max(np.abs(np.sort(vals)[::-1] - exact[:4])) < 1e-9
    assert max(eng.residuals(vals, vecs)) < 1e-7


def test_full_space_breakdown_and_scalar_tail():
    """num_eigs=n: later rounds have less room than the block width and must
    delegate to the scalar thick engine instead of emitting spurious zero
    Ritz values from dead block rows."""
    d = np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    eng = _engine(d, 6, 2, eps=1e-13)
    vals, vecs = eng.run()
    assert np.allclose(np.sort(vals), np.arange(1.0, 7.0), atol=1e-10)


def test_f32_dia_chain_cluster():
    """f32 + DIA operator (flagship shape, small n): the df64 pair dots keep
    the cluster eigenvalues well under the f32 dot floor."""
    n = 1024
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _engine(op, 3, 3, max_iteration=128, eps=1e-7, max_restarts=12)
    eng.eigenvalue_offset = -4.0
    vals, _ = eng.run()
    errs = [abs(vals[i] - exact[i]) for i in range(3)]
    assert max(errs) < 2e-6


def test_matches_scalar_thick_on_separated_spectrum():
    """Block and scalar thick engines agree on a generic (non-degenerate)
    spectrum — the band arrowhead reduces to the scalar arrowhead."""
    n = 200
    rng = np.random.default_rng(3)
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    exact = np.sort(np.linalg.eigvalsh(a))
    eng_b = _engine(a, 4, 2, max_iteration=48, eps=1e-11)
    vals_b, vecs_b = eng_b.run()
    eng_s = _engine(a, 4, 1, max_iteration=48, eps=1e-11)
    vals_s, _ = eng_s.run()
    assert np.max(np.abs(np.sort(vals_b) - exact[:4])) < 1e-8
    assert np.max(np.abs(np.sort(vals_s) - exact[:4])) < 1e-8
    assert max(eng_b.residuals(vals_b, vecs_b)) < 1e-7


def test_confined_start_rows_escape_invariant_subspace():
    """Start rows confined to small invariant coordinate subspaces of a
    diagonal matrix: their Krylov directions exhaust after a few steps.
    The build must still reach the extremal eigenvalues OUTSIDE those
    subspaces — via reorthogonalization noise leaking into fresh space
    (the classical self-healing) or, below the breakdown threshold, the
    explicit repair path."""
    n = 40
    a = np.diag(np.arange(1.0, n + 1.0))
    eng = _engine(a, 2, 2, find_maximum=True, max_iteration=24, eps=1e-12)
    calls = {"k": 0}
    rng = np.random.default_rng(5)

    def init(n_):
        calls["k"] += 1
        v = rng.uniform(-1, 1, n_)
        if calls["k"] == 1:
            v[4:] = 0.0  # row 0: span(e_1..e_4) — exhausts in 2 block steps
        elif calls["k"] == 2:
            v[10:] = 0.0  # row 1: span(e_1..e_10)
        return jnp.asarray(v)

    eng.init_vector = init
    vals, vecs = eng.run()
    assert np.allclose(np.sort(vals)[::-1], [40.0, 39.0], atol=1e-9), vals
    assert max(eng.residuals(vals, vecs)) < 1e-8


def test_mgs_block_marks_dead_rows():
    """_mgs_block: a rank-deficient block gets exact zero rows and zero R
    diagonal (the host's collapse signal), never arbitrary fill-in."""
    from lanczos_tpu.solvers.block_thick import _mgs_block

    rng = np.random.default_rng(0)
    v = rng.normal(size=16)
    w = jnp.asarray(np.stack([v, 2.0 * v, rng.normal(size=16)]))
    u, r, _r_lo, live = _mgs_block(w, 1e-12)
    live = np.asarray(live)
    assert live.tolist() == [True, False, True]
    assert np.allclose(np.asarray(u)[1], 0.0)
    r = np.asarray(r)
    assert r[1, 1] == 0.0
    assert abs(r[0, 1] - 2.0 * np.linalg.norm(v)) < 1e-10  # coupling kept
    # reconstruction: W = R^T U on the live rows
    assert np.allclose(np.asarray(r).T @ np.asarray(u), np.asarray(w), atol=1e-10)
    g = np.asarray(u) @ np.asarray(u).T
    assert np.allclose(g[np.ix_([0, 2], [0, 2])], np.eye(2), atol=1e-12)


def test_mgs_block_precise_r_entries():
    """precise=True: the R entries (hi+lo) must match the f64 reference to
    ~1e-7 relative at large n, where plain f32 reductions drift by ~n*eps
    (this biased every Ritz value by 2.2e-4 at n=262144 before the fix)."""
    from lanczos_tpu.solvers.block_thick import _mgs_block

    n = 1 << 20
    rng = np.random.default_rng(5)
    w64 = rng.normal(size=(2, n))
    w = jnp.asarray(w64, jnp.float32)
    _u, r, r_lo, live = _mgs_block(w, 1e-12, precise=True)
    assert bool(np.all(np.asarray(live)))
    r64 = np.asarray(r, np.float64) + np.asarray(r_lo, np.float64)
    w32 = np.asarray(w, np.float64)  # exact values of the rounded inputs
    want00 = np.linalg.norm(w32[0])
    assert abs(r64[0, 0] - want00) / want00 < 1e-6
    u0 = w32[0] / want00
    want01 = np.dot(u0, w32[1])
    assert abs(r64[0, 1] - want01) < 1e-6 * abs(want01)
    w1o = w32[1] - want01 * u0
    assert abs(r64[1, 1] - np.linalg.norm(w1o)) / np.linalg.norm(w1o) < 1e-5


def test_repair_candidates_revives_dead_rows():
    """_repair_candidates: dead candidate rows are replaced by fresh
    directions orthonormal to the deflation slot, the whole basis, and the
    surviving rows; live rows are untouched."""
    from lanczos_tpu.solvers.block_thick import _repair_candidates

    rng = np.random.default_rng(1)
    n, b = 24, 2
    basis_rows, _ = np.linalg.qr(rng.normal(size=(n, 4)))
    # layout: basis block [0, 2), candidate block [2, 4) with row 2 live and
    # row 3 dead (zero); one deflated vector in the slot.
    u_buf = jnp.zeros((8, n))
    u_buf = u_buf.at[0].set(basis_rows[:, 0])
    u_buf = u_buf.at[1].set(basis_rows[:, 1])
    u_buf = u_buf.at[2].set(basis_rows[:, 2])
    # row 3 stays zero = dead candidate row
    defl = jnp.asarray(basis_rows[:, 3][None])
    mask = jnp.ones((1,))
    fresh = jnp.asarray(rng.uniform(-1, 1, (b, n)))
    dead = jnp.asarray([False, True])
    block, revived = _repair_candidates(u_buf, defl, mask, fresh, dead, 4)
    revived = np.asarray(revived)
    assert revived[1] and not revived[0]
    blk = np.asarray(block)
    assert np.allclose(blk[0], basis_rows[:, 2], atol=1e-14)  # live row untouched
    # revived row orthonormal to everything
    assert abs(np.linalg.norm(blk[1]) - 1.0) < 1e-12
    for q in [basis_rows[:, 0], basis_rows[:, 1], basis_rows[:, 2], basis_rows[:, 3], blk[0]]:
        assert abs(np.dot(q, blk[1])) < 1e-12


def test_sharded_dia_block_thick_parity():
    """Block thick restart composes with the row-sharded DIA operator on the
    8-virtual-device mesh (block matvec + chunked BCGS lower to local work +
    collectives via GSPMD) and matches the dense eigensolve."""
    from lanczos_tpu.parallel.mesh import make_mesh
    from lanczos_tpu.parallel.sharded import ShardedDIAOperator

    mesh = make_mesh()
    n = 512
    main = np.linspace(0.0, 6.0, n)
    off = np.full(n, -1.0)
    sop = ShardedDIAOperator.from_diagonals([-1, 0, 1], [off, main, off], n, mesh=mesh)
    a = np.diag(main) + np.diag(off[: n - 1], 1) + np.diag(off[: n - 1], -1)
    exact = np.sort(np.linalg.eigvalsh(a))
    eng = _engine(sop, 4, 2, max_iteration=64, eps=1e-11, max_restarts=24)
    vals, vecs = eng.run()
    assert np.abs(np.sort(vals) - exact[:4]).max() < 1e-10
    assert max(eng.residuals(vals, vecs)) < 1e-8


def test_space_exhaustion_includes_candidate_rows():
    """cap = n: the build exhausts the space mid-block; the final
    Rayleigh-Ritz must include the candidate block's live rows (excluding
    them silently returned ~res^2-level errors at eps=1e-12)."""
    n = 120
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n)
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _engine(op, 3, 3, max_iteration=n, eps=1e-12)
    eng.eigenvalue_offset = -4.0
    vals, vecs = eng.run()
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 1e-11
    assert max(eng.residuals(vals, vecs)) < 1e-9


def test_partial_collapse_repair_fires_and_recovers():
    """Force a genuine mid-build partial rank collapse: a DIAGONAL operator
    keeps confined coordinates EXACTLY zero (elementwise matvec), so a start
    row inside a tiny invariant subspace dies below the breakdown threshold
    with space remaining; the repair path must fire (spy-counted), revive it
    with a fresh direction, and the solve must reach eigenvalues OUTSIDE the
    confined subspaces.  Complex dtype also covers the device-side complex
    fresh-block draw."""
    import lanczos_tpu.solvers.block_thick as bt

    n = 48
    d = np.arange(1.0, n + 1.0)
    a = np.diag(d).astype(np.complex128)
    eng = _engine(a, 2, 2, find_maximum=True, max_iteration=24, eps=1e-10)
    calls = {"k": 0}
    rng = np.random.default_rng(6)

    def init(n_):
        calls["k"] += 1
        v = rng.uniform(-1, 1, n_) + 1j * rng.uniform(-1, 1, n_)
        if calls["k"] == 1:
            v[2:] = 0.0  # row 0: span(e_1, e_2) — exactly invariant, dies fast
        return jnp.asarray(v)

    eng.init_vector = init
    hits = {"n": 0}
    orig = bt._repair_candidates

    def spy(*args, **kw):
        hits["n"] += 1
        return orig(*args, **kw)

    bt._repair_candidates = spy
    try:
        vals, vecs = eng.run()
    finally:
        bt._repair_candidates = orig
    assert hits["n"] >= 1, "partial-collapse repair path never fired"
    assert np.allclose(np.sort(vals)[::-1], [48.0, 47.0], atol=1e-8), vals
    assert max(eng.residuals(vals, vecs)) < 1e-7


def test_space_exhaustion_partial_live_candidate():
    """cap = n with n % b != 0: exhaustion leaves a PARTIALLY live candidate
    block whose live rows must enter the terminal Rayleigh-Ritz extension."""
    n = 100  # b=3: 33 blocks = 99 rows + 1 leftover dim -> 1 live candidate row
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0)] * 2, n)
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _engine(op, 3, 3, max_iteration=n, eps=1e-12)
    eng.eigenvalue_offset = -4.0
    vals, vecs = eng.run()
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 1e-11
    assert max(eng.residuals(vals, vecs)) < 1e-9


def test_runner_and_knob_validation():
    """lanczos_run_block_thick standalone runner; thick_keep < 1 rejects."""
    from lanczos_tpu.solvers.block_thick import lanczos_run_block_thick
    from lanczos_tpu.solvers.lanczos import LanczosConfig
    from lanczos_tpu.ops.operators import DenseOperator
    from lanczos_tpu.utils.random import fixed_seed_initializer

    n = 40
    rng = np.random.default_rng(12)
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    exact = np.sort(np.linalg.eigvalsh(a))
    cfg = LanczosConfig(matrix_size=n, num_eigs=2, max_iteration=20, eps=1e-11)
    res = lanczos_run_block_thick(
        DenseOperator(jnp.asarray(a), n), cfg, fixed_seed_initializer(np.float64, seed=4), np.float64, 2
    )
    assert np.max(np.abs(np.sort(res.eigenvalues) - exact[:2])) < 1e-9

    eng = _engine(a, 2, 2, max_iteration=20, eps=1e-11)
    eng.thick_keep = 0
    with pytest.raises(ValueError):
        eng.run()


def test_f32_space_exhaustion_precise_extension():
    """f32 + precise: the terminal candidate extension computes the df64
    candidate diagonal block (the precise branch of the extension path)."""
    n = 64  # b=3: 63 rows + 1 leftover dim
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(3)]
    eng = _engine(op, 3, 3, max_iteration=n, eps=1e-7)
    eng.eigenvalue_offset = -4.0
    vals, _ = eng.run()
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 1e-5


def test_checkpointed_block_thick(tmp_path):
    """CheckpointedRun composes with the block-thick engine through the
    shared dispatch point (engine selection + deflation-round checkpoints)."""
    from lanczos_tpu.utils.checkpoint import CheckpointedRun

    n = 48
    rng = np.random.default_rng(9)
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    exact = np.sort(np.linalg.eigvalsh(a))
    eng = _engine(a, 3, 3, max_iteration=24, eps=1e-11)
    path = str(tmp_path / "bt.npz")
    vals1, _ = CheckpointedRun(eng, path).run()
    # resume from the saved state: must return the same spectrum
    eng2 = _engine(a, 3, 3, max_iteration=24, eps=1e-11)
    vals2, _ = CheckpointedRun(eng2, path).run()
    assert np.max(np.abs(np.sort(vals1) - exact[:3])) < 1e-9
    np.testing.assert_allclose(np.sort(vals1), np.sort(vals2), atol=1e-9)


def test_fixed_seed_identical_rows_repaired():
    """A fixed-seed init returns IDENTICAL block rows; the start-block repair
    must replace the dead copies instead of breaking down at step 0."""
    n = 30
    a = np.diag(np.linspace(1, 4, n))
    eng = _engine(a, 2, 2, max_iteration=16, eps=1e-12)
    v = np.random.default_rng(11).normal(size=n)
    eng.init_vector = lambda n_: jnp.asarray(v)
    vals, vecs = eng.run()
    assert np.allclose(np.sort(vals), np.linspace(1, 4, n)[:2], atol=1e-9)


def test_budget_stall_distinct_targets_hint():
    """Engine-economics rule encoded: when a
    block>1 round budget-stalls while the best Ritz values come out DISTINCT
    (the characterized 'wrong tool' case — block thick needs block_size x
    the row budget for equal convergence depth on distinct targets), the
    budget-limited warning must point at block_size=1."""
    n = 96
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0), np.full(n, -1.0)], n
    )
    # distinct chain spectrum, starved budget: 12-row basis, depth 12/3=4
    eng = _engine(op, 3, 3, max_iteration=12, max_restarts=2, eps=1e-14)
    eng.eigenvalue_offset = -4.0
    with pytest.warns(UserWarning, match="block_size=1") as rec:
        eng.run()
    assert any("DISTINCT" in str(w.message) for w in rec)

    # control: a block run that CONVERGES (degenerate triple, ample budget)
    # must emit no budget warning and no hint at all
    import warnings as _w

    nd = 32
    a = np.diag(np.concatenate([np.full(3, 1.0), np.linspace(2.0, 5.0, nd - 3)]))
    eng2 = _engine(a, 3, 3, max_iteration=24, eps=1e-11)
    with _w.catch_warnings():
        _w.simplefilter("error", UserWarning)
        vals, _ = eng2.run()
    np.testing.assert_allclose(np.sort(vals), 1.0, atol=1e-9)


def test_pv_fixed_seed_identical_rows_repaired():
    """pv block engine: identical init rows trigger the START-block repair
    on the df path (fresh random directions, zero coupling, lo words zeroed)
    — same contract as the f32 engine's repair, at pv accuracy."""
    n = 32
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n
    )
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
    eng = _engine(op, 2, 2, max_iteration=n, eps=1e-11)
    eng.precise_vectors = True
    eng.dtype = np.float32
    eng.eigenvalue_offset = -4.0
    v = np.random.default_rng(11).normal(size=n).astype(np.float32)
    eng.init_vector = lambda n_: jnp.asarray(v)  # both block rows identical
    vals, _ = eng.run()
    assert max(abs(vals[i] - exact[i]) for i in range(2)) < 1e-8


def test_pv_in_build_rank_collapse_repair():
    """pv block engine, exact Krylov-space exhaustion mid-build: a diagonal
    operator with few distinct eigenvalues kills candidate rows (R diagonal
    hits exact zero) before the row budget — the in-build repair must inject
    fresh directions (or close the relation) and the solve must still return
    the exact lowest eigenvalues."""
    n = 32
    # 4 distinct eigenvalues => Krylov space per start vector has dim <= 4;
    # a width-2 block exhausts the reachable space after ~4 block steps
    diag = np.repeat(np.array([1.0, 2.0, 3.0, 4.0], np.float32), n // 4)
    op = DIAOperator.from_diagonals([0], [diag], n)
    eng = _engine(op, 2, 2, max_iteration=n, eps=1e-11)
    eng.precise_vectors = True
    eng.dtype = np.float32
    vals, vecs = eng.run()
    # eigenvalue 1.0 has multiplicity n/4 = 8: the two lowest counting
    # multiplicity are BOTH 1.0 (the block engine captures two copies)
    np.testing.assert_allclose(np.sort(vals), [1.0, 1.0], atol=1e-9)
    # returned Ritz vectors are orthonormal true eigenvectors (A v = v)
    v = np.asarray(vecs, np.float64)
    np.testing.assert_allclose(v @ v.T, np.eye(2), atol=1e-6)
    av = np.asarray(diag, np.float64) * v
    np.testing.assert_allclose(av, v, atol=1e-6)
