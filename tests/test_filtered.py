"""Chebyshev filter operator + filtered Lanczos solve.

The filter is validated against the exact Chebyshev closed form on a dense
matrix (eigen-decomposed ground truth), then the end-to-end filtered solve
is checked on the chain (analytic spectrum, the flagship problem's shape)
and on a dense matrix, both ends, scalar and block engines.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from lanczos_tpu import DenseOperator, DIAOperator, filtered_lanczos
from lanczos_tpu.ops.filters import ChebyshevFilterOperator


def _chain_op(n, dtype=np.float64):
    return DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, dtype)] * 2, n)


def _chain_exact(n, k):
    return sorted(-2 * np.cos((j + 1) * np.pi / (n + 1)) for j in range(n))[:k]


def test_filter_matches_closed_form_on_dense():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((12, 12))
    a = (a + a.T) / 2
    w, q = np.linalg.eigh(a)
    op = DenseOperator(jnp.asarray(a))
    f = ChebyshevFilterOperator.from_interval(op, 9, float(w[0]) - 0.1, float(w[-1]) + 0.1, 0.3)
    x = rng.standard_normal(12)
    got = np.asarray(f.matvec(jnp.asarray(x)))
    # exact: q diag(T_p(scaled w)) q^T x
    expect = q @ (f.eval_scalar(w) * (q.T @ x))
    assert np.allclose(got, expect, rtol=1e-9, atol=1e-9)


def test_eval_scalar_is_chebyshev():
    op = DenseOperator(jnp.eye(2))
    f = ChebyshevFilterOperator.from_interval(op, 7, -1.0, 1.0, 1e-6)
    xs = np.linspace(-0.999, 0.999, 11)
    c, e = float(f.c), float(f.e)
    np.testing.assert_allclose(
        f.eval_scalar(xs), np.cos(7 * np.arccos((xs - c) / e)), rtol=1e-10, atol=1e-12
    )
    # outside the window the filter grows in magnitude; for ODD degree the
    # bottom band maps to -cosh (why filtered_lanczos coerces degree even)
    assert f.eval_scalar(np.array([-1.0 - 1e-3]))[0] < -1.0
    f2 = ChebyshevFilterOperator.from_interval(op, 8, -1.0, 1.0, 1e-6)
    assert f2.eval_scalar(np.array([-1.0 - 1e-3]))[0] > 1.0


def test_from_interval_validation():
    op = DenseOperator(jnp.eye(3))
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 8, 1.0, -1.0, 0.1)
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 8, -1.0, 1.0, 5.0)
    with pytest.raises(ValueError):
        ChebyshevFilterOperator.from_interval(op, 1, -1.0, 1.0, 0.1)


def test_filtered_chain_bottom():
    n = 4096
    vals, vecs, info = filtered_lanczos(_chain_op(n), num_eigs=3, degree=120, mu=1e-4)
    exact = _chain_exact(n, 3)
    assert np.all(np.abs(np.asarray(vals) - exact) < 2e-4)
    assert np.all(np.diff(vals) >= 0)  # ascending (engine order, minimizing)
    assert max(info["residuals"]) < 2e-2  # sqrt(mu)-scale residuals
    # the whole point: tiny basis, few iterations
    assert sum(info["iteration_counts"]) < 500
    # vectors are orthonormal
    V = np.asarray(vecs)
    np.testing.assert_allclose(V @ V.T, np.eye(3), atol=1e-6)


def test_filtered_chain_top_descending():
    n = 2048
    vals, _, _ = filtered_lanczos(_chain_op(n), num_eigs=2, find_maximum=True,
                                  degree=120, mu=1e-4)
    exact_top = sorted(-2 * np.cos((j + 1) * np.pi / (n + 1)) for j in range(n))[-2:]
    assert abs(vals[0] - exact_top[-1]) < 2e-4
    assert vals[0] >= vals[1]  # best (largest) first, engine convention


def test_filtered_dense_distinct_pair():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((300, 300)).astype(np.float64)
    a = (a + a.T) / 2
    w = np.linalg.eigvalsh(a)
    op = DenseOperator(jnp.asarray(a))
    # mu must COVER the wanted spread: w0 and w1 are distinct (~0.34 apart),
    # so the band is sized to contain both, and the error budget is ~mu.
    mu = 1.5 * (w[1] - w[0])
    vals, _, info = filtered_lanczos(op, num_eigs=2, degree=80, mu=mu)
    assert abs(vals[0] - w[0]) < mu
    assert abs(vals[1] - w[1]) < mu
    # target-side bound is a tight pre-pass estimate (from inside), far side
    # a safe Gershgorin bound
    lo, hi = info["interval"]
    assert w[0] - 1e-6 <= lo <= w[0] + 1.0
    assert hi >= w[-1]


def test_filtered_band_miss_warns():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((300, 300)).astype(np.float64)
    a = (a + a.T) / 2
    w = np.linalg.eigvalsh(a)
    op = DenseOperator(jnp.asarray(a))
    # mu far smaller than the w0-w1 spacing: the second target is OUTSIDE
    # the amplified band and must be flagged, with vals[0] still exact.
    with pytest.warns(UserWarning, match="OUTSIDE the amplified mu-band"):
        vals, _, info = filtered_lanczos(op, num_eigs=2, degree=80,
                                         mu=5e-4 * (w[-1] - w[0]))
    assert abs(vals[0] - w[0]) < 1e-6
    assert info["residuals"][1] > 1.0


def test_filtered_block_engine():
    n = 4096
    def cfg(eng):
        eng.block_size = 3

    vals, _, info = filtered_lanczos(_chain_op(n), num_eigs=3, degree=120,
                                     mu=1e-4, configure=cfg)
    exact = _chain_exact(n, 3)
    assert np.all(np.abs(np.asarray(vals) - exact) < 2e-4)
    assert info["matvecs"] == sum(info["iteration_counts"]) * 120 * 3


@pytest.mark.parametrize("with_diag0", [True, False], ids=["diag0", "no_diag0"])
def test_filter_scan_matches_f64_recurrence(with_diag0):
    """The lax.scan filter apply in f32 against the float64 NumPy three-term
    recurrence T_{k+1} = 2 ((A - c)/e) T_k - T_{k-1}, on a banded operator
    with a 0-diagonal and on one without.  Tolerance: p^2 f32 eps of the
    output scale, the standard rounding growth of a degree-p Chebyshev
    recurrence on [-1, 1]."""
    n = 2200
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n - 1).astype(np.float32) * 0.3
    up = np.r_[v, 0].astype(np.float32)
    dn = np.r_[0, v].astype(np.float32)
    d0 = rng.standard_normal(n).astype(np.float32) * 0.1
    x = rng.standard_normal(n).astype(np.float32)
    offs, diags = ((1, -1, 0), [up, dn, d0]) if with_diag0 else ((1, -1), [up, dn])
    op = DIAOperator.from_diagonals(offs, diags, n)
    a = np.diag(v.astype(np.float64), 1) + np.diag(v.astype(np.float64), -1)
    if with_diag0:
        a += np.diag(d0.astype(np.float64))
    x64 = x.astype(np.float64)

    for degree in (2, 8, 9, 37):
        filt = ChebyshevFilterOperator.from_interval(op, degree, -2.0, 2.0, 1e-2)
        c, e = float(filt.c), float(filt.e)
        t_prev, t_cur = x64, (a @ x64 - c * x64) / e
        for _ in range(degree - 1):
            t_prev, t_cur = t_cur, 2.0 * (a @ t_cur - c * t_cur) / e - t_prev
        got = np.asarray(filt.matvec(jnp.asarray(x)), np.float64)
        scale = np.max(np.abs(t_cur))
        assert scale > 0
        err = np.max(np.abs(got - t_cur)) / scale
        assert err < degree ** 2 * np.finfo(np.float32).eps, (offs, degree, err)


def test_filtered_guard_oversampling():
    """guard=g runs the B-space solve with num_eigs+g pairs but returns the
    best num_eigs after the final Rayleigh-Ritz.  The last-converged pair
    of a deflation run is the noisiest (measured on chip: n=2^16 3rd-pair
    error 5e-10..7.6e-6 at guard=0 vs <=1.4e-8 at guard=1, same iteration
    counts) — here just lock the contract: shapes, ordering, accuracy no
    worse than the guard-free tail bar, band warning keyed to the best
    num_eigs only."""
    n = 4096
    vals, vecs, info = filtered_lanczos(
        _chain_op(n), num_eigs=3, degree=120, mu=1e-4, guard=2)
    exact = _chain_exact(n, 3)
    assert len(vals) == 3 and np.asarray(vecs).shape == (3, n)
    assert len(info["residuals"]) == 3
    assert np.all(np.diff(vals) >= 0)
    assert np.all(np.abs(np.asarray(vals) - exact) < 2e-4)
    V = np.asarray(vecs)
    np.testing.assert_allclose(V @ V.T, np.eye(3), atol=1e-6)


def test_filtered_stops_when_full_by_default():
    """filtered_lanczos sets stop_when_full on its B-space engine: the
    confirming nothing_added round is skipped because the A-space
    Rayleigh-Ritz + residuals + band check are this solve's independent
    verification (one fewer budget-capped round).  On a
    distinct-at-B-resolution spectrum
    the whole solve is ONE deflation round."""
    n = 2048
    vals, _vecs, info = filtered_lanczos(
        _chain_op(n), num_eigs=3, degree=120, mu=1e-4, lo=-2.0, hi=2.0)
    exact = _chain_exact(n, 3)
    assert np.all(np.abs(np.asarray(vals) - exact) < 2e-4)
    assert len(info["iteration_counts"]) == 1

    # opting out via configure restores reference deflation semantics
    def cfg(eng):
        eng.stop_when_full = False

    vals2, _v2, info2 = filtered_lanczos(
        _chain_op(n), num_eigs=3, degree=120, mu=1e-4, lo=-2.0, hi=2.0,
        configure=cfg)
    assert np.all(np.abs(np.asarray(vals2) - exact) < 2e-4)
    assert len(info2["iteration_counts"]) > 1


def test_filter_matvec_df_matches_f64_truth():
    """ChebyshevFilterOperator.matvec_df: df64 3-term recurrence lands at
    the df floor (~1e-13) where the f32 scan sits at ~1e-6 — the precision
    gap that makes precise=True possible."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    n = 256
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    f = ChebyshevFilterOperator.from_interval(op, 40, -2.0, 2.0, 1e-2)
    A = sp.diags([np.full(n - 1, -1.0)] * 2, [-1, 1]).toarray()
    Y = (A - float(f.c) * np.eye(n)) / float(f.e)
    Tm2, Tm1 = np.eye(n), Y.copy()
    for _ in range(f.degree - 1):
        Tm2, Tm1 = Tm1, 2 * Y @ Tm1 - Tm2
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    truth = Tm1 @ x.astype(np.float64)
    hi, lo = f.matvec_df(jnp.asarray(x), jnp.zeros(n, jnp.float32))
    out = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 1e-11


def test_filter_invert_value_roundtrip():
    """invert_value is the stable analytic inverse of eval_scalar on the
    amplified side (both window orientations); damped-bulk values (<=1)
    return NaN."""
    n = 512
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    lams = -2 * np.cos(np.arange(1, 6) * np.pi / (n + 1))
    f = ChebyshevFilterOperator.from_interval(op, 40, -2.0, 2.0, 1e-2)
    np.testing.assert_allclose(
        f.invert_value(f.eval_scalar(lams)), lams, atol=1e-14)
    ftop = ChebyshevFilterOperator.from_interval(
        op, 40, -2.0, 2.0, 1e-2, find_maximum=True)
    tops = -2 * np.cos((n - np.arange(3)) * np.pi / (n + 1))
    np.testing.assert_allclose(
        ftop.invert_value(ftop.eval_scalar(tops)), tops, atol=1e-14)
    assert np.isnan(f.invert_value(0.5))


def test_filtered_precise_reference_grade_values():
    """precise=True, fully automatic (scout pass -> mu/degree -> df64
    B-solve -> analytic inverse map): eigenvalues at <=1e-12 — the
    reference's eps=1e-12 head-to-head bar — from a bounded basis at
    filter cost (the inverse map ATTENUATES B-space error by 1/T_p')."""
    n = 1000
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    vals, vecs, info = filtered_lanczos(
        op, num_eigs=3, lo=-2.0, hi=2.0, precise=True)
    exact = _chain_exact(n, 3)
    assert np.max(np.abs(np.asarray(vals) - exact)) < 1e-12
    assert "rr_values" in info
    # vectors stay RR-grade (f32 subspace) and orthonormal
    V = np.asarray(vecs)
    np.testing.assert_allclose(V @ V.T, np.eye(3), atol=1e-5)


def test_filtered_degree_overflow_guard():
    """An explicit degree whose amplification would overflow f32
    (cosh(d*theta) > e^60) is clipped with a warning instead of letting
    the B matvec go inf."""
    n = 512
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    with pytest.warns(UserWarning, match="beyond f32 range once squared"):
        vals, _v, info = filtered_lanczos(
            op, num_eigs=1, degree=2000, mu=0.04, lo=-2.0, hi=2.0)
    assert info["filter_degree"] * np.arccosh(1 + 2 * 0.04 / (4 - 0.04)) <= 41
    assert abs(vals[0] - _chain_exact(n, 1)[0]) < 0.04


def test_filtered_interior_sigma():
    """sigma= targets INTERIOR eigenvalues via the squared transform
    (ShiftSquaredOperator) — no linear solves, unlike eigsh(sigma=...)
    shift-invert.  Coarse mode: rough locations only (error ~ mu2/(2|λ-σ|)
    — the squared transform halves the achievable digits; precise= is the
    production interior mode).  precise mode: inverse-map values at
    <=1e-11 with sigma-symmetric merged pairs split by the final A-space
    RR."""
    n = 1000
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    allv = np.sort(-2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
    sigma = 0.7321
    near = allv[np.argsort(np.abs(allv - sigma))[:4]]

    vals, vecs, info = filtered_lanczos(
        op, num_eigs=4, lo=-2.0, hi=2.0, sigma=sigma)
    assert info["sigma"] == sigma
    # nearest-sigma-first ordering
    d = np.abs(np.asarray(vals) - sigma)
    assert np.all(np.diff(d) >= -1e-12)
    assert np.max(np.abs(np.sort(vals) - np.sort(near))) < 2e-2

    pvals, pvecs, pinfo = filtered_lanczos(
        op, num_eigs=4, lo=-2.0, hi=2.0, sigma=sigma, precise=True)
    assert np.max(np.abs(np.sort(pvals) - np.sort(near))) < 1e-11
    V = np.asarray(pvecs)
    np.testing.assert_allclose(V @ V.T, np.eye(4), atol=1e-4)

    with pytest.raises(ValueError):
        filtered_lanczos(op, num_eigs=1, sigma=0.0, find_maximum=True)


def test_filtered_precise_degenerate_ring_copies():
    """The missed-copy probe: a single Krylov start cannot see the second
    copy of a degenerate eigenvalue, and the residual gate cannot either
    (the wrong answer {-2, -1.984, -1.937} is three perfectly converged
    eigenpairs).  The deflated band-weight probe detects the missed copy
    (its inverse-mapped A-value beats the worst returned one) and buys the
    discovery round — reference deflation semantics (lambda_lanczos.hpp:
    330-366, the degenerate ring test :519) restored at probe cost.
    Ring-50: 3 lowest WITH multiplicity are {-2, -1.984, -1.984}."""
    n = 50
    rows = np.concatenate([np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n])
    from lanczos_tpu import COOOperator

    op = COOOperator.from_arrays(rows, cols, np.full(2 * n, -1.0, np.float32), n)
    allv = np.sort(-2 * np.cos(2 * np.pi * np.arange(n) / n))
    for _ in range(2):  # fresh-entropy robustness
        vals, _vecs, info = filtered_lanczos(
            op, num_eigs=3, lo=-2.0, hi=2.0, precise=True)
        assert np.max(np.abs(np.sort(vals) - allv[:3])) < 1e-11
        assert len(info["iteration_counts"]) >= 2  # the discovery round ran


def test_filtered_precise_dense_zoo():
    """precise=True across unstructured spectra, FULLY automatic (no
    bounds, no mu, no degree): dense random Hermitian at both ends and a
    1e6-scaled copy (scale invariance of the window machinery).  Errors at
    the reference's 1e-12 grade (measured 1e-13 abs at |lambda|~17,
    ~1e-15 rel on the scaled copy)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((300, 300))
    a = ((a + a.T) / 2).astype(np.float32)
    truth = np.linalg.eigvalsh(np.asarray(a, np.float64))
    op = DenseOperator(np.asarray(a), 300)

    vals, _v, _i = filtered_lanczos(op, num_eigs=3, precise=True)
    assert np.max(np.abs(np.sort(vals) - truth[:3])) < 5e-12

    vals_t, _vt, _it = filtered_lanczos(op, num_eigs=2, find_maximum=True, precise=True)
    assert np.max(np.abs(np.sort(vals_t)[::-1] - truth[::-1][:2])) < 5e-12

    b = (a * 1e6).astype(np.float32)
    opb = DenseOperator(np.asarray(b), 300)
    truthb = np.linalg.eigvalsh(np.asarray(b, np.float64))
    vals_s, _vs, _is = filtered_lanczos(opb, num_eigs=2, precise=True)
    rel = np.abs(np.sort(vals_s) - truthb[:2]) / np.abs(truthb[:2])
    assert np.max(rel) < 5e-12


def test_filtered_precise_complex_hermitian_split():
    """precise=True through the real split embedding (ops/hermitian_split):
    complex Hermitian eigenvalues at f64 grade from f32 storage.  The
    embedding doubles every eigenvalue; the missed-copy probe discovers
    the second copy of each pair (2 deflation rounds) and the RR span
    returns both.  Truth is the STORED (f32-rounded) matrix's spectrum —
    the f64 matrix differs at ~1e-7 eigenvalue level by representation."""
    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator

    rng = np.random.default_rng(9)
    H = rng.standard_normal((120, 120)) + 1j * rng.standard_normal((120, 120))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    truth = np.linalg.eigvalsh((H32 + H32.conj().T) / 2)
    op = HermitianSplitOperator(DenseOperator(Hr, 120), DenseOperator(Hi, 120))
    vals, _vecs, info = filtered_lanczos(op, num_eigs=4, precise=True)
    assert np.abs(np.sort(vals) - np.repeat(truth[:2], 2)).max() < 5e-12
    # round count is entropy-dependent: noise-seeded copies sometimes all
    # converge within round 1 (RR span catches them); otherwise the probe
    # buys the discovery round — either way the VALUES are the contract
    assert len(info["iteration_counts"]) >= 1


def test_filter_inverse_map_property():
    """Property test: invert_value(eval_scalar(lam)) == lam for random
    windows/degrees/orientations on the amplified side, and eval_scalar
    round-trips stay monotone toward the target edge (the ordering the
    manager and the inverse map both rely on)."""
    rng = np.random.default_rng(123)
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(64, -1.0, np.float32)] * 2, 64)
    for _ in range(25):
        lo = float(rng.uniform(-5.0, 0.0))
        hi = float(lo + rng.uniform(0.5, 6.0))
        mu = float(rng.uniform(1e-4, 0.2) * (hi - lo))
        deg = int(rng.integers(2, 40)) * 2
        fmax = bool(rng.integers(0, 2))
        f = ChebyshevFilterOperator.from_interval(
            op, deg, lo, hi, mu, find_maximum=fmax)
        edge = hi if fmax else lo
        side = -1.0 if not fmax else 1.0
        lams = edge + side * mu * rng.uniform(0.0, 1.0, size=8)
        bs = f.eval_scalar(lams)
        back = f.invert_value(bs)
        ok = bs > 1.0
        assert np.all(np.abs(back[ok] - lams[ok]) < 1e-9 * max(1.0, abs(edge)))
        # deeper into the band (farther past the window edge) => larger b
        order = np.argsort(side * (lams - edge))
        assert np.all(np.diff(bs[order]) >= -1e-9)


def test_structured_warning_categories():
    """Library warnings carry diagnostics.* categories so callers filter by
    CLASS, not message regex (VERDICT r4 item 9).  The band-miss and
    budget-exhausted warnings are the two the internal suppression sites
    rely on."""
    import warnings

    from lanczos_tpu import (
        BandCoverageWarning, BudgetExhaustedWarning, LanczosWarning,
        LambdaLanczos,
    )
    from lanczos_tpu import DenseOperator as _D

    # band-miss: num_eigs far beyond a narrow band -> BandCoverageWarning
    n = 64
    diag = np.linspace(0.0, 1.0, n).astype(np.float64)
    A = np.diag(diag)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        filtered_lanczos(_D(jnp.asarray(A), n), num_eigs=6, mu=1e-4,
                         lo=0.0, hi=1.0, degree=64)
    bands = [w for w in rec if issubclass(w.category, BandCoverageWarning)]
    assert bands, [str(w.category) for w in rec]
    assert all(issubclass(w.category, LanczosWarning) for w in rec), (
        [str(w.category) for w in rec])

    # budget-exhausted: tiny budget on a hard problem -> BudgetExhaustedWarning
    rng = np.random.default_rng(0)
    B = rng.standard_normal((96, 96))
    B = (B + B.T) / 2
    eng = LambdaLanczos(jnp.asarray(B), num_eigs=2)
    eng.max_iteration = 6
    eng.max_restarts = 1
    eng.eps = 1e-14
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng.run()
    assert any(issubclass(w.category, BudgetExhaustedWarning) for w in rec), (
        [str(w.category) for w in rec])
    # and filtering by class silences it
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warnings.filterwarnings("ignore", category=BudgetExhaustedWarning)
        eng.run()
    assert not [w for w in rec if issubclass(w.category, BudgetExhaustedWarning)]


def test_precise_refined_vectors_meet_reference_bar():
    """filtered_lanczos(precise=True) now returns df-grade eigenVECTORS
    (VERDICT r4 item 4): df64 filter-subspace iteration pushes the f32 RR
    vectors to A-space residuals at the df floor, meeting the reference's
    elementwise eigenvector tolerance |lambda|*eps*10
    (test/lambda_lanczos_test.cpp:156-159) on f32 storage."""
    n = 1000
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    vals, vecs, info = filtered_lanczos(op, 3, lo=-2.0, hi=2.0, precise=True)
    A = np.zeros((n, n))
    idx = np.arange(n - 1)
    A[idx, idx + 1] = A[idx + 1, idx] = -1.0
    vecs = np.asarray(vecs)
    assert vecs.dtype == np.float64  # refined vectors come back f64
    assert info["refine_sweeps"] >= 1
    for i in range(3):
        k = i + 1
        exact_val = -2 * np.cos(k * np.pi / (n + 1))
        exact_vec = np.sin(k * np.pi * np.arange(1, n + 1) / (n + 1))
        exact_vec /= np.linalg.norm(exact_vec)
        r = np.linalg.norm(A @ vecs[i] - vals[i] * vecs[i])
        assert r < 1e-10, (i, r)
        # reference elementwise bar, modulo sign gauge
        g = np.sign(np.dot(exact_vec, vecs[i]))
        assert np.abs(vecs[i] * g - exact_vec).max() < abs(exact_val) * 1e-12 * 10, i
    # and refinement can be disabled: f32 vectors, f32-grade residuals
    _v0, vecs0, i0 = filtered_lanczos(op, 3, lo=-2.0, hi=2.0, precise=True,
                                      refine_vectors=False)
    assert np.asarray(vecs0).dtype == np.float32
    assert "refine_sweeps" not in i0


def test_refined_vectors_degenerate_ring():
    """Refinement through an exactly degenerate pair (ring-50): block
    orthonormalization keeps both copies; residuals reach the df floor."""
    n = 50
    ring = np.zeros((n, n), np.float32)
    for i in range(n):
        ring[i, (i + 1) % n] = ring[(i + 1) % n, i] = -1.0
    vals, vecs, info = filtered_lanczos(DenseOperator(jnp.asarray(ring), n), 3,
                                        precise=True)
    A = ring.astype(np.float64)
    vecs = np.asarray(vecs)
    for i in range(3):
        r = np.linalg.norm(A @ vecs[i] - vals[i] * vecs[i])
        assert r < 1e-10, (i, r)
    exact = np.sort(-2 * np.cos(2 * np.pi * np.arange(n) / n))[:3]
    assert max(abs(vals[i] - exact[i]) for i in range(3)) < 1e-11
    # the two degenerate copies stay orthonormal through the refinement
    G = vecs @ vecs.T
    assert np.abs(G - np.eye(3)).max() < 1e-10


def test_refined_vectors_interior():
    """Interior (sigma=) refinement: band tightened around the known
    values so the next level is excluded; residuals at the df floor."""
    n = 2000
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    sig = -0.987
    vals, vecs, info = filtered_lanczos(op, 3, sigma=sig, precise=True)
    A = np.zeros((n, n))
    idx = np.arange(n - 1)
    A[idx, idx + 1] = A[idx + 1, idx] = -1.0
    vecs = np.asarray(vecs)
    for i in range(3):
        r = np.linalg.norm(A @ vecs[i] - vals[i] * vecs[i])
        assert r < 1e-9, (i, r)
    ex = np.sort(-2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
    want = ex[np.argsort(np.abs(ex - sig))[:3]]
    assert max(abs(np.sort(vals) - np.sort(want))) < 1e-11
