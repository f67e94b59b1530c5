"""Tridiagonal-solver tests, mirroring the reference TRIDIAGONAL_TEST suite
(test/lambda_lanczos_test.cpp:757-801) across all backends."""

import numpy as np
import jax.numpy as jnp
import pytest

from lanczos_tpu.core import tridiagonal

BACKENDS = ["lapack", "numpy", "native"]


def _skip_if_unavailable(backend):
    if backend == "native":
        from lanczos_tpu.native import host_kernels

        if not host_kernels.available():
            pytest.skip("native extension not built")


@pytest.mark.parametrize("backend", BACKENDS)
def test_known_3x3(backend):
    # Reference TRIDIAGONAL_TEST.IMPLICIT_SHIFT_QR (lambda_lanczos_test.cpp:757-784):
    # diag {1,2,3}, offdiag {2,2} -> eigvals {-1,2,5}, known eigenvectors.
    _skip_if_unavailable(backend)
    vals, vecs = tridiagonal.eigh_tridiagonal_host([1.0, 2.0, 3.0], [2.0, 2.0], backend=backend)
    np.testing.assert_allclose(vals, [-1.0, 2.0, 5.0], atol=1e-10)
    expected = np.array([[2, -2, 1], [2, 1, -2], [1, 2, 2]], dtype=float)
    expected /= np.linalg.norm(expected, axis=1, keepdims=True)
    for i in range(3):
        sign = np.sign(vecs[i, 0])
        np.testing.assert_allclose(vecs[i] * sign, expected[i] * np.sign(expected[i, 0]), atol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_near_null_input_no_nan(backend):
    # Reference TRIDIAGONAL_TEST.NULL_EIGENVALUE_NO_ASSERTS
    # (lambda_lanczos_test.cpp:786-801): denormal-scale entries must not NaN.
    _skip_if_unavailable(backend)
    alpha = [6.82333617e-03, 3.09398208e00, 1.89919458e00, 1.28531906e-16]
    beta = [1.19582528e-01, -1.37689656e00, 6.16147405e-15]
    vals, vecs = tridiagonal.eigh_tridiagonal_host(alpha, beta, backend=backend)
    assert np.all(np.isfinite(vals))
    assert np.all(np.isfinite(vecs))


@pytest.mark.parametrize("backend", BACKENDS)
def test_eigvals_only(backend):
    _skip_if_unavailable(backend)
    (vals,) = tridiagonal.eigh_tridiagonal_host([1.0, 2.0, 3.0], [2.0, 2.0], eigvals_only=True, backend=backend)
    np.testing.assert_allclose(vals, [-1.0, 2.0, 5.0], atol=1e-10)


def test_single_element():
    vals, vecs = tridiagonal.eigh_tridiagonal_host([7.0], [])
    np.testing.assert_allclose(vals, [7.0])
    np.testing.assert_allclose(vecs, [[1.0]])


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_agree_random(backend):
    _skip_if_unavailable(backend)
    rng = np.random.default_rng(3)
    m = 37
    alpha = rng.normal(size=m)
    beta = rng.normal(size=m - 1)
    vals, vecs = tridiagonal.eigh_tridiagonal_host(alpha, beta, backend=backend)
    ref = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1))
    np.testing.assert_allclose(vals, ref, atol=1e-12)
    # residual check: T v = lambda v
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    for i in range(m):
        np.testing.assert_allclose(t @ vecs[i], vals[i] * vecs[i], atol=1e-10)


def test_device_bisection_extremal():
    rng = np.random.default_rng(5)
    m, cap = 23, 32
    alpha_np = rng.normal(size=m)
    beta_np = rng.normal(size=m - 1)
    ref = np.linalg.eigvalsh(np.diag(alpha_np) + np.diag(beta_np, 1) + np.diag(beta_np, -1))

    alpha = jnp.zeros(cap, jnp.float64).at[:m].set(alpha_np)
    beta = jnp.zeros(cap, jnp.float64).at[: m - 1].set(beta_np)

    lo = tridiagonal.extremal_eigenvalues_device(alpha, beta, m, 3, find_maximum=False)
    np.testing.assert_allclose(np.asarray(lo), ref[:3], atol=1e-11)

    hi = tridiagonal.extremal_eigenvalues_device(alpha, beta, m, 3, find_maximum=True)
    np.testing.assert_allclose(np.asarray(hi), ref[::-1][:3], atol=1e-11)


def test_device_bisection_f32():
    rng = np.random.default_rng(7)
    m, cap = 11, 16
    alpha_np = rng.normal(size=m).astype(np.float32)
    beta_np = rng.normal(size=m - 1).astype(np.float32)
    ref = np.linalg.eigvalsh(
        np.diag(alpha_np.astype(np.float64)) + np.diag(beta_np.astype(np.float64), 1) + np.diag(beta_np.astype(np.float64), -1)
    )
    alpha = jnp.zeros(cap, jnp.float32).at[:m].set(alpha_np)
    beta = jnp.zeros(cap, jnp.float32).at[: m - 1].set(beta_np)
    lo = tridiagonal.extremal_eigenvalues_device(alpha, beta, m, 2, find_maximum=False)
    np.testing.assert_allclose(np.asarray(lo), ref[:2], atol=1e-5)


def test_bisect_backend_eigenpairs():
    # Bisection eigen*pairs* (reference tridiagonal_impl.hpp:93-134): Sturm
    # eigenvalues + backward-recurrence eigenvectors through the 'bisect'
    # backend must reproduce the full decomposition on a well-separated
    # spectrum.
    rng = np.random.default_rng(11)
    m = 24
    alpha = np.linspace(0.0, 10.0, m) + 0.1 * rng.standard_normal(m)
    beta = 0.3 + 0.1 * rng.standard_normal(m - 1)
    vals, vecs = tridiagonal.eigh_tridiagonal_host(alpha, beta, backend="bisect")
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    ref = np.linalg.eigvalsh(t)
    np.testing.assert_allclose(vals, ref, atol=1e-10)
    # The inverse-iteration refinement must hold even for the localized
    # eigenvectors of this graded matrix (pure recurrence alone fails here).
    for i in range(m):
        np.testing.assert_allclose(t @ vecs[i], vals[i] * vecs[i], atol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(vecs[i]), 1.0, atol=1e-12)


def test_bisect_backend_numpy_fallback_matches_native():
    from lanczos_tpu.core.tridiagonal import _eigvec_backward_np

    rng = np.random.default_rng(12)
    m = 15
    alpha = np.sort(rng.standard_normal(m)) * 3
    beta = 0.4 * np.ones(m - 1)
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    vals = np.linalg.eigvalsh(t)
    for lam in vals[:3]:
        v = _eigvec_backward_np(alpha, beta, lam)
        np.testing.assert_allclose(t @ v, lam * v, atol=1e-7)


@pytest.mark.parametrize("rdtype", [np.float64, np.float32])
def test_device_backward_eigenvectors(rdtype):
    # Device counterpart: lax.scan backward recurrence on a static cap with a
    # dynamic active size must match the host eigenvectors up to sign.
    # Strong-coupling (extended-eigenvector) matrix: the pure recurrence is
    # accurate here; localized eigenvectors are the documented caveat shared
    # with the reference's recurrence (host paths add inverse iteration).
    rng = np.random.default_rng(13)
    m, cap = 19, 32
    alpha_np = 0.3 * rng.standard_normal(m)
    beta_np = -np.ones(m - 1)
    t = np.diag(alpha_np) + np.diag(beta_np, 1) + np.diag(beta_np, -1)
    ref_vals = np.linalg.eigvalsh(t)

    alpha = jnp.zeros(cap, rdtype).at[:m].set(alpha_np.astype(rdtype))
    beta = jnp.zeros(cap, rdtype).at[: m - 1].set(beta_np.astype(rdtype))
    lams = ref_vals[[0, 1, m - 1]]
    vecs = np.asarray(
        tridiagonal.eigenvectors_backward_device(alpha, beta, m, lams.astype(rdtype))
    )
    assert vecs.shape == (3, cap)
    atol = 1e-8 if rdtype == np.float64 else 2e-3
    for j, lam in enumerate(lams):
        v = vecs[j]
        assert np.all(v[m:] == 0)
        np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-5)
        np.testing.assert_allclose(t @ v[:m], lam * v[:m], atol=atol)


def test_device_backward_eigenvectors_size_one():
    alpha = jnp.zeros(8, jnp.float64).at[0].set(3.0)
    beta = jnp.zeros(8, jnp.float64)
    vecs = np.asarray(tridiagonal.eigenvectors_backward_device(alpha, beta, 1, np.array([3.0])))
    np.testing.assert_allclose(vecs[0], np.eye(8)[0], atol=1e-14)


def test_unconverged_counter_surface():
    # A well-behaved solve must report zero unconverged blocks through the
    # RunStats plumbing (the reference returns this count from its QR driver,
    # tridiagonal_impl.hpp:342; we accumulate it instead of dropping it).
    from lanczos_tpu.api import LambdaLanczos

    a = np.diag(np.arange(1.0, 9.0)) + 0.01
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True)
    eng.tridiag_backend = "native"
    from lanczos_tpu.native import host_kernels

    if not host_kernels.available():
        pytest.skip("native extension not built")
    eng.run()
    assert eng.stats.tridiag_unconverged == 0


@pytest.mark.parametrize("backend", ["native", "lapack", "numpy"])
@pytest.mark.parametrize("find_maximum", [False, True])
def test_extremal_eigvals_host(backend, find_maximum):
    from lanczos_tpu.core.tridiagonal import extremal_eigvals_host

    rng = np.random.default_rng(1)
    m = 30
    alpha = rng.standard_normal(m)
    beta = rng.standard_normal(m - 1)
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    full = np.linalg.eigvalsh(t)
    want = full[::-1][:4] if find_maximum else full[:4]
    got = extremal_eigvals_host(alpha, beta, 4, find_maximum, backend=backend)
    np.testing.assert_allclose(got, want, atol=1e-11)


def test_native_build_rebuilds_on_stale_so():
    """native/build.py: a source newer than the .so triggers a real g++
    rebuild (the cached path is what every other test exercises); build=False
    never compiles but returns an up-to-date library."""
    import os
    import time as _time

    from lanczos_tpu.native import build as nb
    from lanczos_tpu.native import host_kernels as hk

    built = nb.shared_object_path()
    assert built is not None and nb.shared_object_path(build=False) == built  # cached path
    # Make the source look newer than the .so -> forces the compile branch.
    now = _time.time()
    os.utime(nb._SRC, (now, now))
    path = nb.shared_object_path()
    assert path is not None and os.path.getmtime(path) >= os.path.getmtime(nb._SRC)
    assert hk.available()
    # and the rebuilt library still solves
    import numpy as np

    vals, vecs = hk.tridiagonal_eigh(np.array([2.0, 2.0]), np.array([-1.0]))
    np.testing.assert_allclose(np.sort(vals), [1.0, 3.0], atol=1e-12)


def test_native_library_keyed_on_source_hash(monkeypatch, tmp_path):
    """A library built from other source bytes is never picked up: the file
    name carries the source hash, so an edited source (or a stale library
    copied in from another machine) means a new name and a fresh build."""
    import os
    import shutil

    from lanczos_tpu.native import build as nb

    own = nb.shared_object_path()
    assert own is not None and os.path.basename(own).startswith("_host_kernels-")
    src = tmp_path / "host_kernels.cpp"
    shutil.copy(nb._SRC, src)
    with open(src, "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(nb, "_SRC", str(src))
    monkeypatch.setattr(nb, "_DIR", str(tmp_path))
    assert nb._so_path() != os.path.join(str(tmp_path), os.path.basename(own))
    shutil.copy(own, os.path.join(str(tmp_path), os.path.basename(own)))  # stale library
    assert nb.shared_object_path(build=False) is None
    rebuilt = nb.shared_object_path()
    assert rebuilt == nb._so_path() and os.path.exists(rebuilt)


def test_native_bisect_degenerate_cluster_orthonormal():
    """Degenerate/clustered spectra: the native bisection eigenpairs must be
    ORTHONORMAL (xSTEIN-style within-cluster Gram-Schmidt) — previously all
    cluster members returned the identical vector (Gram matrix of ones)."""
    import numpy as np
    from lanczos_tpu.native import host_kernels as hk

    if not hk.available():
        import pytest

        pytest.skip("native extension not built")
    # exactly degenerate (decoupled)
    vals, vecs = hk.tridiagonal_eigh_bisect(np.array([2.0, 2.0, 2.0]), np.array([0.0, 0.0]), 0, 3)
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(3), atol=1e-12)
    # tightly clustered with tiny couplings
    a = np.array([1.0, 3.0, 1.0, 4.0])
    b = np.array([1e-9, 1e-9, 1e-9])
    vals2, vecs2 = hk.tridiagonal_eigh_bisect(a, b, 0, 4)
    np.testing.assert_allclose(vecs2 @ vecs2.T, np.eye(4), atol=1e-10)
    t = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    for k in range(4):
        assert np.linalg.norm(t @ vecs2[k] - vals2[k] * vecs2[k]) < 1e-9
    # extreme scales: the backward recurrence must stay finite
    a3 = np.array([1e200, -1e200, 5.0])
    vals3, vecs3 = hk.tridiagonal_eigh_bisect(a3, np.array([0.0, 0.0]), 0, 3)
    assert np.isfinite(vecs3).all()
    assert (np.abs(vecs3).sum(axis=1) > 0).all()
