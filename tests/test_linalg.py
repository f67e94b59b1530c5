"""Unit tests for the vector-kernel layer, mirroring the reference UNIT_TEST
suite (test/lambda_lanczos_test.cpp:47-126)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lanczos_tpu.core import linalg, df64


def test_inner_product_conjugates_first_argument():
    # Reference UNIT_TEST.INNER_PRODUCT (lambda_lanczos_test.cpp:47-59):
    # v1 = [3, 1+3i], v2 = [3, 2+4i]  ->  <v1, v2> = 23 - 2i.
    v1 = jnp.array([3.0, 1.0 + 3.0j], dtype=jnp.complex128)
    v2 = jnp.array([3.0, 2.0 + 4.0j], dtype=jnp.complex128)
    result = linalg.inner_prod(v1, v2)
    assert result == pytest.approx(23.0 - 2.0j, abs=1e-15)


def test_cgs2_builds_orthonormal_basis():
    # Reference UNIT_TEST.SCHMIDT_ORTHOGONALIZATION (lambda_lanczos_test.cpp:61-91):
    # residual overlaps below 1e-15 * n.
    n = 10
    rng = np.random.default_rng(1)
    basis = np.zeros((0, n), dtype=np.complex128)
    for _ in range(n // 2):
        u = rng.uniform(-10, 10, n) + 1j * rng.uniform(-10, 10, n)
        u = jnp.asarray(u)
        if basis.shape[0]:
            u = linalg.orthogonalize_cgs2(u, jnp.asarray(basis))
        u = linalg.normalize(u)
        basis = np.concatenate([basis, np.asarray(u)[None]], axis=0)

    v = jnp.asarray(rng.uniform(-10, 10, n) + 1j * rng.uniform(-10, 10, n))
    v = linalg.orthogonalize_cgs2(v, jnp.asarray(basis))
    for u in basis:
        ip = complex(linalg.inner_prod(v, jnp.asarray(u)))
        assert abs(ip.real) < 1e-15 * n
        assert abs(ip.imag) < 1e-15 * n


def test_row_mask_disables_buffer_rows():
    n = 8
    basis = jnp.eye(4, n, dtype=jnp.float64)
    v = jnp.ones(n, dtype=jnp.float64)
    mask = jnp.array([1.0, 1.0, 0.0, 0.0])
    out = linalg.orthogonalize_cgs2(v, basis, mask)
    # components 0,1 removed; 2,3 untouched
    np.testing.assert_allclose(np.asarray(out)[:4], [0, 0, 1, 1], atol=1e-15)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("k", [0, 1, 5, 31, 32, 33, 64])
def test_bcgs_dyn_matches_masked_cgs(dtype, k, monkeypatch):
    """orthogonalize_bcgs_dyn over live rows [0, k) must agree with the
    masked full-capacity CGS2 (chunk boundaries, clamping, k=0, k=cap).
    The chunked path is accelerator-only, so force it under the CPU tests."""
    monkeypatch.setattr(linalg.jax, "default_backend", lambda: "gpu")
    cap, n = 64, 96
    rng = np.random.default_rng(int(k) + 7)

    def draw():
        x = rng.standard_normal(n)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.standard_normal(n)
        return x

    # Orthonormal live rows (the engine's contract), zeros elsewhere.
    raw = np.stack([draw() for _ in range(max(k, 1))])
    q = np.linalg.qr(raw.conj().T)[0].conj().T[:k] if k else raw[:0]
    basis = np.zeros((cap, n), dtype)
    basis[:k] = q
    basis_j = jnp.asarray(basis)

    v = jnp.asarray(draw().astype(dtype))
    mask = (jnp.arange(cap) < k).astype(jnp.float64)
    want = linalg.orthogonalize_cgs2(v, basis_j, mask)
    for chunk in (8, 32, 64, 128):
        got = linalg.orthogonalize_bcgs_dyn(v, basis_j, k, chunk=chunk)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)
        # and the result is actually orthogonal to every live row
        for j in range(k):
            assert abs(complex(linalg.inner_prod(got, basis_j[j]))) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("k", [0, 1, 33, 64])
def test_bcgs_dyn_coeffs_matches_masked_cgs(dtype, k, monkeypatch):
    """The coefficient-returning variant must reproduce the masked CGS2
    result AND its summed two-pass coefficients (the thick-restart T column)
    on both the chunked accelerator path and the CPU fallback."""
    cap, n = 64, 96
    rng = np.random.default_rng(int(k) + 11)

    def draw():
        x = rng.standard_normal(n)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.standard_normal(n)
        return x

    raw = np.stack([draw() for _ in range(max(k, 1))])
    q = np.linalg.qr(raw.conj().T)[0].conj().T[:k] if k else raw[:0]
    basis = np.zeros((cap, n), dtype)
    basis[:k] = q
    basis_j = jnp.asarray(basis)
    v = jnp.asarray(draw().astype(dtype))

    mask = (jnp.arange(cap) < k).astype(jnp.float64)
    want = v
    c_want = jnp.zeros((cap,), v.dtype)
    for _ in range(2):
        c = linalg._project_coeffs(basis_j, want, mask)
        want = want - c @ basis_j
        c_want = c_want + c

    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(linalg.jax, "default_backend", lambda b=backend: b)
        got, c_got = linalg.orthogonalize_bcgs_dyn_coeffs(v, basis_j, k)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)
        np.testing.assert_allclose(np.asarray(c_got), np.asarray(c_want), atol=1e-12)
        assert np.all(np.asarray(c_got)[k:] == 0)


def _f32_live_basis(k, cap, n, seed):
    """f32 basis with orthonormal rows [0, k) and zeros elsewhere."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((max(k, 1), n))
    q = np.linalg.qr(raw.T)[0].T[:k] if k else raw[:0]
    basis = np.zeros((cap, n), np.float32)
    basis[:k] = q
    return basis, rng


@pytest.mark.parametrize("k", [0, 1, 63, 64, 100, 128])
def test_bcgs_dyn_single_pass_matches_f64_cgs(k, monkeypatch):
    """One chunked BCGS pass (the accelerator path, forced here) on f32 data
    must match one classical Gram-Schmidt pass in float64: live-row masking,
    the clamped ragged final chunk (cap=129 is not a multiple of 64) and
    k=0 are the logic under test."""
    monkeypatch.setattr(linalg.jax, "default_backend", lambda: "gpu")
    cap, n = 129, 256
    basis, rng = _f32_live_basis(k, cap, n, k + 3)
    v = rng.standard_normal(n).astype(np.float32)
    if k:
        v = v + 10.0 * basis[:min(k, 4)].sum(axis=0)

    got = np.asarray(
        linalg.orthogonalize_bcgs_dyn(jnp.asarray(v), jnp.asarray(basis), k, passes=1),
        np.float64,
    )
    c = basis[:k].astype(np.float64) @ v.astype(np.float64)
    want = v.astype(np.float64) - c @ basis[:k].astype(np.float64)
    np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(v).max(), 1))


@pytest.mark.parametrize("k", [0, 1, 63, 64, 100, 128])
def test_bcgs_block_matches_f64_cgs(k, monkeypatch):
    """The block form (block_thick._bcgs_block, chunked accelerator path
    forced here): per-vector results must match the float64 classical
    masked-GS pass of each block row."""
    from lanczos_tpu.solvers import block_thick

    monkeypatch.setattr(block_thick.jax, "default_backend", lambda: "gpu")
    cap, n, b = 129, 256, 3
    basis, rng = _f32_live_basis(k, cap, n, k + 11)
    vblk = rng.standard_normal((b, n)).astype(np.float32)
    if k:
        vblk = vblk + 10.0 * basis[: min(k, 4)].sum(axis=0)[None, :]

    got = np.asarray(
        block_thick._bcgs_block(jnp.asarray(vblk), jnp.asarray(basis), k, passes=1),
        np.float64,
    )
    c = basis[:k].astype(np.float64) @ vblk.astype(np.float64).T  # (k, b)
    want = vblk.astype(np.float64) - c.T @ basis[:k].astype(np.float64)
    np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(vblk).max(), 1))


def test_manhattan_norm_complex():
    # Reference UNIT_TEST.MANHATTAN_NORM (lambda_lanczos_test.cpp:93-100).
    v = jnp.array([1.0 + 3.0j, -1.0 - 1.0j], dtype=jnp.complex128)
    assert float(linalg.m_norm(v)) == pytest.approx(6.0)


def test_norm_is_real_for_complex():
    v = jnp.array([3.0 + 4.0j], dtype=jnp.complex128)
    assert float(linalg.norm(v)) == pytest.approx(5.0)


def test_df64_dot_beats_f32():
    # An ill-conditioned dot product: f32 loses most digits, df64 keeps ~1e-12.
    rng = np.random.default_rng(0)
    n = 4096
    x64 = rng.uniform(-1, 1, n)
    y64 = rng.uniform(-1, 1, n)
    exact = float(np.dot(x64.astype(np.float64), y64.astype(np.float64)))

    x32 = jnp.asarray(x64, jnp.float32)
    y32 = jnp.asarray(y64, jnp.float32)
    hi, lo = df64.dot_df(x32, y32)
    df_val = float(np.float64(hi) + np.float64(lo))
    # compare against the f64 dot of the *rounded* f32 inputs
    exact32 = float(np.dot(np.asarray(x32, np.float64), np.asarray(y32, np.float64)))
    assert abs(df_val - exact32) < 1e-10 * max(1.0, abs(exact32))
    # sanity: plain f32 is meaningfully worse on average; don't assert hard.
    _ = exact


def test_two_sum_exactness():
    a = jnp.float32(1.0)
    b = jnp.float32(1e-8)
    s, e = df64.two_sum(a, b)
    assert float(np.float64(s) + np.float64(e)) == pytest.approx(1.0 + 1e-8, rel=1e-15)
