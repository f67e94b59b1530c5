"""Exponentiator tests mirroring the reference suite
(test/exponentiator_test.cpp): ground truth by explicit eigendecomposition,
asserting normalized overlap ~ 1 within eps."""

import numpy as np
import jax.numpy as jnp
import pytest

from lanczos_tpu import Exponentiator, DenseOperator, FunctionOperator


def _overlap(truth, out):
    truth = np.asarray(truth)
    out = np.asarray(out)
    return abs(np.vdot(truth, out)) / (np.linalg.norm(truth) * np.linalg.norm(out))


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_exponentiate_real(mode):
    # Reference EXPONENTIATOR_TEST.EXPONENTIATE_REAL (exponentiator_test.cpp:31-81):
    # 3x3 matrix, a=3, truth via eigendecomposition.
    a_mat = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    expo = Exponentiator(DenseOperator(jnp.asarray(a_mat)), mode=mode)
    inp = np.array([1.0, 0.0, 0.0])

    out, itern = expo.run(3.0, inp)
    w, u = np.linalg.eigh(a_mat)
    truth = u @ np.diag(np.exp(3.0 * w)) @ u.T @ inp
    assert _overlap(truth, out) == pytest.approx(1.0, abs=expo.eps)
    assert itern >= 1

    out_t, _ = expo.taylor_run(3.0, inp)
    assert _overlap(truth, out_t) == pytest.approx(1.0, abs=expo.eps)


def _hopping_ring(n, t=-1.0):
    def matmul(x):
        y = jnp.zeros_like(x)
        y = y.at[:-1].add(t * x[1:])
        y = y.at[1:].add(t * x[:-1])
        y = y.at[0].add(t * x[n - 1])
        y = y.at[n - 1].add(t * x[0])
        return y

    dense = np.zeros((n, n))
    for i in range(n - 1):
        dense[i, i + 1] = dense[i + 1, i] = t
    dense[0, n - 1] = dense[n - 1, 0] = t
    return matmul, dense


def _test_input(n):
    inp = np.zeros(n, dtype=np.complex128)
    inp[0] = 1 + 2j
    inp[n - 1] = 1 + 2j
    inp[n // 2] = 8 + 2j
    return inp / np.linalg.norm(inp)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_exponentiate_large_imaginary_time(mode):
    # Reference EXPONENTIATOR_TEST.EXPONENTIATE_LARGE_MATRIX
    # (exponentiator_test.cpp:106-162): n=100 periodic hopping Hamiltonian,
    # a = 3i — real quantum time evolution.
    n = 100
    matmul, dense = _hopping_ring(n)
    expo = Exponentiator(FunctionOperator(matmul, n, np.complex128), mode=mode)
    inp = _test_input(n)

    a = 3.0j
    out, itern = expo.run(a, inp)

    w, u = np.linalg.eigh(dense)
    truth = u @ np.diag(np.exp(a * w)) @ u.conj().T @ inp
    assert _overlap(truth, out) == pytest.approx(1.0, abs=expo.eps)

    out_t, _ = expo.taylor_run(a, inp)
    assert _overlap(truth, out_t) == pytest.approx(1.0, abs=expo.eps)


@pytest.mark.parametrize("mode", ["hybrid", "fused"])
def test_exponentiate_zero_delta(mode):
    # Reference EXPONENTIATOR_TEST.EXPONENTIATE_ZERO_DELTA
    # (exponentiator_test.cpp:164-222): a=0 with full_orthogonalize=true must
    # return the input itself.
    n = 100
    matmul, dense = _hopping_ring(n)
    expo = Exponentiator(FunctionOperator(matmul, n, np.complex128), mode=mode)
    expo.full_orthogonalize = True
    inp = _test_input(n)

    out, _ = expo.run(0.0, inp)
    assert _overlap(inp, out) == pytest.approx(1.0, abs=expo.eps)

    out_t, _ = expo.taylor_run(0.0, inp)
    assert _overlap(inp, out_t) == pytest.approx(1.0, abs=expo.eps)


def test_exponentiate_f32():
    # f32 fast-path sanity at the reference's float tolerance table
    # (exponentiator.hpp:51-56: eps ~ 1e-6 for 4-byte types).
    a_mat = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]], dtype=np.float32)
    expo = Exponentiator(DenseOperator(jnp.asarray(a_mat)))
    inp = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    out, _ = expo.run(1.5, inp)
    w, u = np.linalg.eigh(a_mat.astype(np.float64))
    truth = u @ np.diag(np.exp(1.5 * w)) @ u.T @ inp.astype(np.float64)
    assert _overlap(truth, out) == pytest.approx(1.0, abs=expo.eps)


def test_f32_meets_reference_overlap_tolerance():
    """The f32 Krylov build at eps=1e-14 meets the reference's f64 OVERLAP
    tolerance (machine_eps*1e2 ~ 2.2e-14, exponentiator.hpp:58) on its ring
    zoo (exponentiator_test.cpp:105-160): the overlap criterion is quadratic
    in the output's angle error, and the convergence replay runs on host in
    f64 from the streamed alpha/beta, so the f32 floor (~1e-7 vector error)
    lands at ~3e-15 overlap with the same iteration count as an f64 build.
    This is the f32-storage accuracy statement for the exponentiator."""
    n = 100
    _, dense = _hopping_ring(n)
    inp = _test_input(n)
    k = 2 * np.pi / n * np.arange(n)
    evs = -2.0 * np.cos(k)
    u = np.exp(1j * np.outer(np.arange(n), k)) / np.sqrt(n)
    truth = u @ (np.diag(np.exp(3.0j * evs)) @ (u.conj().T @ inp))

    eps_ref = np.finfo(np.float64).eps * 1e2
    expo = Exponentiator(jnp.asarray(dense, np.float32), dtype=np.float32)
    expo.eps = 1e-14
    (o_re, o_im), iters = expo.run_split(
        3.0j, jnp.asarray(inp.real, np.float32), jnp.asarray(inp.imag, np.float32)
    )
    out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert _overlap(truth, out) == pytest.approx(1.0, abs=eps_ref)

    # Same Krylov depth as the f64 build: the host f64 replay sees through
    # the f32 storage (truncation, not rounding, controls the exit).
    expo64 = Exponentiator(jnp.asarray(dense, np.float64), dtype=np.float64)
    expo64.eps = 1e-14
    (r64, i64), iters64 = expo64.run_split(
        3.0j, jnp.asarray(inp.real), jnp.asarray(inp.imag)
    )
    # +-1 tolerance: a one-iteration shift from platform/BLAS rounding in the
    # f32 build is benign (the overlap assertion above is the accuracy gate).
    assert all(abs(a - b) <= 1 for a, b in zip(iters, iters64))


def test_batched_time_evolution_matches_single():
    """run_batch evolves B states in one vmapped program; results and
    iteration counts match per-state runs."""
    n = 60
    matmul, dense = _hopping_ring(n)
    from lanczos_tpu import FunctionOperator

    op = FunctionOperator(matmul, n, np.complex128)
    expo = Exponentiator(op)

    rng = np.random.default_rng(3)
    batch = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    batch /= np.linalg.norm(batch, axis=1, keepdims=True)

    a = -0.7j
    outs, iters = expo.run_batch(a, jnp.asarray(batch))

    w, u = np.linalg.eigh(dense)
    for i in range(4):
        truth = u @ np.diag(np.exp(a * w)) @ u.conj().T @ batch[i]
        ov = abs(np.vdot(truth, np.asarray(outs[i]))) / (
            np.linalg.norm(truth) * np.linalg.norm(np.asarray(outs[i]))
        )
        assert 1 - ov < expo.eps
        single, it_single = expo.run(a, jnp.asarray(batch[i]))
        assert int(iters[i]) == it_single
        np.testing.assert_allclose(np.asarray(outs[i]), np.asarray(single), atol=1e-12)


def test_fused_f32_breakdown_terminates():
    """Regression: an f32 Krylov breakdown (beta in (f64_eps, f32_eps))
    previously hung the fused grow/retry loop forever — the device stopped
    on the f32 threshold while the host replay looked for the f64 one."""
    n = 8
    d = np.arange(1, n + 1, dtype=np.float32)
    a_mat = jnp.asarray(np.diag(d))
    v = np.zeros(n, np.float32)
    v[0] = 1.0
    v[1] = 1e-8  # Krylov space exhausts after ~2 steps at f32 precision
    expo = Exponentiator(DenseOperator(a_mat), mode="fused")
    out, itern = expo.run(0.5, jnp.asarray(v))
    # exp(0.5 * diag)[0] acts on e1 almost exactly.
    assert abs(float(out[0]) - np.exp(0.5 * 1.0)) < 1e-4
    assert itern <= n


def test_split_complex_evolution_matches_complex():
    """run_split (two real builds, complex coefficients on host) agrees with
    the native-complex path — the split-real form of exp(-i t H) psi."""
    n = 80
    i = np.arange(n - 1)
    h = np.zeros((n, n))
    h[i, i + 1] = h[i + 1, i] = -1.0

    rng = np.random.default_rng(8)
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)

    a = -0.8j
    expo_c = Exponentiator(DenseOperator(jnp.asarray(h, jnp.complex128)))
    truth, _ = expo_c.run(a, jnp.asarray(psi))

    expo_r = Exponentiator(DenseOperator(jnp.asarray(h)))
    (out_re, out_im), iters = expo_r.run_split(a, psi.real, psi.imag)
    got = np.asarray(out_re) + 1j * np.asarray(out_im)
    np.testing.assert_allclose(got, np.asarray(truth), atol=1e-10)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-9


def test_split_complex_real_input():
    """Purely real psi (zero imaginary part) through the split path."""
    n = 40
    i = np.arange(n - 1)
    h = np.zeros((n, n)); h[i, i + 1] = h[i + 1, i] = -1.0
    psi = np.zeros(n); psi[n // 2] = 1.0
    expo = Exponentiator(DenseOperator(jnp.asarray(h)))
    expo.full_orthogonalize = True  # localized start -> near-full Krylov space
    (out_re, out_im), _ = expo.run_split(-1.0j, psi, np.zeros(n))
    got = np.asarray(out_re) + 1j * np.asarray(out_im)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-9
    import scipy.linalg as sla
    truth = sla.expm(-1.0j * h) @ psi
    # overlap-criterion truncation accuracy (reference semantics), not exact
    np.testing.assert_allclose(got, truth, atol=1e-8)


def test_evolve_device_resident():
    """Multi-step device-resident evolution matches the exact propagator."""
    import scipy.linalg as sla

    n = 64
    i = np.arange(n - 1)
    h = np.zeros((n, n)); h[i, i + 1] = h[i + 1, i] = -1.0
    rng = np.random.default_rng(9)
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)

    expo = Exponentiator(DenseOperator(jnp.asarray(h)))
    out_re, out_im = expo.evolve(-0.3j, psi.real, psi.imag, steps=5, krylov_dim=16)
    got = np.asarray(out_re) + 1j * np.asarray(out_im)
    truth = np.linalg.matrix_power(sla.expm(-0.3j * h), 5) @ psi
    assert abs(np.linalg.norm(got) - 1.0) < 1e-8
    ov = abs(np.vdot(truth, got))
    assert 1 - ov < 1e-9


def test_batch_with_zero_padding_rows():
    """Zero rows (batch padding) must not produce NaNs or run to max_iter."""
    n = 30
    matmul, dense = _hopping_ring(n)
    from lanczos_tpu import FunctionOperator

    expo = Exponentiator(FunctionOperator(matmul, n, np.complex128))
    batch = np.zeros((3, n), complex)
    batch[0, 0] = 1.0  # one real state + two zero padding rows
    outs, iters = expo.run_batch(-0.4j, jnp.asarray(batch))
    assert np.all(np.isfinite(np.asarray(outs).view(np.float64)))
    np.testing.assert_allclose(np.asarray(outs[1]), 0.0, atol=1e-12)
    assert int(iters[1]) == 1


def test_checkpoint_suffixless_path(tmp_path):
    """Resume works for paths without .npz (np.savez appends the suffix)."""
    from lanczos_tpu import LambdaLanczos
    from lanczos_tpu.utils.checkpoint import CheckpointedRun

    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12)); a = (a + a.T) / 2
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=2)
    path = tmp_path / "state.ckpt"  # no .npz
    vals1, _ = CheckpointedRun(eng, path).run()
    # second run must actually RESUME (file found under the canonical name)
    eng2 = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=2)
    vals2, _ = CheckpointedRun(eng2, path).run()
    np.testing.assert_allclose(vals2, vals1, atol=1e-10)


def test_evolve_precise_df64():
    """precise=True evolve (solvers/exponentiator_precise.py): df64-carried
    state + EFT build + df small expm reaches f64-grade VECTOR-LEVEL
    fidelity on f32 storage.  The f32 path drifts ~1e-7 angle/step (the
    overlap metric the reference uses, exponentiator.hpp:58, is quadratic
    in angle and hides it — VERDICT r3 item 4); the df path floors ~1e-12.
    Measured build invariants: basis orthonormality 3.1e-14, Lanczos
    residual 6.4e-15, single-step angle 8.4e-13."""
    from lanczos_tpu import DIAOperator

    n = 192
    op = DIAOperator.from_diagonals([-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    d = np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
    w, u = np.linalg.eigh(d)
    steps, dt = 25, 0.1
    truth = u @ (np.exp(1j * dt * steps * w) * (u.conj().T @ v))

    ex = Exponentiator(op, dtype=np.float32)

    def angle_err(out):
        tn = truth / np.linalg.norm(truth)
        on = out / np.linalg.norm(out)
        ip = np.vdot(tn, on)
        return np.linalg.norm(on - (ip / abs(ip)) * tn)

    rp, ip_ = ex.evolve(1j * dt, v.real, v.imag, steps, krylov_dim=16, precise=True)
    assert rp.dtype == np.float64  # host f64 fold of the df words
    err_p = angle_err(rp + 1j * ip_)
    assert err_p < 1e-10, err_p

    r32, i32 = ex.evolve(1j * dt, v.real.astype(np.float32), v.imag.astype(np.float32), steps, krylov_dim=16)
    err_32 = angle_err(np.asarray(r32, np.float64) + 1j * np.asarray(i32, np.float64))
    assert err_p < err_32 * 1e-2, (err_p, err_32)  # >=100x better than f32


def test_evolve_precise_renormalize_real_a():
    """precise evolve with real a (imaginary-time projection) + renormalize:
    converges toward the ground state like the f32 path, in df words."""
    from lanczos_tpu import DIAOperator

    n = 64
    # unit-gapped diagonal spectrum: 20 steps of exp(-A) suppress the first
    # excited component by e^-20 — the projection actually converges within
    # the step budget (a chain's ~0.007 gap would need thousands of steps)
    op = DIAOperator.from_diagonals([0], [np.arange(n, dtype=np.float32)], n)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    re, im = Exponentiator(op, dtype=np.float32).evolve(
        -1.0, v, np.zeros_like(v), 20, krylov_dim=12, renormalize=True, precise=True
    )
    assert abs(np.linalg.norm(re + 1j * im) - 1.0) < 1e-10
    # Rayleigh quotient ~ ground state (eigenvalue 0)
    rq = re @ (np.arange(n) * re)
    assert abs(rq) < 1e-8, rq


def test_evolve_precise_requires_matvec_df():
    """A matrix-free FunctionOperator (no matvec_df) must fail with guidance,
    not garbage."""
    n = 16

    def mv(x):
        return -x

    ex = Exponentiator(FunctionOperator(mv, n, np.float32))
    with pytest.raises(NotImplementedError):
        ex.evolve(1j, np.ones(n, np.float32), np.zeros(n, np.float32), 2, precise=True)


def test_chebyshev_propagator_matches_expm():
    """run_chebyshev: the Tal-Ezer/Kosloff propagator (solvers/cheby_expm)
    vs scipy expm at the reference exponentiator's tolerance grade —
    unitary (a=3i, the reference's hardest apply, exponentiator_test.cpp:
    106-162), decay (a=-0.5), mixed complex, and a LONG unitary step
    (a=25i: the whole evolution in ~90 matvecs, no per-step Krylov
    builds).  Plus the shared-chain grid and auto (Gershgorin) bounds."""
    import scipy.linalg as sla

    from lanczos_tpu import DIAOperator

    n = 100
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0)] * 2, n)
    A = np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 1, -1.0), 1)
    exp_eng = Exponentiator(op)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)

    for a in (3j, -0.5, 1.5j - 0.2, 25j):
        truth = sla.expm(a * A) @ v
        (o_re, o_im), terms = exp_eng.run_chebyshev(
            a, v.real, v.imag, lo=-2.0, hi=2.0)
        out = np.asarray(o_re) + 1j * np.asarray(o_im)
        assert np.linalg.norm(out - truth) < 1e-12, a
        assert terms < 120

    # grid: one chain, several times
    ts = [0.5j, 2.0j, 5.0j]
    (g_re, g_im), _K = exp_eng.run_chebyshev_grid(ts, v.real, v.imag, lo=-2.0, hi=2.0)
    for j, t in enumerate(ts):
        truth = sla.expm(t * A) @ v
        out = np.asarray(g_re[j]) + 1j * np.asarray(g_im[j])
        assert np.linalg.norm(out - truth) < 1e-12

    # auto bounds (Gershgorin encloses the spectrum by construction)
    (o_re, o_im), _ = exp_eng.run_chebyshev(2j, v.real, v.imag)
    truth = sla.expm(2j * A) @ v
    assert np.linalg.norm((np.asarray(o_re) + 1j * np.asarray(o_im)) - truth) < 1e-12


def test_chebyshev_propagator_precise_df64():
    """run_chebyshev(precise=True): the df64 chain reaches f64-grade
    fidelity from an f32 operator."""
    import scipy.linalg as sla

    from lanczos_tpu import DIAOperator

    n = 100
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    A = np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 1, -1.0), 1)
    exp_eng = Exponentiator(op, dtype=np.float32)
    rng = np.random.default_rng(2)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    for a in (3j, 25j, -0.5):
        truth = sla.expm(a * A) @ v
        (re, im), _K = exp_eng.run_chebyshev(
            a, v.real, v.imag, lo=-2.0, hi=2.0, precise=True)
        out = re + 1j * im
        assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 1e-12, a


def test_chebyshev_propagator_complex_hermitian():
    """chebyshev_expm_apply_hermitian: complex-Hermitian propagation
    through the real embedding — T_k has real coefficients, so the
    homomorphism lets the ordinary chain on the symmetric 2n embedding
    compute every complex T_k(H)psi, and the complex coefficients
    recombine linearly afterwards.  f32 ~3-6e-7 rel, df64 ~2-3e-14 vs
    dense scipy expm of the STORED (f32) matrix."""
    import scipy.linalg as sla

    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator
    from lanczos_tpu.solvers.cheby_expm import chebyshev_expm_apply_hermitian

    rng = np.random.default_rng(4)
    n = 90
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    H32 = (H32 + H32.conj().T) / 2
    op = HermitianSplitOperator(DenseOperator(Hr, n), DenseOperator(Hi, n))
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)
    for a in (3j, -0.3, 1j - 0.1):
        truth = sla.expm(a * H32) @ psi
        (o_re, o_im), _K = chebyshev_expm_apply_hermitian(
            op, a, psi.real.astype(np.float32), psi.imag.astype(np.float32))
        out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
        assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 5e-6, a
        (p_re, p_im), _K2 = chebyshev_expm_apply_hermitian(
            op, a, psi.real, psi.imag, precise=True)
        outp = p_re + 1j * p_im
        assert np.linalg.norm(outp - truth) / np.linalg.norm(truth) < 1e-12, a


def test_run_chebyshev_dispatches_hermitian_split():
    """Exponentiator.run_chebyshev on a HermitianSplitOperator treats the
    state as the ORIGINAL n-dim complex vector and dispatches to the
    homomorphism-recombined chain (the 2n embedding is an implementation
    detail, not the user's state shape)."""
    import scipy.linalg as sla

    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator

    rng = np.random.default_rng(4)
    n = 70
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    H32 = (H32 + H32.conj().T) / 2
    op = HermitianSplitOperator(DenseOperator(Hr, n), DenseOperator(Hi, n))
    ex = Exponentiator(op, dtype=np.float32)
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)
    truth = sla.expm(2j * H32) @ psi
    (o_re, o_im), _K = ex.run_chebyshev(
        2j, psi.real.astype(np.float32), psi.imag.astype(np.float32))
    out = np.asarray(o_re, np.float64) + 1j * np.asarray(o_im, np.float64)
    assert out.shape == (n,)
    assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 5e-6
    (p_re, p_im), _K2 = ex.run_chebyshev(2j, psi.real, psi.imag, precise=True)
    assert np.linalg.norm((p_re + 1j * p_im) - truth) / np.linalg.norm(truth) < 1e-12


def test_run_chebyshev_grid_dispatches_hermitian_split():
    """run_chebyshev_grid on a HermitianSplitOperator: every time point of
    a complex-Hermitian evolution from one chain on the embedding,
    recombined per row to the original n-dim complex states."""
    import scipy.linalg as sla

    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator

    rng = np.random.default_rng(4)
    n = 60
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    H32 = (H32 + H32.conj().T) / 2
    op = HermitianSplitOperator(DenseOperator(Hr, n), DenseOperator(Hi, n))
    ex = Exponentiator(op, dtype=np.float32)
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)
    ts = [0.5j, 1j, 2j]
    (g_re, g_im), _K = ex.run_chebyshev_grid(
        ts, psi.real.astype(np.float32), psi.imag.astype(np.float32))
    assert np.asarray(g_re).shape == (3, n)
    for j, tj in enumerate(ts):
        truth = sla.expm(tj * H32) @ psi
        out = np.asarray(g_re[j], np.float64) + 1j * np.asarray(g_im[j], np.float64)
        assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 5e-6


def _herm_problem(n, seed=4):
    import scipy.linalg as sla

    from lanczos_tpu.ops.hermitian_split import HermitianSplitOperator

    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2
    Hr = np.real(H).astype(np.float32)
    Hi = np.imag(H).astype(np.float32)
    # ground truth of the STORED (f32) matrix
    H32 = Hr.astype(np.float64) + 1j * Hi.astype(np.float64)
    H32 = (H32 + H32.conj().T) / 2
    op = HermitianSplitOperator(DenseOperator(Hr, n), DenseOperator(Hi, n))
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    psi /= np.linalg.norm(psi)
    return op, H32, psi, sla


def test_run_dispatches_hermitian_split():
    """Exponentiator.run on a HermitianSplitOperator takes the ORIGINAL
    n-dim complex state, runs the Krylov build on the real 2n embedding
    (complex a enters only through the host coefficients — a complex-
    coefficient polynomial in the embedding, which commutes back to
    exp(a*H) psi), and returns a complex n-dim state (VERDICT r4 item 7:
    parity with the run_chebyshev dispatch)."""
    n = 60
    op, H32, psi, sla = _herm_problem(n)
    ex = Exponentiator(op, dtype=np.float32)
    ex.eps = 1e-10  # drive the overlap criterion to the f32 floor (~2e-6)
    for a in (2j, -0.3, 1j - 0.2):
        truth = sla.expm(a * H32) @ psi
        out, itern = ex.run(a, psi)
        out = np.asarray(out)
        assert out.shape == (n,)
        assert itern >= 1
        assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 2e-5, a


def test_run_grid_dispatches_hermitian_split():
    """run_grid on a HermitianSplitOperator: every grid point of a complex
    Hermitian evolution from ONE embedded build, complex (num, n) out."""
    n = 50
    op, H32, psi, sla = _herm_problem(n)
    ex = Exponentiator(op, dtype=np.float32)
    ex.eps = 1e-10
    ts = [0.5j, 1j, 2j]
    outs, itern = ex.run_grid(ts, psi)
    outs = np.asarray(outs)
    assert outs.shape == (3, n)
    assert itern >= 1
    for j, tj in enumerate(ts):
        truth = sla.expm(tj * H32) @ psi
        assert np.linalg.norm(outs[j] - truth) / np.linalg.norm(truth) < 2e-5


def test_run_batch_dispatches_hermitian_split():
    """run_batch on a HermitianSplitOperator: (B, n) complex rows embed to
    (B, 2n) real builds (one vmapped program) and come back complex."""
    n = 40
    op, H32, psi, sla = _herm_problem(n)
    rng = np.random.default_rng(11)
    batch = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    batch /= np.linalg.norm(batch, axis=1, keepdims=True)
    ex = Exponentiator(op, dtype=np.float32)
    ex.eps = 1e-10
    outs, iters = ex.run_batch(1.5j, batch)
    outs = np.asarray(outs)
    assert outs.shape == (3, n)
    assert len(np.asarray(iters)) == 3
    E = sla.expm(1.5j * H32)
    for b in range(3):
        truth = E @ batch[b]
        assert np.linalg.norm(outs[b] - truth) / np.linalg.norm(truth) < 2e-5


def test_run_split_and_taylor_dispatch_hermitian_split():
    """run_split/taylor_run on a HermitianSplitOperator take the original
    n-dim complex state (split re/im for run_split)."""
    n = 40
    op, H32, psi, sla = _herm_problem(n)
    ex = Exponentiator(op, dtype=np.float32)
    ex.eps = 1e-10
    truth = sla.expm(1j * H32) @ psi
    (o_re, o_im), itern = ex.run_split(1j, psi.real, psi.imag)
    out = np.asarray(o_re) + 1j * np.asarray(o_im)
    assert out.shape == (n,)
    assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 2e-5
    t_out, terms = ex.taylor_run(1j, psi)
    assert np.asarray(t_out).shape == (n,)
    # Taylor's f32 floor: intermediate terms grow like exp(|a|*||A||) before
    # cancelling, so the summation noise is ~exp(|a|*||A||)*eps_f32
    assert np.linalg.norm(np.asarray(t_out) - truth) / np.linalg.norm(truth) < 5e-3
    assert terms >= 2


def test_evolve_dispatches_hermitian_split():
    """evolve on a HermitianSplitOperator: each step is ONE Krylov build on
    the real embedding + the homomorphism recombination; the multi-step
    result matches dense expm of the complex matrix.  precise=True carries
    df64 words through the same loop (f64-grade fidelity on f32 words)."""
    n = 40
    op, H32, psi, sla = _herm_problem(n)
    ex = Exponentiator(op, dtype=np.float32)
    steps, dt = 8, 0.25j
    truth = sla.expm(steps * dt * H32) @ psi
    re, im = ex.evolve(dt, psi.real, psi.imag, steps, krylov_dim=20,
                       renormalize=True)
    out = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    assert out.shape == (n,)
    # unitary evolution: compare by angle
    ang = np.arccos(min(1.0, abs(np.vdot(truth, out)) / np.linalg.norm(out)))
    # f32 floor here is the 12-squaring small-expm rounding (~2^12 * eps_f32
    # per step), not the Krylov truncation
    assert ang < 5e-3

    rep, imp = ex.evolve(dt, psi.real, psi.imag, steps, krylov_dim=24,
                         renormalize=True, precise=True)
    outp = rep + 1j * imp
    angp = np.arccos(min(1.0, abs(np.vdot(truth, outp)) / np.linalg.norm(outp)))
    assert angp < 1e-10


def test_chebyshev_heat_kernel_ive_fallback():
    """Large-|z| Bessel fallback: iv overflows past |Re z| ~ 710 and the
    scaled path must unscale ive with exp(|Re z|) (scipy's convention) —
    the old exp(z) was off by exp(2|Re z|) for Re z < 0 (heat kernels) and
    injected a spurious phase for complex z.  End-to-end: exp(-t*A)v for a
    PSD chain at t large enough to overflow iv converges to the ground
    state direction with the exact decay factor."""
    import scipy.linalg as sla

    from lanczos_tpu.solvers.cheby_expm import chebyshev_expm_coeffs

    # identity vs direct iv where both are finite (|Re z| = 600)
    from scipy.special import iv, ive

    ks = np.arange(40)
    for z0 in (-600 + 0.5j, 600 + 2j):
        direct = iv(ks, z0)
        fall = ive(ks, z0) * np.exp(abs(z0.real))
        rel = np.max(np.abs(direct - fall) / np.maximum(np.abs(direct), 1e-280))
        assert rel < 1e-12, z0

    # package-level heat kernel: A = 2I - chain (PSD, lambda_1 ~ 9.6e-4),
    # t=380 -> z = -760 overflows iv; exp(-tA)v ~ e^{-t lambda_1} <v,phi1> phi1
    n = 100
    t = 380.0
    A = 2.0 * np.eye(n)
    idx = np.arange(n - 1)
    A[idx, idx + 1] = A[idx + 1, idx] = -1.0
    op = DenseOperator(jnp.asarray(A, jnp.float32), n)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    ex = Exponentiator(op, dtype=np.float32)
    (o_re, o_im), K = ex.run_chebyshev(-t, v, np.zeros(n), lo=0.0, hi=4.0)
    out = np.asarray(o_re, np.float64)
    w, U = np.linalg.eigh(A)
    truth = U @ (np.exp(-t * w) * (U.T @ v))
    assert np.linalg.norm(out - truth) / np.linalg.norm(truth) < 1e-4, (
        np.linalg.norm(out - truth), np.linalg.norm(truth))

    # genuine overflow of the prefactor raises instead of returning inf
    import pytest

    with pytest.raises(OverflowError):
        chebyshev_expm_coeffs(400.0 + 1j, 0.0, 2.0)
