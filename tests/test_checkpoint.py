"""Checkpoint/resume tests (an addition; reference has none,
SURVEY.md §5)."""

import numpy as np
import jax.numpy as jnp

from lanczos_tpu import LambdaLanczos
from lanczos_tpu.solvers.lanczos import EigenPairManager
from lanczos_tpu.utils.checkpoint import CheckpointedRun, load_state, save_state
from lanczos_tpu.utils.random import fixed_seed_initializer


def _matrix(n=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def test_save_load_roundtrip(tmp_path):
    m = EigenPairManager(True, 3)
    m.insert([2.0, 1.0], [jnp.asarray([1.0, 0.0]), jnp.asarray([0.0, 1.0])])
    p = tmp_path / "ck.npz"
    save_state(p, m, [5, 7])
    m2, counts = load_state(p, np.float64)
    assert counts == [5, 7]
    assert m2.eigenvalues() == m.eigenvalues()
    np.testing.assert_array_equal(np.asarray(m2.eigenvectors()[0]), np.asarray(m.eigenvectors()[0]))


def test_checkpointed_run_matches_plain(tmp_path):
    a = _matrix()
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=11)
    vals_plain, _ = eng.run()

    eng2 = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng2.init_vector = fixed_seed_initializer(np.float64, seed=11)
    vals_ck, vecs_ck = CheckpointedRun(eng2, tmp_path / "run.npz").run()
    np.testing.assert_allclose(vals_ck, vals_plain, atol=1e-10)


def test_resume_from_partial_state(tmp_path):
    a = _matrix()
    w = np.linalg.eigvalsh(a)[::-1]

    # Simulate a crash after the first restart: run once with num_eigs=3,
    # keep the checkpoint, then resume a fresh engine from it.
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=1)
    path = tmp_path / "partial.npz"
    run = CheckpointedRun(eng, path)
    vals1, _ = run.run()
    assert path.exists()

    eng2 = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng2.init_vector = fixed_seed_initializer(np.float64, seed=2)
    vals2, _ = CheckpointedRun(eng2, path).run()
    np.testing.assert_allclose(vals2, w[:3], atol=1e-9)


def test_resume_after_finished_skips_rerun(tmp_path):
    """A checkpoint written at the deflation fixed point (the crash window
    between the final save and run() returning) must resume by returning the
    stored result — not burn a whole extra deflated restart."""
    a = _matrix()
    eng = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng.init_vector = fixed_seed_initializer(np.float64, seed=3)
    path = tmp_path / "done.npz"
    vals1, _ = CheckpointedRun(eng, path).run()

    calls = {"n": 0}
    real_init = fixed_seed_initializer(np.float64, seed=3)

    def counting_init(n):
        calls["n"] += 1
        return real_init(n)

    eng2 = LambdaLanczos(jnp.asarray(a), find_maximum=True, num_eigs=3)
    eng2.init_vector = counting_init
    vals2, vecs2 = CheckpointedRun(eng2, path).run()
    assert calls["n"] == 0, "finished checkpoint should not launch any restart"
    np.testing.assert_allclose(np.sort(vals2), np.sort(vals1), atol=1e-12)
    assert eng2.iteration_counts == eng.iteration_counts


def test_checkpointed_run_precise_vectors_thick(tmp_path):
    """Checkpoint/resume over the pv thick engine (the round-3 production
    accuracy path): the shared deflation driver makes resume engine-agnostic,
    but pin it — a pv-specific state leak would corrupt resumed rounds."""
    from lanczos_tpu import DIAOperator

    n = 256
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32)], n
    )

    def make_engine():
        eng = LambdaLanczos(op, find_maximum=False, num_eigs=2, dtype=np.float32, mode="fused")
        eng.precise_vectors = True
        eng.restart_policy = "thick"
        eng.max_iteration = 40
        eng.max_restarts = 64
        eng.eps = 1e-12
        eng.eigenvalue_offset = -4.0
        return eng

    path = tmp_path / "pv.npz"
    vals1, _ = CheckpointedRun(make_engine(), path).run()
    assert path.exists()
    # Resume (finished state: must skip the re-run and return saved pairs).
    vals2, _ = CheckpointedRun(make_engine(), path).run()
    exact = np.sort(-2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))[:2]
    np.testing.assert_allclose(np.sort(np.asarray(vals1)), exact, atol=1e-10)
    np.testing.assert_allclose(np.sort(np.asarray(vals2)), np.sort(np.asarray(vals1)), atol=1e-12)


def test_filtered_checkpoint_resume(tmp_path):
    """filtered_lanczos(checkpoint_path=...) resumes at the round boundary
    (VERDICT r4 item 8): a run killed after round 1 continues from the
    saved B-space manager + loop scalars instead of restarting, and the
    combined run executes exactly as many deflation rounds as an
    uninterrupted one."""
    import warnings

    import jax.numpy as jnp

    from lanczos_tpu import DIAOperator, filtered_lanczos
    from lanczos_tpu.solvers import filtered as _filtered
    from lanczos_tpu.solvers import lanczos as _lanczos
    from lanczos_tpu.utils.random import fixed_seed_initializer

    n = 400
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    path = str(tmp_path / "filtered_state.npz")

    def cfg_hook(eng):
        eng.init_vector = fixed_seed_initializer(np.float32, 5)

    kwargs = dict(num_eigs=2, lo=-2.0, hi=2.0, mu=1e-3,  # band holds ~4 states
                  residual_bound=1e-30,  # never passes: forces the full
                  max_extra_rounds=2,    # extra-round ladder (3 rounds)
                  configure=cfg_hook)

    calls = {"n": 0}
    real_driver = _lanczos.deflation_driver

    def counting_driver(*a, **k):
        calls["n"] += 1
        return real_driver(*a, **k)

    def interrupting_driver(*a, **k):
        if calls["n"] >= 1:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return real_driver(*a, **k)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # uninterrupted reference run (no checkpoint)
        _lanczos_mod_attr = _filtered._lanczos
        _filtered._lanczos.deflation_driver = counting_driver
        try:
            vals_ref, _v, _i = filtered_lanczos(op, **kwargs)
            rounds_ref = calls["n"]

            # interrupted run: dies after round 1, checkpoint on disk
            calls["n"] = 0
            _filtered._lanczos.deflation_driver = interrupting_driver
            try:
                filtered_lanczos(op, checkpoint_path=path, **kwargs)
                raise AssertionError("interrupt did not fire")
            except KeyboardInterrupt:
                pass
            import os

            assert os.path.exists(path)

            # resume: replays the post-round-1 checks, runs ONLY the
            # remaining rounds
            calls["n"] = 0
            _filtered._lanczos.deflation_driver = counting_driver
            vals_res, _v2, _i2 = filtered_lanczos(op, checkpoint_path=path, **kwargs)
            rounds_resumed = calls["n"]
        finally:
            _filtered._lanczos.deflation_driver = real_driver
    assert rounds_resumed == rounds_ref - 1, (rounds_resumed, rounds_ref)
    # same problem, same seed: the resumed values match the reference run
    assert np.allclose(np.asarray(vals_res), np.asarray(vals_ref), atol=1e-5)
    exact = [-2 * np.cos((k + 1) * np.pi / (n + 1)) for k in range(2)]
    assert max(abs(float(vals_res[i]) - exact[i]) for i in range(2)) < 5e-3


def test_filtered_checkpoint_rejects_mismatched_config(tmp_path):
    import warnings

    import pytest

    from lanczos_tpu import DIAOperator, filtered_lanczos

    n = 200
    op = DIAOperator.from_diagonals(
        [-1, 1], [np.full(n, -1.0, np.float32)] * 2, n)
    path = str(tmp_path / "state.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        filtered_lanczos(op, num_eigs=2, lo=-2.0, hi=2.0, mu=1e-3,
                         checkpoint_path=path)
        with pytest.raises(ValueError, match="configuration changed"):
            filtered_lanczos(op, num_eigs=3, lo=-2.0, hi=2.0, mu=1e-3,
                             checkpoint_path=path)
