"""Checkpoint / resume for long-running solves.

The reference has no checkpointing (SURVEY.md §5: engines are stateless
between ``run()`` calls).  For production runs — large n, many deflated
restarts — the natural checkpoint boundary is *between restarts*: the state
is exactly the accepted eigenpairs (the :class:`EigenPairManager` content)
plus the iteration counts.  Everything inside one restart is rebuilt in
seconds; everything across restarts is hours of accumulated matvecs.

Format: a single ``.npz`` (portable, no orbax dependency) with the
eigenvalues, the eigenvector block, find_maximum/num_eigs, and the
per-restart iteration counts.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["save_state", "load_state", "CheckpointedRun"]

_FORMAT_VERSION = 1


def _npz_path(path) -> str:
    """np.savez appends '.npz' to suffix-less paths; canonicalize so save,
    load and exists() all agree on the actual on-disk name."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path, manager, iteration_counts, *, extra: dict | None = None) -> None:
    """Write the deflation state of a run (the EigenPairManager content)."""
    vals = np.asarray(manager.eigenvalues(), dtype=np.float64)
    vecs = (
        np.stack([np.asarray(v) for v in manager.eigenvectors()])
        if manager.pairs
        else np.zeros((0, 0))
    )
    import os
    import tempfile

    target = _npz_path(path)
    # Atomic write: a crash mid-savez (the exact scenario checkpoints exist
    # for) must not leave a truncated file that blocks every future resume.
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(target) or ".")
    os.close(fd)
    try:
        np.savez(
            tmp[:-4],  # savez re-appends .npz
            format_version=_FORMAT_VERSION,
            eigenvalues=vals,
            eigenvectors=vecs,
            find_maximum=np.asarray(manager.find_maximum),
            num_eigs=np.asarray(manager.num_eigs),
            iteration_counts=np.asarray(iteration_counts, dtype=np.int64),
            **{f"extra_{k}": np.asarray(v) for k, v in (extra or {}).items()},
        )
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path, dtype=None, *, with_finished: bool = False,
               with_extras: bool = False):
    """Read a checkpoint -> (manager, iteration_counts[, finished][, extras]).

    ``dtype`` converts the stored eigenvectors back to the solve dtype.
    ``finished`` reports whether the saved run had reached the deflation
    fixed point (False for checkpoints written before the flag existed).
    ``with_extras`` additionally returns every ``extra_*`` field saved by
    the caller (as a plain dict of numpy values) — the filtered driver's
    round-loop state lives there.
    """
    from ..solvers.lanczos import EigenPairManager

    with np.load(_npz_path(path)) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than this library")
        manager = EigenPairManager(bool(z["find_maximum"]), int(z["num_eigs"]))
        vals = z["eigenvalues"]
        vecs = z["eigenvectors"]
        for i in range(vals.shape[0]):
            v = jnp.asarray(vecs[i], dtype) if dtype is not None else jnp.asarray(vecs[i])
            manager.insert([float(vals[i])], [v])
        counts = [int(c) for c in z["iteration_counts"]]
        finished = bool(z["extra_finished"]) if "extra_finished" in z else False
        extras = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    out = [manager, counts]
    if with_finished:
        out.append(finished)
    if with_extras:
        out.append(extras)
    return tuple(out)


class CheckpointedRun:
    """Drive a :class:`~lanczos_tpu.api.LambdaLanczos` with periodic
    checkpoints: saves after every deflated restart, resumes if the file
    exists.

    >>> run = CheckpointedRun(engine, "state.npz")
    >>> eigenvalues, eigenvectors = run.run()
    """

    def __init__(self, engine, path):
        self.engine = engine
        self.path = path

    def run(self):
        import os

        from ..solvers import lanczos as _lanczos

        eng = self.engine
        cfg = eng._config().resolved(eng.dtype)

        if os.path.exists(_npz_path(self.path)):
            manager, iter_counts, finished = load_state(self.path, eng.dtype, with_finished=True)
            if finished:
                # The saved run reached the deflation fixed point (the crash
                # window between the final save and run() returning): resume
                # by returning the stored result — re-running would burn a
                # whole extra deflated restart just to re-hit nothing_added.
                eng._iteration_counts = iter_counts
                vals = np.asarray(manager.eigenvalues())
                vecs = (
                    jnp.stack(manager.eigenvectors())
                    if manager.pairs
                    else jnp.zeros((0, eng.matrix_size), eng.dtype)
                )
                return vals, vecs
        else:
            manager, iter_counts = None, None

        # The exact engine selection run() would make (fused/hybrid/thick/
        # block) via the shared dispatch point.
        iterate_one, v0_rows, use_warm = eng._iterate_factory(cfg)
        result = _lanczos.deflation_driver(
            iterate_one, cfg, eng._init_fn(), eng.dtype,
            v0_rows=v0_rows, use_warm_restarts=use_warm,
            manager=manager, iter_counts=iter_counts,
            after_round=lambda mgr, counts, fin: save_state(
                self.path, mgr, counts, extra={"finished": fin}
            ),
        )
        eng._iteration_counts = result.iteration_counts
        return result.eigenvalues, result.eigenvectors
