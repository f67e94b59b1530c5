"""Observability: iteration stats and profiler hooks.

The reference's only built-in observability is per-restart iteration counts
(``getIterationCounts``, lambda_lanczos.hpp:187, :412-414).  This library
keeps that and adds wall-clock timing plus optional ``jax.profiler`` trace
annotation around the hot loop.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax

__all__ = ["RunStats", "trace_span", "vector_to_string"]


@dataclasses.dataclass
class RunStats:
    iteration_counts: list[int] = dataclasses.field(default_factory=list)
    wall_time_s: float = 0.0
    # Number of small tridiagonal blocks whose native QL sweep hit the
    # iteration cap during this run (the reference's forced-break count,
    # tridiagonal_impl.hpp:290-343); 0 means every host solve converged.
    tridiag_unconverged: int = 0
    # Fused-engine iterations that ran a basis reorthogonalization this run:
    # == total_iterations under reorth_policy='full'; under 'selective' the
    # ratio reorth_count/total_iterations is the omega-trigger rate (the
    # knob-tuning signal for selective reorthogonalization).  0 for engines
    # that don't report it (hybrid/block/thick-host).
    reorth_count: int = 0
    # Deflation rounds that exhausted their restart/iteration budget with the
    # Ritz values still moving — the result may be budget-limited, not
    # eps-converged (check api.residuals).  0 means every round settled.
    unconverged_rounds: int = 0

    @property
    def total_iterations(self) -> int:
        return int(sum(self.iteration_counts))


@contextlib.contextmanager
def trace_span(name: str):
    """Annotate a region for the JAX/XLA profiler."""
    with jax.profiler.TraceAnnotation(name):
        yield


def vector_to_string(v, digits: int = 16) -> str:
    """Space-joined repr of a vector (reference ``util::vectorToString``,
    include/lambda_lanczos/util/common.hpp:206-221)."""
    import numpy as np

    return " ".join(f"{x:.{digits}g}" for x in np.asarray(v).ravel())
