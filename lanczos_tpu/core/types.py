"""Dtype policy and scalar-type utilities.

Re-think of the reference's type layer
(reference: include/lambda_lanczos/util/common.hpp:80-134 — ``real_t<T>`` and
``typed_conj``): eigenvalues, alpha/beta recurrence scalars and tolerances are
always *real* even when the operator is complex Hermitian, and inner products
must conjugate their first argument.

The dtype policy is explicit: the *vector dtype* (storage of Krylov vectors and
the operator) and the *solver dtype* (the small tridiagonal eigenproblem and
convergence scalars) are chosen independently.  The solver dtype defaults to
float64, which is cheap because everything at that level is O(m^2) for the
Krylov dimension m.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "real_dtype",
    "is_complex_dtype",
    "machine_eps",
    "default_lanczos_eps",
    "default_exponentiator_eps",
    "typed_conj",
]


def real_dtype(dtype) -> np.dtype:
    """Map a (possibly complex) dtype to its real counterpart.

    Analogue of ``util::real_t<T>`` (reference:
    include/lambda_lanczos/util/common.hpp:80-102).
    """
    dtype = np.dtype(dtype)
    if dtype == np.complex64:
        return np.dtype(np.float32)
    if dtype == np.complex128:
        return np.dtype(np.float64)
    return dtype


def is_complex_dtype(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def machine_eps(dtype) -> float:
    """Machine epsilon of the *real* counterpart of ``dtype``."""
    return float(np.finfo(real_dtype(dtype)).eps)


def default_lanczos_eps(dtype) -> float:
    """Default eigensolver convergence threshold.

    Mirrors the reference default ``machine_eps * 1e3``
    (reference: include/lambda_lanczos/lambda_lanczos.hpp:150), i.e. ~2.2e-13
    for float64/complex128 and ~1.2e-4 for float32/complex64.
    """
    return machine_eps(dtype) * 1e3


def default_exponentiator_eps(dtype) -> float:
    """Default exponentiator convergence threshold, ``machine_eps * 1e2``
    (reference: include/lambda_lanczos/exponentiator.hpp:58)."""
    return machine_eps(dtype) * 1e2


def typed_conj(x):
    """Conjugate that is a no-op for real arrays.

    Analogue of ``util::typed_conj`` (reference:
    include/lambda_lanczos/util/common.hpp:112-134).  jnp.conj is already a
    no-op on real dtypes, but routing through one symbol keeps the intent
    greppable and lets us specialize later (e.g. split-complex storage).
    """
    return jnp.conj(x) if is_complex_dtype(x.dtype) else x
