"""Native (C++) host kernels: tridiagonal eigensolver and sparse packing.

The reference is a header-only C++ library; its compute-dense host-side pieces
(the implicit-shift QR tridiagonal eigensolver,
lambda_lanczos_tridiagonal_impl.hpp:181-343, and data preparation) map here.
The device compute path itself lives in JAX; this package accelerates the
sequential host work that sits between device calls.
"""
