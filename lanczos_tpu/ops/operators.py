"""Linear-operator layer: the analogue of the reference's pluggable
``mv_mul`` closure (reference: include/lambda_lanczos/lambda_lanczos.hpp:120-126).

The reference's single best idea — the matrix is never materialized, the user
supplies a matrix-vector product — is preserved as a first-class protocol:
an operator is a pytree with a jittable, functional ``matvec(x) -> y``
(the reference's accumulate-into-``out`` contract becomes a pure function so
XLA can fuse and shard it).

Concrete operators mirror the reference sample zoo
(src/samples/sample1_simple.cpp dense, sample2_sparse.cpp COO tuples,
sample3_dynamic.cpp matrix-free, sample4_use_Eigen_library.cpp foreign
arrays) plus a BSR block-sparse format whose matvec streams dense tiles.

All operators are registered as JAX pytrees so engines can pass them through
``jax.jit`` boundaries as *arguments* (traced leaves), not captured constants.
"""

from __future__ import annotations

import dataclasses

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "LinearOperator",
    "FunctionOperator",
    "DenseOperator",
    "COOOperator",
    "CSROperator",
    "BSROperator",
    "DIAOperator",
    "SumOperator",
    "ScaledOperator",
    "ShiftSquaredOperator",
    "ShiftInvertOperator",
    "as_operator",
]


class LinearOperator:
    """Protocol: ``n`` (dimension), ``dtype``, and jittable ``matvec``.

    Operators may additionally provide ``matvec_df`` — a double-float matvec
    ``(x_hi, x_lo) -> (y_hi, y_lo)`` with error-free-transformation products
    and compensated accumulation, accurate to ~2^-45 relative in pure f32
    arithmetic.  The fused engine's ``precise_vectors`` mode (the path that
    reaches reference-grade eigenvalue tolerances with f32 storage)
    requires it; Dense/DIA/BSR/Sum/Scaled implement it.
    """

    n: int

    @property
    def dtype(self):
        raise NotImplementedError

    def matvec(self, x):
        raise NotImplementedError

    def matvec_df(self, x_hi, x_lo):
        raise NotImplementedError(
            f"{type(self).__name__} has no double-float matvec; precise_vectors "
            "needs a df-capable operator (Dense/DIA/BSR/Sum/Scaled), or implement "
            "matvec_df on your operator"
        )

    def __matmul__(self, x):
        return self.matvec(x)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FunctionOperator(LinearOperator):
    """Matrix-free operator from a user callable ``fn(x) -> A @ x``.

    Counterpart of the raw ``std::function`` matvec
    (lambda_lanczos.hpp:126, sample3_dynamic.cpp:17-22).  ``fn`` must be
    jax-traceable; it is the hot-loop device boundary.
    """

    fn: Callable
    n: int
    _dtype: np.dtype

    @property
    def dtype(self):
        return np.dtype(self._dtype)

    def matvec(self, x):
        return self.fn(x)

    def tree_flatten(self):
        return (), (self.fn, self.n, self._dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseOperator(LinearOperator):
    """Dense symmetric/Hermitian operator; matvec is one matmul.

    Counterpart of the dense sample (sample1_simple.cpp:22-28).  On a device
    mesh, shard ``a`` row-partitioned (PartitionSpec('rows', None)); XLA GSPMD
    then all-gathers the input vector over the mesh and keeps the output sharded.
    """

    a: jax.Array
    n: int = dataclasses.field(default=0)

    def __post_init__(self):
        if self.n == 0:
            self.n = int(self.a.shape[0])

    @property
    def dtype(self):
        return np.dtype(self.a.dtype)

    def matvec(self, x):
        # HIGHEST: an accelerator's default f32 matmul may run reduced-
        # precision passes (TF32 on the GPU) — unacceptable for the solver.
        return jnp.matmul(self.a, x, precision=jax.lax.Precision.HIGHEST)

    def matvec_df(self, x_hi, x_lo):
        """Double-float matvec: exact elementwise products (Dekker two_prod)
        reduced with a compensated pairwise tree, plus the
        f32-exactness-sufficient A @ x_lo correction."""
        from ..core import df64

        p, e = df64.two_prod(self.a, x_hi[None, :])
        e = e + self.a * x_lo[None, :]
        return df64.df_sum_axis(p, e, axis=-1)

    def tree_flatten(self):
        return (self.a,), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseDFOperator(LinearOperator):
    """Dense operator whose ENTRIES are df64 (hi, lo) word pairs.

    :class:`DenseOperator` stores the matrix in the storage dtype; for a
    matrix whose entries are NOT f32-representable (e.g. the reference's
    random-rotation zoo generators, lambda_lanczos_test.cpp:538-713), the
    `precise_vectors` engines then solve the ROUNDED matrix exactly — the
    eigenvalues floor at the ~1e-8 entry-rounding error (measured:
    hermitian10 on chip at 7.9e-9 with f32 entries), not at the engines'
    ~1e-14.  This operator carries the f64 matrix as two f32 words so the
    EFT matvec sees the full-precision entries.
    """

    a_hi: jax.Array
    a_lo: jax.Array
    n: int

    @classmethod
    def from_f64(cls, a64):
        a64 = np.asarray(a64, np.float64)
        hi = a64.astype(np.float32)
        lo = (a64 - hi.astype(np.float64)).astype(np.float32)
        return cls(jnp.asarray(hi), jnp.asarray(lo), int(a64.shape[0]))

    @property
    def dtype(self):
        return np.dtype(self.a_hi.dtype)

    def matvec(self, x):
        # hi product + lo correction: ~1 ulp better than a plain f32 matvec
        # (the engines' plain paths only need storage-dtype accuracy here).
        y = jnp.matmul(self.a_hi, x, precision=jax.lax.Precision.HIGHEST)
        return y + jnp.matmul(self.a_lo, x, precision=jax.lax.Precision.HIGHEST)

    def matvec_df(self, x_hi, x_lo):
        from ..core import df64

        p, e = df64.two_prod(self.a_hi, x_hi[None, :])
        e = e + self.a_hi * x_lo[None, :] + self.a_lo * x_hi[None, :]
        e = e + self.a_lo * x_lo[None, :]
        return df64.df_sum_axis(p, e, axis=-1)

    def tree_flatten(self):
        return (self.a_hi, self.a_lo), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


def _gather_matvec_df(vals, cols, rows, n, x_hi, x_lo):
    """Double-float gather/segment matvec shared by COO and CSR.

    Each nonzero's product is made exact by Dekker two_prod, but a plain f32
    ``segment_sum`` would round every accumulation back to the f32 floor —
    the one reduction XLA offers no compensated form of.  The honest route
    is an f64 segmented reduction; these are the PORTABLE formats, so
    correctness beats speed here — the production pv paths are BSR/DIA,
    whose matvec_df is EFT end-to-end.
    Requires x64 (raises with guidance otherwise: without jax_enable_x64 the
    f64 cast silently degrades to f32 and the pv accuracy promise would be
    silently broken).
    """
    from ..core import df64

    if not jax.config.read("jax_enable_x64"):
        raise NotImplementedError(
            "COO/CSR matvec_df needs an f64 segmented reduction: enable x64 "
            "(jax.config.update('jax_enable_x64', True)) or convert the "
            "operator with .to_bsr() / DIAOperator for the EFT path"
        )
    xh = x_hi[cols]
    xl = x_lo[cols]
    p, e = df64.two_prod(vals, xh)
    e = e + vals * xl
    tot = jax.ops.segment_sum(
        p.astype(jnp.float64) + e.astype(jnp.float64), rows, num_segments=n
    )
    hi = tot.astype(x_hi.dtype)
    lo = (tot - hi.astype(jnp.float64)).astype(x_hi.dtype)
    return hi, lo


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class COOOperator(LinearOperator):
    """COO sparse operator: y = segment_sum(vals * x[cols], rows).

    Counterpart of the tuple-list sample (sample2_sparse.cpp:43-47).  This is
    the portable (XLA gather/scatter) path; convert to :class:`BSROperator`
    for the streaming tile path.
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    n: int

    @classmethod
    def from_arrays(cls, rows, cols, vals, n):
        return cls(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), int(n))

    @property
    def dtype(self):
        return np.dtype(self.vals.dtype)

    def matvec(self, x):
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(prod, self.rows, num_segments=self.n)

    def matvec_df(self, x_hi, x_lo):
        return _gather_matvec_df(self.vals, self.cols, self.rows, self.n, x_hi, x_lo)

    def to_dense(self):
        a = jnp.zeros((self.n, self.n), dtype=self.vals.dtype)
        return a.at[self.rows, self.cols].add(self.vals)

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CSROperator(LinearOperator):
    """CSR sparse operator (indptr/indices/data, scipy layout).

    Portable XLA path: the row index of every nonzero is recovered once at
    construction (``row_of_nnz``) so the matvec is the same gather +
    segment-sum as COO — CSR's sequential per-row loop is hostile to XLA's
    static-shape model, while the flattened form vectorizes.  Convert to
    :class:`BSROperator` (:meth:`to_bsr`) for the streaming tile path.
    """

    indptr: jax.Array  # (n+1,) int
    indices: jax.Array  # (nnz,) int
    data: jax.Array  # (nnz,)
    n: int
    row_of_nnz: jax.Array = None  # (nnz,) int32, derived

    def __post_init__(self):
        if self.row_of_nnz is None:
            counts = np.diff(np.asarray(self.indptr))
            self.row_of_nnz = jnp.asarray(np.repeat(np.arange(self.n), counts).astype(np.int32))

    @classmethod
    def from_scipy(cls, mat):
        """From any scipy.sparse matrix (converted to CSR)."""
        csr = mat.tocsr()
        return cls(jnp.asarray(csr.indptr), jnp.asarray(csr.indices), jnp.asarray(csr.data), int(csr.shape[0]))

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    def matvec(self, x):
        prod = self.data * x[self.indices]
        return jax.ops.segment_sum(prod, self.row_of_nnz, num_segments=self.n)

    def matvec_df(self, x_hi, x_lo):
        return _gather_matvec_df(self.data, self.indices, self.row_of_nnz, self.n, x_hi, x_lo)

    def to_bsr(self, **kwargs):
        return BSROperator.from_coo(
            np.asarray(self.row_of_nnz), np.asarray(self.indices), np.asarray(self.data),
            self.n, dtype=kwargs.pop("dtype", self.dtype), **kwargs,
        )

    def tree_flatten(self):
        return (self.indptr, self.indices, self.data, self.row_of_nnz), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], children[3])


def bsr_matvec(blocks, col_blocks, x):
    """y = A x for BSR tiles ``blocks`` (R, S, bm, bk) and block-column
    indices ``col_blocks`` (R, S) against the padded ``x`` (R*bm,).

    precision=HIGHEST is mandatory: a default f32 einsum may run
    reduced-precision passes (TF32 on the GPU), ~1e-3 relative matvec error
    that poisons eigenvalues.  The op is bandwidth-bound, so full precision
    costs nothing.  XLA fuses the gather, the multiply and the (S, bk)
    reduction into one pass over the tiles (no transposed copy).
    """
    bk = blocks.shape[3]
    xg = x.reshape(-1, bk)[col_blocks]  # (R, S, bk) gather of needed segments
    acc = jnp.promote_types(blocks.dtype, jnp.float32)
    y = jnp.einsum(
        "rsmk,rsk->rm", blocks, xg, preferred_element_type=acc,
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(-1).astype(x.dtype)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BSROperator(LinearOperator):
    """Block-sparse-row operator: dense tiles streamed from device memory.

    A scattered scalar gather per nonzero streams poorly; a sparse matvec
    becomes bandwidth-bound when nonzeros are grouped into dense
    (bm x bk) tiles that are streamed contiguously and multiplied against
    gathered input segments.  Layout (ELL-like, padded per row-block):

    * ``blocks``      (n_row_blocks, max_blocks_per_row, bm, bk) dense tiles
    * ``col_blocks``  (n_row_blocks, max_blocks_per_row) int32 column-block
      index of each tile; padding tiles point at block 0 with all-zero values.

    The matvec is one XLA gather + einsum (:func:`bsr_matvec`).  On one
    H100 it streams 64 Mi stored f32 nonzeros at the card's read rate; the
    pre-transposed (R, bm, S, bk) layout and a hand-written Triton kernel
    measured no faster (PERF.md, "Kernel decisions on the H100").

    Tile-size guidance: storage per row is (#column-blocks the row's block
    row touches) * bk, so for banded/local operators bm=128 costs the same
    memory as bm=8 and is much faster; for pathologically scattered
    patterns a large bm unions column sets over more rows — drop to bm=8 if
    the pack inflates.

    ``dtype=jnp.bfloat16`` halves the tile stream at ~0.4% relative element
    rounding — pair with df64 alpha/beta reductions when eigenvalue
    tolerances allow matvec-level noise.  Accumulation stays float32
    (``preferred_element_type``).
    """

    blocks: jax.Array
    col_blocks: jax.Array
    n: int

    @property
    def dtype(self):
        return np.dtype(self.blocks.dtype)

    @property
    def bm(self):
        return self.blocks.shape[2]

    @property
    def bk(self):
        return self.blocks.shape[3]

    @property
    def s_max(self):
        """Stored tiles per row block (padding included)."""
        return self.blocks.shape[1]

    @property
    def n_padded(self):
        return self.blocks.shape[0] * self.bm

    @property
    def nnz_dense(self):
        """Number of stored (padded) nonzeros = what the matvec streams."""
        return int(np.prod(self.blocks.shape))

    @classmethod
    def from_coo(cls, rows, cols, vals, n, *, bm: int = 128, bk: int = 128, dtype=jnp.float32):
        """Pack COO triplets (duplicates summed) into the padded BSR layout.

        Uses the native C++ packer when available, else numpy.
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        if np.iscomplexobj(vals) and not np.issubdtype(np.dtype(dtype), np.complexfloating):
            raise TypeError(
                f"complex values with real block dtype {np.dtype(dtype)} would silently "
                "drop the imaginary parts; pass dtype=jnp.complex64/complex128"
            )
        # n_pad must be divisible by BOTH tile dims: max(bm, bk) alone broke
        # packing whenever the smaller dim does not divide the larger
        # (e.g. bm=6, bk=4 -> n_pad=6, block row ids out of range).
        q = int(np.lcm(bm, bk))
        n_pad = int(-(-n // q) * q)
        n_row_blocks = n_pad // bm
        n_col_blocks = n_pad // bk

        block_ids, dense_blocks = _pack_blocks(rows, cols, vals, n_col_blocks, bm, bk, np.dtype(dtype))

        rb = block_ids // n_col_blocks
        cb = block_ids % n_col_blocks
        counts = np.bincount(rb, minlength=n_row_blocks)
        max_per_row = max(int(counts.max(initial=0)), 1)

        blocks = np.zeros((n_row_blocks, max_per_row, bm, bk), dtype=np.dtype(dtype))
        col_blocks = np.zeros((n_row_blocks, max_per_row), dtype=np.int32)
        slot = np.zeros(n_row_blocks, dtype=np.int64)
        for i in range(block_ids.shape[0]):
            r = rb[i]
            s = slot[r]
            blocks[r, s] = dense_blocks[i]
            col_blocks[r, s] = cb[i]
            slot[r] += 1
        return cls(jnp.asarray(blocks), jnp.asarray(col_blocks), int(n))

    def matvec(self, x):
        n_pad = self.n_padded
        xp = jnp.pad(x, (0, n_pad - x.shape[0])) if x.shape[0] != n_pad else x
        return bsr_matvec(self.blocks, self.col_blocks, xp)[: self.n]

    def matvec_df(self, x_hi, x_lo):
        """Double-float BSR matvec: two_prod per stored element, compensated
        tree reduction over the (S, bk) contraction.  Streams the tiles once
        (same HBM traffic as the plain matvec); the extra VPU flops
        (~10x 2 flops/nnz) trade throughput for ~2^-45 accuracy."""
        from ..core import df64

        n_pad = self.n_padded
        pad = n_pad - x_hi.shape[0]
        if pad:
            x_hi = jnp.pad(x_hi, (0, pad))
            x_lo = jnp.pad(x_lo, (0, pad))
        r, s, bm, bk = self.blocks.shape
        xg_hi = x_hi.reshape(-1, bk)[self.col_blocks][:, :, None, :]  # (R,S,1,bk)
        xg_lo = x_lo.reshape(-1, bk)[self.col_blocks][:, :, None, :]
        p, e = df64.two_prod(self.blocks, xg_hi)
        e = e + self.blocks * xg_lo
        # reduce over bk then S: (R,S,bm,bk) -> (R,bm,S*bk) -> (R,bm)
        p = jnp.moveaxis(p, 1, 2).reshape(r, bm, s * bk)
        e = jnp.moveaxis(e, 1, 2).reshape(r, bm, s * bk)
        y_hi, y_lo = df64.df_sum_axis(p, e, axis=-1)
        return y_hi.reshape(-1)[: self.n], y_lo.reshape(-1)[: self.n]

    def tree_flatten(self):
        return (self.blocks, self.col_blocks), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DIAOperator(LinearOperator):
    """Diagonal (DIA/banded) operator: the fastest format for stencils.

    For banded Hamiltonians (hopping chains, finite-difference Laplacians,
    …) every other sparse format pads massively: a 2-nnz-per-row chain
    stored as 128x128 BSR tiles streams ~256x more bytes than its true nnz.
    DIA stores one length-n vector per nonzero diagonal and the matvec is
    pure streaming — ndiag fused multiply-shift-adds, zero gathers, traffic
    O(ndiag * n):

        y[i] = sum_d  data[d][i] * x[i + offsets[d]]

    i.e. ``data[d][i]`` is A[i, i + offsets[d]] (scipy.sparse.dia
    row-aligned convention transposed to row-major access).  Offsets are
    static Python ints, so XLA sees a short chain of shifted elementwise
    ops and fuses them into one pass.
    """

    offsets: tuple  # static tuple of python ints
    data: jax.Array  # (ndiag, n); data[d, i] = A[i, i + offsets[d]]
    n: int

    @classmethod
    def from_diagonals(cls, offsets, diagonals, n):
        """``diagonals[d]`` is the length-n array with A[i, i+offsets[d]]
        at position i (entries running off the matrix are ignored)."""
        data = jnp.stack([jnp.asarray(diag) for diag in diagonals])
        return cls(tuple(int(o) for o in offsets), data, int(n))

    @classmethod
    def from_coo(cls, rows, cols, vals, n, *, dtype=None):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        offs = np.unique(cols - rows)
        data = np.zeros((offs.shape[0], n), dtype=vals.dtype if dtype is None else np.dtype(dtype))
        for j, d in enumerate(offs):
            m = (cols - rows) == d
            np.add.at(data[j], rows[m], vals[m])
        return cls(tuple(int(o) for o in offs), jnp.asarray(data), int(n))

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def ndiag(self):
        return len(self.offsets)

    def matvec(self, x):
        # Padded-x formulation: every diagonal reads a static slice of ONE
        # padded buffer and the partial products fuse into a single
        # elementwise pass.
        n = self.n
        offs = self.offsets
        lo = max([0] + [-d for d in offs])
        hi = max([0] + [d for d in offs])
        xp = jnp.pad(x, (lo, hi)) if (lo or hi) else x
        y = jnp.zeros_like(x)
        for j, d in enumerate(offs):
            # The vector dtype governs O(n) arithmetic: coerce the diagonal
            # so an f64-built operator driven by an f32 engine doesn't mix
            # dtypes (a future hard error in jax).
            row = self.data[j].astype(x.dtype)
            # Entries running off the matrix edge read the zero padding, but
            # the stored diagonal may carry junk there — mask it once.
            if d > 0:
                row = row.at[n - d :].set(0)
            elif d < 0:
                row = row.at[: -d].set(0)
            y = y + row * jax.lax.slice_in_dim(xp, lo + d, lo + d + n)
        return y

    def matvec_df(self, x_hi, x_lo):
        """Double-float banded matvec: per-diagonal two_prod with a running
        compensated (df) accumulator — pure elementwise streaming."""
        from ..core import df64

        n = self.n
        y = (jnp.zeros_like(x_hi), jnp.zeros_like(x_hi))

        def shifted(x, d):
            if d == 0:
                return x
            if d > 0:
                return jnp.concatenate([x[d:], jnp.zeros((d,), x.dtype)])
            return jnp.concatenate([jnp.zeros((-d,), x.dtype), x[: n + d]])

        for j, d in enumerate(self.offsets):
            row = self.data[j]
            if d > 0:
                row = row.at[n - d :].set(0)
            elif d < 0:
                row = row.at[: -d].set(0)
            xs_hi = shifted(x_hi, d)
            xs_lo = shifted(x_lo, d)
            p, e = df64.two_prod(row, xs_hi)
            e = e + row * xs_lo
            y = df64.df_add(y, (p, e))
        return y

    def to_dense(self):
        a = jnp.zeros((self.n, self.n), self.data.dtype)
        for j, d in enumerate(self.offsets):
            i = jnp.arange(max(0, -d), self.n - max(0, d))
            a = a.at[i, i + d].set(self.data[j, i])
        return a

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], children[0], aux[1])


def _pack_blocks(rows, cols, vals, n_col_blocks, bm, bk, target_dtype=np.float32):
    """COO -> (sorted unique block ids, dense blocks); native C++ or numpy.

    The native path packs in the target dtype (f32 or f64); complex targets
    fall back to numpy.
    """
    try:
        from ..native import host_kernels

        target = np.dtype(target_dtype)
        if (
            host_kernels.available()
            and not np.issubdtype(vals.dtype, np.complexfloating)
            and not np.issubdtype(target, np.complexfloating)
        ):
            pack_dtype = np.float64 if target.itemsize > 4 else np.float32
            return host_kernels.pack_bsr(rows, cols, vals, n_col_blocks, bm, bk, dtype=pack_dtype)
    except Exception:
        pass
    ids = (rows // bm) * n_col_blocks + (cols // bk)
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    block_ids, starts = np.unique(ids_sorted, return_index=True)
    nblocks = block_ids.shape[0]
    blocks = np.zeros((nblocks, bm, bk), dtype=vals.dtype)
    slot_of = {int(b): i for i, b in enumerate(block_ids)}
    for i in range(rows.shape[0]):
        s = slot_of[int(ids[i])]
        blocks[s, rows[i] % bm, cols[i] % bk] += vals[i]
    return block_ids, blocks


def as_operator(op, n=None, dtype=None):
    """Coerce an array / callable / operator into a :class:`LinearOperator`."""
    if isinstance(op, LinearOperator):
        return op
    if callable(op):
        if n is None or dtype is None:
            raise ValueError("FunctionOperator needs explicit n and dtype")
        return FunctionOperator(op, int(n), np.dtype(dtype))
    arr = jnp.asarray(op)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"expected a square matrix, got shape {arr.shape}")
    return DenseOperator(arr)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SumOperator(LinearOperator):
    """A + B as an operator (e.g. H = H_hop + H_interaction); terms may be
    different formats (DIA + COO, dense + function, ...)."""

    terms: tuple

    @property
    def n(self):
        return self.terms[0].n

    @n.setter
    def n(self, value):  # dataclass/pytree plumbing; n is derived
        pass

    @property
    def dtype(self):
        return np.dtype(np.result_type(*[t.dtype for t in self.terms]))

    def matvec(self, x):
        y = self.terms[0].matvec(x)
        for t in self.terms[1:]:
            y = y + t.matvec(x)
        return y

    def matvec_df(self, x_hi, x_lo):
        from ..core import df64

        y = self.terms[0].matvec_df(x_hi, x_lo)
        for t in self.terms[1:]:
            y = df64.df_add(y, t.matvec_df(x_hi, x_lo))
        return y

    def tree_flatten(self):
        return (self.terms,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ScaledOperator(LinearOperator):
    """c * A + shift * I as an operator (spectral shift-and-scale)."""

    base: LinearOperator
    scale: float = 1.0
    shift: float = 0.0

    @property
    def n(self):
        return self.base.n

    @n.setter
    def n(self, value):
        pass

    @property
    def dtype(self):
        return self.base.dtype

    def matvec(self, x):
        y = self.base.matvec(x)
        if self.scale != 1.0:
            y = jnp.asarray(self.scale, y.dtype) * y
        if self.shift != 0.0:
            y = y + jnp.asarray(self.shift, x.dtype) * x
        return y

    def matvec_df(self, x_hi, x_lo):
        from ..core import df64

        y = self.base.matvec_df(x_hi, x_lo)
        rdtype = y[0].dtype

        def _host_split(v):
            # scale/shift are static Python floats: split on HOST in real
            # float64.  jnp.asarray(..., jnp.float64) silently truncates to
            # f32 when jax_enable_x64 is off (the default config),
            # which zeroed the lo word and capped the df64 path at ~1e-8.
            hi = np.float32(v) if np.dtype(rdtype) == np.float32 else np.float64(v)
            lo = np.float64(v) - np.float64(hi)
            return jnp.asarray(hi, rdtype), jnp.asarray(lo, rdtype)

        if self.scale != 1.0:
            y = df64.df_mul(y, _host_split(self.scale))
        if self.shift != 0.0:
            term = df64.df_mul((x_hi, x_lo), _host_split(self.shift))
            y = df64.df_add(y, term)
        return y

    def tree_flatten(self):
        return (self.base,), (self.scale, self.shift)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShiftSquaredOperator(LinearOperator):
    """``(A - sigma I)^2`` — the POLYNOMIAL spectral transform for interior
    targets: eigenvalues of A nearest ``sigma`` map to the BOTTOM edge of
    the squared spectrum, where the filtered engines (and the inverse-map
    refinement) apply.  Two base matvecs per application, NO linear solves
    — contrast :class:`ShiftInvertOperator`, whose inner MINRES caps
    accuracy at the f32 solve floor and breaks when ``sigma`` sits ON an
    eigenvalue (here that case is the best-conditioned one: the target
    maps to exactly 0, the most amplified point of the band).
    """

    base: LinearOperator
    sigma: float = 0.0

    @property
    def n(self):
        return self.base.n

    @n.setter
    def n(self, value):  # derived
        pass

    @property
    def dtype(self):
        return self.base.dtype

    def _shift(self, y, x):
        return y - jnp.asarray(self.sigma, y.dtype) * x

    def matvec(self, x):
        w = self._shift(self.base.matvec(x), x)
        return self._shift(self.base.matvec(w), w)

    def matvec_df(self, x_hi, x_lo):
        from ..core import df64

        rdtype = None

        def shift_df(y, xd):
            # sigma split on HOST (x64-disabled runtimes truncate a traced
            # f64 silently — same hazard as ScaledOperator above)
            hi = np.float32(self.sigma) if np.dtype(y[0].dtype) == np.float32 else np.float64(self.sigma)
            lo = np.float64(self.sigma) - np.float64(hi)
            sig = (jnp.asarray(hi, y[0].dtype), jnp.asarray(lo, y[0].dtype))
            return df64.df_sub(y, df64.df_mul(xd, sig))

        w = shift_df(self.base.matvec_df(x_hi, x_lo), (x_hi, x_lo))
        return shift_df(self.base.matvec_df(*w), w)

    def tree_flatten(self):
        return (self.base,), (self.sigma,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


@jax.tree_util.register_pytree_node_class
class ShiftInvertOperator(LinearOperator):
    """``(A - sigma I)^{-1}`` applied matrix-free by an inner MINRES solve.

    The shift-invert spectral transform behind ``eigsh(sigma=...)``: the
    eigenvalues of this operator are ``1 / (lambda_i - sigma)``, so the
    eigenvalues of ``A`` NEAREST ``sigma`` become the extremal (and
    well-separated) ones — Lanczos on the transformed operator converges in
    a handful of iterations where direct Lanczos on ``A`` would need the
    whole spectrum resolved.  A factorization-based backend does an LU solve
    per matvec; the matrix-free device path runs MINRES (indefinite-safe, one
    ``lax.while_loop``, O(n) memory) — see :mod:`lanczos_tpu.solvers.minres`.

    ``sigma`` is a traced leaf: re-running with a different shift reuses the
    compiled program.  ``inner_tol``/``inner_maxiter`` bound the inner solve
    (static).  The outer eigensolver's accuracy floor is the inner residual:
    keep ``inner_tol`` at least ~100x below the outer ``eps``.
    """

    def __init__(self, op, sigma, inner_tol: float = 1e-8, inner_maxiter: int = 500):
        self.op = op
        self.sigma = sigma
        self.inner_tol = float(inner_tol)
        self.inner_maxiter = int(inner_maxiter)

    @property
    def n(self):
        return self.op.n

    @property
    def dtype(self):
        return self.op.dtype

    def matvec(self, x):
        from ..solvers.minres import minres

        y, _relres, _iters = minres(
            self.op, x, shift=self.sigma, tol=self.inner_tol, maxiter=self.inner_maxiter
        )
        return y

    def tree_flatten(self):
        return (self.op, self.sigma), (self.inner_tol, self.inner_maxiter)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)
