"""Sparse NDArrays: CSR and row-sparse storage (counterpart of
``mxnet_tpu/ndarray/sparse.py``), exported as ``mx.nd.sparse``.

Sparse here is a storage and communication format, as in the JAX
package: embedding-gradient rows riding the kvstore
(``row_sparse_pull`` moves k rows, not the table), lazy optimizer
updates touching only the live rows, CSR batches of libsvm-style data.
Compute lowers to dense gather, scatter and segment sums with static
output shapes: ``CSRNDArray.todense`` is an accumulating
``index_put_``, :func:`dot` an ``index_add`` over the nonzeros (whose
float atomics on the card sum in no fixed order: hold it to a
tolerance, not bitwise).

Storage rules of the JAX package: indices are int32; a float64 dtype
becomes float32; a dense input keeps float32 or float16 and anything
else becomes float32 unless a dtype is given; duplicate coordinates sum
when densified.  The row union of :func:`elemwise_add` is exact and
host-side (the index arrays are read back), as the JAX package's is.
:meth:`RowSparseNDArray.retain` finds each kept row by a binary search
over a stable sort of the stored ids, so it never builds a kept x stored
table: a present row takes its first matching stored row, an absent row
is zero, an empty store gives zeros.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import _NP_DTYPES, NDArray, invoke

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "add", "array", "csr_matrix", "dot", "elemwise_add", "retain",
           "row_sparse_array", "zeros"]


def _np_dtype(dtype):
    """A numpy dtype from a numpy, torch or string dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_DTYPES[dtype])
    return np.dtype(dtype)


def _tensor(x, dtype, device):
    """``x`` (an NDArray, a tensor or an array-like) as a tensor of the
    numpy ``dtype`` on ``device``."""
    if isinstance(x, NDArray):
        x = x._data
    tdt = getattr(torch, np.dtype(dtype).name)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, tdt)
    return torch.from_numpy(np.array(x, dtype)).to(device)


class BaseSparseNDArray:
    """The surface both sparse storage types share."""

    stype = None

    def __init__(self, shape, dtype, ctx):
        self.shape = tuple(int(s) for s in shape)
        dtype = _np_dtype(dtype)
        if dtype == np.float64:
            dtype = np.dtype(np.float32)
        self.dtype = dtype
        self._ctx = Context(ctx) if ctx is not None else current_context()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def ndim(self):
        return len(self.shape)

    def _device(self):
        return self._ctx.torch_device()

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype):
        raise NotImplementedError

    def todense(self) -> NDArray:
        """The dense array (``tostype('default')``)."""
        raise NotImplementedError

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == self.stype:
            return self
        raise MXNetError("cannot convert %s to %s directly"
                         % (self.stype, stype))

    def copyto(self, other):
        raise MXNetError("copyto on sparse arrays: densify first "
                         "(tostype('default'))")

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self.shape)), self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix: ``indptr`` (rows + 1,),
    ``indices`` (nnz,) and ``data`` (nnz,)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        dtype = dtype or getattr(data, "dtype", np.float32)
        super().__init__(shape, dtype, ctx)
        if len(self.shape) != 2:
            raise MXNetError("CSR arrays are 2-D")
        dev = self._device()
        self._csr_data = _tensor(data, self.dtype, dev)
        self._csr_indices = _tensor(indices, np.int32, dev)
        self._csr_indptr = _tensor(indptr, np.int32, dev)

    @property
    def data(self):
        return NDArray(self._csr_data)

    @property
    def indices(self):
        return NDArray(self._csr_indices)

    @property
    def indptr(self):
        return NDArray(self._csr_indptr)

    @property
    def nnz(self):
        return int(self._csr_data.shape[0])

    def todense(self):
        dense = torch.zeros(self.shape, dtype=self._csr_data.dtype,
                            device=self._csr_data.device)
        dense.index_put_((self._row_ids().long(), self._csr_indices.long()),
                         self._csr_data, accumulate=True)
        return NDArray(dense)

    def astype(self, dtype):
        return CSRNDArray(self._csr_data, self._csr_indices,
                          self._csr_indptr, self.shape, dtype, self._ctx)

    def _row_ids(self):
        """The row of each nonzero, from ``indptr``."""
        nz = torch.arange(self.nnz, dtype=torch.int32,
                          device=self._csr_indptr.device)
        return torch.searchsorted(self._csr_indptr, nz, right=True,
                                  out_int32=True) - 1

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise MXNetError("CSR slicing supports step 1 only")
            start = key.start or 0
            stop = self.shape[0] if key.stop is None else key.stop
            d = self.todense().asnumpy()[start:stop]
            return csr_matrix(d, ctx=self._ctx, dtype=self.dtype)
        raise MXNetError("CSR indexing supports row slices only")


class RowSparseNDArray(BaseSparseNDArray):
    """A subset of rows: ``indices`` (k,) row ids and ``data`` (k,
    *row_shape): the embedding-gradient and kvstore type."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        dtype = dtype or getattr(data, "dtype", np.float32)
        super().__init__(shape, dtype, ctx)
        dev = self._device()
        self._rs_data = _tensor(data, self.dtype, dev)
        self._rs_indices = _tensor(indices, np.int32, dev)
        if tuple(self._rs_data.shape[1:]) != self.shape[1:]:
            raise MXNetError(
                "row data shape %s does not match dense shape %s"
                % (tuple(self._rs_data.shape), self.shape))

    @property
    def data(self):
        return NDArray(self._rs_data)

    @property
    def indices(self):
        return NDArray(self._rs_indices)

    def todense(self):
        dense = torch.zeros(self.shape, dtype=self._rs_data.dtype,
                            device=self._rs_data.device)
        dense.index_put_((self._rs_indices.long(),), self._rs_data,
                         accumulate=True)
        return NDArray(dense)

    def astype(self, dtype):
        return RowSparseNDArray(self._rs_data, self._rs_indices, self.shape,
                                dtype, self._ctx)

    def retain(self, row_ids):
        """Only the rows ``row_ids``, in their order: one output row each,
        zero where the row is not stored."""
        rows = row_ids._data if isinstance(row_ids, NDArray) \
            else torch.as_tensor(np.asarray(row_ids))
        rows = rows.to(self._rs_indices.device, torch.int32)
        k = self._rs_indices.shape[0]
        if k == 0:
            picked = torch.zeros((rows.shape[0],) + self.shape[1:],
                                 dtype=self._rs_data.dtype,
                                 device=self._rs_data.device)
            return RowSparseNDArray(picked, rows, self.shape, self.dtype,
                                    self._ctx)
        order = torch.sort(self._rs_indices, stable=True).indices
        ids = self._rs_indices[order]
        pos = torch.searchsorted(ids, rows).clamp_(max=k - 1)
        hit = ids[pos] == rows
        src = order[pos]
        picked = torch.where(
            hit.reshape((-1,) + (1,) * (self._rs_data.dim() - 1)),
            self._rs_data[src], torch.zeros((), dtype=self._rs_data.dtype,
                                            device=self._rs_data.device))
        return RowSparseNDArray(picked, rows, self.shape, self.dtype,
                                self._ctx)


# ----------------------------------------------------------------------
# Constructors
# ----------------------------------------------------------------------

def _coerce_dense(arg1, dtype):
    """The dense input as numpy by ``mx.nd.array``'s rule: an explicit
    dtype wins; float32 and float16 stay; anything else is float32."""
    dense = np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray)
                       else arg1)
    if dtype is not None:
        return dense.astype(_np_dtype(dtype))
    if dense.dtype in (np.float32, np.float16):
        return dense
    return dense.astype(np.float32)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``, or
    from a dense array-like."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("shape required with (data, indices, indptr)")
        return CSRNDArray(data, indices, indptr, shape, dtype, ctx)
    dense = _coerce_dense(arg1, dtype)
    if dense.ndim != 2:
        raise MXNetError("csr_matrix needs a 2-D input")
    mask = dense != 0
    indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))]) \
        .astype(np.int32)
    indices = np.nonzero(mask)[1].astype(np.int32)
    return CSRNDArray(dense[mask], indices, indptr, dense.shape,
                      dtype or dense.dtype, ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` (without ``shape``,
    enough rows for the largest index) or from a dense array-like."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            data = np.asarray(data)
            idx = np.asarray(indices)
            nrows = int(idx.max()) + 1 if idx.size else 0
            shape = (nrows,) + tuple(data.shape[1:])
        return RowSparseNDArray(data, indices, shape, dtype, ctx)
    dense = _coerce_dense(arg1, dtype)
    live = np.nonzero((dense != 0).reshape(dense.shape[0], -1)
                      .any(axis=1))[0].astype(np.int32)
    return RowSparseNDArray(dense[live], live, dense.shape, dense.dtype,
                            ctx)


def array(source, ctx=None, dtype=None):
    """A sparse array as it is, anything else as a CSRNDArray."""
    if isinstance(source, BaseSparseNDArray):
        return source
    return csr_matrix(source, ctx=ctx, dtype=dtype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero sparse array of ``stype`` (no stored entry)."""
    if stype == "csr":
        return CSRNDArray(np.zeros((0,), dtype), np.zeros((0,), np.int32),
                          np.zeros((shape[0] + 1,), np.int32), shape,
                          dtype, ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            np.zeros((0,) + tuple(shape[1:]), dtype),
            np.zeros((0,), np.int32), shape, dtype, ctx)
    raise MXNetError("unknown stype %r" % stype)


# ----------------------------------------------------------------------
# Operators
# ----------------------------------------------------------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``csr . dense`` and ``csr^T . dense`` with a 1-D or 2-D dense
    ``rhs`` (a segment sum over the nonzeros); two dense operands take
    the dense ``dot``."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        if transpose_b:
            raise MXNetError("transpose_b unsupported for csr dot")
        r = rhs._data
        if r.dim() not in (1, 2):
            raise MXNetError("csr dot expects a 1-D or 2-D dense rhs")
        vec = r.dim() == 1
        mat = r[:, None] if vec else r
        rows = lhs._row_ids()
        cols = lhs._csr_indices
        vals = lhs._csr_data
        if not transpose_a:
            contrib = vals[:, None] * mat[cols]
            seg, n = rows, lhs.shape[0]
        else:
            contrib = vals[:, None] * mat[rows]
            seg, n = cols, lhs.shape[1]
        out = torch.zeros((n, contrib.shape[1]), dtype=contrib.dtype,
                          device=contrib.device).index_add(0, seg, contrib)
        return NDArray(out[:, 0] if vec else out)
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                          "transpose_b": transpose_b})
    raise MXNetError("sparse.dot supports csr x dense")


def retain(data, indices):
    """``data.retain(indices)`` of a RowSparseNDArray."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    return data.retain(indices)


def elemwise_add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse over the union of their
    rows; a dense operand makes the sum dense."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise MXNetError("shape mismatch %s vs %s"
                             % (lhs.shape, rhs.shape))
        idx = np.concatenate([lhs._rs_indices.cpu().numpy(),
                              rhs._rs_indices.cpu().numpy()])
        dat = torch.cat([lhs._rs_data, rhs._rs_data])
        uniq, inv = np.unique(idx, return_inverse=True)
        inv = torch.from_numpy(inv.reshape(-1)).to(dat.device)
        summed = torch.zeros((len(uniq),) + tuple(dat.shape[1:]),
                             dtype=dat.dtype, device=dat.device) \
            .index_add(0, inv, dat)
        return RowSparseNDArray(summed, uniq.astype(np.int32), lhs.shape,
                                lhs.dtype, lhs._ctx)
    if isinstance(lhs, NDArray) and isinstance(rhs, RowSparseNDArray):
        lhs, rhs = rhs, lhs
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, NDArray):
        return NDArray(rhs._data.index_put(
            (lhs._rs_indices.long(),), lhs._rs_data.to(rhs._data.dtype),
            accumulate=True))
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return NDArray(lhs._data + rhs._data)
    raise MXNetError("unsupported operand storage types")


add = elemwise_add
