"""Sparse storage in the port (``mx.nd.sparse``, row-sparse kvstore
pulls and pushes, ``Optimizer.update_row_sparse*``) against the JAX
package's on the CPU: every case of ``tests/test_sparse.py`` and
``test_misc_api.py :: test_sparse_embedding_forward`` through both, and
the dtype rules, ``retain`` with absent rows and an empty store, every
storage pair of ``elemwise_add``, the ``out`` kinds of
``row_sparse_pull``, pending merges without an updater,
``pushpull_bucket``, the float16 master-copy route and
``NDArray.tostype``'s message.

Tolerance: 1e-6 relative (the JAX tests' own); a selection, a
densified array, an index array and an elementwise row update whose
operands are equal are held bitwise.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsp

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _same(got, want, exact=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _rand_csr(n, m, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, m) * (rng.rand(n, m) < density)
    return dense.astype(np.float32)


# -- tests/test_sparse.py, through both packages -----------------------

def test_csr_roundtrip():
    dense = _rand_csr(8, 5)
    j, t = jsp.csr_matrix(dense), tsp.csr_matrix(dense)
    assert t.stype == j.stype == "csr"
    _same(t.asnumpy(), j.asnumpy(), exact=True)
    for part in ("data", "indices", "indptr"):
        _same(getattr(t, part), getattr(j, part), exact=True)
    assert t.nnz == j.nnz == int((dense != 0).sum())
    parts = (j.data.asnumpy(), j.indices.asnumpy(), j.indptr.asnumpy())
    _same(tsp.csr_matrix(parts, shape=(8, 5)).asnumpy(),
          jsp.csr_matrix(parts, shape=(8, 5)).asnumpy(), exact=True)


@pytest.mark.parametrize("rhs_shape,transpose_a", [
    ((5, 3), False), ((8, 3), True), ((5,), False), ((8,), True)])
def test_csr_dot_dense(rhs_shape, transpose_a):
    dense = _rand_csr(8, 5)
    rhs = np.random.RandomState(1).randn(*rhs_shape).astype(np.float32)
    got = tsp.dot(tsp.csr_matrix(dense), tmx.nd.array(rhs),
                  transpose_a=transpose_a)
    want = jsp.dot(jsp.csr_matrix(dense), jmx.nd.array(rhs),
                   transpose_a=transpose_a)
    _same(got, want)
    ref = (dense.T if transpose_a else dense) @ rhs
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=1e-5, atol=1e-6)


def test_dense_dot_route_and_csr_errors():
    a = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    b = np.random.RandomState(3).randn(3, 5).astype(np.float32)
    _same(tsp.dot(tmx.nd.array(a), tmx.nd.array(b), transpose_a=True),
          jsp.dot(jmx.nd.array(a), jmx.nd.array(b), transpose_a=True))
    csr = tsp.csr_matrix(_rand_csr(4, 3))
    for bad in (lambda: tsp.dot(csr, tmx.nd.ones((3, 2)),
                                transpose_b=True),
                lambda: tsp.dot(csr, tmx.nd.ones((3, 2, 1))),
                lambda: tsp.dot(tmx.nd.ones((2, 4)), csr)):
        with pytest.raises(MXNetError):
            bad()


def test_row_sparse_roundtrip_and_retain():
    data = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    idx = np.array([1, 3, 5, 7], dtype=np.int32)
    j = jsp.row_sparse_array((data, idx), shape=(10, 3))
    t = tsp.row_sparse_array((data, idx), shape=(10, 3))
    _same(t.asnumpy(), j.asnumpy(), exact=True)
    keep = np.array([3, 4, 7], np.float32)
    jk, tk = j.retain(jmx.nd.array(keep)), t.retain(tmx.nd.array(keep))
    _same(tk.asnumpy(), jk.asnumpy(), exact=True)
    _same(tk.data, jk.data, exact=True)
    _same(tk.indices, jk.indices, exact=True)
    assert tk.asnumpy()[4].sum() == 0


def test_row_sparse_add():
    args = [((np.ones((2, 3), np.float32), np.array([0, 2])), (5, 3)),
            ((2 * np.ones((2, 3), np.float32), np.array([2, 4])), (5, 3))]
    ja, jb = [jsp.row_sparse_array(a, shape=s) for a, s in args]
    ta, tb = [tsp.row_sparse_array(a, shape=s) for a, s in args]
    ts, js = tsp.elemwise_add(ta, tb), jsp.elemwise_add(ja, jb)
    assert ts.stype == js.stype == "row_sparse"
    _same(ts.asnumpy(), js.asnumpy(), exact=True)
    _same(ts.indices, js.indices, exact=True)
    _same(tsp.elemwise_add(ta, tmx.nd.ones((5, 3))),
          jsp.elemwise_add(ja, jmx.nd.ones((5, 3))), exact=True)


def test_sparse_zeros():
    for stype, shape in (("row_sparse", (6, 2)), ("csr", (4, 4))):
        t, j = tsp.zeros(stype, shape), jsp.zeros(stype, shape)
        _same(t.asnumpy(), j.asnumpy(), exact=True)
        assert t.stype == j.stype
    with pytest.raises(MXNetError, match="unknown stype"):
        tsp.zeros("bsr", (2, 2))


def test_kvstore_row_sparse_pull_no_densify():
    table = np.random.RandomState(0).randn(100, 8).astype(np.float32)
    rows = np.array([5, 17, 99], np.float32)
    got, want = [], []
    for pkg, out in ((tmx, got), (jmx, want)):
        kv = pkg.kv.create("local")
        kv.init("emb", pkg.nd.array(table))
        out.append(kv.row_sparse_pull("emb", row_ids=pkg.nd.array(rows)))
    assert got[0].stype == want[0].stype == "row_sparse"
    assert got[0].data.shape == want[0].data.shape == (3, 8)
    _same(got[0].data, want[0].data, exact=True)
    _same(got[0].indices, want[0].indices, exact=True)


def _sparse_push_with_optimizer(pkg, sp):
    kv = pkg.kv.create("local")
    kv.init("w", pkg.nd.array(np.ones((10, 4), np.float32)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.0))
    kv.push("w", sp.row_sparse_array(
        (np.ones((2, 4), np.float32), np.array([2, 7])), shape=(10, 4)))
    out = pkg.nd.zeros((10, 4))
    kv.pull("w", out=out)
    return out.asnumpy()


def test_kvstore_sparse_push_with_optimizer():
    got = _sparse_push_with_optimizer(tmx, tsp)
    _same(got, _sparse_push_with_optimizer(jmx, jsp), exact=True)
    expect = np.ones((10, 4), np.float32)
    expect[[2, 7]] -= 0.5
    np.testing.assert_array_equal(got, expect)


def _adagrad_rows(pkg, sp):
    opt = pkg.optimizer.AdaGrad(learning_rate=1.0)
    w = pkg.nd.ones((6, 2))
    state = opt.create_state(0, w)
    g = sp.row_sparse_array(
        (np.full((2, 2), 2.0, np.float32), np.array([1, 4])), shape=(6, 2))
    opt.update_row_sparse(0, w, g, state)
    return w.asnumpy(), state.asnumpy()


def test_sparse_adagrad_rows_only():
    (w, h), (jw, jh) = _adagrad_rows(tmx, tsp), _adagrad_rows(jmx, jsp)
    _same(w, jw, exact=True)
    _same(h, jh, exact=True)
    assert np.allclose(w[[0, 2, 3, 5]], 1.0) and (w[[1, 4]] < 1.0).all()
    assert np.allclose(h[[0, 2, 3, 5]], 0.0) and np.allclose(h[[1, 4]], 4.0)


def _updater_sparse(pkg, sp):
    upd = pkg.optimizer.get_updater(
        pkg.optimizer.SGD(learning_rate=0.1, momentum=0.0))
    w = pkg.nd.ones((5, 3))
    upd(0, sp.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([3])), shape=(5, 3)), w)
    return w.asnumpy()


def test_updater_dispatches_sparse():
    got = _updater_sparse(tmx, tsp)
    _same(got, _updater_sparse(jmx, jsp), exact=True)
    assert np.allclose(got[3], 0.9) and np.allclose(got[0], 1.0)


def _momentum_sgd(pkg, sp):
    opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    w = pkg.nd.ones((4, 2))
    state = opt.create_state(0, w)
    g = sp.row_sparse_array(
        (np.ones((1, 2), np.float32), np.array([1])), shape=(4, 2))
    opt.update_row_sparse(0, w, g, state)
    opt.update_row_sparse(0, w, g, state)
    return w.asnumpy(), state.asnumpy()


def test_momentum_sgd_densifies_correctly():
    (w, m), (jw, jm) = _momentum_sgd(tmx, tsp), _momentum_sgd(jmx, jsp)
    _same(w, jw)
    _same(m, jm)
    assert not np.allclose(w[1], 1.0) and np.allclose(w[0], 1.0)


def test_sparse_embedding_forward():
    """``test_misc_api.py :: test_sparse_embedding_forward`` through both
    packages, the same weights."""
    emb = tmx.gluon.contrib.nn.SparseEmbedding(10, 4)
    emb.initialize(device="cpu")
    jemb = jmx.gluon.contrib.nn.SparseEmbedding(10, 4)
    jemb.initialize()
    jemb.weight.set_data(jmx.nd.array(emb.weight.data().asnumpy()))
    ids = np.array([1.0, 3.0])
    out, jout = emb(tmx.nd.array(ids)), jemb(jmx.nd.array(ids))
    assert out.shape == jout.shape == (2, 4)
    _same(out, jout, exact=True)


# -- beyond tests/test_sparse.py ----------------------------------------

@pytest.mark.parametrize("src,dtype", [
    (np.float64, None), (np.int64, None), (np.float16, None),
    (np.float32, None), (np.float64, "float16"), (np.int32, "float32")])
def test_dtype_rules(src, dtype):
    dense = (_rand_csr(4, 5, seed=4) * 4).astype(src)
    for build in ("csr_matrix", "row_sparse_array"):
        t = getattr(tsp, build)(dense, dtype=dtype)
        j = getattr(jsp, build)(dense, dtype=dtype)
        assert t.dtype == j.dtype, (build, t.dtype, j.dtype)
        _same(t.asnumpy(), j.asnumpy(), exact=True)
    data = np.ones((2, 3), np.float64)
    t = tsp.row_sparse_array((data, np.array([0, 4])))
    j = jsp.row_sparse_array((data, np.array([0, 4])))
    assert t.shape == j.shape == (5, 3) and t.dtype == j.dtype == np.float32
    assert t.indices.dtype == j.indices.dtype == np.int32
    assert tsp.array(t) is t
    _same(tsp.array(dense).asnumpy(), jsp.array(dense).asnumpy(),
          exact=True)


def test_astype_slicing_and_tostype():
    dense = _rand_csr(6, 4, seed=5)
    t, j = tsp.csr_matrix(dense), jsp.csr_matrix(dense)
    _same(t[1:4].asnumpy(), j[1:4].asnumpy(), exact=True)
    _same(t.astype("float16").asnumpy(), j.astype("float16").asnumpy(),
          exact=True)
    assert t.tostype("csr") is t
    _same(t.tostype("default"), j.tostype("default"), exact=True)
    for bad in (lambda: t[::2], lambda: t[1], lambda: t.tostype(
            "row_sparse"), lambda: t.copyto(tmx.nd.zeros((6, 4)))):
        with pytest.raises(MXNetError):
            bad()
    rs = tsp.row_sparse_array(dense)
    _same(rs.astype("float16").asnumpy(),
          jsp.row_sparse_array(dense).astype("float16").asnumpy(),
          exact=True)


@pytest.mark.parametrize("stored,keep", [
    ([1, 3, 5, 7], [7, 0, 3, 9, 1]),        # present and absent rows
    ([4, 2, 4], [4, 2, 8]),                 # a duplicate stored id
    ([], [0, 2])])                          # an empty store
def test_retain_absent_duplicate_and_empty(stored, keep):
    data = np.arange(len(stored) * 2, dtype=np.float32).reshape(-1, 2) + 1
    t = tsp.RowSparseNDArray(data, np.array(stored, np.int32), (10, 2))
    j = jsp.RowSparseNDArray(data, np.array(stored, np.int32), (10, 2))
    tk = tsp.retain(t, tmx.nd.array(np.array(keep, np.float32)))
    jk = jsp.retain(j, jmx.nd.array(np.array(keep, np.float32)))
    _same(tk.data, jk.data, exact=True)
    _same(tk.indices, jk.indices, exact=True)
    with pytest.raises(MXNetError, match="RowSparseNDArray"):
        tsp.retain(tmx.nd.ones((2, 2)), [0])


def _operands(pkg, sp, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "dense":
        return pkg.nd.array(rng.randn(6, 3).astype(np.float32))
    rows = np.sort(rng.choice(6, 3, replace=False))
    return sp.row_sparse_array((rng.randn(3, 3).astype(np.float32), rows),
                               shape=(6, 3))


@pytest.mark.parametrize("lhs,rhs", [
    ("row_sparse", "row_sparse"), ("row_sparse", "dense"),
    ("dense", "row_sparse"), ("dense", "dense")])
def test_elemwise_add_every_storage_pair(lhs, rhs):
    got = tsp.add(_operands(tmx, tsp, lhs, 1), _operands(tmx, tsp, rhs, 2))
    want = jsp.add(_operands(jmx, jsp, lhs, 1), _operands(jmx, jsp, rhs, 2))
    assert type(got).__name__ == type(want).__name__
    _same(got.asnumpy(), want.asnumpy(), exact=True)
    csr = tsp.csr_matrix(np.eye(6, 3, dtype=np.float32))
    with pytest.raises(MXNetError):
        tsp.elemwise_add(csr, got)
    with pytest.raises(MXNetError, match="shape mismatch"):
        tsp.elemwise_add(tsp.zeros("row_sparse", (6, 3)),
                         tsp.zeros("row_sparse", (5, 3)))


@pytest.mark.parametrize("kind", ["row_sparse", "dense", "none", "list",
                                  "all_rows"])
def test_row_sparse_pull_out_kinds(kind):
    table = np.random.RandomState(6).randn(20, 3).astype(np.float32)
    ids = np.array([4, 0, 19, 4, 7], np.float32)
    res = []
    for pkg, sp in ((tmx, tsp), (jmx, jsp)):
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.array(table))
        rows = pkg.nd.array(ids)
        if kind == "row_sparse":
            out = sp.zeros("row_sparse", (20, 3))
            kv.row_sparse_pull(3, out=out, row_ids=rows)
            res.append([out.data, out.indices, out.asnumpy()])
        elif kind == "dense":
            out = pkg.nd.ones((20, 3))
            kv.row_sparse_pull(3, out=out, row_ids=rows)
            res.append([out])
        elif kind == "none":
            out = kv.row_sparse_pull(3, row_ids=rows)
            res.append([out.data, out.indices])
        elif kind == "list":
            outs = [pkg.nd.ones((20, 3)), sp.zeros("row_sparse", (20, 3))]
            kv.row_sparse_pull(3, out=outs, row_ids=rows)
            res.append([outs[0], outs[1].data, outs[1].indices])
        else:
            out = pkg.nd.zeros((20, 3))
            kv.row_sparse_pull(3, out=out)
            res.append([out])
    for g, w in zip(*res):
        _same(g, w, exact=True)


def _pending(pkg, sp, order):
    kv = pkg.kv.create("local")
    kv.init("k", pkg.nd.zeros((8, 2)))
    vals = {"a": sp.row_sparse_array(
                (np.full((2, 2), 1.5, np.float32), np.array([1, 6])),
                shape=(8, 2)),
            "b": sp.row_sparse_array(
                (np.full((3, 2), -2.0, np.float32), np.array([0, 1, 7])),
                shape=(8, 2)),
            "d": pkg.nd.array(np.arange(16, dtype=np.float32).reshape(8, 2))}
    for key in order:
        if key == "ab":
            kv.push("k", [vals["a"], vals["b"]])
        elif key == "ad":
            kv.push("k", [vals["a"], vals["d"]])
        else:
            kv.push("k", vals[key])
    out = pkg.nd.zeros((8, 2))
    kv.pull("k", out=out)
    pp = pkg.nd.zeros((8, 2))
    kv.pushpull("k", vals["a"], out=pp)
    return out.asnumpy(), pp.asnumpy()


@pytest.mark.parametrize("order", [["a", "b"], ["d", "a"], ["a", "d"],
                                   ["ab"], ["ad"], ["ab", "b"]])
def test_pending_merges_without_an_updater(order):
    for g, w in zip(_pending(tmx, tsp, order), _pending(jmx, jsp, order)):
        _same(g, w, exact=True)


def _bucket(pkg, sp, compress):
    kv = pkg.kv.create("local")
    if compress:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    rs = sp.row_sparse_array(
        (np.full((2, 3), 0.75, np.float32), np.array([0, 3])), shape=(4, 3))
    dense = pkg.nd.array(np.full((4, 3), 0.3, np.float32))
    outs = [pkg.nd.zeros((4, 3)), pkg.nd.zeros((4, 3)), pkg.nd.zeros((4, 3))]
    kv.pushpull_bucket(["s", "d", "m"], [rs, dense, [rs, rs]], outs)
    pp = pkg.nd.zeros((4, 3))
    kv.init("p", pkg.nd.zeros((4, 3)))
    kv.pushpull("p", [rs, rs], out=pp)
    return [o.asnumpy() for o in outs] + [pp.asnumpy()]


@pytest.mark.parametrize("compress", [False, True])
def test_pushpull_bucket_densifies_row_sparse_values(compress):
    for g, w in zip(_bucket(tmx, tsp, compress), _bucket(jmx, jsp, compress)):
        _same(g, w, exact=True)


def _compressed_sparse_push(pkg, sp):
    kv = pkg.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", pkg.nd.ones((5, 2)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0))
    kv.push("w", sp.row_sparse_array(
        (np.full((1, 2), 0.2, np.float32), np.array([3])), shape=(5, 2)))
    out = pkg.nd.zeros((5, 2))
    kv.pull("w", out=out)
    return out.asnumpy()


def test_row_sparse_pushes_skip_compression():
    got = _compressed_sparse_push(tmx, tsp)
    _same(got, _compressed_sparse_push(jmx, jsp), exact=True)
    np.testing.assert_allclose(got[3], 0.8, rtol=1e-6)


def _mp_route(pkg, sp, momentum, clip):
    opt = pkg.optimizer.SGD(learning_rate=0.25, momentum=momentum,
                            multi_precision=True, wd=0.01,
                            clip_gradient=clip, rescale_grad=0.5)
    w = pkg.nd.array(np.linspace(-1, 1, 12).reshape(6, 2), dtype="float16")
    state = opt.create_state_multi_precision(0, w)
    g = sp.row_sparse_array(
        (np.array([[3.0, -1.0], [0.5, 0.25]], np.float32), np.array([1, 4])),
        shape=(6, 2))
    opt.update_row_sparse_multi_precision(0, w, g, state)
    w32 = state[1]
    return w.asnumpy(), w32.asnumpy()


@pytest.mark.parametrize("momentum,clip", [(0.0, None), (0.9, 1.0)])
def test_float16_master_copy_route_densifies(momentum, clip):
    got, want = _mp_route(tmx, tsp, momentum, clip), \
        _mp_route(jmx, jsp, momentum, clip)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].dtype == np.float16 and got[1].dtype == np.float32


def _lazy_sgd(pkg, sp, wd, clip):
    opt = pkg.optimizer.SGD(learning_rate=0.1, wd=wd, clip_gradient=clip,
                            rescale_grad=2.0)
    w = pkg.nd.array(np.linspace(-2, 2, 18).reshape(6, 3))
    g = sp.row_sparse_array(
        (np.array([[1.0, -3.0, 0.2], [0.7, 0.1, -0.4]], np.float32),
         np.array([5, 2])), shape=(6, 3))
    opt.update_row_sparse(0, w, g, None)
    opt.update_row_sparse(0, w, g, None)
    return w.asnumpy()


@pytest.mark.parametrize("wd,clip", [(0.0, None), (0.05, 1.0)])
def test_lazy_sgd_moves_only_the_named_rows(wd, clip):
    got = _lazy_sgd(tmx, tsp, wd, clip)
    _same(got, _lazy_sgd(jmx, jsp, wd, clip), exact=True)
    start = np.linspace(-2, 2, 18).reshape(6, 3).astype(np.float32)
    np.testing.assert_array_equal(got[[0, 1, 3, 4]], start[[0, 1, 3, 4]])


def test_ndarray_tostype_and_attach_grad_stype():
    for pkg in (tmx, jmx):
        a = pkg.nd.ones((2, 2))
        assert a.tostype("default") is a
        a.attach_grad(stype="row_sparse")
        assert a.grad.shape == (2, 2)
    with pytest.raises(MXNetError) as te:
        tmx.nd.ones((2,)).tostype("csr")
    with pytest.raises(jmx.MXNetError) as je:
        jmx.nd.ones((2,)).tostype("csr")
    assert str(te.value) == str(je.value)


def test_embedding_sparse_grad_gradient_is_dense():
    from mxnet_tpu_torch import autograd
    emb = tmx.gluon.nn.Embedding(6, 3, sparse_grad=True)
    emb.initialize(device="cpu")
    with autograd.record():
        y = emb(tmx.nd.array(np.array([[1.0, 4.0, 1.0]])))
    y.backward()
    grad = emb.weight.grad().asnumpy()
    np.testing.assert_array_equal(grad[:, 0], [0, 2, 0, 0, 1, 0])
