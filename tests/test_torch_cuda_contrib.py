"""Sparse storage and the contrib op families on an NVIDIA GPU, each held
against the port's own CPU run of the same inputs: ``sparse.dot`` and
``retain``, ``row_sparse_pull`` and AdaGrad's row update through the
kvstore, ``quantized_conv``'s int32 accumulator (bitwise, on the
``torch._int_mm`` route and on the float64 one), ``box_nms``,
``ROIAlign`` with its gradient, and ``foreach``/``while_loop``/``cond``
inside a hybridized block's captured graph.  Every test here needs the
card and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_contrib.py

Tolerances: ``sparse.dot`` sums with float atomics on the card (1e-5
relative); the row updates, ``box_nms`` and ``retain`` are elementwise
or exact selections (1e-6, or equal); the int8 accumulators are exact
integers and held bitwise; ``ROIPooling`` (a maximum) bitwise;
``ROIAlign`` and the control-flow nets to 1e-5, and ``ROIAlign``'s
gradient, a scatter whose atomics sum in no fixed order, to 1e-4 of its
largest magnitude.  Every capture and replay runs under
``_capture.checking_syncs()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, autograd, gluon, ops
from mxnet_tpu_torch.ndarray import sparse

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    yield mx.gpu(0)


def _both(fn):
    """``fn(ctx)`` on the CPU and on the card, as numpy."""
    out = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            res = fn(ctx)
        res = res if isinstance(res, (list, tuple)) else [res]
        out.append([r.asnumpy() if hasattr(r, "asnumpy") else
                    r.detach().cpu().numpy() for r in res])
    return out


def _csr(rows, cols, nnz_row, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.choice(cols, nnz_row, replace=False)
                            for _ in range(rows)]), axis=1).ravel()
    data = rng.standard_normal(rows * nnz_row).astype(np.float32)
    indptr = np.arange(0, rows * nnz_row + 1, nnz_row)
    return data, idx.astype(np.int32), indptr.astype(np.int32)


def test_sparse_dot_and_retain_match_the_cpu(card):
    data, idx, indptr = _csr(256, 5000, 15, 0)
    w = np.random.default_rng(1).standard_normal((5000, 4)).astype(
        np.float32)
    dy = np.random.default_rng(2).standard_normal((256, 4)).astype(
        np.float32)

    def run(ctx):
        csr = sparse.csr_matrix((data, idx, indptr), shape=(256, 5000),
                                ctx=ctx)
        rs = sparse.row_sparse_array(
            (w[:300], np.arange(0, 900, 3)), shape=(5000, 4), ctx=ctx)
        return [sparse.dot(csr, mx.nd.array(w)),
                sparse.dot(csr, mx.nd.array(dy), transpose_a=True),
                sparse.dot(csr, mx.nd.array(w[:, 0])),
                rs.retain(mx.nd.array(np.array([3, 4, 897, 0, 3]))).data,
                csr.todense()]
    cpu, gpu = _both(run)
    for c, g in zip(cpu[:3], gpu[:3]):
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gpu[3], cpu[3])
    np.testing.assert_array_equal(gpu[4], cpu[4])


def test_row_sparse_pull_and_adagrad_rows_match_the_cpu(card):
    table = np.random.default_rng(3).standard_normal((1000, 8)).astype(
        np.float32)
    ids = np.array([7, 3, 999, 3, 512], np.float32)
    grad = np.random.default_rng(4).standard_normal((3, 8)).astype(
        np.float32)

    def run(ctx):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.array(table))
        kv.set_optimizer(mx.optimizer.AdaGrad(learning_rate=0.1,
                                              rescale_grad=0.5, wd=1e-3))
        for _ in range(2):
            kv.push("w", sparse.row_sparse_array(
                (grad, np.array([3, 7, 999])), shape=(1000, 8)))
        dense = mx.nd.zeros((1000, 8))
        kv.row_sparse_pull("w", out=dense, row_ids=mx.nd.array(ids))
        pulled = kv.row_sparse_pull("w", row_ids=mx.nd.array(ids))
        hist = kv._updater.states["w"]
        return [dense, pulled.data, pulled.indices, mx.nd.NDArray(hist)]
    cpu, gpu = _both(run)
    for c, g in zip(cpu, gpu):
        np.testing.assert_allclose(g, c, rtol=1e-6, atol=1e-7)
    assert (gpu[0][[0, 1, 2, 4]] == 0).all()
    np.testing.assert_array_equal(gpu[2], [3, 7, 512, 999])


@pytest.mark.parametrize("groups,channels,filters", [
    (1, 64, 32),        # im2col and torch._int_mm
    (2, 6, 10)])        # float64
def test_quantized_conv_int32_is_bitwise_the_cpu(card, groups, channels,
                                                 filters):
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (4, channels, 14, 14)).astype(np.int8)
    w = rng.integers(-127, 128, (filters, channels // groups, 3, 3)) \
        .astype(np.int8)
    b = rng.integers(-127, 128, (filters,)).astype(np.int8)
    rngs = [np.float32(v) for v in (-2.0, 2.5, -0.5, 0.4, -1.0, 1.0)]

    def run(ctx):
        args = [mx.nd.array(x), mx.nd.array(w), mx.nd.array(b)] + \
            [mx.nd.array(np.asarray(v)) for v in rngs]
        return mx.nd.quantized_conv(*args, kernel=(3, 3), stride=(1, 1),
                                    pad=(1, 1), num_filter=filters,
                                    num_group=groups, no_bias=False)
    cpu, gpu = _both(run)
    assert gpu[0].dtype == np.int32
    for c, g in zip(cpu, gpu):
        np.testing.assert_array_equal(g, c)


def test_box_nms_matches_the_cpu(card):
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 60, (3, 300, 2)).astype(np.float32)
    wh = rng.uniform(4, 30, (3, 300, 2)).astype(np.float32)
    score = np.round(rng.uniform(0, 1, (3, 300, 1)), 2).astype(np.float32)
    cls = rng.integers(0, 4, (3, 300, 1)).astype(np.float32)
    data = np.concatenate([cls, score, xy, xy + wh], axis=-1)

    def run(ctx):
        with _capture.checking_syncs():
            return mx.nd.box_nms(mx.nd.array(data), overlap_thresh=0.5,
                                 valid_thresh=0.1)
    cpu, gpu = _both(run)
    np.testing.assert_array_equal(gpu[0], cpu[0])


def test_roi_align_and_its_gradient_match_the_cpu(card):
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((2, 16, 19, 25)).astype(np.float32)
    boxes = rng.uniform(0, 280, (24, 2)).astype(np.float32)
    rois = np.concatenate([np.repeat([0.0, 1.0], 12)[:, None],
                           boxes, boxes + rng.uniform(16, 120, (24, 2))],
                          axis=1).astype(np.float32)

    def run(ctx):
        x = mx.nd.array(feat)
        x.attach_grad()
        with autograd.record():
            y = mx.nd.ROIAlign(x, mx.nd.array(rois), pooled_size=(7, 7),
                               spatial_scale=1 / 16.0, sample_ratio=2)
            (y * y).sum().backward()
        pool = mx.nd.ROIPooling(x, mx.nd.array(rois), pooled_size=(7, 7),
                                spatial_scale=1 / 16.0)
        return [y, x.grad, pool]
    (y, grad, pool), (gy, ggrad, gpool) = _both(run)
    np.testing.assert_allclose(gy, y, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gpool, pool)
    # the gradient's scatter sums many samples a pixel in the atomics'
    # order on the card
    np.testing.assert_allclose(ggrad, grad, rtol=1e-5,
                               atol=1e-4 * np.abs(grad).max())


class _Flow(gluon.HybridBlock):
    """A dense step scanned by ``foreach``, a doubling ``while_loop`` and
    a ``cond`` on the sign of the sum, in one hybridized forward."""

    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.cell = gluon.nn.Dense(8, in_units=8, flatten=False)

    def hybrid_forward(self, F, x, h):
        outs, h = F.contrib.foreach(
            lambda xt, s: (F.tanh(self.cell(xt) + s),) * 2, x, h)
        _, (i, acc) = F.contrib.while_loop(
            lambda i, a: i < 3.0, lambda i, a: (a, (i + 1.0, a * 2.0)),
            (h.sum() * 0, h), max_iterations=6)
        return F.contrib.cond(acc.sum() > 0, lambda a: a * 2.0,
                              lambda a: a - 1.0, [acc]) + outs.sum(axis=0)


def test_control_flow_runs_captured_and_matches_the_cpu(card):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 4, 8)).astype(np.float32)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    nets = {}
    for dev in ("cpu", "cuda"):
        net = _Flow(prefix="flow_")
        net.initialize(device=dev,
                       generator=torch.Generator().manual_seed(0))
        net.hybridize()
        nets[dev] = net
    want = nets["cpu"](torch.from_numpy(x), torch.from_numpy(h))
    net = nets["cuda"]
    with _capture.checking_syncs():
        outs = [net(torch.from_numpy(x).cuda(), torch.from_numpy(h).cuda())
                for _ in range(3)]
    owner = next(iter(net._graph_owners.values()))
    assert owner.graphs >= 1 and owner.replays >= 1
    for out in outs:
        np.testing.assert_allclose(out.detach().cpu().numpy(),
                                   want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert ops.contrib.foreach is not None
