"""The port's single-process kvstore (``mxnet_tpu_torch.kvstore``)
against the JAX package's (``mxnet_tpu/kvstore.py``) on the CPU: push,
pull and pushpull over single keys and lists, a pushed list merged,
``set_optimizer`` updating the stored copy, 2-bit compression with its
error-feedback residual over three pushes, and the optimizer states
saved and loaded.  The same numpy inputs go to both; every result is
equal to the JAX package's within 1e-6 (the same fp32 sums, or the same
SGD step)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, NDArray
from mxnet_tpu_torch import kvstore as tkv

TOL = dict(rtol=1e-6, atol=1e-6)


def _arrays(n, shape=(3, 4), seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _j(a):
    return jmx.nd.array(a, ctx=jmx.cpu())


def _t(a):
    return NDArray(torch.tensor(a))


def _close(t, j):
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)


@pytest.mark.parametrize("kind", ["local", "device", "nccl"])
def test_push_pull_single_keys_and_lists(kind):
    a, b, c, d = _arrays(4)
    stores = [jkv.create(kind), tkv.create(kind)]
    for kv, wrap in zip(stores, (_j, _t)):
        assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
        kv.init(3, wrap(a))
        kv.init(["w", "x"], [wrap(a), wrap(b)])
        kv.push(3, wrap(c))
        kv.push(["w", "x"], [[wrap(c), wrap(d)], wrap(d)])
    outs = []
    for kv, wrap in zip(stores, (_j, _t)):
        o = [wrap(np.zeros_like(a)) for _ in range(4)]
        kv.pull(3, out=o[0])
        kv.pull(["w", "x"], out=[o[1], o[2]])
        kv.pull(3, out=o[3])        # the pending value is taken once
        outs.append(o)
    for t, j in zip(outs[1], outs[0]):
        _close(t, j)
    np.testing.assert_allclose(outs[1][1].asnumpy(), c + d, **TOL)
    np.testing.assert_allclose(outs[1][3].asnumpy(), a, **TOL)


def test_pushpull_returns_the_merged_value_in_place():
    a, b, c = _arrays(3, seed=1)
    jout, tout = _j(np.zeros_like(a)), _t(np.zeros_like(a))
    held = tout._data
    jkv.create("device").pushpull(0, [_j(a), _j(b), _j(c)], out=jout)
    tkv.create("device").pushpull(0, [_t(a), _t(b), _t(c)], out=tout)
    _close(tout, jout)
    assert tout._data is held            # written into, not rebound
    jouts, touts = [_j(np.zeros_like(a))] * 2, [_t(np.zeros_like(a))] * 2
    jkv.create("local").pushpull(["p", "q"], [_j(a), _j(b)], out=jouts)
    tkv.create("local").pushpull(["p", "q"], [_t(a), _t(b)], out=touts)
    for t, j in zip(touts, jouts):
        _close(t, j)


def test_pushpull_of_a_value_into_itself_copies_nothing(monkeypatch):
    """The Trainer's ``pushpull(i, g, out=g)`` on a single-process store
    without compression leaves ``g`` as it was and launches no copy;
    an ``out`` that is another view (a transposed one) is written."""
    a, = _arrays(1, seed=3)
    g = torch.tensor(a)
    copies = []
    real = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_",
                        lambda t, src, *k: copies.append(t.shape)
                        or real(t, src, *k))
    kv = tkv.create("device")
    kv.pushpull(0, g, out=g)
    assert copies == [] and np.array_equal(g.numpy(), a)
    sq = torch.tensor(_arrays(1, shape=(4, 4), seed=4)[0])
    want = sq.clone()
    out = torch.zeros(4, 4)
    kv.pushpull(1, sq, out=out.t())
    assert copies == [(4, 4)]
    np.testing.assert_array_equal(out.t().numpy(), want.numpy())


def test_set_optimizer_updates_the_stored_copy(tmp_path):
    w, g1, g2 = _arrays(3, seed=2)
    got = {}
    for name, mx, kvmod, wrap in (("jax", jmx, jkv, _j),
                                  ("port", tmx, tkv, _t)):
        kv = kvmod.create("device")
        kv.init("w", wrap(w))
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3))
        kv.push("w", wrap(g1))
        out = wrap(np.zeros_like(w))
        kv.pushpull("w", [wrap(g2), wrap(g1)], out=out)
        kv.save_optimizer_states(str(tmp_path / ("%s.states" % name)))
        kv.load_optimizer_states(str(tmp_path / ("%s.states" % name)))
        after = wrap(np.zeros_like(w))
        kv.pull("w", out=after)
        got[name] = (out.asnumpy(), after.asnumpy())
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(t, j, **TOL)
    assert not np.allclose(got["port"][1], w)


def test_two_bit_compression_keeps_its_residual_over_three_pushes():
    """Each pushed value is quantized to {-t, 0, t} after adding what
    the last quantization dropped; the residual is the JAX package's
    after every push."""
    grads = _arrays(3, shape=(50,), seed=3, scale=0.4)
    params = {"type": "2bit", "threshold": 0.5}
    jstore, tstore = jkv.create("device"), tkv.create("device")
    for kv in (jstore, tstore):
        kv.set_gradient_compression(params)
    for g in grads:
        jout, tout = _j(np.zeros_like(g)), _t(np.zeros_like(g))
        jstore.pushpull(7, _j(g), out=jout)
        tstore.pushpull(7, _t(g), out=tout)
        _close(tout, jout)
        assert set(np.unique(tout.asnumpy())) <= {-0.5, 0.0, 0.5}
        np.testing.assert_allclose(
            tstore._compression._residual[7].numpy(),
            np.asarray(jstore._compression._residual[7]), **TOL)
    # three pushes of values below the threshold: the residual crossed it
    assert np.abs(tout.asnumpy()).sum() > 0


def test_multi_process_stores_and_row_sparse_pull_match_the_jax_store():
    """The multi-process stores are ported (their cross-process cases
    are in tests/test_torch_kvstore_dist.py); in one process they are a
    world of one, as the JAX package's are.  ``row_sparse_pull`` gives
    the JAX store's rows (deduplicated, in order) into a dense ``out``
    with every other row zero."""
    for name in ("dist_sync", "dist_device_sync", "dist_async", "dist",
                 "horovod"):
        kv, jstore = tkv.create(name), jkv.create(name)
        assert (kv.rank, kv.num_workers) == \
            (jstore.rank, jstore.num_workers) == (0, 1)
        assert kv._is_dist == jstore._is_dist
        kv.barrier()
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tkv.create("nope")
    kv = tkv.create("local")
    kv.init(0, _t(np.zeros(3, np.float32)))
    table = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    rows = np.array([2, 0, 2], np.float32)
    kv.init(5, _t(table))
    jstore = jkv.create("local")
    jstore.init(5, _j(table))
    ones = np.ones((4, 3), np.float32)
    out, jout = _t(ones), _j(ones)
    kv.row_sparse_pull(5, out=out, row_ids=_t(rows))
    jstore.row_sparse_pull(5, out=jout, row_ids=_j(rows))
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(out.asnumpy()[[1, 3]], 0)
    with pytest.raises(MXNetError, match="not initialized"):
        kv.pull(1, out=_t(np.zeros(3, np.float32)))
    kv.barrier()


def test_mx_kv_is_the_kvstore_module():
    assert tmx.kv is tmx.kvstore is tkv
    assert jmx.kv is jmx.kvstore is jkv
