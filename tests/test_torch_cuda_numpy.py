"""The NumPy front end and the engine and runtime helpers on an NVIDIA
GPU: a narrow BERT trained from ``mx.np`` arrays under ``npx.set_np()``,
through ``mx.nd`` and inside ``mx.engine.bulk`` (phase 22 (a) of
``chip_smoke.py`` at a small width); every ``mx.np``/``npx`` name on the
card against the CPU (phase 22 (b) at fewer rows); ``runtime.Features()``
and ``test_utils.check_consistency`` on ``gpu(0)``; ``set_np()`` through
a hybridized block's captured graph.  Every test here needs the card
and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_numpy.py

Tolerances: the three BERT runs bitwise (at seq 64 each (batch, head)
is one key tile of the flash backward, so no two blocks add into one dq
entry); card against CPU as phase 22 (b): sorts, arg-ops, selections
and copies bitwise, the rest within 1e-5 of the CPU result's largest
magnitude; ``check_consistency`` at its own (the JAX package's)
tolerances.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import _build, _capture, gluon  # noqa: E402
from mxnet_tpu_torch import runtime, test_utils  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import BERTModel  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    yield mx.gpu(0)


def _narrow_bert():
    return BERTModel(vocab_size=300, units=64, hidden_size=128,
                     num_layers=2, num_heads=2, max_length=64, dropout=0.1)


def test_bert_from_np_arrays_bitwise_across_np_nd_and_bulk(card):
    sites = {"flash_attention_fwd": 2, "flash_attention_bwd": 2,
             "layernorm_fwd": 2 * 2 + 2}
    # the narrow net learns visibly in three steps at pretraining's lr
    out = chip_smoke.numpy_bert_path(make_net=_narrow_bert, vocab=300,
                                     batch=4, seq=64, steps=3, sites=sites,
                                     ctx=card, hyper={"learning_rate": 1e-4})
    assert out["nd_twice"]["bitwise"]
    assert out["vs_nd"]["np"]["bitwise"] and out["vs_nd"]["bulk"]["bitwise"]
    assert out["launches"]["flash_attention_fwd"] == 2 * 3 * 3


def test_every_np_and_npx_name_on_the_card_matches_the_cpu(card):
    out = chip_smoke.numpy_card_vs_cpu(width=(1024, 768), ffn=3072,
                                       vocab=30522)
    assert out["cases"] == len(chip_smoke.numpy_cases())
    assert out["largest"] <= chip_smoke.NUMPY_TOL


def test_np_arrays_land_on_the_card_without_a_context(card):
    a = mx.np.array([1.0, 2.0])
    assert a.context == card and isinstance(a, mx.np.ndarray)
    assert mx.np.random.uniform(size=3).context == card
    with mx.cpu():
        assert mx.np.ones(2).context == mx.cpu()


def test_features_on_the_card(card):
    _build.build_all()
    feats = runtime.Features()
    for name in ("CUDA", "CUDNN", "GPU", "KERNELS", "CPU"):
        assert feats.is_enabled(name), name
    for name in ("TPU", "XLA", "PALLAS", "MKLDNN", "SHARD_CHECK"):
        assert not feats.is_enabled(name), name
    assert len(feats) == 26 and "✔ CUDA" in repr(feats)


def test_check_consistency_on_gpu(card):
    assert test_utils.default_context() == card
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = rng.standard_normal((32, 96)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    test_utils.check_consistency("FullyConnected", [x, w, b],
                                 {"num_hidden": 32})
    test_utils.check_consistency("log_softmax", [x], {},
                                 ctx_list=[card, mx.cpu(0)])


def test_check_consistency_names_the_op_and_contexts(card, monkeypatch):
    """A second context that computes another function fails the check,
    which names the op and both contexts."""
    real = test_utils.invoke

    def shifted(op, args, params):
        out = real(op, args, params)
        return out + 1.0 if out.context == card else out

    monkeypatch.setattr(test_utils, "invoke", shifted)
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    with pytest.raises(AssertionError, match=r"exp inconsistent between "
                       r"cpu\(0\) and gpu\(0\)"):
        test_utils.check_consistency("exp", [x], {})


def test_set_np_through_a_captured_block(card):
    net = gluon.nn.Dense(8, in_units=16)
    net.initialize(device="cuda")
    net.hybridize()
    x = mx.np.random.uniform(size=(4, 16))
    mx.npx.set_np()
    try:
        with _capture.checking_syncs():
            outs = [net(x) for _ in range(3)]   # eager, captured, replayed
    finally:
        mx.npx.reset_np()
    graphs = net.cache_stats()["graphs"].values()
    assert sum(g["graphs"] for g in graphs) == 1
    assert sum(g["replays"] for g in graphs) >= 1
    assert all(isinstance(o, mx.np.ndarray) for o in outs)
    np.testing.assert_array_equal(outs[2].asnumpy(), outs[1].asnumpy())
    assert not isinstance(net(x), mx.np.ndarray)


def test_bulk_scope_changes_no_result_on_the_card(card):
    out = chip_smoke.numpy_deviation_cost(chain=32, size=768)
    assert out["host_us_per_op"] > 0 and out["host_us_per_op_in_bulk"] > 0
