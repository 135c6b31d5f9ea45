"""The port's namesakes of the JAX package's plain MXNet API that it
lacked: each follows its JAX namesake's contract on the port's device
(``mx.context.gpu_memory_info``, ``mx.autograd.get_symbol``,
``mx.base.check_call``, ``analysis.memory.device_hbm_bytes``,
``telemetry.hooks.update_observability_doc``)."""
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import base as jbase
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.telemetry import hooks as jhooks

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.analysis import memory
from mxnet_tpu_torch.telemetry import hooks


def test_gpu_memory_info_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.context.gpu_memory_info()


def test_gpu_memory_info_is_mem_get_info(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def mem_get_info(device):
        seen.append(device)
        return (3 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert mx.context.gpu_memory_info(1) == (3 << 30, 80 << 30)
    assert seen == [1]


def test_get_symbol_raises_as_the_jax_one():
    with mx.cpu():
        x = mx.nd.array([1.0, 2.0])
    with pytest.raises(JMXNetError) as want:
        jautograd.get_symbol(jmx.nd.array([1.0, 2.0]))
    with pytest.raises(MXNetError) as got:
        mx.autograd.get_symbol(x)
    assert str(got.value) == str(want.value)


def test_check_call_is_a_no_op():
    assert mx.base.check_call(0) == jbase.check_call(0) == 0
    assert mx.base.check_call(None) is None


def test_device_hbm_bytes(monkeypatch):
    assert memory.device_hbm_bytes() is None          # the CPU

    class Props:
        total_memory = 85520809984

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    assert memory.device_hbm_bytes() == 85520809984


def test_update_observability_doc_names_the_missing_doc(tmp_path):
    with pytest.raises(MXNetError, match="no observability doc"):
        hooks.update_observability_doc()
    missing = tmp_path / "observability.md"
    with pytest.raises(MXNetError, match=str(missing)):
        hooks.update_observability_doc(str(missing))
    missing.write_text("no markers\n")
    with pytest.raises(MXNetError, match="missing the instrument-index"):
        hooks.update_observability_doc(str(missing))


def test_update_observability_doc_regenerates_the_ports_table(tmp_path):
    doc = tmp_path / "observability.md"
    doc.write_text("head\n%s\nstale\n%s\ntail\n"
                   % (hooks._INDEX_BEGIN, hooks._INDEX_END))
    new = hooks.update_observability_doc(str(doc))
    assert doc.read_text() == new
    head, rest = new.split(hooks._INDEX_BEGIN, 1)
    inside, tail = rest.split(hooks._INDEX_END, 1)
    assert head == "head\n" and tail == "\ntail\n"
    assert inside.strip("\n") == hooks.instrument_index_md().strip("\n")
    # the same generator as the JAX package's, over the port's registry
    assert jhooks.instrument_index_md().splitlines()[:2] \
        == hooks.instrument_index_md().splitlines()[:2]
