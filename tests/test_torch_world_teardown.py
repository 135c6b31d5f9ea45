"""The world's teardown (``mxnet_tpu_torch.distributed._shutdown``) frees
the CUDA graphs that recorded a mesh's collectives before it destroys
the process groups, on the CPU with the store and the groups stood in.

On four H100s a rank whose captured ``TrainStep`` was still referenced
at interpreter exit did not exit until its graphs were freed first
(``tests/test_torch_cuda_mesh.py :: test_a_world_of_four_ranks``)."""
import torch.distributed as dist

from mxnet_tpu_torch import _capture
from mxnet_tpu_torch import distributed as mdist


class _Store:
    def __init__(self):
        self.keys = {}

    def set(self, key, value):
        self.keys[key] = value

    def wait(self, keys, timeout):
        assert all(k in self.keys for k in keys), keys


def test_graphs_are_freed_before_the_groups_are_destroyed(monkeypatch):
    calls = []
    monkeypatch.setattr(_capture, "release_collective_graphs",
                        lambda: calls.append("release") or 0)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **k: calls.append("destroy"))
    store = _Store()
    monkeypatch.setattr(mdist, "_world",
                        mdist._World(store, None, 2, 1, None))
    mdist._shutdown()
    assert calls == ["release", "destroy"]
    assert mdist._world is None
    assert list(store.keys) == ["mxbar/g%d/shutdown/1" % mdist.generation()]


def test_release_without_collective_graphs_frees_nothing():
    assert _capture.release_collective_graphs() == 0
