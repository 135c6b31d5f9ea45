"""The port's ``mx.profiler`` on the CPU: the reference control surface
over ``torch.profiler`` writes a Chrome trace that holds the hybridized
call's ``mx.cachedop:<Block>`` range and user scopes, and ``dumps()``
renders the JAX package's table, column for column, over the same
``mx.profiling`` reports."""
import json

import numpy as np
import pytest

from mxnet_tpu import profiler as jprofiler

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, profiler, profiling


@pytest.fixture(autouse=True)
def _stopped():
    yield
    profiler.set_state("stop")
    profiling.disable()
    profiling.reset()
    profiler.reset()


def _net():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, in_units=8), gluon.nn.Activation("relu"),
            gluon.nn.Dense(4, in_units=16))
    net.initialize(device="cpu")
    net.hybridize()
    return net


def test_trace_holds_the_cachedop_range_and_scopes(tmp_path):
    x = mx.nd.array(np.random.default_rng(0).standard_normal((4, 8))
                    .astype(np.float32), ctx=mx.cpu())
    with mx.cpu():
        net = _net()
        profiler.set_config(filename=str(tmp_path / "trace.json"),
                            profile_all=True)
        profiler.set_state("run")
        assert profiler.state() == "run"
        with profiler.scope("user.region"):
            net(x)
        with profiler.Task(profiler.Domain("dom"), "task"):
            net(x)
        profiler.marker("here")
        path = profiler.dump()
    assert profiler.state() == "stop"
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "mx.cachedop:HybridSequential" in names
    assert {"user.region", "dom::task", "marker:here"} <= names


def test_dumps_has_the_jax_table_columns():
    jlines = jprofiler.dumps().splitlines()
    plines = profiler.dumps().splitlines()
    assert plines[:3] == jlines[:3]
    profiling.enable()
    with mx.cpu():
        net = _net()
        net(mx.nd.array(np.ones((2, 8), np.float32), ctx=mx.cpu()))
    lines = profiler.dumps().splitlines()
    assert lines[1] == jlines[1]
    assert lines[2].split()[0] == "hybrid:HybridSequential"
    rows = json.loads(profiler.dumps(format="json", sort_by="flops"))
    assert sorted(rows[0]) == ["avg", "bytes", "count", "flops", "max",
                               "min", "name", "peak_hbm", "total"]
    assert rows[0]["flops"] == 2 * 2 * 8 * 16 + 2 * 2 * 16 * 4
    with pytest.raises(mx.MXNetError):
        profiler.dumps(sort_by="nope")
    with pytest.raises(mx.MXNetError):
        profiler.set_config(nope=1)


def test_counters_live_in_telemetry():
    from mxnet_tpu_torch import telemetry
    c = profiler.Counter(profiler.Domain("d"), "c", value=3)
    c.increment(2)
    c.decrement()
    assert c.value == 4 == profiler.Counter("d::c").value
    assert telemetry.registry().get("profiler.d::c").value == 4
    profiler.reset()
    assert c.value == 0
    # a profiled run with no card traces the host only
    assert profiler.kernel_rows() == []



def test_trace_replays_of_groups_a_trace_by_graph_launch():
    """Phase 17 (b) tells replays apart by the correlation id that a
    replayed graph's kernels share with its ``cudaGraphLaunch``, in
    launch order, with each launch's lag to its first recorded kernel."""
    import chip_smoke

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                "ts": ts, "dur": 5, "args": {"correlation": corr}}

    def kernel(ts, corr, name):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": 2, "args": {"correlation": corr}}

    events = [launch(200, 9), launch(100, 7), launch(300, 11),
              kernel(130, 7, "bn_relu_fwd_kernel"), kernel(120, 7, "gemm"),
              kernel(140, 7, "bn_relu_fwd_kernel"),
              kernel(210, 9, "bn_relu_fwd_kernel"), kernel(220, 9, "gemm"),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 90,
               "dur": 1, "args": {"correlation": 7}}]
    replays = chip_smoke.trace_replays_of(events)
    assert [dict(r["kernels"]) for r in replays] == [
        {"bn_relu_fwd_kernel": 2, "gemm": 1},
        {"bn_relu_fwd_kernel": 1, "gemm": 1}, {}]
    assert [r["launch_to_first_kernel_us"] for r in replays] == [20, 10,
                                                                 None]
    assert chip_smoke.trace_replays_of(events[3:]) == []


def test_complete_replays_keeps_the_full_replays_of_one_graph():
    """Phase 17 (b) counts the replays that hold every kernel event: a
    replay the tracer dropped records of holds fewer and is left out;
    a replay holding more than the others makes it the one complete
    replay, so the others fall short of the three counted."""
    from collections import Counter

    import chip_smoke
    full = Counter({"gemm": 4, "bn_relu_fwd_kernel": 2})
    lossy = Counter({"gemm": 3, "bn_relu_fwd_kernel": 2})
    got, complete = chip_smoke.complete_replays([full, full.copy(), lossy,
                                                 full.copy()])
    assert got == full and len(complete) == 3
    extra = full + Counter({"copy": 1})
    got, complete = chip_smoke.complete_replays([full, full, extra, full])
    assert got == extra and len(complete) == 1
    assert chip_smoke.complete_replays([]) == ({}, [])
