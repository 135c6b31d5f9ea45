"""``chip_smoke.run_world``: the runner of the card phases' child worlds
(``python -m mxnet_tpu_torch.launch -n N``), on the CPU.

A world whose rank hangs is stopped at the runner's bound, after its
ranks' lines were relayed as they came, and the failure names each
rank's last line; a world that exits 0 gives back its output.  Each
world's workers are plain ``python`` processes that import nothing.
"""
import time

import pytest

import chip_smoke

BOUND_S = 10.0
GRACE_S = 5.0
_HANG = ("import os, time; r = int(os.environ['MXNET_TPU_PROC_ID']); "
         "print('rank %d: part x' % r, flush=True); "
         "time.sleep(120 if r == 1 else 0)")
_DONE = ("import os; print('rank %s: done' % os.environ['MXNET_TPU_PROC_ID'],"
         " flush=True)")


def test_a_hung_rank_is_streamed_stopped_and_named():
    seen = []
    t0 = time.perf_counter()
    with pytest.raises(chip_smoke.SmokeFailure) as err:
        chip_smoke.run_world(
            _HANG, 2, BOUND_S, grace=GRACE_S,
            echo=lambda line: seen.append((time.perf_counter() - t0, line)))
    took = time.perf_counter() - t0
    # the hung rank's line was relayed before the bound, not at the end
    arrived = [t for t, line in seen if line == "[1] rank 1: part x\n"]
    assert arrived and arrived[0] < BOUND_S, seen
    assert BOUND_S <= took < BOUND_S + GRACE_S + 5, took
    msg = str(err.value)
    assert "ran past its 10 s bound" in msg, msg
    assert "rank 1: [1] rank 1: part x" in msg, msg


def test_a_world_that_exits_0_returns_its_output():
    lines = chip_smoke.run_world(_DONE, 2, 60, echo=lambda line: None)
    assert sorted(lines) == ["[0] rank 0: done\n", "[1] rank 1: done\n"]
