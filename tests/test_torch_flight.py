"""The port's flight recorder against the JAX package's: the mmap ring
file is byte for byte the same format, so a file written by either
package reads identically in the other (wrapped rings and torn lines
included), and a ``chaos.KILL`` in a subprocess of the port leaves a
black box that both packages read and both ``mxtelemetry blackbox``
CLIs render alike."""
import os
import subprocess
import sys
import types

import pytest

from mxnet_tpu.obs import flight as jflight
from mxnet_tpu.telemetry import cli as jcli

import mxnet_tpu_torch
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.obs import flight
from mxnet_tpu_torch.telemetry import cli as pcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    mxnet_tpu_torch.__file__)))


def _fill(module, path, n, capacity=4096):
    rec = module.FlightRecorder(str(path), capacity=capacity)
    for i in range(n):
        rec.write({"kind": "event", "name": "e", "t": float(i),
                   "payload": {"i": i, "pad": "x" * (i % 7)}})
    rec.note("marker", i=n)
    rec.close()


@pytest.mark.parametrize("n", [5, 400])
def test_rings_read_alike_across_packages(tmp_path, n, monkeypatch):
    for writer in (jflight, flight):
        # one clock for both writers' notes: the files are then equal
        # byte for byte
        monkeypatch.setattr(writer, "time",
                            types.SimpleNamespace(time=lambda: 1.5))
        path = tmp_path / ("%s-%d.bbox" % (writer.__name__, n))
        _fill(writer, path, n)
        got, want = flight.read(str(path)), jflight.read(str(path))
        assert got == want and got[-1]["name"] == "marker"
        if n == 400:        # wrapped: the oldest records are gone
            assert got[0]["payload"]["i"] > 0
    a = (tmp_path / ("%s-%d.bbox" % (jflight.__name__, n))).read_bytes()
    b = (tmp_path / ("%s-%d.bbox" % (flight.__name__, n))).read_bytes()
    assert a == b


def test_bad_files_raise(tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"not a ring at all, long enough for a header....")
    with pytest.raises(MXNetError, match="bad magic"):
        flight.read(str(bad))
    with pytest.raises(MXNetError, match="too small"):
        flight.FlightRecorder(str(tmp_path / "small"), capacity=100)


WORKER = r"""
import sys
sys.path.insert(0, sys.argv[2])
from mxnet_tpu_torch import chaos, obs, telemetry
obs.install_blackbox(sys.argv[1], capacity=8192)
telemetry.enable()
telemetry.hooks.train_publish(8, 0.5)
chaos.arm(seed=0)
chaos.on("train.step", action=chaos.KILL)
chaos.fail_point("train.step", step=13)
print("still alive")
"""


def test_chaos_kill_leaves_a_readable_black_box(tmp_path, capsys):
    path = tmp_path / "gen0.bbox"
    out = subprocess.run([sys.executable, "-c", WORKER, str(path), REPO],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 137, out.stderr
    assert "still alive" not in out.stdout
    recs = flight.read(str(path))
    assert recs == jflight.read(str(path))
    names = [r["name"] for r in recs]
    assert names[0] == "obs.blackbox.open"
    assert "train_loop.publish" in names and "chaos.inject" in names
    assert recs[-1]["name"] == "chaos.kill"
    assert recs[-1]["payload"]["point"] == "train.step"
    assert pcli.main(["blackbox", str(path)]) == 0
    ptext = capsys.readouterr().out
    assert jcli.main(["blackbox", str(path)]) == 0
    assert capsys.readouterr().out == ptext
    assert "chaos.kill" in ptext and "train.step" in ptext
