"""The PyTorch port stands alone: importing it pulls in neither JAX nor
the JAX package, no module of it imports either, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch import MXNetError, resolve_device

PKG = pathlib.Path(mxnet_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def test_import_leaves_jax_and_mxnet_tpu_out():
    modules = sorted(
        ".".join(("mxnet_tpu_torch",) + p.relative_to(PKG).with_suffix("")
                 .parts[:-1 if p.name == "__init__.py" else None])
        for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            "for m in %r: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r); print(bad)" % (modules, FORBIDDEN))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_imperative_api_loads_neither_jax_nor_mxnet_tpu():
    """``import mxnet_tpu_torch as mx`` with ``mx.nd``, ``gluon.data``
    and ``metric`` in use; the new subpackages are among the modules the
    tests above import one by one."""
    names = {p.relative_to(PKG).parts[0] for p in PKG.rglob("*.py")}
    assert {"ndarray", "metric.py"} <= names
    assert (PKG / "gluon" / "data" / "vision" / "datasets.py").exists()
    code = ("import sys\n"
            "import mxnet_tpu_torch as mx\n"
            "mx.nd; mx.gluon.data.vision.MNIST; mx.metric.Accuracy\n"
            "with mx.cpu():\n"
            "    a = mx.nd.array([1.0, 2.0]) * 2\n"
            "assert a.asnumpy().tolist() == [2.0, 4.0]\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (FORBIDDEN,))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_optimizer_and_sentinel_load_neither_jax_nor_mxnet_tpu():
    """The optimizer module (schedulers, every optimizer, the ``mx.nd``
    update ops) and the numerics sentinel, imported and used in a fresh
    process; the scan above imports each of their modules too."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"optimizer/lr_scheduler.py", "analysis/numerics.py",
            "ops/optimizer_ops.py"} <= names
    code = ("import sys, torch\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.analysis import numerics\n"
            "s = mx.lr_scheduler.PolyScheduler(max_update=10, base_lr=0.1)\n"
            "o = mx.optimizer.create('adam', lr_scheduler=s)\n"
            "u = mx.optimizer.get_updater(o)\n"
            "w = torch.ones(3)\n"
            "u(0, torch.ones(3), w)\n"
            "assert (w < 1).all() and not numerics.check_enabled()\n"
            "with mx.cpu():\n"
            "    mx.nd.adam_update(mx.nd.ones((2,)), mx.nd.ones((2,)),\n"
            "                      mx.nd.zeros((2,)), mx.nd.zeros((2,)))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (FORBIDDEN,))
    env = dict(os.environ)
    env.pop("MXNET_TPU_NUMERICS_CHECK", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_pretraining_loop_and_kvstore_load_neither_jax_nor_mxnet_tpu():
    """The slice of BERT pretraining as users run it: ``mx.kv``,
    ``Trainer`` with its default single-process kvstore and 2-bit
    compression, ``gluon.Constant``, the new initializers, ``summary``,
    ``set_recording`` and the differentiable flat updates, used in a
    fresh process; the scan above imports ``kvstore.py`` too."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert "kvstore.py" in names
    code = ("import sys, torch\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import autograd, gluon\n"
            "from mxnet_tpu_torch.kernels import optimizer_update as ou\n"
            "assert mx.kv is mx.kvstore and mx.parallel and mx.serving\n"
            "net = gluon.nn.HybridSequential()\n"
            "net.add(gluon.nn.Dense(3, in_units=4))\n"
            "net.initialize(mx.init.Mixed(['.*'], [mx.init.Orthogonal()]),\n"
            "               mx.cpu(), False, True)\n"
            "c = gluon.Constant('c', [1.0, 2.0])\n"
            "c.initialize(ctx=mx.cpu())\n"
            "tr = gluon.Trainer(net.collect_params(), 'adam',\n"
            "                   compression_params={'type': '2bit'})\n"
            "x = mx.nd.NDArray(torch.ones(2, 4))\n"
            "with autograd.record():\n"
            "    loss = net(x).sum()\n"
            "loss.backward()\n"
            "tr.step(2)\n"
            "assert tr._kvstore.type == 'device'\n"
            "assert 'Total params' in net.summary(x)\n"
            "w = torch.ones(5, requires_grad=True)\n"
            "nw, nm = ou.lars_bucket_update([w], [torch.ones(5)],\n"
            "                               [torch.zeros(5)], [0.1], [0.0],\n"
            "                               [False])\n"
            "nw[0].sum().backward()\n"
            "assert w.grad is not None\n"
            "assert autograd.set_recording(True) is False\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (FORBIDDEN,))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_input_path_and_its_process_pool_load_neither_jax_nor_mxnet_tpu(
        tmp_path):
    """``mx.recordio``, ``mx.image``, ``mx.io`` and ``mx.dataio`` used in
    a fresh process, ``ImageIter``'s forkserver process pool among them:
    an augmenter run inside the worker writes into the image whether a
    forbidden module is loaded there."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"recordio.py", "_native/__init__.py", "image/image.py",
            "io/io.py", "dataio/feed.py", "dataio/transforms.py"} <= names
    (tmp_path / "probe.py").write_text(
        "import sys\n"
        "import numpy as np\n"
        "class Probe:\n"
        "    def __call__(self, img):\n"
        "        bad = any(m.split('.')[0] in %r for m in sys.modules)\n"
        "        return np.full_like(np.asarray(img), 200 if bad else 100)\n"
        % (FORBIDDEN,))
    code = ("import sys\n"
            "import numpy as np\n"
            "import mxnet_tpu_torch as mx\n"
            "from probe import Probe\n"
            "rec = mx.recordio.MXIndexedRecordIO(%r, %r, 'w')\n"
            "for i in range(4):\n"
            "    rec.write_idx(i, mx.recordio.pack(\n"
            "        mx.recordio.IRHeader(0, float(i), i, 0),\n"
            "        np.full((8, 8, 3), i, np.uint8).tobytes()))\n"
            "rec.close()\n"
            "it = mx.image.ImageIter(2, (3, 8, 8), path_imgrec=%r,\n"
            "    aug_list=[Probe()], preprocess_procs=1, dtype='uint8')\n"
            "data, labels, pad = it.next_np()\n"
            "it.close()\n"
            "assert (data == 100).all(), np.unique(data)\n"
            "feed = mx.io.ImageRecordIter(path_imgrec=%r,\n"
            "    data_shape=(3, 8, 8), batch_size=2, ctx=mx.cpu(),\n"
            "    preprocess_threads=0, dtype='bfloat16', mean_r=1.0)\n"
            "assert len(list(feed)) == 2\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (str(tmp_path / "d.idx"), str(tmp_path / "d.rec"),
                      str(tmp_path / "d.rec"), str(tmp_path / "d.rec"),
                      FORBIDDEN))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent), str(tmp_path)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_loop_and_the_ops_plane_load_neither_jax_nor_mxnet_tpu(
        tmp_path):
    """``sync``, ``telemetry``, ``chaos``, ``obs``, ``preemption`` and
    ``serving/loop.py`` imported and used in a fresh process: a chaos
    scenario trains, publishes and hot-swaps on the CPU with telemetry,
    tracing and the sanitizer on; the scan above imports each of their
    modules too."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"sync.py", "preemption.py", "serving/loop.py",
            "telemetry/hooks.py", "chaos/scenarios.py", "obs/trace.py",
            "obs/status.py"} <= names
    code = ("import sys, warnings\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import chaos, obs, sync, telemetry\n"
            "from mxnet_tpu_torch import preemption\n"
            "from mxnet_tpu_torch.serving import loop\n"
            "sync.enable(seed_static=False)\n"
            "telemetry.enable()\n"
            "obs.enable_tracing()\n"
            "with mx.cpu():\n"
            "    rep = chaos.scenarios.hotswap_scenario(%r, torn=True,\n"
            "        device='cpu', requests_per_client=4)\n"
            "assert rep['served_step'] == 2 and rep['errors'] == []\n"
            "assert telemetry.counter('serving.swaps').value == 1\n"
            "assert obs.status.statusz()['schema'] == 'mxstatusz.v1'\n"
            "assert any(s['name'] == 'serving.swap' for s in obs.spans())\n"
            "assert callable(preemption.install) and loop.RegistryWatcher\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (str(tmp_path / "loop"), FORBIDDEN))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_port_imports_jax_or_mxnet_tpu():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 35
    for path in files + [PKG.parent / "chip_smoke.py",
                         PKG.parent / "chip_paths.py"]:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("args", [["bogus"], ["decode", "mnist"]])
def test_chip_paths_exits_2_on_an_unknown_path_or_without_a_card(args):
    """``chip_paths.py`` names an unknown path, and without CUDA it
    exits before building or running anything."""
    out = subprocess.run([sys.executable, str(PKG.parent / "chip_paths.py")]
                         + args, capture_output=True, text=True,
                         timeout=120, cwd=str(PKG.parent),
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
    assert ("unknown path bogus" if args == ["bogus"]
            else "CUDA is not available") in out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(MXNetError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from mxnet_tpu_torch.serving import ModelRegistry
    from mxnet_tpu_torch.serving.decode import PagedKVCache, tiny_gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tiny_gpt(vocab_size=32, units=16, num_layers=2, num_heads=2,
                     max_seq=32)
    with pytest.raises(MXNetError):
        model.init_params(0)
    with pytest.raises(MXNetError):
        PagedKVCache(1, 1, 4, block_size=4, num_blocks=4)
    params = model.init_params(0, device="cpu")
    with pytest.raises(MXNetError):
        ModelRegistry().register_generative("gpt", model, params=params)


def test_training_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = resnet18_v1(layout="NHWC")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        net.initialize()
    net.initialize(device="cpu")


def test_the_ops_plane_loads_neither_jax_nor_mxnet_tpu(tmp_path):
    """The single-process ops plane -- ``mx.profiling`` (a walked
    ``TrainStep``, the roofline, the report files and ``mxprof``),
    ``mx.profiler``, the goodput ledger, the leak sentinel, the flight
    recorder, the obs server, the supervisor and ``mxtelemetry`` --
    imported and used in a fresh process; the scan above imports each
    of their modules too."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"profiling/aten.py", "profiling/cost.py", "profiling/cli.py",
            "profiler.py", "obs/goodput.py", "obs/flight.py",
            "obs/server.py", "obs/fleet.py", "analysis/memory.py",
            "supervisor.py", "telemetry/cli.py",
            "kernels/costs.py"} <= names
    code = ("import sys, torch\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import gluon, obs, parallel, profiling\n"
            "from mxnet_tpu_torch import profiler, supervisor, telemetry\n"
            "from mxnet_tpu_torch.analysis import memory\n"
            "from mxnet_tpu_torch.profiling import cli, roofline\n"
            "from mxnet_tpu_torch.telemetry import cli as tcli\n"
            "profiling.enable(); telemetry.enable()\n"
            "with mx.cpu():\n"
            "    net = gluon.nn.Dense(2, in_units=3)\n"
            "    net.initialize(device='cpu')\n"
            "    tr = gluon.Trainer(net.collect_params(), 'sgd')\n"
            "    st = parallel.TrainStep(net,\n"
            "        gluon.loss.SoftmaxCrossEntropyLoss(), tr)\n"
            "    st(torch.ones(4, 3), torch.zeros(4))\n"
            "assert st.cost_analysis()['flops'] > 0\n"
            "roofline.build(profiling.reports()[0], 0.01)\n"
            "assert cli.main(['report', '--dir',\n"
            "                 profiling.save_reports(%r)[:-12]]) == 0\n"
            "obs.goodput.StepLedger(window_steps=1).step()\n"
            "memory.live_census()\n"
            "obs.install_blackbox(%r)\n"
            "obs.serve(0); obs.server.stop()\n"
            "supervisor.Supervisor([sys.executable, '-c', 'pass'], 1)\n"
            "profiler.dumps()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r))" % (str(tmp_path / "rep"), str(tmp_path / "bb"),
                      FORBIDDEN))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_env_registry_defaults_and_typed_reads(monkeypatch):
    from mxnet_tpu import env as jax_env
    from mxnet_tpu_torch import env
    assert len(env.REGISTRY) == 46
    for name, var in env.REGISTRY.items():
        assert var.default == jax_env.REGISTRY[name].default, name
        assert var.type is jax_env.REGISTRY[name].type, name
    for raw, want in (("0", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("MXNET_TPU_CKPT_ASYNC", raw)
        assert env.get("MXNET_TPU_CKPT_ASYNC") is want
        assert jax_env.get("MXNET_TPU_CKPT_ASYNC") is want
    monkeypatch.setenv("MXNET_TPU_SERVING_KV_BLOCK", "32")
    assert env.get("MXNET_TPU_SERVING_KV_BLOCK") == 32
    monkeypatch.setenv("MXNET_TPU_SERVING_KV_BLOCK", "x")
    with pytest.raises(MXNetError, match="not a valid int"):
        env.get("MXNET_TPU_SERVING_KV_BLOCK")
    with pytest.raises(MXNetError, match="unregistered"):
        env.get("MXNET_TPU_NOPE")
