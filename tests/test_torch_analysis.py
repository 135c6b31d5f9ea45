"""The port's ``mxnet_tpu_torch.analysis`` against the JAX package's
``mxnet_tpu.analysis`` on the same inputs (CPU).

- **The static rules on a shared corpus.**  Every multi-line Python
  source literal of the JAX package's rule tests (``tests/
  test_analysis.py``, ``test_perf.py``, ``test_numerics.py``,
  ``test_memory.py``: each fires-and-clean-twin pair and each
  suppression) goes through ``lint_source`` of both packages, which
  must give the same list of (rule id, line, severity), the sharding
  sanitizer's rules included (``tests/test_sharding.py``'s sources
  are in the corpus).
- **The project rules**: ``lint_paths`` and ``audit_lock_order`` on the
  same ``tmp_path`` trees.
- **The graph check** on the same symbols: the MLP, the broken ones,
  and zoo nets exported by the JAX package and loaded by both (their
  ``-symbol.json`` files are byte for byte equal): the same (rule,
  node, severity).
- **The CLI**: the same exit codes and JSON on the same inputs, SARIF
  equal apart from the tool's name and version.
- **``diff_audit``** of the perf, numerics and memory audits: the same
  artifacts give the same diagnostics.
- torch's spellings (``.cpu()``, ``torch.cuda.synchronize()``,
  ``with torch.cuda.graph(...)``, ``.to(torch.bfloat16)``, ``.half()``,
  ``torch.zeros(4096, 4096)``), held on the port alone;
- the port's own tree lints clean, the counterpart of the JAX tests'
  ``test_lint_paths_on_repo_is_clean`` and ``test_cli_self_check_clean``.
"""
import ast
import copy
import json
import os
from pathlib import Path

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import analysis as jan
from mxnet_tpu.analysis import memory as jmem
from mxnet_tpu.analysis import numerics as jnum
from mxnet_tpu.analysis import perf as jperf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch.analysis import memory as tmem
from mxnet_tpu_torch.analysis import numerics as tnum
from mxnet_tpu_torch.analysis import perf as tperf
from mxnet_tpu_torch.base import MXNetError

REPO = Path(__file__).resolve().parent.parent
CORPUS_FILES = ("test_analysis.py", "test_perf.py", "test_numerics.py",
                "test_memory.py", "test_sharding.py")
# the sharding sanitizer's rules: the port has them too, so nothing is
# dropped from either package's findings
SHARDING_RULES = set()


def _corpus():
    """``(id, source)`` of every multi-line string literal of the JAX
    rule tests that parses as Python."""
    out = []
    for name in CORPUS_FILES:
        tree = ast.parse((REPO / "tests" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and "\n" in node.value:
                try:
                    ast.parse(node.value)
                except SyntaxError:
                    continue
                out.append(("%s:%d" % (name, node.lineno), node.value))
    return out


CORPUS = _corpus()


def _triples(diags, drop=()):
    return [(d.rule, d.line, d.severity) for d in diags
            if d.rule not in drop]


def test_corpus_covers_every_static_rule_the_port_shares():
    fired = set()
    for _id, src in CORPUS:
        fired.update(d.rule for d in jan.lint_source(src, "probe.py"))
    ast_rules = {r.id for r in tan.list_rules("ast")}
    assert ast_rules <= fired, sorted(ast_rules - fired)
    assert len(CORPUS) >= 60


@pytest.mark.parametrize("case", CORPUS, ids=[c[0] for c in CORPUS])
def test_static_rules_agree_on_the_shared_corpus(case):
    _id, src = case
    want = _triples(jan.lint_source(src, "probe.py"), SHARDING_RULES)
    got = _triples(tan.lint_source(src, "probe.py"))
    assert got == want


@pytest.mark.parametrize("path", ["mxnet_tpu/checkpoint/core.py",
                                  "mxnet_tpu_torch/checkpoint/core.py",
                                  "elsewhere.py"])
def test_bare_state_write_exemption_agrees(path):
    src = ("def save_stage(fname):\n"
           "    with open(fname, 'wb') as f:\n"
           "        f.write(b'x')\n")
    assert _triples(tan.lint_source(src, path)) == \
        _triples(jan.lint_source(src, path), SHARDING_RULES)


def test_rule_registries_agree_but_for_sharding():
    """The registries are equal, the sharding sanitizer's rules
    (``collective-drift`` and the static ones) included."""
    jids = {r.id: (r.kind, r.severity) for r in jan.list_rules()}
    tids = {r.id: (r.kind, r.severity) for r in tan.list_rules()}
    assert tids == jids


# ----------------------------------------------------------------------
# project rules on the same trees
# ----------------------------------------------------------------------

_LOCKS_A = ("import sync\n"
            "a = sync.Lock(name='L.a')\n"
            "b = sync.Lock(name='L.b')\n"
            "def fwd():\n"
            "    with a:\n"
            "        with b:\n"
            "            pass\n")
_LOCKS_B_REV = _LOCKS_A.replace("def fwd():\n    with a:\n        with b:",
                                "def rev():\n    with b:\n        with a:")
_THREADS = ("import threading, time\n"
            "class W:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def _run(self):\n"
            "        self.n = 1\n"
            "    def go(self):\n"
            "        threading.Thread(target=self._run).start()\n"
            "        self.n = 2\n"
            "        while True:\n"
            "            time.sleep(1)\n")


@pytest.mark.parametrize("tree", ["inverted", "consistent", "suppressed",
                                  "threads"])
def test_project_rules_agree_on_the_same_tree(tmp_path, tree):
    if tree == "threads":
        (tmp_path / "w.py").write_text(_THREADS)
    else:
        (tmp_path / "probe_a.py").write_text(_LOCKS_A)
        rev = _LOCKS_A if tree == "consistent" else _LOCKS_B_REV
        if tree == "suppressed":
            rev = rev.replace("        with a:\n", "        with a:  "
                              "# mxlint: disable=lock-order-inversion\n")
        (tmp_path / "probe_b.py").write_text(rev)
    paths = [str(tmp_path)]

    def triples(diags):
        return sorted((d.rule, os.path.basename(d.file), d.line,
                       d.severity) for d in diags)
    assert triples(tan.audit_lock_order(paths)) == \
        triples(jan.audit_lock_order(paths))
    assert sorted(_triples(tan.lint_paths(paths))) == \
        sorted(_triples(jan.lint_paths(paths), SHARDING_RULES))
    assert tan.static_order_edges(paths) == jan.static_order_edges(paths)
    if tree == "inverted":
        assert tan.audit_lock_order(paths)


# ----------------------------------------------------------------------
# the graph check on the same symbols
# ----------------------------------------------------------------------

def _mlp(mx):
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mx.sym.Activation(fc, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _unknown_op(mx):
    if mx is jmx:
        from mxnet_tpu.symbol.symbol import Symbol, _Node
    else:
        from mxnet_tpu_torch.symbol.symbol import Symbol, _Node
    v = _Node(None, "x", {}, [])
    return Symbol([(_Node("NoSuchOp2077", "bad0", {}, [(v, 0)]), 0)])


def _dangling(mx):
    if mx is jmx:
        from mxnet_tpu.symbol.symbol import Symbol, _Node
    else:
        from mxnet_tpu_torch.symbol.symbol import Symbol, _Node
    v = _Node(None, "x", {}, [])
    return Symbol([(_Node("dot", "d0", {}, [(v, 0)]), 0)])


SYMBOLS = {
    "mlp": (_mlp, {"data": (4, 16), "softmax_label": (4,)}, False),
    "duplicate": (lambda mx: mx.sym.var("x") + mx.sym.var("x"), None,
                  True),
    "distinct": (lambda mx: mx.sym.var("x") + mx.sym.var("y"), None,
                 True),
    "contradiction": (lambda mx: mx.sym.dot(
        mx.sym.var("d", shape=(4, 5)), mx.sym.var("w", shape=(3, 7))),
        None, False),
    "consistent": (lambda mx: mx.sym.dot(
        mx.sym.var("a", shape=(4, 5)), mx.sym.var("b", shape=(5, 7))),
        None, False),
    "unknown_shape": (lambda mx: mx.sym.var("p") + mx.sym.var("q"), None,
                      False),
    "promotion": (lambda mx: mx.sym.var("lo", shape=(2, 2),
                                        dtype="float16")
                  + mx.sym.var("hi", shape=(2, 2), dtype="float32"),
                  None, False),
    "unknown_op": (_unknown_op, None, True),
    "dangling": (_dangling, None, True),
}


def _graph_triples(diags):
    return sorted((d.rule, d.node, d.severity) for d in diags)


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_graph_check_agrees_on_the_same_symbols(name):
    build, shapes, structural = SYMBOLS[name]
    want = jan.check_symbol(build(jmx), shapes=shapes,
                            structural_only=structural)
    got = tan.check_symbol(build(tmx), shapes=shapes,
                           structural_only=structural)
    assert _graph_triples(got) == _graph_triples(want)


@pytest.mark.parametrize("name,shape", [
    ("resnet18_v1", (1, 3, 64, 64)), ("squeezenet1.1", (1, 3, 64, 64)),
    ("mobilenet0.25", (1, 3, 64, 64))])
def test_graph_check_agrees_on_exported_zoo_graphs(tmp_path, name, shape):
    from mxnet_tpu.gluon.model_zoo import vision
    sym = vision.get_model(name)(jmx.sym.var("data"))
    path = tmp_path / "net-symbol.json"
    sym.save(str(path))
    want = jan.check_symbol(jmx.sym.load(str(path)),
                            shapes={"data": shape})
    got = tan.check_symbol(tmx.sym.load(str(path)),
                           shapes={"data": shape})
    assert _graph_triples(got) == _graph_triples(want)
    assert not [d for d in got if d.severity == tan.ERROR]


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

CLI_FILES = {
    "bad.py": "def f(a=[]):\n    return a\n",
    "good.py": "def f(a=None):\n    return a\n",
    "except.py": "try:\n    pass\nexcept:\n    pass\n",
}
CLI_ARGS = [["bad.py"], ["good.py"], ["bad.py", "--disable",
                                      "mutable-default"],
            ["bad.py", "except.py"], ["bad.py", "--strict"], []]


@pytest.mark.parametrize("args", CLI_ARGS,
                         ids=[" ".join(a) or "no-args" for a in CLI_ARGS])
def test_cli_exit_codes_and_json_agree(tmp_path, capsys, args):
    for name, src in CLI_FILES.items():
        (tmp_path / name).write_text(src)
    argv = [str(tmp_path / a) if a.endswith(".py") else a for a in args]
    if args:
        argv.append("--json")
    rj = jan.main(list(argv))
    out_j = capsys.readouterr().out
    rt = tan.main(list(argv))
    out_t = capsys.readouterr().out
    assert rt == rj
    if args:
        assert json.loads(out_t) == json.loads(out_j)


def test_cli_graph_mode_agrees(tmp_path, capsys):
    path = tmp_path / "m-symbol.json"
    _mlp(jmx).save(str(path))
    for shapes, want_rc in ((["data=2,16", "softmax_label=2"], 0),
                            ([], 0)):
        argv = ["--graph", str(path), "--json"]
        for s in shapes:
            argv += ["--shape", s]
        rj = jan.main(list(argv))
        dj = json.loads(capsys.readouterr().out)
        rt = tan.main(list(argv))
        dt = json.loads(capsys.readouterr().out)
        assert rt == rj == want_rc
        assert _graph_triples_json(dt) == _graph_triples_json(dj)


def _graph_triples_json(payload):
    return sorted((d["rule"], d["node"], d["severity"], d["file"])
                  for d in payload["diagnostics"])


def test_cli_sarif_agrees_but_for_the_tool(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(CLI_FILES["bad.py"])
    outs = {}
    for pkg, an in (("jax", jan), ("port", tan)):
        out = tmp_path / ("%s.sarif" % pkg)
        assert an.main([str(bad), "--sarif", str(out), "--json"]) == 1
        capsys.readouterr()
        outs[pkg] = json.loads(out.read_text())
    port = copy.deepcopy(outs["port"])
    tool = port["runs"][0]["tool"]["driver"]
    assert tool.pop("name") == "mxlint-torch"
    assert tool.pop("version") == tmx.__version__
    jtool = outs["jax"]["runs"][0]["tool"]["driver"]
    assert jtool.pop("name") == "mxlint"
    assert port == outs["jax"]
    assert port["version"] == "2.1.0"


def test_cli_audit_diffs_reject_a_foreign_schema(tmp_path, capsys):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"schema": "nope"}))
    for flag in ("--perf-diff", "--numerics-diff", "--memory-diff"):
        assert tan.main([flag, str(p), str(p)]) == \
            jan.main([flag, str(p), str(p)]) == 2
    capsys.readouterr()


# ----------------------------------------------------------------------
# diff_audit of the three audits on the same artifacts
# ----------------------------------------------------------------------

def _artifact(schema, metrics, advisories=()):
    return {"schema": schema,
            "executables": {"step": {"metrics": dict(metrics),
                                     "advisories": list(advisories)}}}


PERF_BASE = {"transpose_share": 0.1, "unfused_elementwise_share": 0.05,
             "pad_waste": 0.0, "intensity": 40.0}
NUM_BASE = {"convert_share": 0.05, "half_accum_dot_share": 0.0,
            "half_reduce_share": 0.0}
MEM_BASE = {"peak_hbm_bytes": 1 << 30, "argument_bytes": 1 << 28}


def _variants(base, grow, adv):
    out = {"same": (base, []), "improved": ({k: v * 0.5 for k, v in
                                             base.items()}, [])}
    for m in grow:
        cur = dict(base)
        cur[m] = cur[m] * 1.5 if m in ("peak_hbm_bytes",) else cur[m] + 0.1
        out["grown_" + m] = (cur, [])
    out["advisory"] = (base, [adv])
    return out


PERF_ADV = {"kind": "transpose-share", "category": "transpose_layout",
            "share": 0.3, "op_names": [], "message": "m"}
NUM_ADV = {"kind": "half-reduce", "share": 0.2, "op_names": [],
           "message": "m"}
MEM_ADV = {"kind": "temp-share", "share": 3.0, "dominant_category": None,
           "message": "m"}
AUDITS = {
    "perf": (jperf, tperf, jperf.AUDIT_SCHEMA, PERF_BASE, _variants(
        PERF_BASE, ("transpose_share", "unfused_elementwise_share",
                    "pad_waste"), PERF_ADV)),
    "numerics": (jnum, tnum, jnum.AUDIT_SCHEMA, NUM_BASE, _variants(
        NUM_BASE, ("convert_share", "half_accum_dot_share",
                   "half_reduce_share"), NUM_ADV)),
    "memory": (jmem, tmem, jmem.AUDIT_SCHEMA, MEM_BASE, _variants(
        MEM_BASE, ("peak_hbm_bytes",), MEM_ADV)),
}
AUDIT_CASES = [(a, v) for a in sorted(AUDITS) for v in AUDITS[a][4]]
AUDIT_CASES += [("perf", "intensity_drop"), ("memory", "new_step"),
                ("perf", "new_step")]


@pytest.mark.parametrize("audit,variant", AUDIT_CASES,
                         ids=["%s-%s" % c for c in AUDIT_CASES])
def test_diff_audit_agrees(audit, variant):
    jmod, tmod, schema, base_m, variants = AUDITS[audit]
    assert tmod.AUDIT_SCHEMA == schema
    base = _artifact(schema, base_m)
    if variant == "intensity_drop":
        cur = _artifact(schema, dict(base_m, intensity=10.0))
    elif variant == "new_step":
        cur = copy.deepcopy(base)
        cur["executables"]["other"] = {"metrics": dict(base_m),
                                       "advisories": [dict(
                                           PERF_ADV if audit == "perf"
                                           else MEM_ADV)]}
    else:
        metrics, adv = variants[variant]
        cur = _artifact(schema, metrics, adv)
    want = jmod.diff_audit(base, cur, tol=0.02)
    got = tmod.diff_audit(base, cur, tol=0.02)
    assert _graph_triples(got) == _graph_triples(want)
    if variant not in ("same", "improved"):
        assert got


@pytest.mark.parametrize("audit", sorted(AUDITS))
def test_audit_artifacts_round_trip_and_default_tolerance(tmp_path,
                                                          audit):
    jmod, tmod, schema, base_m, _v = AUDITS[audit]
    art = _artifact(schema, base_m)
    path = tmp_path / "a.json"
    tmod.save_audit(str(path), art)
    assert tmod.load_audit(str(path)) == jmod.load_audit(str(path)) == art
    assert tmod.diff_audit(art, art) == []
    with pytest.raises(ValueError):
        bad = tmp_path / "b.json"
        bad.write_text(json.dumps({"schema": "x"}))
        tmod.load_audit(str(bad))


# ----------------------------------------------------------------------
# the sharding sanitizer's names: each runs (the rules and the contract
# against the JAX package's are tests/test_torch_sharding.py's)
# ----------------------------------------------------------------------

def _sharding_name_runs(name, tmp_path):
    if name == "audit_sharding":
        src = tmp_path / "m.py"
        src.write_text("from jax.sharding import PartitionSpec as P\n"
                       "spec = P('dq')\n")
        return [d.rule for d in tan.audit_sharding([str(src)])] == \
            ["mesh-axis-unknown"]
    if name == "collective_contract":
        return tan.collective_contract()["schema"] == \
            "mxshard.collectives.v1"
    if name == "collective_profile":
        rep = {"collectives": {"all-reduce": {"count": 2, "bytes": 8}}}
        return tan.collective_profile(rep) == rep["collectives"]
    if name == "diff_contract":
        return tan.diff_contract({}, {"executables": {}}) == []
    if name in ("save_contract", "load_contract"):
        path = str(tmp_path / "c.json")
        saved = tan.save_contract(path)
        return tan.load_contract(path) == saved
    with tan.transfer_guard("allow"):
        pass
    with pytest.raises(MXNetError, match="not one of"):
        with tan.transfer_guard("sometimes"):
            pass
    return True


@pytest.mark.parametrize("name", ["audit_sharding", "collective_contract",
                                  "collective_profile", "diff_contract",
                                  "load_contract", "save_contract",
                                  "transfer_guard"])
def test_sharding_names_raise_naming_item_9b(name, tmp_path):
    """Each of the sanitizer's names runs in the port (they raised
    before the mesh slice)."""
    assert name in tan.__all__
    assert _sharding_name_runs(name, tmp_path)


def test_the_all_names_are_the_jax_packages():
    assert set(tan.__all__) == set(jan.__all__)


# ----------------------------------------------------------------------
# torch's spellings, on the port alone
# ----------------------------------------------------------------------

TORCH_CASES = {
    "cpu_in_hybrid_forward": (
        "class M:\n"
        "    def hybrid_forward(self, F, x):\n"
        "        y = x.cpu()\n"
        "        return y.numpy()\n", [("host-sync", 3), ("host-sync", 4)]),
    "synchronize_in_hybrid_forward_of_a_block": (
        "import torch\n"
        "class M(HybridBlock):\n"
        "    def forward(self, x):\n"
        "        torch.cuda.synchronize()\n"
        "        if x.sum() > 0:\n"
        "            return x\n"
        "        return -x\n", [("host-sync", 4), ("tracer-branch", 5)]),
    "item_in_a_graph_capture": (
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = x * 2\n"
        "        n = y.item()\n"
        "    return y.item()\n", [("host-sync", 5)]),
    "bf16_sum_by_to": (
        "import torch\n"
        "class M:\n"
        "    def hybrid_forward(self, F, x):\n"
        "        h = x.to(torch.bfloat16)\n"
        "        return h.sum()\n", [("bf16-sensitive-reduce", 5)]),
    "bf16_sum_upcast_by_float": (
        "import torch\n"
        "class M:\n"
        "    def hybrid_forward(self, F, x):\n"
        "        h = x.to(torch.bfloat16)\n"
        "        return h.float().sum()\n", []),
    "half_loss_backward": (
        "def train(net, x):\n"
        "    loss = net(x).half()\n"
        "    loss.backward()\n", [("unscaled-half-loss", 3)]),
    "torch_zeros_copied_to_host_in_a_loop": (
        "import torch\n"
        "def f(n):\n"
        "    big = torch.zeros(4096, 4096)\n"
        "    for _ in range(n):\n"
        "        host = big.cpu()\n"
        "    return host\n", [("host-materialize-large", 5)]),
    "clamp_min_guards_log": (
        "import torch\n"
        "class M:\n"
        "    def hybrid_forward(self, F, x):\n"
        "        return torch.log(torch.clamp_min(x, 1e-6))\n", []),
    "plain_call_is_captured": (
        "class M:\n"
        "    def _plain_call(self, args):\n"
        "        return args[0].tolist()\n", [("host-sync", 3)]),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_spellings_on_the_port(case):
    src, want = TORCH_CASES[case]
    got = [(d.rule, d.line) for d in tan.lint_source(src, "probe.py")]
    assert got == want


def test_pad_waste_suggests_the_tensor_core_alignment():
    d = tan.lint_source("def f(nn, layout):\n    nn.Dense(500)\n",
                        "probe.py")
    assert [x.rule for x in d] == ["pad-waste"]
    assert "did you mean 504" in d[0].message
    assert "fp32/TF32" in d[0].message


# ----------------------------------------------------------------------
# the port lints itself clean
# ----------------------------------------------------------------------

def test_cli_self_check_on_the_port_is_clean(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert tan.main(["--self", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["errors"] == 0 and payload["warnings"] == 0


def test_retrace_audit_on_the_port_is_clean_and_anchors_present():
    from mxnet_tpu_torch.analysis.retrace import (cache_key_fields,
                                                  eager_dynamic_params)
    assert [d.format() for d in tan.audit_retrace()] == []
    assert set(cache_key_fields()) >= {"training", "shape", "dtype",
                                       "device"}
    from mxnet_tpu.ndarray.ndarray import _DYNAMIC_PARAMS
    assert eager_dynamic_params() == _DYNAMIC_PARAMS
