"""The port's public surface against the JAX package's, name by name.

A walker imports every public module of both packages
(``pkgutil.walk_packages``; not a ``__main__`` module, whose import runs
its command line on ``sys.argv``, nor a module with a ``_``-prefixed
part) and, for each JAX module, compares:

(a) the public names the module defines itself: a function or class
    whose ``__module__`` is the module, or a name its source binds at
    top level by assignment;
(b) a package ``__init__``'s public namespace, which is what users type
    (``mx.nd.concat``), less objects of other packages and less the
    package's own submodules, which (a) walks;
(c) for each public class of (a), every public member, inherited ones
    included, and ``__init__``;
(d) for each callable of (a) and (c), its keyword names: every
    positional-or-keyword and keyword-only parameter.  The port's
    callable must name each one; a keyword it takes only through
    ``**kwargs`` counts only where a case of :data:`KWARGS_CALLS`
    calls it with that keyword.

Every JAX name, member and keyword the port lacks stands in
:data:`ALLOWED`, the one record of what the port deliberately leaves
out, with one reason of a closed set (:data:`REASONS`).  An entry whose
name the port has fails the test, so the table only shrinks.  A
self-test runs the walker on small synthetic package pairs and checks
that it flags a missing function, a missing inherited method, a missing
keyword, a keyword taken only through ``**kwargs`` and a stale entry.

Keys: ``"<module>"`` for a module, ``"<module>.<name>"`` for a name
(``"<name>"`` in the top-level package), ``"<module>.<Class>.<member>"``
for a member, and ``"<module>.<callable>(<keyword>=)"`` for a keyword,
the callable being ``<function>``, ``<Class>`` (its ``__init__``) or
``<Class>.<method>``; module paths are relative to the package.
"""
import ast
import importlib
import inspect
import pkgutil
import sys
import textwrap
import types

import pytest

# The closed set of reasons.  The six deviations are the port's named
# ones (ROADMAP, "Port conventions"): 1 the default context is gpu(0);
# 2 gluon.data builds batches on the host; 3 a restored checkpoint comes
# back on the host; 4 there is no compile cache; 5 the .mxa archive
# carries no compiled program; 6 there is no bulked eager dispatch.
REASONS = {
    "jax": "a JAX or XLA object or a PRNG key",
    "hlo": "reads HLO text or a compiled executable",
    "tpu": "a TPU device or a TPU tiling constant",
    "pallas": "a Pallas kernel module (ported as mxnet_tpu_torch/csrc/)",
    "kernel_switch": "the MXNET_TPU_KERNELS choice between a Pallas "
                     "kernel and XLA: the port has no switch",
}
REASONS.update({"deviation:%d" % i: "named deviation %d" % i
                for i in range(1, 7)})

ALLOWED = {
    # modules
    "ndarray.bulk": "deviation:6",
    "ops.pallas": "pallas",
    "ops.pallas.flash_attention": "pallas",
    "ops.pallas.layernorm": "pallas",
    "ops.pallas.paged_attention": "pallas",
    "profiling.hlo": "hlo",
    "serving.cache": "deviation:4",
    # names
    "analysis.memory.executable_memory": "hlo",
    "analysis.numerics.audit_hlo_numerics": "hlo",
    "analysis.perf.SUBLANE_BF16": "tpu",
    "analysis.perf.SUBLANE_F32": "tpu",
    "analysis.perf.TILE_LANE": "tpu",
    "analysis.perf.audit_hlo_text": "hlo",
    "autograd.TapeNode": "jax",
    "context.num_tpus": "tpu",
    "context.tpu": "tpu",
    "num_tpus": "tpu",
    "tpu": "tpu",
    "kernels.flash_attention.AUTO_MIN_SEQ": "kernel_switch",
    "kernels.fused_bn_relu.xla_reference": "kernel_switch",
    "kernels.optimizer_update.LANE": "tpu",
    "kernels.optimizer_update.bucket_active": "kernel_switch",
    "kernels.KernelChoice": "kernel_switch",
    "kernels.available": "pallas",
    "kernels.choose": "kernel_switch",
    "kernels.enabled": "kernel_switch",
    "kernels.mode": "kernel_switch",
    "kernels.registry.KernelChoice": "kernel_switch",
    "kernels.registry.available": "pallas",
    "kernels.registry.choose": "kernel_switch",
    "kernels.registry.enabled": "kernel_switch",
    "kernels.registry.mode": "kernel_switch",
    "ndarray.from_jax": "jax",
    "ndarray.ndarray.from_jax": "jax",
    "profiling.cost.analyze_compiled": "hlo",
    "profiling.cost.analyze_jit": "hlo",
    "profiling.cost.fingerprint": "hlo",
    "profiling.store.compiled_executables": "hlo",
    "profiling.store.executables": "hlo",
    "random.current_key": "jax",
    "random.next_key": "jax",
    "random.traced_stream": "jax",
    "serving.CompileCache": "deviation:4",
    "serving.stablehlo_fingerprint": "deviation:4",
    # members
    "context.Context.jax_device": "jax",
    "context.DeviceType.kTPU": "tpu",
    "kernels.registry.KernelSpec.auto_predicate": "kernel_switch",
    "kernels.registry.KernelSpec.supports": "kernel_switch",
    "kernels.registry.KernelSpec.xla_ref": "kernel_switch",
    # keywords
    "analysis.sharding.collective_profile(hlo_text=)": "hlo",
    "kernels.optimizer_update.lamb_bucket_update(choice=)": "kernel_switch",
    "kernels.optimizer_update.lars_bucket_update(choice=)": "kernel_switch",
    "kernels.paged_attention.paged_attention(use_pallas=)": "kernel_switch",
    "kernels.registry.KernelSpec(auto_predicate=)": "kernel_switch",
    "kernels.registry.KernelSpec(supports=)": "kernel_switch",
    "kernels.registry.KernelSpec(xla_ref=)": "kernel_switch",
    "ndarray.LayerNorm(use_pallas=)": "kernel_switch",
    "symbol.LayerNorm(use_pallas=)": "kernel_switch",
    "profiling.store.register(args=)": "hlo",
    "profiling.store.register(fn=)": "hlo",
    "profiling.store.register(kind=)": "hlo",
    "profiling.store.register(label=)": "hlo",
}

# Names the port once refused and now has: none may come back into
# ALLOWED or go missing.
KEPT = (
    "gluon.block.HybridBlock.functionalize",
    "gluon.block.SymbolBlock.functionalize",
    "context.Context.empty_cache",
    "context.Context.memory_info",
    "gluon.parameter.Parameter(stype=)",
    "gluon.parameter.Parameter(grad_stype=)",
    "gluon.model_zoo.get_model",
    "ops.get_op", "ops.list_ops", "ops.register", "ops.Op", "ops.OpParam",
    "ops.OP_REGISTRY", "ops.registry",
    "parallel.data_parallel.TrainStep(donate=)",
    "serving.executor.BucketExecutorPool(pure_fn=)",
    "serving.executor.BucketExecutorPool(params=)",
    "serving.executor.BucketExecutorPool(cache=)",
    "serving.executor.BucketExecutorPool.compiled_buckets",
    "serving.decode.engine.DecodeEngine(cache=)",
    "analysis.memory.hbm_plan(fn=)",
    "analysis.memory.hbm_plan(args=)",
    "analysis.memory.hbm_plan(probe_factor=)",
    "base.build_param_doc", "base.camel_to_snake",
    "bucketing.flatten_group(xp=)",
    "kernels.describe", "kernels.registry.describe",
)

# Port callables that take a JAX keyword only through ``**kwargs``:
# ``{key: case}``, each case a call of the port with that keyword.
KWARGS_CALLS = {}


# ----------------------------------------------------------------------
# The walker
# ----------------------------------------------------------------------

def public_modules(pkg_name):
    """``{relative name: module}`` of the package and every public
    module under it ("" for the package itself)."""
    pkg = importlib.import_module(pkg_name)
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg_name + "."):
        rel = info.name[len(pkg_name) + 1:]
        parts = rel.split(".")
        if parts[-1] == "__main__" or any(p.startswith("_") for p in parts):
            continue
        out[rel] = importlib.import_module(info.name)
    return out


def _assigned(module):
    """The names the module's source binds at top level by assignment."""
    try:
        tree = ast.parse(inspect.getsource(module))
    except (OSError, TypeError):
        return set()
    names = set()
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, (ast.AnnAssign,
                                               ast.AugAssign)) else []
        for t in targets:
            names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    return names


def own_names(module):
    """(a): ``{name: object}`` of the public names ``module`` defines."""
    assigned = _assigned(module)
    out = {}
    for k, v in vars(module).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if inspect.isclass(v) or inspect.isfunction(v):
            if v.__module__ == module.__name__:
                out[k] = v
        elif k in assigned:
            out[k] = v
    return out


def _foreign(v, pkg_name):
    """Whether ``v`` belongs to another package than ``pkg_name``."""
    if isinstance(v, types.ModuleType):
        return not v.__name__.startswith(pkg_name + ".")
    if type(v).__module__ == "__future__":
        return True
    if inspect.isclass(v) or inspect.isroutine(v):
        return not (getattr(v, "__module__", None) or "").startswith(
            pkg_name)
    return False


def _keywords(fn):
    """``(names, takes **kwargs)`` of a callable, or None where it has
    no signature."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)
    return ({p.name for p in params if p.kind in kinds}
            - {"self", "cls"},
            any(p.kind == p.VAR_KEYWORD for p in params))


def _key(rel, name):
    return "%s.%s" % (rel, name) if rel else name


def surface_gaps(ref_pkg, port_pkg, called=()):
    """The keys of every public module, name, member and keyword of
    ``ref_pkg`` that ``port_pkg`` lacks; a keyword the port takes only
    through ``**kwargs`` is a gap unless its key is in ``called``."""
    ref, port = public_modules(ref_pkg), public_modules(port_pkg)
    gaps = set()

    def keywords(jfn, pfn, where):
        want, got = _keywords(jfn), _keywords(pfn)
        if want is None or got is None:
            return
        for kw in want[0] - got[0]:
            key = "%s(%s=)" % (where, kw)
            if not (got[1] and key in called):
                gaps.add(key)

    for rel, jm in ref.items():
        pm = port.get(rel)
        if pm is None:
            gaps.add(rel)
            continue
        own = own_names(jm)
        names = dict(own)
        if hasattr(jm, "__path__"):     # (b): a package's namespace
            for k in dir(jm):
                v = getattr(jm, k)
                if not k.startswith("_") and not _foreign(v, ref_pkg) \
                        and _key(rel, k) not in ref:
                    names.setdefault(k, v)
        for k, v in names.items():
            if not hasattr(pm, k):
                gaps.add(_key(rel, k))
                continue
            pv = getattr(pm, k)
            if inspect.isclass(v) and own.get(k) is v:
                for m in dir(v):        # (c)
                    if m.startswith("_") and m != "__init__":
                        continue
                    if not hasattr(pv, m):
                        gaps.add(_key(rel, "%s.%s" % (k, m)))
                        continue
                    jmv = getattr(v, m)
                    if m == "__init__":
                        if jmv is not object.__init__:
                            keywords(jmv, pv.__init__, _key(rel, k))
                    elif inspect.isroutine(jmv):
                        keywords(jmv, getattr(pv, m),
                                 _key(rel, "%s.%s" % (k, m)))
            elif inspect.isroutine(v) and own.get(k) is v:
                keywords(v, pv, _key(rel, k))     # (d)
    return gaps


def unlisted_and_stale(gaps, allowed):
    """The gaps ``allowed`` does not list, and its entries that are no
    gap (the port has them now)."""
    return sorted(gaps - set(allowed)), sorted(set(allowed) - gaps)


# ----------------------------------------------------------------------
# The port against the JAX package
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gaps():
    return surface_gaps("mxnet_tpu", "mxnet_tpu_torch", set(KWARGS_CALLS))


def test_every_name_the_port_lacks_is_allowed_with_its_reason(gaps):
    unlisted, _stale = unlisted_and_stale(gaps, ALLOWED)
    assert not unlisted, "the port lacks: %s" % unlisted


def test_no_allowed_entry_is_stale(gaps):
    _unlisted, stale = unlisted_and_stale(gaps, ALLOWED)
    assert not stale, "the port has these now; take them out of " \
        "ALLOWED: %s" % stale


def test_reasons_are_of_the_closed_set():
    assert set(ALLOWED.values()) <= set(REASONS)


def test_kept_names_are_neither_allowed_nor_missing(gaps):
    assert not set(KEPT) & (set(ALLOWED) | gaps)


def test_keywords_taken_through_kwargs():
    for key, case in KWARGS_CALLS.items():
        case()


# ----------------------------------------------------------------------
# The walker on synthetic pairs
# ----------------------------------------------------------------------

_REF = {
    "__init__.py": "from .a import f, g\n",
    "a.py": """
        def f(x):
            return x

        def g(x, scale=1.0):
            return x * scale

        def h(x, y=1):
            return x + y

        def same(x, mode="a"):
            return x
        """,
    "b.py": """
        class Base:
            def m(self, k=0):
                return k

        class Child(Base):
            def __init__(self, size=1):
                self.size = size
        """,
}
_PORT = {
    "__init__.py": "from .a import g\n",
    "a.py": """
        def g(x):
            return x

        def h(x, **kwargs):
            return x

        def same(x, mode="a"):
            return x
        """,
    "b.py": """
        class Base:
            pass

        class Child(Base):
            def __init__(self, size=1):
                self.size = size
        """,
}


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("surface")
    for pkg, files in (("surface_ref", _REF), ("surface_port", _PORT)):
        (root / pkg).mkdir()
        for name, src in files.items():
            (root / pkg / name).write_text(textwrap.dedent(src))
    sys.path.insert(0, str(root))
    try:
        yield {called: surface_gaps("surface_ref", "surface_port", called)
               for called in ((), ("a.h(y=)",))}
    finally:
        sys.path.remove(str(root))
        for m in [m for m in sys.modules
                  if m.split(".")[0] in ("surface_ref", "surface_port")]:
            del sys.modules[m]


@pytest.mark.parametrize("key", [
    "a.f",                  # a missing function
    "f",                    # ... and its name in the package namespace
    "b.Child.m",            # a missing inherited method
    "a.g(scale=)",          # a missing keyword
    "a.h(y=)",              # a keyword taken only through **kwargs
])
def test_walker_flags_planted_gap(synthetic, key):
    assert key in synthetic[()]


def test_walker_flags_nothing_else_and_counts_a_called_keyword(synthetic):
    assert synthetic[()] == {"a.f", "f", "b.Child.m", "a.g(scale=)",
                             "a.h(y=)", "b.Base.m"}
    assert synthetic[("a.h(y=)",)] == synthetic[()] - {"a.h(y=)"}


def test_walker_flags_a_stale_entry(synthetic):
    allowed = {k: "jax" for k in synthetic[()]}
    allowed["a.same"] = "jax"       # the port has it
    del allowed["b.Child.m"]
    assert unlisted_and_stale(synthetic[()], allowed) == (["b.Child.m"],
                                                          ["a.same"])
