"""The port's fused BatchNorm+ReLU (``mxnet_tpu_torch.ops.fused_bn_relu``
and ``kernels.fused_bn_relu``) against the JAX package's
(``mxnet_tpu.kernels.fused_bn_relu``), on the CPU.  The JAX side runs
its Pallas kernels in interpret mode (``MXNET_TPU_KERNELS=1``), the port
its plain versions; the same numpy inputs go to both.

Tolerances: 2e-5 on fp32 outputs and 1e-5/1e-6 on running statistics
(fp32 sums in another order); 2e-4 relative on gradients (two
reductions over the batch, then a subtraction); bf16 outputs 2e-2 (one
bf16 rounding of the stored value)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu import kernels as jkernels
from mxnet_tpu.kernels import fused_bn_relu as jfbr

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import fused_bn_relu as tfbr
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.ops import fused_bn_relu as tops

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture()
def kernels_on(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")


def _bn_inputs(seed=0, c=16, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 5, 5, c) * 2 + 1).astype(dtype)
    gamma = rng.rand(c).astype(np.float32) + 0.5
    beta = rng.randn(c).astype(np.float32)
    mm = (rng.randn(c) * 0.1).astype(np.float32)
    mv = rng.rand(c).astype(np.float32) + 0.5
    return x, gamma, beta, mm, mv


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


@pytest.mark.parametrize("training,use_global,fix_gamma", [
    (True, False, False), (True, False, True),
    (False, False, False), (True, True, False)])
def test_fused_op_matches_jax(kernels_on, training, use_global, fix_gamma):
    arrs = _bn_inputs()
    kw = dict(fix_gamma=fix_gamma, use_global_stats=use_global, axis=3,
              training=training)
    jo, jm, jv = jfbr.fused_bn_relu(*(jnp.asarray(a) for a in arrs), **kw)
    to, tm, tv = tfbr.fused_bn_relu(*(_t(a) for a in arrs), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert to.min() >= 0.0


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_fused_op_grads_match_jax(kernels_on, fix_gamma):
    """dx, dgamma, dbeta against ``jax.grad`` of the JAX op (its custom
    VJP with the Pallas backward kernel), cotangent ``o * cos(o)``."""
    x, gamma, beta, mm, mv = _bn_inputs(2)

    def jloss(x, g, b):
        o, _, _ = jfbr.fused_bn_relu(x, g, b, jnp.asarray(mm),
                                     jnp.asarray(mv), fix_gamma=fix_gamma,
                                     axis=3, training=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (_t(a).requires_grad_(True) for a in (x, gamma, beta))
    o, _, _ = tfbr.fused_bn_relu(tx, tg, tb, _t(mm), _t(mv),
                                 fix_gamma=fix_gamma, axis=3, training=True)
    (o * torch.cos(o)).sum().backward()
    for got, w, name in zip((tx.grad, tg.grad, tb.grad), want,
                            ("dx", "dgamma", "dbeta")):
        if fix_gamma and name == "dgamma":
            assert got is None
            assert not np.asarray(w).any()
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_bf16_activations_fp32_stats(kernels_on):
    x, gamma, beta, mm, mv = _bn_inputs(3)
    kw = dict(fix_gamma=False, axis=3, training=True)
    jo, jm, jv = jfbr.fused_bn_relu(jnp.asarray(x).astype(jnp.bfloat16),
                                    jnp.asarray(gamma), jnp.asarray(beta),
                                    jnp.asarray(mm), jnp.asarray(mv), **kw)
    to, tm, tv = tfbr.fused_bn_relu(_t(x, torch.bfloat16), _t(gamma),
                                    _t(beta), _t(mm), _t(mv), **kw)
    assert to.dtype == torch.bfloat16
    assert tm.dtype == torch.float32 and tv.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("rows,c", [(100, 16), (392, 64), (7, 3)])
def test_plain_apply_matches_the_pallas_kernel(rows, c):
    """Each kernel's plain version against the Pallas kernel it
    replaces, run in interpret mode."""
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, c) * 2).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    offset = rng.randn(c).astype(np.float32)
    want = jfbr.bn_relu_apply_pallas(jnp.asarray(x), jnp.asarray(scale)[None],
                                     jnp.asarray(offset)[None],
                                     interpret=True)
    got = tops.bn_relu_apply_reference(_t(x), _t(scale), _t(offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("rows,c", [(100, 16), (392, 64), (7, 3)])
def test_plain_bwd_matches_the_pallas_kernel(rows, c):
    rng = np.random.RandomState(rows + 1)
    x, dy = (rng.randn(2, rows, c) * 2).astype(np.float32)
    y = np.maximum(rng.randn(rows, c), 0).astype(np.float32)
    vecs = [rng.randn(c).astype(np.float32) for _ in range(5)]
    want = jfbr.bn_relu_bwd_pallas(jnp.asarray(x), jnp.asarray(dy),
                                   jnp.asarray(y),
                                   *(jnp.asarray(v)[None] for v in vecs),
                                   interpret=True)
    got = tops.bn_relu_bwd_reference(_t(x), _t(dy), _t(y),
                                     *(_t(v) for v in vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the registry runs the plain versions: no launch is
    counted."""
    x, gamma, beta, mm, mv = _bn_inputs(4)
    before = (registry.launches("bn_relu_apply"),
              registry.launches("bn_relu_bwd"))
    tx = _t(x).requires_grad_(True)
    o, _, _ = tfbr.fused_bn_relu(tx, _t(gamma), _t(beta), _t(mm), _t(mv),
                                 fix_gamma=False, axis=3, training=True)
    o.sum().backward()
    assert (registry.launches("bn_relu_apply"),
            registry.launches("bn_relu_bwd")) == before
    assert tx.grad is not None


def test_fused_op_is_channels_last_only():
    x, gamma, beta, mm, mv = _bn_inputs(5)
    with pytest.raises(MXNetError, match="channels-last"):
        tfbr.fused_bn_relu(_t(x), _t(gamma), _t(beta), _t(mm), _t(mv),
                           axis=1)


def test_registry_names_the_tpu_kernel_each_replaces():
    """Every registered kernel names its source and the file:line of the
    Pallas function it replaces, and that line defines the function."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    names = registry.list_kernels()
    for want in ("bn_relu_apply", "bn_relu_bwd", "paged_attention"):
        assert want in names
    for name in names:
        spec = registry.get(name)
        assert (root / "mxnet_tpu_torch" / spec.source).is_file()
        where, func = spec.replaces.split()
        path, line = where.split(":")
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def %s(" % func), (name, text)
