"""The port's LayerNorm (``mxnet_tpu_torch.kernels.layernorm``,
``ops.nn.LayerNorm`` and the gluon layer) against the JAX package's
(``mxnet_tpu/ops/pallas/layernorm.py`` in interpret mode,
``ops/nn.py :: _ln_xla_lastaxis`` and ``LayerNorm``), on the CPU.  The
same numpy inputs go to both.

Tolerances: 1e-5 on fp32 outputs and gradients (fp32 sums in another
order); 2e-2 on bf16 outputs (one bf16 rounding of the stored
value).  On rows of mean 1e4 and std 0.1 the fp32 mean itself is only
good to a few of its ulps (2**-10 each, 1% of the std), whatever the
order of the sum, so there each version is held to the fp64 truth
within 8 of those ulps, carried through the row's 1/std and |gamma|."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas import layernorm as jln

from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch import ops
from mxnet_tpu_torch.kernels import layernorm as tln
from mxnet_tpu_torch.kernels import registry

pytestmark = pytest.mark.skipif(not jln._HAS_PALLAS,
                                reason="no pallas on this backend")


def _inputs(rows, dim, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, dim)) * 2 + 0.5).astype(np.float32)
    gamma = (rng.random(dim) + 0.5).astype(np.float32)
    beta = rng.standard_normal(dim).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("rows,dim,eps", [(48, 64, 1e-5), (37, 100, 1e-5),
                                          (16, 768, 1e-12), (5, 3, 1e-3)])
def test_forward_matches_pallas_kernel_and_xla(rows, dim, eps):
    x, g, b = _inputs(rows, dim)
    want_k = jln.layernorm_fwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                      jnp.asarray(b), eps=eps,
                                      interpret=True)
    want_x = jnn._ln_xla_lastaxis(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b), eps)
    got = tln.layernorm_reference(torch.tensor(x), torch.tensor(g),
                                  torch.tensor(b), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), atol=1e-5)


def test_bf16_forward_matches_pallas_kernel():
    x, g, b = _inputs(32, 64, seed=1)
    want = jln.layernorm_fwd_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                    jnp.asarray(g), jnp.asarray(b),
                                    interpret=True)
    got = tln.layernorm_reference(torch.tensor(x).bfloat16(),
                                  torch.tensor(g), torch.tensor(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def _large_mean_rows(rows, dim, seed):
    """Rows of mean 1e4 and std 0.1, and per element the fp64 truth and
    the error unit: one ulp of the row's fp32 mean times the row's
    1/std and |gamma|."""
    rng = np.random.default_rng(seed)
    x = (1e4 + 0.1 * rng.standard_normal((rows, dim))).astype(np.float32)
    g = (rng.random(dim) + 0.5).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32)
    xd = x.astype(np.float64)
    mean = xd.mean(-1, keepdims=True)
    inv = 1 / np.sqrt(((xd - mean) ** 2).mean(-1, keepdims=True) + 1e-5)
    truth = (xd - mean) * inv * g + b
    unit = 2.0 ** (np.floor(np.log2(np.abs(mean))) - 23) * inv * np.abs(g)
    return x, g, b, truth, unit


def test_large_mean_rows_need_two_pass_statistics():
    """Mean 1e4, std 0.1: the plain version and the Pallas kernel (both
    two-pass, fp32) stay within 8 ulps of the mean of the fp64 truth; a
    one-pass E[x^2] - E[x]^2 on the same rows loses the variance (off
    by thousands of those units, or NaN), so the case discriminates."""
    x, g, b, truth, unit = _large_mean_rows(64, 768, seed=5)
    want = np.asarray(jln.layernorm_fwd_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), interpret=True))
    got = tln.layernorm_reference(torch.tensor(x), torch.tensor(g),
                                  torch.tensor(b)).numpy()
    for name, out in (("pallas", want), ("plain", got)):
        assert np.isfinite(out).all(), name
        assert (np.abs(out - truth) / unit).max() <= 8, name
    assert (np.abs(got - want) / unit).max() <= 16
    m = x.mean(-1, keepdims=True, dtype=np.float32)
    var = (x * x).mean(-1, keepdims=True, dtype=np.float32) - m * m
    with np.errstate(invalid="ignore"):
        one = (x - m) / np.sqrt(var + np.float32(1e-5)) * g + b
        err = np.abs(one - truth) / unit
    assert np.isnan(one).any() or np.nanmax(err) > 1000


@pytest.mark.parametrize("shape", [(2, 9, 32), (7, 100)])
def test_op_gradients_match_jax_vjp(shape):
    """The op's recomputed backward against ``jax.vjp`` of
    ``_ln_xla_lastaxis`` (the JAX kernel path's backward)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda *a: jnn._ln_xla_lastaxis(*a, 1e-5),
                        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    jgrads = vjp(jnp.asarray(cot))
    ins = [torch.tensor(a).requires_grad_() for a in (x, g, b)]
    out = ops.LayerNorm(*ins, axis=-1, eps=1e-5)
    out.backward(torch.tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    for name, t, j in zip(("dx", "dgamma", "dbeta"), ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=1e-5, err_msg=name)


def test_other_axis_matches_jax_op():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    g = (rng.random(6) + 0.5).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jnn._layer_norm.fcompute(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b), axis=1)
    got = ops.LayerNorm(torch.tensor(x), torch.tensor(g), torch.tensor(b),
                        axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gluon_layer_runs_the_kernel_tier_on_cpu():
    """The gluon layer goes through the registry (its plain version on
    the CPU, no launch counted) and infers its channels."""
    x, g, b = _inputs(6, 24, seed=4)
    layer = gluon.nn.LayerNorm()
    layer.initialize(device="cpu")
    registry.reset_launches()
    out = layer(torch.tensor(x).reshape(2, 3, 24))
    assert layer.gamma.shape == (24,)
    want = jnn._ln_xla_lastaxis(jnp.asarray(x), jnp.ones(24),
                                jnp.zeros(24), 1e-5)
    np.testing.assert_allclose(out.detach().numpy().reshape(6, 24),
                               np.asarray(want), atol=1e-5)
    assert registry.launches("layernorm_fwd") == 0
    spec = registry.get("layernorm_fwd")
    assert spec.replaces.startswith("mxnet_tpu/ops/pallas/layernorm.py:38")


def test_cuda_launcher_refuses_cpu_tensors():
    x, g, b = _inputs(4, 8)
    with pytest.raises(MXNetError, match="needs a CUDA tensor"):
        tln.layernorm_fwd_cuda(torch.tensor(x), torch.tensor(g),
                               torch.tensor(b))
