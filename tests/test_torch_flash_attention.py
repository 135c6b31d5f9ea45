"""The port's flash attention (``mxnet_tpu_torch.kernels.flash_attention``
and ``ops.transformer``) against the JAX package's Pallas kernels
(``mxnet_tpu/ops/pallas/flash_attention.py``, interpret mode) and its
plain XLA attention, on the CPU.  The same numpy inputs go to both; the
port runs its plain versions, which the Hopper kernels are held against
on the card (``tests/test_torch_cuda_kernels.py``).

Tolerances: 2e-5 absolute on fp32 outputs, lse and gradients (fp32 sums
in another order and, in the Pallas kernels, online-softmax
rescaling); 2e-2 on bf16 outputs (one bf16 rounding of the stored
value).  The port's autograd function against autodiff of its own plain
forward: 1e-5."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import transformer as jtr
from mxnet_tpu.ops.pallas import flash_attention as jfa

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.ops import transformer as tops

pytestmark = pytest.mark.skipif(not jfa._HAS_PALLAS,
                                reason="no pallas on this backend")

BH, D, HEADS = 4, 16, 2
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(seq, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((BH, seq, D)).astype(np.float32)
                   * 0.7 for _ in range(4))
    mask = None
    if masked:
        # padding masks: each batch row attends to its first n keys
        lens = rng.integers(seq // 3, seq + 1, BH // HEADS)
        mask = (np.arange(seq)[None, None, :]
                < lens[:, None, None]).astype(np.float32)
        mask = np.ascontiguousarray(np.broadcast_to(
            mask, (BH // HEADS, seq, seq)))
    return q, k, v, do, mask


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [  # (seq, causal, masked, jax block size)
    (32, False, False, 256),
    (32, True, False, 256),
    (32, False, True, 256),
    (48, False, False, 16),
    (48, True, False, 16),
    (48, False, True, 16),
]


@pytest.mark.parametrize("seq,causal,masked,block", CASES)
def test_forward_matches_pallas_kernel(seq, causal, masked, block):
    q, k, v, _do, mask = _inputs(seq, masked=masked)
    scale = 1.0 / np.sqrt(D)
    jout, jlse = jfa.flash_attention_fwd_pallas(
        _j(q), _j(k), _j(v), _j(mask), causal=causal, scale=scale,
        block_q=block, block_k=block, heads=HEADS, interpret=True)
    tout, tlse = tfa.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), _t(mask), causal=causal, scale=scale,
        heads=HEADS)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL)


@pytest.mark.parametrize("seq,causal,masked,block", CASES)
def test_backward_matches_pallas_kernel(seq, causal, masked, block):
    """``(dq, dk, dv)`` from the same ``lse`` and ``delta``."""
    q, k, v, do, mask = _inputs(seq, seed=1, masked=masked)
    scale = 0.3
    jout, jlse = jfa.flash_attention_fwd_pallas(
        _j(q), _j(k), _j(v), _j(mask), causal=causal, scale=scale,
        block_q=block, block_k=block, heads=HEADS, interpret=True)
    delta = np.sum(do * np.asarray(jout), axis=-1).astype(np.float32)
    jgrads = jfa.flash_attention_bwd_pallas(
        _j(q), _j(k), _j(v), jlse, _j(do), _j(delta), _j(mask),
        causal=causal, scale=scale, block_q=block, block_k=block,
        heads=HEADS, interpret=True)
    tgrads = tfa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(jlse)), _t(do), _t(delta),
        _t(mask), causal=causal, scale=scale, heads=HEADS)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_any_seq_matches_plain_attention(causal):
    """A seq no TPU block divides (37): the port's op against the JAX
    package's ``_attention_reference`` and its autodiff."""
    seq = 37
    q, k, v, do, _ = _inputs(seq, seed=2)
    scale = 0.25
    jout, jvjp = jax.vjp(
        lambda a, b, c: jtr._attention_reference(a, b, c, causal, scale),
        _j(q), _j(k), _j(v))
    jgrads = jvjp(_j(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_autograd_function_equals_autodiff_of_plain_forward(causal,
                                                            masked):
    q, k, v, do, mask = _inputs(40, seed=3, masked=masked)
    scale = 0.2
    got, want = [], []
    for out_of in ("op", "plain"):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        if out_of == "op" and masked:
            out = tops.flash_attention_masked(tq, tk, tv, _t(mask),
                                              scale=scale, heads=HEADS)
        elif out_of == "op":
            out = tops.flash_attention(tq, tk, tv, causal=causal,
                                       scale=scale)
        else:
            out, _ = tfa.flash_attention_fwd_reference(
                tq, tk, tv, _t(mask), causal=causal, scale=scale,
                heads=HEADS)
        out.backward(_t(do))
        (got if out_of == "op" else want).append(
            [out.detach()] + [t.grad for t in (tq, tk, tv)])
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=name)


def test_masked_op_matches_jax_custom_vjp_on_the_kernels():
    """``flash_attention_masked`` with its gradient against the JAX
    package's ``_flash_masked`` custom VJP on the Pallas kernels
    (interpret mode)."""
    seq = 32
    q, k, v, do, mask = _inputs(seq, seed=4, masked=True)
    scale = 1.0 / np.sqrt(D)

    def jop(a, b, c):
        return jtr._flash_masked(a, b, c, _j(mask), scale, 256, 256, True,
                                 HEADS, True)
    jout, jvjp = jax.vjp(jop, _j(q), _j(k), _j(v))
    jgrads = jvjp(_j(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tops.flash_attention_masked(tq, tk, tv, _t(mask), heads=HEADS)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("seq", [40, 70])
def test_causal_masked_row_without_key_matches_xla_math(seq):
    """Causal with a float mask that leaves a row no key (row 3 of batch
    row 0, both its heads): the port's plain forward against the JAX
    package's ``_attention_reference_masked`` with the mask ANDed with
    the lower triangle, its lse against ``logsumexp`` of the same masked
    scores, and its plain backward (from that lse and ``delta``) against
    ``_xla_attention_bwd(..., causal=True, mask=...)``.  The empty row
    averages every key in the forward and weights each by 1 / seq in the
    backward, as softmax does."""
    q, k, v, do, mask = _inputs(seq, seed=8, masked=True)
    mask[0, 3, :] = 0.0
    scale = 0.3
    mask_bh = np.repeat(mask, HEADS, axis=0)
    causal_bh = mask_bh * np.tril(np.ones((seq, seq), np.float32))
    jout = jtr._attention_reference_masked(_j(q), _j(k), _j(v),
                                           _j(causal_bh), scale)
    s = jnp.einsum("bqd,bkd->bqk", _j(q), _j(k)) * scale
    jlse = jax.nn.logsumexp(jnp.where(_j(causal_bh) > 0, s, -1e30),
                            axis=-1)
    tout, tlse = tfa.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), _t(mask), causal=True, scale=scale,
        heads=HEADS)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tout[:HEADS, 3].numpy(),
                               v[:HEADS].mean(axis=1), atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL)
    delta = np.sum(do * tout.numpy(), axis=-1).astype(np.float32)
    tgrads = tfa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), tlse, _t(do), _t(delta), _t(mask),
        causal=True, scale=scale, heads=HEADS)
    jgrads = jtr._xla_attention_bwd(_j(q), _j(k), _j(v), _j(do), True,
                                    scale, mask=_j(mask_bh))
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)


def test_bf16_forward_matches_pallas_kernel():
    q, k, v, _do, _ = _inputs(32, seed=5)
    jout, _ = jfa.flash_attention_fwd_pallas(
        *(_j(a).astype(jnp.bfloat16) for a in (q, k, v)), scale=0.25,
        interpret=True)
    tout, _ = tfa.flash_attention_fwd_reference(
        *(_t(a).bfloat16() for a in (q, k, v)), scale=0.25)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=2e-2)


def test_cpu_tensors_run_the_plain_version_without_counting():
    q, k, v, do, _ = _inputs(16, seed=6)
    registry.reset_launches()
    tq = _t(q).requires_grad_()
    tops.flash_attention(tq, _t(k), _t(v)).backward(_t(do))
    assert registry.launches("flash_attention_fwd") == 0
    assert registry.launches("flash_attention_bwd") == 0
    for name, line in (("flash_attention_fwd", ":101"),
                       ("flash_attention_bwd", ":250")):
        spec = registry.get(name)
        assert spec.source == "csrc/flash_attention.cu"
        assert spec.replaces.startswith(
            "mxnet_tpu/ops/pallas/flash_attention.py" + line)


def test_cuda_launcher_refuses_cpu_tensors():
    q, k, v, _do, _ = _inputs(16, seed=7)
    with pytest.raises(MXNetError, match="needs CUDA"):
        tfa.flash_attention_fwd_cuda(_t(q), _t(k), _t(v))
