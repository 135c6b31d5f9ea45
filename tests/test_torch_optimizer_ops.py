"""The port's optimizer update ops (``mxnet_tpu_torch.ops.optimizer_ops``)
against the JAX package's on the CPU: one case for each name the JAX
package registers in ``ops/optimizer_ops.py`` (and its alias), run as
``mx.nd.<name>`` in both packages on the same seeded numpy inputs.  The
port's ``mx.nd`` ops return new arrays and leave their inputs as they
were, as the JAX package's do; the in-place functions behind them, which
the optimizers call, write the same values into their arguments.

Tolerance: 1e-6 relative and 1e-7 absolute (the same elementwise fp32
arithmetic; the sums of squares in another order); dtypes and shapes
equal."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import OP_REGISTRY

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import optimizer_ops, table

RTOL, ATOL = 1e-6, 1e-7
SHAPE = (3, 4)


def _u(seed, lo=-1.0, hi=1.0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


W, G, S1, S2, S3 = (_u(0), _u(1, -3, 3), _u(2, 0.0, 0.5), _u(3, 0.0, 0.5),
                    _u(4, -0.2, 0.2))
H = np.float16
COMMON = {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.2}

# name -> (numpy inputs, parameters)
CASES = {
    "sgd_update": ([W, G], COMMON),
    "sgd_mom_update": ([W, G, S3], dict(COMMON, momentum=0.9)),
    "nag_mom_update": ([W, G, S3], dict(COMMON, momentum=0.9)),
    "mp_sgd_update": ([W.astype(H), G.astype(H), W], COMMON),
    "mp_sgd_mom_update": ([W.astype(H), G.astype(H), S3, W],
                          dict(COMMON, momentum=0.9)),
    "adam_update": ([W, G, S3, S1], dict(COMMON, beta1=0.8, beta2=0.99,
                                         epsilon=1e-6)),
    "adamw_update": ([W, G, S3, S1], dict(COMMON, beta1=0.8, eta=0.7)),
    "rmsprop_update": ([W, G, S1], dict(COMMON, gamma1=0.8,
                                        clip_weights=0.9)),
    "rmspropalex_update": ([W, G, S1 + 0.5, S3, S3], dict(COMMON,
                                                          gamma1=0.9,
                                                          gamma2=0.8,
                                                          clip_weights=0.9)),
    "ftrl_update": ([W, G, S3, S1], dict(COMMON, lamda1=0.05, beta=0.5)),
    "adagrad_update": ([W, G, S1], dict(COMMON, epsilon=1e-5)),
    "_sparse_adagrad_update": ([W, G, S1], dict(COMMON, epsilon=1e-5)),
    "signsgd_update": ([W, G], COMMON),
    "signum_update": ([W, G, S3], dict(COMMON, momentum=0.8, wd_lh=0.1)),
    "lamb_update_phase1": ([W, G, S3, S1], {"beta1": 0.8, "beta2": 0.99,
                                            "epsilon": 1e-6, "t": 3,
                                            "wd": 0.01, "rescale_grad": 0.5,
                                            "clip_gradient": 1.2}),
    "lamb_update_phase2": ([W, G, np.array([1.5], np.float32),
                            np.array([0.7], np.float32)],
                           {"lr": 0.05, "lower_bound": 0.1,
                            "upper_bound": 1.0}),
    "lars_update": ([W, G, S3], dict(COMMON, momentum=0.9, eta=0.01)),
    "multi_sum_sq": ([W, G, S1], {"num_arrays": 3}),
    "multi_all_finite": ([W, G, np.where(W > 0.5, np.inf, W)],
                         {"num_arrays": 3}),
    "multi_sgd_update": ([W, G, S3, S1], {"lrs": (0.1, 0.2),
                                          "wds": (0.01, 0.0),
                                          "rescale_grad": 0.5,
                                          "clip_gradient": 1.2,
                                          "num_weights": 2}),
    "multi_sgd_mom_update": ([W, G, S3, S1, S2, S3],
                             {"lrs": (0.1, 0.2), "wds": (0.01, 0.0),
                              "momentum": 0.9, "num_weights": 2}),
    "multi_mp_sgd_update": ([W.astype(H), G.astype(H), W, S1.astype(H),
                             S2.astype(H), S1],
                            {"lrs": (0.1, 0.2), "wds": (0.01, 0.0),
                             "num_weights": 2}),
    "multi_lars": ([np.array([0.1, 0.2, 0.3], np.float32),
                    np.array([4.0, 0.0, 9.0], np.float32),
                    np.array([1.0, 2.0, 0.25], np.float32),
                    np.array([0.01, 0.0, 0.1], np.float32)],
                   {"eta": 0.01, "eps": 1e-9, "rescale_grad": 0.5}),
}
# the JAX names and aliases
JAX_NAMES = sorted(n for n, op in OP_REGISTRY.items()
                   if op.fcompute.__module__ == "mxnet_tpu.ops.optimizer_ops")


def _outputs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


def test_every_jax_optimizer_op_has_a_case_and_a_port_entry():
    names = {n for n in table.names()
             if table.lookup(n).fn.__module__.endswith(".optimizer_ops")}
    assert len({OP_REGISTRY[n].name for n in JAX_NAMES}) == 22
    assert names == set(JAX_NAMES)
    assert set(CASES) == names


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_jax_package(name):
    inputs, params = CASES[name]
    want = _outputs(getattr(jmx.nd, name)(*[jmx.nd.array(x, dtype=x.dtype)
                                            for x in inputs], **params))
    with mx.cpu():
        args = [mx.nd.array(x, dtype=x.dtype) for x in inputs]
        got = _outputs(getattr(mx.nd, name)(*args, **params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_allclose(g.asnumpy().astype(np.float32),
                                   w.asnumpy().astype(np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for a, x in zip(args, inputs):      # the inputs are left as they were
        np.testing.assert_array_equal(a.asnumpy(), x)


@pytest.mark.parametrize("name", ["sgd_mom_update", "mp_sgd_mom_update",
                                  "adam_update", "rmspropalex_update",
                                  "ftrl_update", "multi_sgd_mom_update"])
def test_in_place_functions_write_what_the_ops_return(name):
    """The function the optimizers call writes into its weight and
    states the values ``mx.nd`` returns, in the tensors it was given."""
    inputs, params = CASES[name]
    with mx.cpu():
        want = _outputs(getattr(mx.nd, name)(
            *[mx.nd.array(x, dtype=x.dtype) for x in inputs], **params))
    tensors = [torch.tensor(x) for x in inputs]
    ptrs = [t.data_ptr() for t in tensors]
    got = _outputs(getattr(optimizer_ops, name)(*tensors, **params))
    assert [t.data_ptr() for t in tensors] == ptrs
    for g, w in zip(got, want):
        assert any(g is t for t in tensors)
        np.testing.assert_array_equal(g.numpy(), w.asnumpy())


def test_fed_scalars_compute_below_fp32_weights_in_fp32():
    """With ``lr`` a 0-d fp32 tensor (a captured step's feed), a bf16
    weight's Adam update is computed in fp32 and written back rounded
    once."""
    w = torch.tensor(W).bfloat16()
    g = torch.tensor(G).bfloat16()
    m, v = torch.zeros(SHAPE), torch.zeros(SHAPE)
    ref = w.float() - 0.05 * (0.1 * g.float() * 0.5) / (
        torch.sqrt(0.001 * (g.float() * 0.5) ** 2) + 1e-8)
    optimizer_ops.adam_update(w, g, m, v, lr=torch.tensor(0.05),
                              rescale_grad=torch.tensor(0.5))
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  ref.bfloat16().float().numpy())
