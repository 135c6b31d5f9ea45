"""The port's learning-rate schedulers (``mxnet_tpu_torch.lr_scheduler``)
against the JAX package's on the CPU: each scheduler's lr for update
counts 0 to 120 in both warm-up modes, and an optimizer's
``learning_rate`` and ``_get_lr`` under a scheduler, including the
reference behaviour that ``Optimizer(learning_rate=...)`` overwrites the
scheduler's ``base_lr`` while warm-up and the polynomial and cosine
decays keep the ``base_lr`` they were built with.

Tolerance: equal to 1e-12 relative (the same float64 arithmetic in the
same order)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

RTOL = 1e-12
UPDATES = range(121)

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=10, factor=0.7,
                                       stop_factor_lr=1e-3, base_lr=0.5)),
    "multifactor": ("MultiFactorScheduler", dict(step=[15, 40, 90],
                                                 factor=0.3, base_lr=0.2)),
    "poly": ("PolyScheduler", dict(max_update=100, base_lr=0.1, pwr=2,
                                   final_lr=1e-3)),
    "cosine": ("CosineScheduler", dict(max_update=100, base_lr=0.1,
                                       final_lr=1e-4)),
}
WARMUPS = {
    "none": {},
    "linear": dict(warmup_steps=12, warmup_begin_lr=0.01,
                   warmup_mode="linear"),
    "constant": dict(warmup_steps=12, warmup_begin_lr=0.02,
                     warmup_mode="constant"),
}


def _pair(kind, warmup):
    name, kw = SCHEDULERS[kind]
    kw = dict(kw, **WARMUPS[warmup])
    return (getattr(mx.lr_scheduler, name)(**kw),
            getattr(jmx.lr_scheduler, name)(**kw))


@pytest.mark.parametrize("warmup", sorted(WARMUPS))
@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_schedule_matches_the_jax_package(kind, warmup):
    got, want = _pair(kind, warmup)
    g = [got(n) for n in UPDATES]
    w = [want(n) for n in UPDATES]
    np.testing.assert_allclose(g, w, rtol=RTOL)
    assert len(set(g)) > 3


def test_bad_warmup_mode_raises_in_both():
    s = mx.lr_scheduler.FactorScheduler(step=5, warmup_steps=4,
                                        warmup_mode="cubic")
    j = jmx.lr_scheduler.FactorScheduler(step=5, warmup_steps=4,
                                         warmup_mode="cubic")
    with pytest.raises(mx.MXNetError, match="warmup_mode"):
        s(1)
    with pytest.raises(jmx.base.MXNetError, match="warmup_mode"):
        j(1)


@pytest.mark.parametrize("warmup", ["none", "linear"])
@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_optimizer_lr_under_a_scheduler_matches_the_jax_package(kind,
                                                                warmup):
    """``learning_rate`` and ``_get_lr`` (with an ``lr_mult``) at each
    count as updates advance: the optimizer's ``learning_rate`` (0.05)
    replaces the scheduler's ``base_lr``, but warm-up and the poly and
    cosine decays keep the value they were built with."""
    got_s, want_s = _pair(kind, warmup)
    got = mx.optimizer.create("sgd", learning_rate=0.05,
                              lr_scheduler=got_s)
    want = jmx.optimizer.create("sgd", learning_rate=0.05,
                                lr_scheduler=want_s)
    assert got_s.base_lr == want_s.base_lr == 0.05
    for o in (got, want):
        o.set_lr_mult({1: 0.5})
    g, w = [], []
    for _ in UPDATES:
        for o, out in ((got, g), (want, w)):
            o._update_count(0)
            o._update_count(1)
            out.append((o.learning_rate, o._get_lr(0), o._get_lr(1)))
    np.testing.assert_allclose(g, w, rtol=RTOL)
    assert got.num_update == want.num_update == len(UPDATES)


def test_mx_lr_scheduler_is_the_optimizer_module():
    assert mx.lr_scheduler is mx.optimizer.lr_scheduler
    assert mx.optimizer.PolyScheduler is mx.lr_scheduler.PolyScheduler
