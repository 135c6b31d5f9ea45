"""BucketingModule: variable-length training through one module a
bucket (counterpart of ``mxnet_tpu/module/bucketing_module.py``;
reference ``python/mxnet/module/bucketing_module.py``).

A bucket is a shape class: each gets a :class:`~.module.Module` of its
own, so one executor, and on the card one train graph and one eval
graph, while all buckets share one parameter set.  The JAX package
copies the parameters between its buckets' executors; here each
bucket's module is bound with the default bucket's as
``shared_module``, so every graph reads the same parameter, aux and
gradient arrays, and an update made through one bucket is what the
others' replays read.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """``BucketingModule(sym_gen, default_bucket_key)``, with
    ``sym_gen(bucket_key) -> (symbol, data_names, label_names)``."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def bucket_keys(self):
        """The keys bound so far."""
        return sorted(self._buckets)

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    def _gen_module(self, bucket_key):
        from .module import Module
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names=data_names,
                      label_names=label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        """Bind the default bucket."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad)
        self._buckets = {self._default_bucket_key: mod}
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module over the
        default bucket's arrays the first time and handing it the
        optimizer (and the dist kvstore, without which its update would
        skip the gradient sum across processes)."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        mod = self._buckets.get(bucket_key)
        if mod is None:
            default = self._buckets[self._default_bucket_key]
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self._inputs_need_grad, shared_module=default)
            if default.optimizer_initialized:
                mod._optimizer = default._optimizer
                mod._updater = default._updater
                mod._kvstore = default._kvstore
                mod.optimizer_initialized = True
            self._buckets[bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if self.params_initialized and not force_init:
            return
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params=None, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def init_optimizer(self, kvstore="device", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init)
        for mod in self._buckets.values():
            mod._optimizer = default._optimizer
            mod._updater = default._updater
            mod._kvstore = default._kvstore
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check_ready()
        key = getattr(data_batch, "bucket_key", self._curr_bucket_key)
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def capture_stats(self):
        """Each bucket's executor's graphs, by key."""
        return {key: mod._exec.capture_stats()
                for key, mod in self._buckets.items()}
