"""BaseModule: the train and eval loops of the symbolic API (counterpart
of ``mxnet_tpu/module/base_module.py``; reference
``python/mxnet/module/base_module.py``).

``bind -> init_params -> init_optimizer -> fit/score/predict``: a
subclass computes (``forward``/``backward``/``update``); this class
owns the epoch loop, the metric and the callbacks.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _as_list(obj):
    if obj is None:
        return []
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


def _check_input_names(symbol, names, typename, throw):
    args = set(symbol.list_arguments())
    for name in names:
        if name not in args:
            msg = "input %s %r is not an argument of the symbol " \
                  "(arguments: %s)" % (typename, name, sorted(args)[:20])
            if throw:
                raise MXNetError(msg)
            logging.warning(msg)


def _call_batch_end(callbacks, epoch, nbatch, eval_metric, scope):
    if callbacks is None:
        return
    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                          eval_metric=eval_metric, locals=scope)
    for cb in _as_list(callbacks):
        cb(param)


class BaseModule:
    """``fit``/``score``/``predict`` over a subclass's ``forward``,
    ``backward`` and ``update``."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------------
    # High-level interface
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0):
        """Run ``eval_data`` through the module and return the metric's
        ``(name, value)`` pairs."""
        self._check_ready()
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            _call_batch_end(batch_end_callback, epoch, nbatch, eval_metric,
                            locals())
        _call_batch_end(score_end_callback, epoch, 0, eval_metric, locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch, the padded
        rows of a last batch cut off."""
        self._check_ready()
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outs = self.get_outputs()
            if eval_batch.pad:
                outs = [o[:o.shape[0] - eval_batch.pad] for o in outs]
            yield outs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        """The outputs over ``eval_data``, concatenated along the batch
        when ``merge_batches`` (one array for one output), else a list
        of each batch's outputs."""
        from .. import ndarray as nd
        output_list = [outs for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list or not merge_batches:
            return output_list
        merged = [nd.concat(*[b[i] for b in output_list], dim=0)
                  for i in range(len(output_list[0]))]
        return merged[0] if len(merged) == 1 else merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="device", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The legacy training loop: bind, initialize, then per epoch
        one ``forward_backward`` and ``update`` a batch, the metric and
        the callbacks, and the validation score."""
        if num_epoch is None:
            raise MXNetError("fit: please specify num_epoch")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                _call_batch_end(batch_end_callback, epoch, nbatch,
                                eval_metric, locals())
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _check_ready(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("%s: bind and init_params first"
                             % type(self).__name__)

    # ------------------------------------------------------------------
    # Properties and the subclass's interface
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="device", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()
