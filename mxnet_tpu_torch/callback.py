"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``;
reference ``python/mxnet/callback.py``).  A batch-end callback gets a
:class:`~.model.BatchEndParam`; an epoch-end callback gets ``(epoch,
symbol, arg_params, aux_params)``.  ``Speedometer`` logs samples/s, the
throughput convention of MXNet's training scripts."""
from __future__ import annotations

import logging
import time

from . import telemetry as _telemetry
from .model import save_checkpoint

__all__ = ["LogValidationMetricsCallback", "ProgressBar", "Speedometer",
           "do_checkpoint", "log_train_metric", "managed_checkpoint",
           "module_checkpoint"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint(prefix, epoch + 1)``
    every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``save_checkpoint(prefix, epoch + 1, ...)``
    every ``period`` epochs (atomic writes)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def managed_checkpoint(manager, period=1, metadata_fn=None):
    """Epoch-end callback saving through a
    :class:`~.checkpoint.CheckpointManager` (manifest, retention,
    optionally asynchronous) in place of prefix files;
    ``metadata_fn(iter_no)`` gives the manifest's user metadata."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period != 0 or not arg:
            return
        params = {"arg:%s" % k: v for k, v in arg.items()}
        params.update({"aux:%s" % k: v for k, v in (aux or {}).items()})
        meta = metadata_fn(iter_no) if metadata_fn is not None else None
        manager.save(iter_no + 1, {"params": params}, metadata=meta)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Logs samples/s every ``frequent`` batches (and the metric, reset
    each time with ``auto_reset``); ``last_speed`` keeps the latest."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.last_speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        try:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
        except ZeroDivisionError:
            speed = float("inf")
        self.last_speed = speed
        if _telemetry._ENABLED:
            # the gauge Trainer.step feeds: one channel for both APIs
            _telemetry.hooks.samples_per_sec(speed)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            msg = "Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec" \
                + "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count - self.frequent, count,
                         speed, *sum(name_value, ()))
            if self.auto_reset:
                param.eval_metric.reset_local()
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """A text progress bar over an epoch of ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback logging each validation metric."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
