"""Samplers (the port's own copy of ``mxnet_tpu/gluon/data/sampler.py``).

``RandomSampler`` draws its order from ``np.random.permutation``, so the
same ``np.random.seed`` gives the same order in both packages."""
from __future__ import annotations

import numpy as np


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wraps a sampler into batches (reference: ``BatchSampler``);
    last_batch in ('keep', 'discard', 'rollover')."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                pass
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError("bad last_batch %r" % self._last_batch)

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length
