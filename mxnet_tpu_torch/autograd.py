"""Recording and train/predict scopes (counterpart of
``mxnet_tpu/autograd.py``).

PyTorch records every operation on a tensor that requires a gradient,
so the port's tape is PyTorch's own.  What stays from MXNet is the pair
of thread-local flags the layers read:

- *recording* -- whether operations are recorded for backward; a scope
  that sets it also enters ``torch.enable_grad()`` or
  ``torch.no_grad()``;
- *training* -- whether layers run in training mode (``BatchNorm`` uses
  batch statistics and updates its running statistics).

``record()`` sets both, ``pause()`` clears recording and (by default)
training, ``train_mode()`` and ``predict_mode()`` set training alone.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["is_recording", "is_training", "pause", "predict_mode",
           "record", "train_mode"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._is_record = is_record
        self._train = train_mode
        self._prev = None
        self._grad_mode = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._is_record is not None:
            st.recording = self._is_record
            self._grad_mode = torch.set_grad_enabled(self._is_record)
            self._grad_mode.__enter__()
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad_mode is not None:
            self._grad_mode.__exit__(*exc)
            self._grad_mode = None
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """Scope in which operations are recorded for backward."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording is suspended."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)
