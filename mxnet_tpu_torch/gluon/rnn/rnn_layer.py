"""Fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; reference ``python/mxnet/gluon/
rnn/rnn_layer.py``).

``RNN``, ``LSTM`` and ``GRU`` over the fused ``RNN`` op
(:func:`mxnet_tpu_torch.ops.nn.RNN`).  Parameters keep the reference's
per-layer names (``l0_i2h_weight``, ``r0_h2h_bias``, ...) and are packed
into the op's flat vector at each call (:meth:`_RNNLayer._pack_params`).
Layout ``TNC`` (time-major) or ``NTC``.  Called without states the
layer starts from zeros and returns the output alone; with states it
returns ``(output, new_states)``.  Between layers, in training
(``autograd.record()``), dropout of rate ``dropout``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock
from ..parameter import shape_is_known

__all__ = ["GRU", "LSTM", "RNN"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode, gates, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("layout must be TNC or NTC, got %r" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = gates
        with self.name_scope():
            for i in range(num_layers):
                in_sz = input_size if i == 0 else hidden_size * self._dir
                for j in self._directions():
                    for part, shape, init, deferred in (
                            ("i2h_weight", (gates * hidden_size, in_sz),
                             i2h_weight_initializer, True),
                            ("h2h_weight", (gates * hidden_size, hidden_size),
                             h2h_weight_initializer, False),
                            ("i2h_bias", (gates * hidden_size,),
                             i2h_bias_initializer, False),
                            ("h2h_bias", (gates * hidden_size,),
                             h2h_bias_initializer, False)):
                        name = "%s%d_%s" % (j, i, part)
                        self._reg_params[name] = self.params.get(
                            name, shape=shape, init=init,
                            allow_deferred_init=deferred)

    def _directions(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def infer_shape(self, x, *args):
        in_sz = x.shape[2]
        for i in range(self._num_layers):
            for j in self._directions():
                p = self._reg_params["%s%d_i2h_weight" % (j, i)]
                if not shape_is_known(p.shape):
                    p.shape = (self._gates * self._hidden_size,
                               in_sz if i == 0
                               else self._hidden_size * self._dir)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero initial states as NDArrays (``func(shape, **kwargs)`` in
        place of ``mx.nd.zeros`` when given; ``ctx=`` places them)."""
        func = func or nd.zeros
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _pack_params(self, F, kwargs):
        """The op's flat parameter vector: per layer, per direction,
        ``i2h_weight, h2h_weight, i2h_bias, h2h_bias``."""
        return torch.cat([kwargs["%s%d_%s" % (j, i, part)].reshape(-1)
                          for i in range(self._num_layers)
                          for j in self._directions()
                          for part in ("i2h_weight", "h2h_weight",
                                       "i2h_bias", "h2h_bias")])

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        if isinstance(states, torch.Tensor):
            states = [states]
        h0 = states[0]
        c0 = states[1] if self._mode == "lstm" else None
        out = F.RNN(inputs, self._pack_params(F, kwargs), h0, c0,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    training=autograd.is_training())
        y, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            y = y.transpose(0, 1)
        return y if skip_states else (y, new_states)

    def __repr__(self):
        return "%s(%s, hidden=%d, layers=%d%s)" % (
            type(self).__name__, self._input_size or "?", self._hidden_size,
            self._num_layers, ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, 1, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM; states ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", 4, **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}, {"shape": shape}]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", 3, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]
