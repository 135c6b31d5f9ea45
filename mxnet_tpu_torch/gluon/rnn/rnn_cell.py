"""Recurrent cells, one time step a call (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``; reference ``python/mxnet/gluon/
rnn/rnn_cell.py``).

A cell is called as ``cell(inputs, states) -> (output, new_states)``
with tensors or NDArrays; :meth:`RecurrentCell.unroll` runs it over the
time axis of a sequence.  Weights are named as the reference's
(``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``), with the
fused layers' gate orders (LSTM i, f, g, o; GRU r, z, n).

``ZoneoutCell`` follows the reference MXNet cell: in training each
output (and state) element keeps its previous value with probability
``zoneout_outputs`` (``zoneout_states``).  The JAX package's cell
applies no zoneout at all (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ... import ops
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["DropoutCell", "GRUCell", "LSTMCell", "RNNCell", "RecurrentCell",
           "SequentialRNNCell", "ZoneoutCell"]


def _namespace(x):
    """``mx.nd`` for an NDArray, the op namespace for a tensor: both
    take the same op names and arguments."""
    return nd if isinstance(x, NDArray) else ops


class RecurrentCell(HybridBlock):
    def reset(self):
        """Forget the state of an unroll in progress (a zoneout cell's
        previous output), in this cell and the cells under it."""
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``func(shape, **kwargs)`` in place of
        ``mx.nd.zeros`` when given; ``ctx=`` places them)."""
        func = func or nd.zeros
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _zero_states(self, like, batch):
        if isinstance(like, NDArray):
            return self.begin_state(batch, ctx=like.context,
                                    dtype=like.dtype)
        return [torch.zeros(info["shape"], dtype=like.dtype,
                            device=like.device)
                for info in self.state_info(batch)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` (time on
        ``layout``'s ``T`` axis): ``(outputs, states)``, the outputs
        stacked on that axis unless ``merge_outputs`` is False."""
        self.reset()
        F = _namespace(inputs)
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state if begin_state is not None \
            else self._zero_states(inputs, batch)
        outputs = []
        for t in range(length):
            step = F.squeeze(F.slice_axis(inputs, axis=axis, begin=t,
                                          end=t + 1), axis=axis)
            out, states = self(step, states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states


class _GatedCell(RecurrentCell):
    """A cell of ``gates`` gate blocks over ``i2h``/``h2h`` products."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        gh = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(gh, input_size),
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(gh, hidden_size))
            self.i2h_bias = self.params.get("i2h_bias", shape=(gh,),
                                            init="zeros")
            self.h2h_bias = self.params.get("h2h_bias", shape=(gh,),
                                            init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])


class RNNCell(_GatedCell):
    """Elman cell: ``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._act = activation

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._act)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell; states ``[h, c]``."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=4 * self._hidden_size) \
            + F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    """GRU cell: ``n = tanh(xn + r * hn)``, ``h' = (1 - z) n + z h``."""

    _gates = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        ir, iz, inn = i2h.chunk(3, -1)
        hr, hz, hn = h2h.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its slice of
    the states."""

    def add(self, cell):
        self.add_module(str(len(self._children)), cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def forward(self, inputs, states):
        next_states, pos = [], 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, new = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(new)
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout of rate ``rate`` on the inputs, in training; no state."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        return F.Dropout(inputs, p=self._rate,
                         training=autograd.is_training()), states


class ZoneoutCell(RecurrentCell):
    """Zoneout around ``base_cell``: in training each element of the
    output (of each state) keeps its previous step's value with
    probability ``zoneout_outputs`` (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def forward(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        F = _namespace(out)
        training = autograd.is_training()

        def keep_new(p, like):
            return F.Dropout(F.ones_like(like), p=p, training=training)

        prev = self._prev_output if self._prev_output is not None \
            else F.zeros_like(out)
        if self._zo:
            out = F.where(keep_new(self._zo, out), out, prev)
        if self._zs:
            new_states = [F.where(keep_new(self._zs, new), new, old)
                          for new, old in zip(new_states, states)]
        self._prev_output = out
        return out, new_states
