"""``gluon.rnn`` (counterpart of ``mxnet_tpu/gluon/rnn``; reference
``python/mxnet/gluon/rnn/``): the fused layers over the ``RNN`` op and
the cells."""
from .rnn_cell import (DropoutCell, GRUCell, LSTMCell, RecurrentCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["DropoutCell", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCell", "RecurrentCell", "SequentialRNNCell", "ZoneoutCell"]
