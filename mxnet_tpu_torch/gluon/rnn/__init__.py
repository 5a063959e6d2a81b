"""Gluon recurrent layers and cells (port of ``mxnet_tpu/gluon/rnn``;
parity: python/mxnet/gluon/rnn/)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from . import rnn_cell, rnn_layer  # noqa: F401

__all__ = rnn_cell.__all__ + rnn_layer.__all__
