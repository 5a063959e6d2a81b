"""Contrib gluon layers of the PyTorch port (parity:
python/mxnet/gluon/contrib/)."""
from . import nn, rnn  # noqa: F401
from .nn import MultiHeadAttention, Remat  # noqa: F401
