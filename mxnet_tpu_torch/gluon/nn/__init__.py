"""Gluon layers of the PyTorch port."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from . import basic_layers, conv_layers

__all__ = basic_layers.__all__ + conv_layers.__all__
