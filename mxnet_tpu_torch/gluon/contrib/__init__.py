"""Contrib gluon layers of the PyTorch port."""
from . import nn  # noqa: F401
