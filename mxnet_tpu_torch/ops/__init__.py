"""Operators of the PyTorch port: plain tensor functions (``math``, ``nn``)
and the hand-written CUDA kernels with their plain versions (``kernels``)."""
from . import kernels, math, nn  # noqa: F401
