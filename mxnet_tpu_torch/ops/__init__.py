"""Operators of the PyTorch port: plain tensor functions (``math``, ``nn``),
the INT8 ops (``quantization``, with K5), the hand-written CUDA kernels with
their plain versions (``kernels``), and the registry that names them for
the Symbol layer (``registry``)."""
from . import registry, kernels, math, nn, quantization  # noqa: F401
