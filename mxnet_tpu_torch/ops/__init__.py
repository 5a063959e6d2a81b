"""Operators of the PyTorch port: plain tensor functions (``math``, ``nn``,
``parity_aliases``, ``random_ops``, ``optimizer_ops``, the fused ``rnn``,
the subgraph loops of ``control_flow``, the SSD / R-CNN ops of
``detection``, the image ops of ``image_ops``), the INT8 ops
(``quantization``, with K5), the hand-written CUDA kernels with their plain
versions (``kernels``), and the registry that names them for ``mx.nd``,
``mx.sym`` and the executor (``registry``)."""
from . import registry, kernels, math, nn, quantization  # noqa: F401
from . import optimizer_ops, parity_aliases, random_ops  # noqa: F401
from . import rnn, control_flow, detection, image_ops  # noqa: F401
