"""Contributed modules of the PyTorch port: INT8 quantization
(:mod:`~mxnet_tpu_torch.contrib.quantization`)."""
from . import quantization  # noqa: F401
