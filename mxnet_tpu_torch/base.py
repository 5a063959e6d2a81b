"""Base utilities: the framework's error type and dtype names.

Counterpart of ``mxnet_tpu/base.py``, kept to what the PyTorch port uses.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "torch_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: dmlc::Error / MXGetLastError)."""


_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dtype):
    """A dtype name, numpy dtype or ``torch.dtype`` -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
