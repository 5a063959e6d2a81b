"""Tensor math ops (subset of ``mxnet_tpu/ops/math.py``): the gather and
index ops the decoder LM's forward needs."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype

__all__ = ["embedding", "arange"]


def embedding(data, weight):
    """Rows of ``weight`` at ids ``data`` (parity: indexing_op.cc Embedding).

    Ids are cast to integers (floats truncate, as ``astype(int32)`` does)
    and clipped into ``[0, input_dim)``: ``mxnet_tpu`` gathers with
    ``mode="clip"`` (ops/math.py:643-650), so an out-of-range id reads the
    nearest edge row instead of raising.
    """
    ids = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)


def arange(start, stop=None, step=1, dtype="float32", device=None):
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                        device=device)
