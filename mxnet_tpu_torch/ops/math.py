"""Tensor math ops (subset of ``mxnet_tpu/ops/math.py``): the gather, index
and layout ops the decoder LM's and ResNet's forwards need."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype

__all__ = ["embedding", "arange", "transpose", "space_to_depth"]


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


def transpose(data, axes=None):
    """Permute the axes (reversed when ``axes`` is None), as a view."""
    if axes is None:
        axes = tuple(range(data.dim() - 1, -1, -1))
    return data.permute(*axes)


def space_to_depth(data, block_size=1):
    """(N, C, H, W) -> (N, C*b*b, H/b, W/b) with output channels ordered
    (bh, bw, C) (``mxnet_tpu/ops/math.py:584-590``). ``F.pixel_unshuffle``
    orders them (C, bh, bw), which would permute a carried stem weight."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)
