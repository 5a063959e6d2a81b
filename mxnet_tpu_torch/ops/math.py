"""Tensor math ops (subset of ``mxnet_tpu/ops/math.py``): the gather, index,
layout and reduction ops the decoder LM's and ResNet's forwards and the
losses need."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.amp import cast_op
from ..base import torch_dtype
from .registry import register

__all__ = ["embedding", "pick", "sum", "mean", "arange", "transpose",
           "space_to_depth", "log", "exp", "square", "norm"]


def embedding(data, weight):
    """Rows of ``weight`` at ids ``data`` (parity: indexing_op.cc Embedding).

    Ids are cast to integers (floats truncate, as ``astype(int32)`` does)
    and clipped into ``[0, input_dim)``: ``mxnet_tpu`` gathers with
    ``mode="clip"`` (ops/math.py:643-650), so an out-of-range id reads the
    nearest edge row instead of raising.
    """
    ids = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """The element of ``data`` at ``index`` along ``axis``
    (``mxnet_tpu/ops/math.py:632-640``; parity: broadcast_reduce_op_index.cc
    pick). ``index`` has ``data``'s shape without ``axis``, or with it of
    size 1. An index outside ``[0, n)`` reads the nearest edge (MXNet's
    ``mode="clip"``, the only mode ported). ``mxnet_tpu``'s ``pick``
    ignores ``mode``: its ``take_along_axis`` fills an index past the end
    with NaN and wraps a negative one (ROADMAP Queue 3); the port follows
    MXNet."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported (only 'clip')")
    axis = axis % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    if idx.dim() != data.dim():
        idx = idx.unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def _axes(data, axis, exclude):
    """The reduced axes: ``axis`` (all when None), or with ``exclude``
    every axis but those (``mxnet_tpu/ops/math.py:192-196``)."""
    if axis is None:
        return tuple(range(data.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    if exclude:
        keep = {a % data.dim() for a in ax}
        return tuple(i for i in range(data.dim()) if i not in keep)
    return ax


@cast_op("sum")
def sum(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    """Sum over ``axis`` (``mxnet_tpu/ops/math.py:186-189``)."""
    axes = _axes(data, axis, exclude)
    return torch.sum(data, dim=axes, keepdim=keepdims) if axes else data


@cast_op("mean")
def mean(data, axis=None, keepdims=False, exclude=False):
    """Mean over ``axis`` (``mxnet_tpu/ops/math.py:199-201``)."""
    axes = _axes(data, axis, exclude)
    return torch.mean(data, dim=axes, keepdim=keepdims) if axes else data


@cast_op("log")
def log(data):
    return torch.log(data)


@cast_op("exp")
def exp(data):
    return torch.exp(data)


@cast_op("square")
def square(data):
    return data * data


@cast_op("norm")
def norm(data, axis=None, keepdims=False):
    """The L2 norm over ``axis`` (all axes when None)."""
    return torch.linalg.vector_norm(data, dim=axis, keepdim=keepdims)


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


# The Symbol operators' ops under their MXNet names
# (``mxnet_tpu/ops/math.py:35-72, 109``)
register("elemwise_add", aliases=("broadcast_add", "broadcast_plus",
                                  "_plus", "_add"))(lambda a, b: a + b)
register("elemwise_sub", aliases=("broadcast_sub", "broadcast_minus",
                                  "_sub", "_minus"))(lambda a, b: a - b)
register("elemwise_mul", aliases=("broadcast_mul", "_mul"))(
    lambda a, b: a * b)
register("elemwise_div", aliases=("broadcast_div", "_div"))(
    lambda a, b: a / b)
register("negative")(lambda a: -a)


@register("elemwise_add_scalar", aliases=("_plus_scalar",))
def _add_scalar(a, scalar=0.0, reverse=False):
    return a + scalar


@register("elemwise_sub_scalar", aliases=("_minus_scalar",
                                          "_rminus_scalar"))
def _sub_scalar(a, scalar=0.0, reverse=False):
    return scalar - a if reverse else a - scalar


@register("elemwise_mul_scalar", aliases=("_mul_scalar",))
def _mul_scalar(a, scalar=1.0, reverse=False):
    return a * scalar


@register("elemwise_div_scalar", aliases=("_div_scalar", "_rdiv_scalar"))
def _div_scalar(a, scalar=1.0, reverse=False):
    return torch.full_like(a, scalar) / a if reverse else a / scalar
