"""Gluon utilities (port of ``mxnet_tpu/gluon/utils.py:17-66``; parity:
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``. They take tensors or NDArrays
and give back the same kind. ``download`` raises: the port fetches
nothing from the network.
"""
from __future__ import annotations

import hashlib
import math
import warnings

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops.optimizer_ops import multi_sum_sq

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` in ``num_slice`` slices along ``batch_axis``, the last
    taking the remainder (``gluon/utils.py:35``); a tensor's slices are
    views of it."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}. Use a batch "
            f"size that's multiple of {num_slice} or set even_split=False.")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    bounds = [(i * step, (i + 1) * step if i < num_slice - 1 else size)
              for i in range(num_slice)]
    if isinstance(data, NDArray):      # copies, as MXNet's slice_axis
        return [NDArray(data._data.narrow(batch_axis, b, e - b).clone(),
                        data.context) for b, e in bounds]
    return [data.narrow(batch_axis, b, e - b) for b, e in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split into ``len(ctx_list)`` slices, slice i on context i
    (``gluon/utils.py:81``). A numpy array comes back as tensors."""
    if not isinstance(data, (NDArray, torch.Tensor)):
        data = torch.from_numpy(_np.ascontiguousarray(data))
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    if isinstance(data, NDArray):
        return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]
    return [s.to(ctx.torch_device()) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the 2-norm of all of them together
    is at most ``max_norm``; returns that norm before scaling, as a float
    (``gluon/utils.py:115``)."""
    if not arrays:
        raise MXNetError("clip_global_norm: no arrays")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        total = torch.stack(multi_sum_sq(*tensors)).sum().sqrt()
        total_norm = float(total.item())
        if check_isfinite and not math.isfinite(total_norm):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for t in tensors:
                t.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 is ``sha1_hash`` (``gluon/utils.py:173``)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises: the port fetches nothing from the network; put the file on
    disk and read it from there."""
    raise MXNetError(f"download({url}): the port does not fetch files from "
                     "the network; place the file on disk and pass its path")
