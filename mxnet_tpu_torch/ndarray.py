"""Parameter files (``mx.nd.save`` / ``mx.nd.load``; port of
``mxnet_tpu/ndarray/ndarray.py:862-926``, dense arrays).

The format is ``mxnet_tpu``'s: a numpy ``.npz`` archive whose entry names
are the array names (``__only__`` for one array, ``__list_<i>__`` for a
list), written to exactly the given file name. A ``.params`` file written
by ``mxnet_tpu`` loads here unchanged, and one written here loads there.
Sparse entries (``<name>::rsp_*`` / ``::csr_*``) are not ported.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["save", "load"]


def _numpy(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return _np.asarray(a)


def save(fname, data):
    """Write a tensor, a list of tensors or a dict name -> tensor (numpy
    arrays too) to ``fname``."""
    if isinstance(data, (torch.Tensor, _np.ndarray)):
        entries = {"__only__": data}
    elif isinstance(data, (list, tuple)):
        entries = {f"__list_{i}__": a for i, a in enumerate(data)}
    elif isinstance(data, dict):
        entries = dict(data)
    else:
        raise TypeError("save expects a tensor, a list or a dict")
    entries = {k: _numpy(v) for k, v in entries.items()}
    tmp = fname if fname.endswith(".npz") else fname + ".npz"
    _np.savez(tmp, **entries)
    if tmp != fname:
        os.replace(tmp, fname)


def load(fname):
    """The arrays of ``fname`` as CPU tensors: a dict name -> tensor, or a
    list for a file saved from one tensor or a list."""
    with _np.load(fname, allow_pickle=False) as f:
        names = list(f.keys())
        if any("::" in n for n in names):
            raise MXNetError(f"{fname}: sparse entries are not ported")
        out = {n: torch.from_numpy(_np.array(f[n])) for n in names}
    if names == ["__only__"]:
        return [out["__only__"]]
    if names and all(n.startswith("__list_") for n in names):
        return [out[f"__list_{i}__"] for i in range(len(names))]
    return out
