"""Device mesh (the one-device subset of ``mxnet_tpu/parallel/mesh.py``).

``mxnet_tpu`` names a ``jax.sharding.Mesh`` of devices by axes ('dp' data,
'fsdp', 'tp', 'pp', 'sp', 'ep'). The port runs one process on one card:
:func:`create_mesh` takes a mesh whose axis sizes multiply to 1. A larger
mesh raises ``NotImplementedError``; it is never treated as one device.
Meshes over several cards (NCCL process groups, DTensor placements) are
ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..context import Context, as_device

__all__ = ["Mesh", "create_mesh"]


class Mesh:
    """Devices laid out over named axes, as ``jax.sharding.Mesh`` shows
    them: ``devices`` (a numpy object array of ``torch.device``, shaped
    by the axes), ``axis_names`` and ``shape`` ({axis: size})."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _torch_device(d):
    if isinstance(d, Context):
        return d.torch_device()
    if isinstance(d, torch.device):
        return d
    raise TypeError(f"create_mesh: a device must be a Context or a "
                    f"torch.device, got {type(d).__name__}")


def create_mesh(axes=None, devices=None):
    """A :class:`Mesh` of one device.

    ``axes``: {axis name: size}, a -1 size absorbing the remaining devices,
    or None for ``{"dp": len(devices)}``. ``devices``: Contexts or
    ``torch.device``s, by default ``[gpu(0)]`` (the current context).
    Sizes whose product is not 1, or more than one device, raise
    ``NotImplementedError``.
    """
    devices = [as_device(None)] if devices is None else [
        _torch_device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = len(devices) // max(known, 1)
    total = math.prod(sizes)
    if total != 1 or len(devices) != 1:
        raise NotImplementedError(
            f"create_mesh: mesh {dict(zip(names, sizes))} over "
            f"{len(devices)} device(s); the PyTorch port runs one device "
            "(axis sizes multiplying to 1). Meshes over several cards are "
            "ROADMAP Queue 1 item 6")
    arr = np.empty(sizes, dtype=object)
    arr.flat[0] = devices[0]
    return Mesh(arr, names)
