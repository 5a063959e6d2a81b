"""Device mesh (port of ``mxnet_tpu/parallel/mesh.py``).

``mxnet_tpu`` names a ``jax.sharding.Mesh`` of devices by axes ('dp' data,
'fsdp', 'tp', 'pp', 'sp', 'ep') and runs one program over it. The port is
multi-controller: one process per rank, each holding the same
:class:`Mesh` and its own coordinate in it. Ranks are laid out over the
axes in row-major (C) order, as ``np.asarray(devices).reshape(sizes)``
lays out ``mxnet_tpu``'s devices, so global rank r sits at
``np.unravel_index(r, sizes)``.

A mesh of several ranks needs ``torch.distributed`` initialized with one
process per rank (``ShardedTrainer.for_multihost`` does it). At
construction it builds one ``ProcessGroup`` for every tuple of its axes
whose extent exceeds 1, on every rank in the same order, as
``torch.distributed.new_group`` requires; :meth:`Mesh.group` returns this
rank's. A mesh of one rank needs no process group.

``PodTopology`` / ``pod_mesh`` / ``shrink_mesh_hosts`` (host failure
domains) are ROADMAP Queue 1 item 12 and raise.
"""
from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_device

__all__ = ["Mesh", "create_mesh", "default_mesh", "named_mesh",
           "parse_mesh_spec", "local_devices", "shrink_mesh",
           "MeshShrinkError", "AXES", "PodTopology", "pod_mesh",
           "shrink_mesh_hosts"]

AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")


class Mesh:
    """Ranks laid out over named axes, as ``jax.sharding.Mesh`` shows its
    devices: ``devices`` (a numpy object array of ``torch.device``, one per
    rank, shaped by the axes), ``axis_names`` and ``shape`` ({axis: size}).

    ``rank`` is this process's global rank (0 on a one-rank mesh),
    ``coords`` its coordinate ({axis: index}) and ``device`` its device.
    """

    def __init__(self, devices, axis_names, rank=0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self._groups = {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def coords(self):
        idx = np.unravel_index(self.rank, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    @property
    def device(self):
        return self.devices.flat[self.rank]

    def _axes(self, axes):
        """``axes`` (a name or a tuple of names) in mesh order, without
        the axes of extent 1; an unknown name raises."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh {self.shape} has no axis {a!r}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def axis_size(self, axes):
        """The number of ranks along ``axes`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes):
        """This rank's index along ``axes``, row-major over them (the
        ``lax.axis_index`` of a tuple of axes)."""
        idx, coords = 0, self.coords
        for a in self._axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group_ranks(self, axes):
        """The global ranks of this rank's group along ``axes``, by their
        index along them."""
        axes = self._axes(axes)
        coords = self.coords
        sizes = self.devices.shape
        ranks = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(coords, **dict(zip(axes, pos)))
            ranks.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], sizes)))
        return ranks

    def group(self, axes):
        """This rank's ``ProcessGroup`` along ``axes``, or None where they
        hold one rank."""
        axes = self._axes(axes)
        if not axes:
            return None
        return self._groups[axes]

    def _build_groups(self):
        """One process group per tuple of axes of extent > 1 and per
        coordinate of the other axes: every rank calls ``new_group`` for
        every group, in the same order."""
        import torch.distributed as dist

        live = [a for a in self.axis_names if self.shape[a] > 1]
        world = dist.get_world_size()
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                span = math.prod(self.shape[a] for a in axes)
                rest = [a for a in self.axis_names if a not in axes]
                seen = set()
                for r in range(self.size):
                    c = dict(zip(self.axis_names,
                                 np.unravel_index(r, self.devices.shape)))
                    key = tuple(int(c[a]) for a in rest)
                    if key in seen:
                        continue
                    seen.add(key)
                    member = Mesh(self.devices, self.axis_names, r)
                    ranks = member.group_ranks(axes)
                    g = dist.group.WORLD if span == world else \
                        dist.new_group(ranks=ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"devices={list(self.devices.flat)})")


def local_devices(platform=None):
    """The devices this process can use: every CUDA device, or the CPU
    (``platform`` 'gpu' or 'cpu' picks one kind)."""
    if platform not in (None, "gpu", "cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}")
    if platform != "cpu" and torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform in ("gpu", "cuda"):
        raise MXNetError("local_devices('gpu'): CUDA is not available")
    return [torch.device("cpu")]


def _torch_device(d):
    if isinstance(d, Context):
        return d.torch_device()
    if isinstance(d, torch.device):
        return d
    raise TypeError(f"create_mesh: a device must be a Context or a "
                    f"torch.device, got {type(d).__name__}")


def _world():
    """(world size, rank) of the initialized ``torch.distributed`` group,
    or (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(axes=None, devices=None):
    """A :class:`Mesh` over ``torch.distributed``'s ranks.

    ``axes``: {axis name: size}, a -1 size absorbing the remaining ranks,
    or None for ``{"dp": len(devices)}``. ``devices``: one Context or
    ``torch.device`` per rank (rank r runs on ``devices[r]``); by default
    this process's current context for each of the world's ranks. The
    sizes must multiply to the number of devices, and a mesh of more than
    one rank needs ``torch.distributed`` initialized with that world size.
    """
    world, rank = _world()
    devices = [as_device(None)] * world if devices is None else [
        _torch_device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = len(devices) // max(known, 1)
    total = math.prod(sizes)
    if total != len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, got {len(devices)}")
    if total > 1 and world != total:
        raise MXNetError(
            f"create_mesh: a mesh of {total} ranks "
            f"{dict(zip(names, sizes))} needs torch.distributed initialized "
            f"with world size {total} (one process per rank: "
            f"ShardedTrainer.for_multihost or init_process_group); "
            f"the world size here is {world}")
    arr = np.empty(sizes, dtype=object)
    for i, d in enumerate(devices):
        arr.flat[i] = d
    mesh = Mesh(arr, names, rank if total > 1 else 0)
    if total > 1:
        mesh._build_groups()
    return mesh


def default_mesh(n_devices=None):
    """A pure data-parallel mesh over the world's ranks (or the first
    ``n_devices``, which must be all of them when there are several)."""
    world, _ = _world()
    n = world if n_devices is None else int(n_devices)
    return create_mesh({"dp": n}, [as_device(None)] * n)


def parse_mesh_spec(spec):
    """Parse a 'dp=2,fsdp=2,tp=-1' mesh-shape string into an ordered
    axis dict (a -1 size absorbs the remaining devices, create_mesh
    semantics). Axis names must come from AXES so a typo'd axis fails
    loudly instead of silently replicating."""
    axes = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh axis {part!r} in {spec!r}: want name=size")
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} in {spec!r}: want one of {AXES}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        axes[name] = int(val)
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


def named_mesh(spec=None, devices=None):
    """The named multi-axis training mesh: ``spec`` is a 'dp=2,fsdp=2'
    string, an axis dict, or None to read ``MXNET_TPU_MESH_SHAPE``; with
    neither set, the pure data-parallel :func:`default_mesh`. Axes of
    size 1 are kept, so SpecLayout rules resolve uniformly."""
    if spec is None:
        spec = os.environ.get("MXNET_TPU_MESH_SHAPE", "").strip()
        if not spec:
            return default_mesh() if devices is None else create_mesh(
                {"dp": len(list(devices))}, devices)
    axes = spec if isinstance(spec, dict) else parse_mesh_spec(spec)
    return create_mesh(axes, devices)


class MeshShrinkError(RuntimeError):
    """No viable smaller mesh exists after excising the dead ranks.

    Carries the old mesh shape (``axes``), the ranks that died
    (``dead_ranks``) and the axis that was being shrunk (``batch_axis``).
    """

    def __init__(self, msg, *, axes=None, dead_ranks=(), batch_axis=None):
        super().__init__(msg)
        self.axes = dict(axes or {})
        self.dead_ranks = tuple(dead_ranks)
        self.batch_axis = batch_axis


def shrink_mesh(mesh, dead_ranks, batch_axis="dp"):
    """The largest viable mesh buildable from the survivors after losing
    ``dead_ranks`` along the (data-parallel) shrink axis
    (``mxnet_tpu/parallel/mesh.py:70``), as arithmetic on the mesh: a
    :class:`Mesh` whose ``devices`` array holds the surviving slots, with
    no process group. Rebuilding the process groups of a live job is
    ROADMAP Queue 1 item 12.

    ``batch_axis`` is one axis name or a tuple (shrinking happens along the
    first). On a one-axis mesh a rank is its slot; on several axes it is
    the flat device ordinal, whose shrink-axis coordinate names the slot
    lost. Ranks outside the device range still cost a slot each, dropped
    from the tail. The new extent is the largest power of two that fits
    the survivors."""
    names = list(mesh.axis_names)
    old_axes = dict(zip(names, mesh.devices.shape))
    shrink_axes = ((batch_axis,) if isinstance(batch_axis, str)
                   else tuple(batch_axis))
    shrink_axis = shrink_axes[0]
    if shrink_axis not in names:
        raise MeshShrinkError(
            f"mesh {names} has no '{shrink_axis}' axis to shrink",
            axes=old_axes, dead_ranks=dead_ranks, batch_axis=shrink_axis)
    axis = names.index(shrink_axis)
    size = int(mesh.devices.shape[axis])
    dead = {int(r) for r in dead_ranks}
    if not dead:
        raise MeshShrinkError("no dead ranks to excise",
                              axes=old_axes, batch_axis=shrink_axis)
    total = int(mesh.devices.size)
    if total == size:  # one axis: a rank is its slot
        in_range = sorted(r for r in dead if 0 <= r < size)
        lost_slots = set(in_range)
    else:  # several axes: rank = flat device ordinal -> shrink-axis slot
        in_range = sorted(r for r in dead if 0 <= r < total)
        lost_slots = {
            int(np.unravel_index(r, mesh.devices.shape)[axis])
            for r in in_range}
    extra = len(dead) - len(in_range)
    slots = [i for i in range(size) if i not in lost_slots]
    if extra:  # ranks that map onto no slot still each cost one
        slots = slots[:max(0, len(slots) - extra)]
    non_batch = {n: s for n, s in old_axes.items() if n != shrink_axis}
    if not slots:
        raise MeshShrinkError(
            f"all {size} '{shrink_axis}' slots lost ranks; no survivors "
            "to rebuild a mesh from"
            + (f" (non-batch axes {non_batch} left untiled)"
               if non_batch else ""),
            axes=old_axes, dead_ranks=dead_ranks, batch_axis=shrink_axis)
    new_size = 1 << (len(slots).bit_length() - 1)
    if new_size >= size:
        raise MeshShrinkError(
            f"'{shrink_axis}' cannot shrink below its current size {size}"
            + (f"; survivors cannot re-tile the non-batch axes "
               f"{non_batch} at a smaller extent" if non_batch else ""),
            axes=old_axes, dead_ranks=dead_ranks, batch_axis=shrink_axis)
    devices = np.take(mesh.devices, slots[:new_size], axis=axis)
    return Mesh(devices, tuple(names))


def _queued_pod(what):
    raise NotImplementedError(
        f"{what}: host failure domains (pods) are not ported to the "
        "PyTorch port yet (ROADMAP Queue 1 item 12)")


class PodTopology:
    """Host failure domains of a pod: ROADMAP Queue 1 item 12."""

    def __init__(self, *args, **kwargs):
        _queued_pod("PodTopology")


def pod_mesh(*args, **kwargs):
    _queued_pod("pod_mesh")


def shrink_mesh_hosts(*args, **kwargs):
    _queued_pod("shrink_mesh_hosts")
