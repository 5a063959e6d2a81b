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

Every group gets the collective watchdog's timeout
(``resilience.watchdog.collective_timeout``): gloo's own default, 30
minutes, would turn a wedged peer into a hung job.

Host failure domains (``mxnet_tpu/parallel/mesh.py:143-392``): a pod
host is ``devices_per_host`` consecutive global ranks
(:class:`PodTopology`; ``LOCAL_WORLD_SIZE`` when a launcher sets it,
else ``MXNET_TPU_TORCH_POD_HOSTS`` virtual hosts), :func:`pod_mesh`
lays the ranks out host-major, and :func:`shrink_mesh_hosts` /
:func:`shrink_mesh` give the arithmetic of the smaller mesh after a loss
(``source_ranks``: the old global rank of each new slot). A live job
moves onto it with :func:`rejoin`: the old process groups are retired
(kept referenced, never joined: a dead peer's in-flight work must not
block), and the survivors, renumbered ``0..k-1``, make a new default
group and the mesh's groups at the next ``generation``, through a
``FileStore`` in the job directory. The rendezvous therefore lives on no
rank, and losing rank 0's host loses nothing of it.
"""
from __future__ import annotations

import datetime
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
           "shrink_mesh_hosts", "rejoin"]

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
        self.generation = 0     # bumped by each rejoin after a loss
        self.source_ranks = None  # a shrink's result: old rank per slot

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

        from ..resilience.watchdog import collective_timeout

        timeout = datetime.timedelta(seconds=collective_timeout())
        live = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
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
                    g = dist.new_group(ranks=ranks, timeout=timeout)
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
    no process group.

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
    return _taken(mesh, slots[:new_size], axis)


def _taken(mesh, slots, axis):
    """The arithmetic :class:`Mesh` of ``mesh``'s ``slots`` along
    ``axis``, with the old global rank of each slot in ``source_ranks``."""
    ordinals = np.arange(mesh.size).reshape(mesh.devices.shape)
    out = Mesh(np.take(mesh.devices, slots, axis=axis), mesh.axis_names)
    out.source_ranks = np.take(ordinals, slots, axis=axis)
    return out


class PodTopology:
    """The pod's host failure domains: which ranks belong to which host
    (``mxnet_tpu/parallel/mesh.py:143``).

    ``mxnet_tpu``'s host is one process of a multi-host job, or a group of
    virtual CPU devices in its one-process CI pod. The port runs a process
    a rank, so a host is ``devices_per_host`` consecutive global ranks:
    host h owns ranks ``[h*M, (h+1)*M)``, the host-major order
    :func:`pod_mesh` lays out. ``devices``: one device per rank (a rank's
    ``torch.device``; several ranks may share one card). Everything
    host-aware -- the host shrink, the pod commit, the watchdog's pod
    liveness -- reads this one mapping.
    """

    def __init__(self, num_hosts, devices_per_host, this_host=0,
                 devices=None, simulated=True):
        self.num_hosts = int(num_hosts)
        self.devices_per_host = int(devices_per_host)
        self.this_host = int(this_host)
        self.simulated = bool(simulated)
        self.devices = list(devices) if devices is not None else None
        if self.num_hosts <= 0 or self.devices_per_host <= 0:
            raise ValueError(
                f"pod needs positive host/device counts, got "
                f"{num_hosts} hosts x {devices_per_host} devices")
        if not 0 <= self.this_host < self.num_hosts:
            raise ValueError(
                f"this_host={this_host} out of range for "
                f"{num_hosts}-host pod")

    @classmethod
    def detect(cls, devices=None):
        """The running job's topology: with ``LOCAL_WORLD_SIZE`` set by a
        launcher (torchrun), hosts of that many ranks; otherwise
        ``MXNET_TPU_TORCH_POD_HOSTS`` virtual hosts (default 1) over the
        world's ranks."""
        world, rank = _world()
        if devices is None:
            devices = [as_device(None)] * world
        local = os.environ.get("LOCAL_WORLD_SIZE", "").strip()
        if local and world > 1:
            per = int(local)
            if per <= 0 or world % per:
                raise ValueError(f"uneven pod: {world} ranks do not split "
                                 f"into hosts of LOCAL_WORLD_SIZE={per}")
            return cls(world // per, per, this_host=rank // per,
                       devices=devices, simulated=False)
        hosts = int(os.environ.get("MXNET_TPU_TORCH_POD_HOSTS", "1"))
        return cls.simulated(hosts, devices)

    @classmethod
    def simulated(cls, num_hosts, devices=None):
        """The ranks split into ``num_hosts`` virtual hosts of equal size;
        this process's host is its rank's."""
        world, rank = _world()
        if devices is None:
            devices = [as_device(None)] * world
        devices = list(devices)
        num_hosts = int(num_hosts)
        if num_hosts <= 0 or len(devices) % num_hosts:
            raise ValueError(
                f"{len(devices)} devices do not split into {num_hosts} "
                "equal virtual hosts")
        per = len(devices) // num_hosts
        this = rank // per if len(devices) == world else 0
        return cls(num_hosts, per, this_host=this, devices=devices,
                   simulated=True)

    @property
    def total_devices(self):
        return self.num_hosts * self.devices_per_host

    def host_of(self, ordinal):
        """The host of global rank (host-major ordinal) ``ordinal``."""
        return int(ordinal) // self.devices_per_host

    def host_ordinals(self, host):
        """The global ranks host ``host`` owns."""
        host = int(host)
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} out of range for "
                             f"{self.num_hosts}-host pod")
        start = host * self.devices_per_host
        return tuple(range(start, start + self.devices_per_host))

    def hosts(self):
        return tuple(range(self.num_hosts))

    def shrunk(self, kept_hosts):
        """The topology after excising every host not in ``kept_hosts``
        (the survivors renumbered 0..k-1 in their order)."""
        kept = sorted(int(h) for h in kept_hosts)
        new_this = kept.index(self.this_host) if self.this_host in kept \
            else 0                   # an excised host's process leaves
        devices = None
        if self.devices is not None:
            devices = [self.devices[o] for h in kept
                       for o in self.host_ordinals(h)]
        return PodTopology(len(kept), self.devices_per_host,
                           this_host=new_this, devices=devices,
                           simulated=self.simulated)

    def describe(self):
        return {"num_hosts": self.num_hosts,
                "devices_per_host": self.devices_per_host,
                "this_host": self.this_host,
                "simulated": self.simulated}

    def __repr__(self):
        return (f"PodTopology(hosts={self.num_hosts}, "
                f"devices_per_host={self.devices_per_host}, "
                f"this_host={self.this_host}, "
                f"simulated={self.simulated})")


def pod_mesh(axes=None, topology=None):
    """``(mesh, topology)``: the pod's named mesh over every rank, host h's
    ranks at the flat (C-order) ordinals ``[h*M, (h+1)*M)``, so a whole
    host maps onto whole slots of some axis and :func:`shrink_mesh_hosts`
    can excise it (``mxnet_tpu/parallel/mesh.py:280``). ``axes`` defaults
    to data parallelism over every rank."""
    if topology is None:
        topology = PodTopology.detect()
    devices = topology.devices
    if devices is None:
        devices = [as_device(None)] * topology.total_devices
        topology.devices = list(devices)
    if axes is None:
        axes = {"dp": len(devices)}
    return create_mesh(axes, devices), topology


def _axis_slot_ordinals(shape, axis):
    """slot -> frozenset of the flat (C-order) ordinals in that slot of
    ``axis`` for a mesh of ``shape``."""
    ordinals = np.arange(int(np.prod(shape))).reshape(shape)
    moved = np.moveaxis(ordinals, axis, 0)
    return [frozenset(int(o) for o in moved[s].ravel())
            for s in range(shape[axis])]


def shrink_mesh_hosts(mesh, dead_hosts, topology, batch_axis="dp"):
    """Excise whole hosts from a host-major pod mesh
    (``mxnet_tpu/parallel/mesh.py:315``): the shrink axis is the first
    named axis (the batch axes first, then mesh order) whose slots the dead
    hosts' ranks exactly tile, trimmed to the largest power of two.

    Returns ``(new_mesh, new_topology, kept_hosts)``: ``new_mesh`` the
    arithmetic :class:`Mesh` (``source_ranks``: each slot's old rank; no
    process group, see :func:`rejoin`), ``kept_hosts`` the original
    indices of the hosts that survive whole, ``new_topology`` renumbering
    them 0..k-1. Raises :class:`MeshShrinkError` when the dead hosts do not
    align to whole slots of any axis, or no smaller mesh is viable."""
    names = list(mesh.axis_names)
    shape = tuple(int(s) for s in mesh.devices.shape)
    old_axes = dict(zip(names, shape))
    dead = sorted({int(h) for h in dead_hosts})
    if not dead:
        raise MeshShrinkError("no dead hosts to excise", axes=old_axes,
                              batch_axis=batch_axis)
    bad = [h for h in dead if not 0 <= h < topology.num_hosts]
    if bad:
        raise MeshShrinkError(
            f"dead host(s) {bad} out of range for "
            f"{topology.num_hosts}-host pod", axes=old_axes,
            dead_ranks=dead, batch_axis=batch_axis)
    dead_ordinals = frozenset(
        o for h in dead for o in topology.host_ordinals(h))
    batch_names = ((batch_axis,) if isinstance(batch_axis, str)
                   else tuple(batch_axis))
    order = [n for n in batch_names if n in names] + \
        [n for n in names if n not in batch_names]
    chosen = None
    for name in order:
        axis = names.index(name)
        slot_sets = _axis_slot_ordinals(shape, axis)
        lost = [s for s, members in enumerate(slot_sets)
                if members & dead_ordinals]
        covered = frozenset(o for s in lost for o in slot_sets[s])
        if covered == dead_ordinals and len(lost) < shape[axis]:
            chosen = (name, axis, lost)
            break
    if chosen is None:
        raise MeshShrinkError(
            f"dead host(s) {dead} (device ordinals "
            f"{sorted(dead_ordinals)}) do not align to whole slots of "
            f"any axis of mesh {old_axes}; the pod cannot excise them "
            "without re-tiling the survivors — restart the job on the "
            "remaining hosts instead", axes=old_axes, dead_ranks=dead,
            batch_axis=batch_names[0])
    name, axis, lost_slots = chosen
    slots = [s for s in range(shape[axis]) if s not in lost_slots]
    new_size = 1 << (len(slots).bit_length() - 1)
    if new_size >= shape[axis]:
        raise MeshShrinkError(
            f"'{name}' cannot shrink below its current size "
            f"{shape[axis]}", axes=old_axes, dead_ranks=dead,
            batch_axis=name)
    new_mesh = _taken(mesh, slots[:new_size], axis)
    # hosts kept = hosts all of whose ranks survive into the new mesh (the
    # power-of-two trim may drop more live hosts' slots)
    kept_ordinals = {int(o) for o in new_mesh.source_ranks.flat}
    kept_hosts = [h for h in topology.hosts()
                  if set(topology.host_ordinals(h)) <= kept_ordinals]
    if not kept_hosts:
        raise MeshShrinkError(
            f"no whole host survives the '{name}' shrink to {new_size} "
            "slot(s)", axes=old_axes, dead_ranks=dead, batch_axis=name)
    return new_mesh, topology.shrunk(kept_hosts), tuple(kept_hosts)


_RETIRED = []   # the process groups of earlier generations, never joined


def rejoin(shrunk, rank, generation, directory, backend=None):
    """Move this process, global rank ``rank`` of the current job, onto
    ``shrunk`` (a :func:`shrink_mesh` / :func:`shrink_mesh_hosts`
    result): the live :class:`Mesh` at ``generation``, or None when the
    shrink left this rank out.

    The current groups are retired: ``destroy_process_group`` unregisters
    them, and the objects stay referenced here, so no destructor waits on
    work a dead peer left in flight (gloo ends it at its timeout). The
    survivors, renumbered by their slots, make the new default group of
    ``backend`` (default: the current one) from the ``FileStore``
    ``<directory>/store.gen<generation>``, then the mesh's groups; every
    group gets the collective watchdog's timeout."""
    import torch.distributed as dist

    from ..resilience.watchdog import collective_timeout

    src = [int(r) for r in np.asarray(shrunk.source_ranks).flat]
    if int(rank) not in src:
        return None
    new_rank, size = src.index(int(rank)), len(src)
    if dist.is_available() and dist.is_initialized():
        backend = backend or dist.get_backend()
        try:
            _RETIRED.extend(dist.distributed_c10d._world.pg_map)
        except AttributeError:
            _RETIRED.append(dist.group.WORLD)
        dist.destroy_process_group()
    if size > 1:
        if not directory:
            raise MXNetError(
                "rejoin: the survivors of a job of several processes need "
                "a shared job directory for their new rendezvous "
                "(resilience.watchdog.join_job)")
        store = dist.FileStore(
            os.path.join(directory, f"store.gen{int(generation)}"), size)
        dist.init_process_group(
            backend or "gloo", store=store, rank=new_rank, world_size=size,
            timeout=datetime.timedelta(seconds=collective_timeout()))
    mesh = Mesh(shrunk.devices, shrunk.axis_names,
                new_rank if size > 1 else 0)
    mesh.generation = int(generation)
    if size > 1:
        mesh._build_groups()
    return mesh
