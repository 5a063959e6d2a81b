"""``ShardedTrainer`` (port of ``mxnet_tpu/parallel/trainer.py``).

``mxnet_tpu`` compiles forward, backward and the optimizer update into one
jitted program over a mesh (``mxnet_tpu/parallel/trainer.py:292-355``),
and GSPMD places its collectives. The port runs one process per rank
(:mod:`mesh`), and the same step is this rank's program plus the
collectives written out (:mod:`collectives`):

- the forward through :func:`functional_call` on the trainer's tensors,
  BatchNorm's moments all-reduced over the batch axes inside it;
- ``torch.autograd.grad`` for the gradients;
- the loss and the gradients of replicated parameters all-reduced as the
  mean over the batch axes, and over 'sp' when the mesh has it (each sp
  rank holds a slice of the sequence and every parameter): one packed
  buffer;
- parameters sharded by ``param_rules`` (fsdp) stored as this rank's
  shard, all-gathered before the forward and their gradients
  reduce-scattered after the backward, then all-reduced over the other
  reduction axes; their optimizer state is sharded with them;
- over a 'tp' axis (tensor parallelism, :mod:`tensor_parallel`), the
  transformer's qkv and FFN-up weights and biases split by rows and its
  attention-output and FFN-down weights by columns, as ``SpecLayout``'s
  rules ask: a rank holds its tp shard (the qkv rows of its own heads) and
  computes on it, column- and row-parallel, its gradient the shard's own;
  a second split of the same tensor over fsdp is storage, gathered and
  reduce-scattered as above. Any other parameter whose spec names 'tp'
  (the embedding, the head, an MLP's weight) is held as its shard and
  all-gathered before the forward; its gradient is equal on the tp ranks,
  so each keeps its own piece of it, reduced over the batch axes;
- the functional update of :func:`make_update_fn` in place, on whatever
  each rank holds, with ``lr``, ``wd`` and ``rescale_grad`` as scalars
  (from device slots in a captured step).

On one rank the step is captured as one CUDA graph per signature (batch
shapes and dtypes, ``microbatches``) through
:class:`mxnet_tpu_torch.capture.CapturedExec`; on a CPU mesh the same
program runs directly; ``MXNET_TPU_TORCH_CAPTURE=0`` runs it eagerly. A
multi-rank step on CUDA runs eagerly only: over gloo its collectives pass
through the host, which a graph cannot hold, and a captured step over
NCCL is not ported yet (ROADMAP Queue 1 item 6). With capture left on it
raises ``CaptureError`` rather than running eagerly without being asked.

The dtype policy is ``mxnet_tpu``'s (``_make_compute_loss``,
``trainer.py:234-290``):

- master parameters and optimizer state stay in the net's dtype (fp32);
- with ``dtype`` set, floating parameters are cast to it inside the step,
  so their gradients land in the master dtype; a floating input is cast
  to it too, and the output is cast to f32 before the loss;
- aux (BatchNorm's running statistics) stays uncast, and ``new_aux`` is
  cast back to each aux tensor's dtype;
- the loss is ``loss_fn(out, y).mean()`` over the rank's rows, averaged
  over the ranks of the batch axes (and 'sp'): the global batch's mean,
  since every rank holds as many rows. The tp ranks hold the same rows
  and the same loss.

The step returns the loss as a 0-d tensor on the device. The net's own
tensors stay as they were until :meth:`ShardedTrainer.sync_to_net`.

The resilience hooks (``mxnet_tpu/parallel/trainer.py:41-814``): a
``checkpoint_manager`` (``enable_recovery``) that the preemption exit
saves through, with the SIGTERM trap
(``integrity.install_preempt_handler``),
the step fingerprint (``integrity.step_fold``; over several ranks
``integrity.fold_sharded``) as one more output of the
captured step, the step under ``watchdog.guard("step")`` with the fault
hooks, the shadow replay audit, the elastic OOM retry (bitwise an explicit
``microbatches=N`` step), the pad mask ``length=``, the numerics tap
(:meth:`ShardedTrainer.attach_numerics`) and optimizer-state
``get_states_bytes`` / ``save_states`` / ``load_states``.

Over several ranks (``mxnet_tpu/parallel/trainer.py:470-985``): the
step fingerprint and the audit are the gathered state's
(``integrity.fold_sharded``: each rank sums the leaves it counts, one
all-reduce, the chain), the same on every rank; a lost peer or host
(``watchdog.PeerLostError``, from the liveness checks at each attempt's
top or from a collective) with a checkpoint manager attached shrinks the
mesh to the survivors, rebuilds their process groups at the next
generation, reloads the latest checkpoint and runs the batch again
(:meth:`ShardedTrainer._recover_peer_loss`); :meth:`for_pod` /
:meth:`bind_pod` make whole hosts the failure domains, and the manager's
pod commit writes each host's own shards.

Not ported, and raising where asked for: mesh axes of more than one rank
other than the batch axes, 'sp' and 'tp' ('pp', 'ep'), 'tp' together
with 'sp', and a spec splitting two dimensions of a parameter outside a
tensor-parallel layer (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import logging
import math
import os
import re
import sys
import time
import warnings

import numpy as np
import torch

from .. import autograd, capture
from ..observability import trace as _obs_trace
from ..base import torch_dtype
from ..remat import checkpointed, mirror_enabled
from . import collectives
from .functional import functional_call, param_arrays, aux_arrays
from .layout import PartitionSpec
from .mesh import _torch_device, create_mesh
from .optim import make_update_fn
from . import tensor_parallel

__all__ = ["ShardedTrainer", "make_update_fn"]


def _box(shape):
    """The index of a whole array: [[0, d] for each dimension]."""
    return [(0, int(d)) for d in shape]


def _dtype_str(t):
    """A tensor's manifest dtype: ``"bfloat16"``, else numpy's string."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty(0, dtype=t.dtype).numpy().dtype.str


def _collective_timedelta():
    import datetime

    from ..resilience.watchdog import collective_timeout

    return datetime.timedelta(seconds=collective_timeout())


def _queued(what, item):
    return NotImplementedError(
        f"ShardedTrainer: {what} is not ported to the PyTorch port yet "
        f"(ROADMAP Queue 1 item {item})")


class _Shard:
    """Where a parameter sharded by a rule lives: split along ``dim`` into
    ``parts`` chunks of ``chunk`` rows over the mesh ``axes`` (the last
    chunk zero-padded), of ``full`` rows in all."""

    def __init__(self, dim, axes, parts, chunk, full):
        self.dim, self.axes = dim, axes
        self.parts, self.chunk, self.full = parts, chunk, full

    def padded(self, t):
        """``t`` (full size along dim) zero-padded to parts * chunk."""
        pad = self.parts * self.chunk - self.full
        if not pad:
            return t
        shape = list(t.shape)
        shape[self.dim] = pad
        return torch.cat([t, t.new_zeros(shape)], dim=self.dim)

    def piece(self, t, i):
        return self.padded(t).narrow(self.dim, i * self.chunk, self.chunk)


class ShardedTrainer:
    """One training step of ``net`` over a mesh.

    Parameters
    ----------
    net : initialized gluon Block (the same weights on every rank, or rank
        0's are broadcast)
    loss_fn : gluon Loss, or callable(pred, label) -> per-sample losses
    optimizer, optimizer_params : a name of :func:`make_update_fn`'s
        registry and its hyper-parameters (``learning_rate``, ``wd``, ...);
        ``wd`` applies to every parameter
    mesh : a :class:`Mesh` (default ``create_mesh()``: the world's ranks
        over 'dp', each on the current context, ``gpu(0)``)
    param_rules : (regex, PartitionSpec) pairs, first match wins,
        unmatched parameters replicate; a spec may name the batch axes
        (fsdp) and 'tp' (e.g. ``SpecLayout.for_mesh(mesh).param_rules()``),
        and shard one dimension, or two where a tensor-parallel layer
        computes on the 'tp' one
    batch_axis_name : the mesh axis (or tuple of axes, e.g.
        ``SpecLayout.batch_axes()``) the batch is split over; an axis the
        mesh lacks holds one rank
    dtype : compute dtype (None: the net's own; ``"bfloat16"`` or
        ``"float16"``: fp32 masters, 16-bit forward and backward)
    remat : False: off; None: ``MXNET_BACKWARD_DO_MIRROR``; True, a policy
        name or a callable: the forward runs under activation
        checkpointing (:mod:`mxnet_tpu_torch.remat`)
    checkpoint_manager : a ``resilience.CheckpointManager``: the
        preemption exit saves through it, and with one the trainer traps
        SIGTERM (``mxnet_tpu`` traps it for every trainer; the port only
        where a checkpoint can be written), and a lost peer is survived
        by a mesh shrink that reloads from it; ``enable_recovery``
        attaches it later
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=(), batch_axis_name="dp",
                 dtype=None, remat=None, checkpoint_manager=None):
        from ..resilience import integrity as _integrity

        mesh = mesh if mesh is not None else create_mesh()
        self._batch_axis = (batch_axis_name if isinstance(batch_axis_name,
                                                          str)
                            else tuple(batch_axis_name))
        self.device = mesh.device
        self.net = net
        self.loss_fn = loss_fn
        self._compute_dtype = None if dtype is None else torch_dtype(dtype)
        self._rules = [(re.compile(pat), spec) for pat, spec in param_rules]
        self._remat = mirror_enabled() if remat is None else remat
        params = {k: v.detach().to(self.device, copy=True)
                  for k, v in param_arrays(net).items()}
        self.aux = {k: v.detach().to(self.device, copy=True)
                    for k, v in aux_arrays(net).items()}
        self._hooks_now = False
        self._optimizer = optimizer
        self._optimizer_params = dict(optimizer_params or {})
        self._opt_init, self._update = make_update_fn(
            optimizer, dict(self._optimizer_params))
        self._pod = None
        self._set_mesh(mesh, params, broadcast=True)
        # this process's rank when the job began: a device fault's victim
        # keeps its name through the renumbering of a shrink
        self._origin_rank = mesh.rank
        self._slots = capture.SlotTable(self.device)
        self._step_vals = None
        self._exec = self._new_exec()
        self._ckpt_mgr = checkpoint_manager
        self._elastic_n = 1        # sticky accumulation count
        self._step_count = 0
        self._last_fp_out = None
        self._numerics = None
        self._tap_slots = capture.SlotTable(self.device)
        self.last_recovery = None
        if checkpoint_manager is not None:
            _integrity.install_preempt_handler()

    def _new_exec(self):
        return capture.CapturedExec(
            self._captured_program, label="sharded_step",
            device=self.device, state=self._state_tensors,
            eager=self._eager_program, warmup_guard=self._warmup_guard,
            fingerprint=lambda sig: capture.fingerprint(
                {"step": self._capture_fingerprint(), "sig": repr(sig)}))

    def _set_mesh(self, mesh, params, broadcast):
        """Lay the trainer out over ``mesh``: its axes, the tensor-parallel
        plan, the forward, and ``params`` ({name: full tensor}) as this
        rank holds them, the optimizer state fresh (``broadcast``: rank
        0's values first, as at construction). A mesh of several ranks
        declares the job's liveness (``watchdog.join_job``)."""
        self.mesh = mesh
        self._batch_axes = tuple(a for a in self._batch_axis_names()
                                 if a in mesh.axis_names)
        self._reduce_axes = self._batch_axes + tuple(
            a for a in ("sp",) if a in mesh.axis_names
            and a not in self._batch_axes)
        self._multi = mesh.size > 1
        # 'tp' of more than one rank, outside the batch axes: tensor
        # parallelism
        self._tp_axis = "tp" if "tp" not in self._reduce_axes and \
            mesh.shape.get("tp", 1) > 1 else None
        if self._multi:
            for a in mesh.axis_names:
                if mesh.shape[a] > 1 and a not in self._reduce_axes \
                        and a != self._tp_axis:
                    raise _queued(
                        f"mesh axis {a!r} of size {mesh.shape[a]} outside "
                        "the batch axes, 'sp' and 'tp' (pipeline or expert "
                        "parallelism)", 6)
            if self._tp_axis and mesh.shape.get("sp", 1) > 1:
                raise _queued(
                    f"'tp' of size {mesh.shape['tp']} together with 'sp' of "
                    f"size {mesh.shape['sp']} (tensor and sequence "
                    "parallelism at once)", 6)
            if not mesh._groups:
                raise ValueError(
                    f"ShardedTrainer: {mesh} holds no process groups; "
                    "build a mesh of several ranks with create_mesh under "
                    "torch.distributed (ShardedTrainer.for_multihost)")
            from ..resilience import watchdog as _watchdog

            if mesh.generation == 0:
                _watchdog.join_job(mesh.size, mesh.rank)
        # {name: (dim, qkv)}: the tp shards the tensor-parallel layers
        # compute on, and the context that names those layers
        self._tp_split, tp = self._tp_plan(params)
        self._fwd = functional_call(self.net, train=True, mesh=mesh,
                                    batch_axes=self._batch_axes, tp=tp)
        if self._remat:
            self._fwd = checkpointed(self._fwd, self._remat)
        if self._multi and broadcast:
            # every rank starts from rank 0's values (mxnet_tpu's _place
            # broadcasts them): nets initialized from different streams
            # would otherwise train different replicas
            self._broadcast(list(params.values()) + list(self.aux.values()))
        local = {k: self._tp_piece(k, v) for k, v in params.items()}
        self._shards = {k: s for k, s in (
            (k, self._shard_of(k, v)) for k, v in local.items()) if s}
        self.params = {k: (self._shards[k].piece(
            v, mesh.axis_index(self._shards[k].axes)).clone()
            if k in self._shards else v) for k, v in local.items()}
        self.opt_state = self._opt_init(self.params)

    @classmethod
    def for_multihost(cls, net, loss_fn, optimizer="sgd",
                      optimizer_params=None, axes=None, coordinator=None,
                      num_processes=None, process_id=None, backend=None,
                      devices=None, **kwargs):
        """A trainer over a mesh of every process of a multi-process job
        (``mxnet_tpu/parallel/trainer.py:444``): ``torch.distributed`` is
        initialized from the arguments unless it already is, and the mesh
        built over its ranks.

        ``coordinator``: the rendezvous, ``"host:port"`` (TCP), a URL
        (``tcp://``, ``file://``) or None for ``env://``
        (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
        ``num_processes`` and ``process_id``: the world size and this
        process's rank. ``backend``: ``"nccl"`` or ``"gloo"``, chosen by
        the caller; by default NCCL where this rank's device is a CUDA
        device, else gloo (one card cannot hold several NCCL ranks: pass
        ``"gloo"``). ``axes``: the mesh axes (default ``{"dp": world}``).
        ``devices``: one per rank (default: the current context for each).

        In :meth:`step`, each process passes its own rows of the global
        batch (and, on an 'sp' axis, its slice of the sequence).
        """
        import torch.distributed as dist

        if not dist.is_initialized():
            cls._init_dist(coordinator, num_processes, process_id, backend,
                           devices)
        elif backend is not None and dist.get_backend() != backend:
            raise ValueError(
                f"for_multihost(backend={backend!r}): torch.distributed is "
                f"already initialized with {dist.get_backend()!r}")
        from ..context import as_device

        world = dist.get_world_size()
        if devices is None:
            devices = [as_device(None)] * world
        mesh = create_mesh(dict(axes or {"dp": world}), devices)
        return cls(net, loss_fn, optimizer, optimizer_params, mesh=mesh,
                   **kwargs)

    @staticmethod
    def _init_dist(coordinator, num_processes, process_id, backend,
                   devices):
        """``torch.distributed`` from :meth:`for_multihost`'s arguments,
        its groups under the collective watchdog's timeout."""
        import torch.distributed as dist

        from ..context import as_device

        if backend is None:
            here = as_device(None) if devices is None else \
                _torch_device(devices[int(process_id or 0)])
            backend = "nccl" if here.type == "cuda" else "gloo"
        if coordinator is None:
            init = "env://"
        elif "://" in coordinator:
            init = coordinator
        else:
            init = f"tcp://{coordinator}"
        kw = {}
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
        dist.init_process_group(backend, init_method=init,
                                timeout=_collective_timedelta(), **kw)

    @classmethod
    def for_pod(cls, net, loss_fn, optimizer="sgd", optimizer_params=None,
                axes=None, coordinator=None, num_processes=None,
                process_id=None, topology=None, backend=None, devices=None,
                **kwargs):
        """A trainer over a pod with host failure domains
        (``mxnet_tpu/parallel/trainer.py:470``): ``torch.distributed`` is
        initialized as :meth:`for_multihost` does, the mesh is laid out
        host-major (``parallel.mesh.pod_mesh``; ``topology`` or
        ``PodTopology.detect()``: hosts of ``LOCAL_WORLD_SIZE`` ranks, or
        ``MXNET_TPU_TORCH_POD_HOSTS`` virtual hosts), and the pod is bound
        (:meth:`bind_pod`): a lost host is excised whole in one shrink."""
        import torch.distributed as dist

        from .mesh import PodTopology, pod_mesh

        if not dist.is_initialized():
            cls._init_dist(coordinator, num_processes, process_id, backend,
                           devices)
        if topology is None:
            topology = PodTopology.detect(
                None if devices is None else [_torch_device(d)
                                              for d in devices])
        mesh, topo = pod_mesh(dict(axes) if axes else None, topology)
        trainer = cls(net, loss_fn, optimizer, optimizer_params, mesh=mesh,
                      **kwargs)
        return trainer.bind_pod(topo)

    def bind_pod(self, topology):
        """Attach a ``parallel.PodTopology``: a lost host is recovered by
        excising its whole rank slice, and the watchdog's pod liveness
        knows this process's host (``watchdog.configure_pod``). Returns
        self."""
        from ..resilience import watchdog as _watchdog

        self._pod = topology
        if topology is not None:
            _watchdog.configure_pod(
                topology.num_hosts, topology.host_of(self.mesh.rank),
                generation=self.mesh.generation,
                devices_per_host=topology.devices_per_host)
        return self

    @property
    def pod(self):
        """The bound PodTopology, or None."""
        return self._pod

    def enable_recovery(self, checkpoint_manager):
        """Attach the ``CheckpointManager`` that the preemption exit saves
        through (``mxnet_tpu/parallel/trainer.py:148``), and trap SIGTERM
        (``integrity.install_preempt_handler``). Returns self."""
        from ..resilience import integrity as _integrity

        self._ckpt_mgr = checkpoint_manager
        if checkpoint_manager is not None:
            _integrity.install_preempt_handler()
        return self

    def attach_numerics(self, tap):
        """Attach an ``observability.numerics.NumericsTap`` (None
        detaches): on the tap's cadence the step runs its tapped program,
        which also returns the stats matrix. Returns self."""
        if tap is not None:
            tap.bind(self.net, self)
        self._numerics = tap
        return self

    # --------------------------------------------------------- sharding
    def _batch_axis_names(self):
        ba = self._batch_axis
        return (ba,) if isinstance(ba, str) else tuple(ba)

    def _spec_for(self, name):
        for pat, spec in self._rules:
            if pat.match(name):
                return spec
        return PartitionSpec()

    def _spec_dims(self, name):
        """[(dim, axes)] of ``name``'s spec over axes of more than one
        rank; raises where it names an axis that is neither a batch axis
        nor 'tp'."""
        spec = self._spec_for(name)
        dims = [(d, (e,) if isinstance(e, str) else tuple(e))
                for d, e in enumerate(spec or ()) if e is not None]
        for _, axes in dims:
            for a in axes:
                if a not in self._batch_axes and not (
                        a == "tp" and a in self.mesh.axis_names):
                    raise ValueError(
                        f"param_rules: {name}'s spec {spec} names {a!r}, "
                        f"neither a batch axis of mesh {self.mesh.shape} "
                        f"(batch axes {self._batch_axes}) nor its 'tp'")
        return [(d, self.mesh._axes(axes)) for d, axes in dims
                if self.mesh.axis_size(axes) > 1]

    def _tp_plan(self, params):
        """({name: (dim, qkv)}, context): the parameters that the
        tensor-parallel layers compute on as tp shards (split along
        ``dim``; ``qkv``: head-aligned rows), and the
        :class:`tensor_parallel.TPContext` naming those layers (None
        without any).

        A block's (column, row) Dense pair (``_tp_layers``: the
        attention's qkv and output projections, the FFN's two layers) runs
        over tp where the column weight's spec splits dim 0 over 'tp'
        alone and the row weight's dim 1, as ``SpecLayout`` has them; the
        column bias must then split over 'tp' too, and the row bias must
        not."""
        tp = self._tp_axis
        if tp is None:
            return {}, None
        split, layers, widths = {}, [], []

        def tp_dim(name):
            hit = [(d, axes) for d, axes in self._spec_dims(name)
                   if tp in axes]
            return hit[0][0] if len(hit) == 1 and hit[0][1] == (tp,) \
                else None

        for blk in self.net.modules():
            pairs = getattr(blk, "_tp_layers", None)
            for col, row, qkv, (what, width) in (pairs() if pairs else ()):
                cw, rw = (m._reg_params["weight"].name for m in (col, row))
                if cw not in params or rw not in params or \
                        tp_dim(cw) != 0 or tp_dim(rw) != 1:
                    continue
                widths.append((width, what))
                split[cw], split[rw] = (0, qkv), (1, False)
                for m, want in ((col, 0), (row, None)):
                    p = m._reg_params.get("bias")
                    if p is None or p.name not in params:
                        continue
                    if tp_dim(p.name) != want:
                        raise ValueError(
                            f"param_rules: {p.name}'s spec "
                            f"{self._spec_for(p.name)} must "
                            + ("split dim 0 over 'tp' alone, as its "
                               f"weight {cw}'s rows are" if want == 0 else
                               f"not name 'tp': {rw}'s product is summed "
                               "over tp before its bias is added"))
                    if want == 0:
                        split[p.name] = (0, qkv)
                layers.append(id(col))
        if not layers:
            return {}, None
        ctx = tensor_parallel.TPContext(self.mesh, tp, layers)
        for width, what in widths:
            ctx.local(width, what)
        return split, ctx

    def _tp_piece(self, name, value):
        """This rank's tp shard of ``name`` (its full ``value``) where a
        tensor-parallel layer computes on one, else ``value``."""
        if name not in self._tp_split:
            return value
        dim, qkv = self._tp_split[name]
        n, i = self.mesh.axis_size(self._tp_axis), \
            self.mesh.axis_index(self._tp_axis)
        if qkv:
            return tensor_parallel.shard_qkv(value, i, n).clone()
        return value.chunk(n, dim)[i].clone()

    def _shard_of(self, name, value):
        """The :class:`_Shard` of ``name`` under ``param_rules``, or None
        where it is held whole. ``value`` is what the forward takes: a
        tp shard's split over tp is not a _Shard's, only its split over
        other axes."""
        spec = self._spec_for(name)
        dims = self._spec_dims(name)
        if name in self._tp_split:
            dims = [(d, axes) for d, axes in dims
                    if d != self._tp_split[name][0]]
        if not dims:
            return None
        if len(dims) > 1:
            raise _queued("param_rules sharding more than one dimension "
                          "of a parameter outside a tensor-parallel layer",
                          6)
        (dim, axes), = dims
        if dim >= value.dim():
            raise ValueError(f"param_rules: {name}'s spec {spec} has more "
                             f"entries than its shape {tuple(value.shape)}")
        parts = self.mesh.axis_size(axes)
        full = int(value.shape[dim])
        return _Shard(dim, axes, parts, -(-full // parts), full)

    def _broadcast(self, tensors):
        """``tensors`` from rank 0, packed as one buffer per dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in group])
                collectives.broadcast(flat, self.mesh, src=0)
                at = 0
                for t in group:
                    t.copy_(flat[at:at + t.numel()].view_as(t))
                    at += t.numel()

    def _gathered(self, shards):
        """{name: full tensor} of ``shards`` ({name: this rank's shard} of
        sharded parameters, or of their gradients), one all-gather per
        tuple of axes (the shards packed)."""
        out, by_axes = {}, {}
        for k in shards:
            by_axes.setdefault(self._shards[k].axes, []).append(k)
        for axes, ks in by_axes.items():
            flat = torch.cat([shards[k].reshape(-1) for k in ks])
            got = collectives.all_gather(flat[None], self.mesh, axes)
            at = 0
            for k in ks:
                sh, local = self._shards[k], shards[k]
                n = local.numel()
                pieces = got[:, at:at + n].reshape(
                    (sh.parts,) + tuple(local.shape))
                out[k] = torch.cat(list(pieces.unbind(0)),
                                   dim=sh.dim).narrow(sh.dim, 0, sh.full)
                at += n
        return out

    def _local(self, tensors):
        """``tensors`` ({name: tensor} as the trainer holds them) as the
        forward takes them: the _Shards all-gathered, the tp shards as
        they are."""
        out = dict(tensors)
        out.update(self._gathered({k: tensors[k] for k in self._shards
                                   if k in tensors}))
        return out

    def _full(self, tensors):
        """``tensors`` ({name: tensor} as the trainer holds them) at their
        full shapes: the _Shards all-gathered, then the tp shards
        all-gathered over tp (the qkv rows back in the net's order)."""
        full = self._local(tensors)
        for k, (dim, qkv) in self._tp_split.items():
            if k not in full:
                continue
            got = collectives.all_gather(full[k], self.mesh, self._tp_axis,
                                         dim)
            full[k] = tensor_parallel.gather_qkv(got.chunk(
                self.mesh.axis_size(self._tp_axis))) if qkv else got
        return full

    def _pieces_by_row(self, axes):
        """([[piece index]], batch axes): the pieces of a _Shard over
        ``axes`` (indexed row-major over them), one row per index along
        its batch axes (the reduce-scatter's chunks, in their order), each
        row holding the pieces of every tp index in order. Without 'tp' in
        ``axes`` a row holds one piece."""
        live = self.mesh._axes(axes)
        idx = np.arange(self.mesh.axis_size(live)).reshape(
            [self.mesh.shape[a] for a in live])
        if self._tp_axis in live:
            idx = np.moveaxis(idx, live.index(self._tp_axis), -1)
        bat = tuple(a for a in live if a != self._tp_axis)
        return idx.reshape(self.mesh.axis_size(bat), -1).tolist(), bat

    def _reduced(self, loss, grads):
        """(global loss, {name: mean gradient}) from this rank's loss and
        gradients of what the forward took: the mean over the reduction
        axes' ranks, each sharded parameter's as its shard. A tp shard's
        gradient is the shard's own (the tp ranks hold other heads); a
        parameter gathered over tp has the same gradient on every tp
        rank, whose piece each keeps."""
        mesh, n = self.mesh, self.mesh.axis_size(self._reduce_axes)
        repl = [k for k in grads if k not in self._shards]
        flat = torch.cat([grads[k].float().reshape(-1) for k in repl]
                         + [loss.float().reshape(1)])
        collectives.all_reduce(flat, mesh, self._reduce_axes)
        flat.div_(n)
        out, at = {}, 0
        for k in repl:
            m = grads[k].numel()
            out[k] = flat[at:at + m].view_as(grads[k]).to(grads[k].dtype)
            at += m
        loss = flat[at]
        by_axes = {}
        for k in self._shards:
            by_axes.setdefault(self._shards[k].axes, []).append(k)
        for axes, ks in by_axes.items():
            shards = [self._shards[k] for k in ks]
            pieces, bat = self._pieces_by_row(axes)
            rows = torch.stack([torch.cat(
                [sh.piece(grads[k].float(), i).reshape(-1)
                 for i in row for k, sh in zip(ks, shards)])
                for row in pieces])
            mine = collectives.reduce_scatter(rows, mesh, bat)[0]
            if len(pieces[0]) > 1:      # this rank's tp index's piece
                mine = mine.view(len(pieces[0]), -1)[
                    mesh.axis_index(self._tp_axis)]
            rest = tuple(a for a in self._reduce_axes if a not in bat)
            collectives.all_reduce(mine, mesh, rest)
            mine.div_(n)
            at = 0
            for k in ks:
                m = self.params[k].numel()
                out[k] = mine[at:at + m].view_as(self.params[k]).to(
                    self.params[k].dtype)
                at += m
        return loss, out

    # ----------------------------------------------------------- capture
    def _capture_fingerprint(self, x=None, y=None, microbatches=None):
        """The step program's structural key (``mxnet_tpu/parallel/
        trainer.py:292``); with a batch, its shapes, dtypes and
        ``microbatches`` too, which the captured entries are keyed by."""
        parts = {"net": capture.net_sig(self.net),
                 "loss": capture.code_sig(self.loss_fn),
                 "optimizer": self._optimizer,
                 "dtype": str(self._compute_dtype),
                 "mesh": self.mesh.shape,
                 "rules": [(p.pattern, repr(s)) for p, s in self._rules],
                 "params": [(k, tuple(v.shape), str(v.dtype))
                            for k, v in self.params.items()]}
        if x is not None:
            parts["batch"] = [(tuple(a.shape), str(a.dtype)) for a in (x, y)]
            parts["microbatches"] = microbatches
        return capture.fingerprint(parts)

    def _state_tensors(self):
        """Masters, aux and optimizer states: the tensors the captured
        program updates in place, whose addresses key its entries."""
        out = list(self.params.values()) + list(self.aux.values())
        for v in self.opt_state["state"].values():
            out += [v] if isinstance(v, torch.Tensor) else list(v)
        return out

    def _warmup_guard(self):
        return capture._restored(self._state_tensors())

    def _captured_program(self, *args):
        return self._program(*args, scal=None if self._step_vals is None
                             else self._slots.views)

    def _eager_program(self, *args):
        return self._program(*args, scal=self._step_vals)

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for k, v in new_aux.items():
                self.aux[k].copy_(v)

    def _loss_and_mean_grads(self, x, y, n, w=None):
        """(loss, {name: grad}): the mean of the ``n`` microbatch losses
        and gradients of this rank's rows, running statistics written back;
        over several ranks, the global loss and mean gradients (shards for
        sharded parameters). ``w``: the pad mask's per-token weight (one
        microbatch only)."""
        full = self._local(self.params) if self._multi else self.params
        if n == 1:
            loss, grads, new_aux = self._loss_and_grads(x, y, full, w)
            self._write_aux(new_aux)
        else:
            if self._multi and self._batch_axes:
                x, y = self._global_slices(x, y, n)
            mb = int(x.shape[0]) // n
            loss, grads = None, None
            for i in range(n):
                sl = slice(i * mb, (i + 1) * mb)
                loss_i, g_i, new_aux = self._loss_and_grads(x[sl], y[sl],
                                                            full)
                self._write_aux(new_aux)
                if grads is None:
                    loss, grads = loss_i, g_i
                else:
                    loss = loss + loss_i
                    for k, g in g_i.items():
                        grads[k].add_(g)
            inv = 1.0 / n
            for g in grads.values():
                g.mul_(inv)
            loss = loss / n
        if self._multi:
            loss, grads = self._reduced(loss, grads)
        return loss, grads

    def _global_slices(self, x, y, n):
        """``x`` and ``y`` as this rank's rows of each of ``n`` microbatches
        in turn, microbatch i being slice i of the global batch (placed over
        the batch axes, as ``mxnet_tpu/parallel/trainer.py:1029-1077``
        slices it), so that a BatchNorm takes its moments over that slice:
        the batch is all-gathered over the batch axes, in rank order, and
        each slice's rows dealt out by this rank's index along them."""
        axes, mesh = self._batch_axes, self.mesh
        shards = mesh.axis_size(axes)
        if shards == 1:
            return x, y
        me = mesh.axis_index(axes)
        part = int(x.shape[0]) // n       # this rank's rows of a slice
        rows = part * shards              # a slice's rows
        out = []
        for t in (x, y):
            g = collectives.all_gather(t, mesh, axes)
            out.append(torch.cat([g[i * rows + me * part:
                                    i * rows + (me + 1) * part]
                                  for i in range(n)]))
        return out

    def _program(self, x, y, *rest, scal):
        """The whole step on the batch: loss, gradients, aux written back,
        the update in place with the scalars ``scal`` (None: the update
        computes them itself). ``rest`` is ``[length,] n, fp, tap``: the
        pad mask's lengths, the microbatches, and whether the step
        fingerprint and the numerics stats are outputs too. Returns the
        loss, or [loss, fingerprint, stats] with those asked for."""
        if len(rest) == 4:
            length, n, fp, tap = rest
            w = self._pad_weight(x, length)
        else:
            (n, fp, tap), w = rest, None
        loss, grads = self._loss_and_mean_grads(x, y, n, w)
        if self._hooks_now:
            from ..resilience import faults as _faults

            _faults.maybe_sdc_bitflip_grad(grads)
        pre = {k: v.detach().clone() for k, v in self.params.items()} \
            if tap else None
        if scal is not None:
            self.opt_state["scalars"] = scal
        try:
            self._update(self.params, grads, self.opt_state)
        finally:
            self.opt_state.pop("scalars", None)
        if not (fp or tap):
            return loss
        out = [loss]
        if fp:
            out.append(self._step_fingerprint(grads))
        if tap:
            mask = torch.stack(self._tap_slots.views)
            out.append(self._numerics.graph_stats(
                sorted(grads.items()), sorted(pre.items()),
                sorted(self.params.items()), [], mask))
        return out

    @staticmethod
    def _pad_weight(x, length):
        """The pad mask as a per-token weight (B, T, 1) normalized to sum
        to B*T, so the loss's mean is sum(loss * mask) / sum(mask)
        (``mxnet_tpu/parallel/trainer.py:369-397``)."""
        t = int(x.shape[1])
        mask = (torch.arange(t, device=x.device)[None, :]
                < length.to(torch.int64)[:, None]).to(torch.float32)
        return (mask * (float(mask.numel()) / mask.sum()))[..., None]

    # ------------------------------------------------------------ the step
    def _loss_and_grads(self, x, y, params=None, w=None):
        """(loss 0-d f32, {name: grad} in the master dtypes, new_aux) of
        this rank's rows at ``params`` (full tensors; by default the
        trainer's own, which on one rank are full)."""
        params = self.params if params is None else params
        cdtype = self._compute_dtype
        names = list(params)
        leaves = [params[k].detach().requires_grad_(
            params[k].is_floating_point()) for k in names]
        with autograd.record():
            cp = dict(zip(names, leaves))
            if cdtype is not None:
                cp = {k: v.to(cdtype) if v.is_floating_point() else v
                      for k, v in cp.items()}
                if x.is_floating_point():
                    x = x.to(cdtype)
            out, new_aux = self._fwd(cp, self.aux, x)
            if cdtype is not None:
                out = out.float()
                new_aux = {k: v.to(self.aux[k].dtype)
                           if self.aux[k].is_floating_point() else v
                           for k, v in new_aux.items()}
            loss = (self.loss_fn(out, y) if w is None
                    else self.loss_fn(out, y, w)).mean()
        diff = [leaf for leaf in leaves if leaf.requires_grad]
        got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
        grads = {}
        for k, leaf in zip(names, leaves):
            g = next(got) if leaf.requires_grad else None
            grads[k] = torch.zeros_like(leaf) if g is None else g
        return loss.detach(), grads, new_aux

    def _place(self, a):
        """A batch operand as a tensor on the trainer's device; one that is
        there already is used as it is (no copy)."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a)
        return a if a.device == self.device else a.to(self.device)

    def _microbatches(self, x, microbatches):
        rows = int(x.shape[0])
        if microbatches is None:
            return 1
        n = int(microbatches)
        if n < 1 or rows % n:
            raise ValueError(
                f"microbatches={n} does not divide the {rows}-row batch "
                "into whole microbatches; accumulation must never "
                "silently drop tail rows")
        return n

    def step(self, x, y, microbatches=None, length=None):
        """One training step on the batch ``(x, y)`` (numpy arrays or
        tensors); returns the loss as a 0-d tensor on the device.

        Over several ranks, ``x`` and ``y`` are this process's rows of the
        global batch, in batch order, as ``mxnet_tpu`` takes them from each
        process of a multi-process mesh (``_host_local_batch``): every rank
        along the batch axes holds as many rows, and on an 'sp' axis each
        rank holds its slice of the sequence. The returned loss is the
        global batch's.

        ``microbatches=n`` takes the gradients of n equal slices of the
        rows at the same parameters, sums them, scales the sum by 1/n and
        applies it in one update; the running statistics chain through the
        slices, and the loss is the mean of the slice losses
        (``mxnet_tpu/parallel/trainer.py:1029-1077``); over several ranks
        slice i is slice i of the global batch, spread over the ranks (the
        batch is all-gathered over the batch axes first), so BatchNorm's
        moments are the slice's, as there. An ``n`` that does not split the
        rows raises.

        Left at None, the step runs whole, and an out-of-memory step
        (``torch.OutOfMemoryError``, in the step or in its capture, or
        the ``oom_step`` fault) runs again as 2, 4, ... accumulated
        microbatches until it fits (``resilience.elastic``), the failed
        attempt's graph freed first; the shrink is sticky. ``length``
        ((B,) valid token counts) masks pad tokens out of the loss:
        sum(loss * mask) / sum(mask), one microbatch only.

        The step runs under ``watchdog.guard("step")``
        (``MXNET_TPU_TORCH_WATCHDOG_STEP_TIMEOUT``) with the ``hang_step``,
        ``oom_step`` and SDC fault hooks; with the fingerprint armed
        (``resilience.integrity``) it also returns the step fingerprint
        (:attr:`last_fingerprint`), and on the audit cadence the step is
        run again from its pre-step state and compared. A preemption
        notice (SIGTERM, the ``preempt`` fault) finishes the step, saves
        through the checkpoint manager and raises ``Preempted``.
        """
        with _obs_trace.span("train.sharded_step",
                             step=self._step_count + 1):
            return self._step_impl(x, y, microbatches, length)

    def _step_impl(self, x, y, microbatches, length):
        from ..resilience import elastic as _elastic
        from ..resilience import faults as _faults
        from ..resilience import integrity as _integrity
        from ..resilience import watchdog as _watchdog

        if length is not None and microbatches not in (None, 1):
            raise ValueError(
                "length= (pad masking) runs one microbatch only; "
                "accumulated microbatches would re-normalize the mask per "
                "slice — request microbatches=None")
        x, y = self._place(x), self._place(y)
        if length is not None:
            length = self._place(length).to(torch.int32)
        rows = int(x.shape[0])
        if microbatches is not None:
            n = self._microbatches(x, microbatches)
        else:
            n = self._elastic_n
            while n > 1 and rows % n:   # a short tail batch: fall back
                n //= 2
        if length is not None:
            n = 1
        t = self.opt_state["t"] + 1
        scalars = getattr(self._update, "scalars", None)
        captured = self.device.type == "cuda" and capture.enabled()
        if captured:
            if self._multi:
                raise capture.CaptureError(
                    f"ShardedTrainer: a step over {self.mesh.size} ranks "
                    "runs eagerly only (over gloo its collectives pass "
                    "through the host; a captured step over NCCL is ROADMAP "
                    "Queue 1 item 6): run with MXNET_TPU_TORCH_CAPTURE=0")
            if scalars is None:
                raise capture.CaptureError(
                    "ShardedTrainer: an update function without .scalars "
                    "bakes its rate into the graph; give it scalars(t) or "
                    "run with MXNET_TPU_TORCH_CAPTURE=0")
        fp_on = _integrity.fingerprint_enabled()

        def step_scalars():
            self._step_vals = None if scalars is None else scalars(t)
            if self._step_vals is not None:
                self._slots.write(self._step_vals)

        step_scalars()
        tap = self._numerics
        tap_on = tap is not None and tap.tick()
        if tap_on:
            self._tap_slots.write(tap.sel_values().tolist())
        self._step_count += 1
        _watchdog.note_step(self._step_count)
        snap = _integrity.snapshot_step(self)

        def run():
            args = (x, y) if length is None else (x, y, length)
            key = (n, fp_on, tap_on)
            self._hooks_now = _faults.active("sdc_bitflip_grad")
            try:
                if self._hooks_now:   # a fault hook reaches no graph
                    out = self._eager_program(*args, *key)
                else:
                    out = self._exec(*args, key=key)
            finally:
                self._hooks_now = False
            out = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = out.pop(0)
            fp = out.pop(0) if fp_on else None
            return loss, fp, (out.pop(0) if tap_on else None)

        while True:
            try:
                with _watchdog.guard("step",
                                     detail="parallel.ShardedTrainer.step",
                                     step=self._step_count):
                    if self._multi:
                        _watchdog.check_peers(
                            detail="parallel.ShardedTrainer.step")
                        if self._pod is not None:
                            # a wedged (not crashed) host at the step's
                            # entry: the survivors' collective deadline
                            # blames it
                            _faults.maybe_host_hang(
                                self._pod.host_of(self.mesh.rank))
                    _faults.maybe_hang("hang_step")
                    _faults.maybe_oom_step()
                    with _obs_trace.span("sharded.execute", microbatches=n):
                        loss, fp, stats = run()
                _faults.maybe_sdc_bitflip_param(self.params)
                _faults.maybe_sdc_sticky_param(self.params, self._fault_id())
                if snap is not None:
                    verdict = _integrity.audit_step(
                        self, snap, lambda: run()[1], live_fp=fp)
                    if verdict == "retry":
                        continue
                    snap = None
                break
            except _watchdog.PeerLostError as e:
                # a dead peer is unrecoverable in place; with a checkpoint
                # manager the run survives it: shrink the mesh to the
                # survivors, reload the latest checkpoint onto it and run
                # this batch again (each survivor feeds its own rows)
                if self._ckpt_mgr is None or not self._multi \
                        or not _elastic.mesh_shrink_enabled():
                    raise
                self._recover_peer_loss(e)
                snap = None     # the pre-step snapshot predates the restore
                t = self.opt_state["t"] + 1
                scalars = getattr(self._update, "scalars", None)
                step_scalars()
                if microbatches is None:
                    n = self._elastic_n
                    while n > 1 and rows % n:
                        n //= 2
                continue
            except Exception as e:
                if microbatches is not None or length is not None \
                        or not (_elastic.enabled()
                                and _elastic.is_oom_error(e)):
                    raise
                if self._multi:
                    warnings.warn(
                        "step OOM on a multi-rank mesh: the elastic retry "
                        "runs on one rank only — lower the per-rank batch "
                        "or request microbatches= explicitly")
                    raise
                _elastic._STATS["elastic_oom_events"] += 1
                nxt = _elastic.next_microbatches(n, rows)
                if nxt is None:
                    raise
                self._exec.drop_failed()
                _elastic._STATS["elastic_shrinks"] += 1
                warnings.warn(
                    f"training step OOM at {n} microbatch(es) over a "
                    f"{rows}-row batch; retrying as {nxt} accumulated "
                    f"microbatches of {rows // nxt} rows")
                n = nxt
        if microbatches is None and n > self._elastic_n:
            self._elastic_n = n
        if n > 1:
            _elastic._STATS["elastic_accum_steps"] += 1
        self.opt_state["t"] = t
        self._last_fp_out = fp
        if fp is not None:
            _integrity.note_fingerprint_step()
        if tap is not None:
            tap.on_step(self._step_count, None,
                        None if stats is None else stats.cpu().numpy(),
                        (x, y))
        if _integrity.preempt_requested() or _faults.maybe_preempt():
            _integrity.preempt_exit(self, loss=loss)
        return loss

    @property
    def last_fingerprint(self):
        """The uint32 step fingerprint of the last step, or None when the
        fingerprint is off (reading it is the only host sync)."""
        if self._last_fp_out is None:
            return None
        from ..resilience import integrity as _integrity

        return _integrity.as_uint32(self._last_fp_out)

    # ------------------------------------------------------ peer recovery
    def _recover_peer_loss(self, err):
        """Mesh-shrink resume after a lost peer
        (``mxnet_tpu/parallel/trainer.py:852-985``): the survivors agree on
        the dead set (``watchdog.settle_dead``), shrink the mesh -- a pod
        excises whole hosts (``shrink_mesh_hosts``), without one each rank
        is its own failure domain (``shrink_mesh`` along the batch axis)
        -- rebuild their process groups at the next generation
        (``mesh.rejoin``), lay the trainer out over the smaller mesh,
        re-declare the job (and the pod, and the manager's pod), reload the
        latest checkpoint and re-arm the sticky microbatches; the caller
        runs the batch again. A rank the shrink leaves out (a dead host's
        live rank, a quarantined rank, a survivor the power-of-two rule
        benches) leaves the job with exit code 0. Raises ``err`` when no
        smaller mesh is viable, and RuntimeError when no checkpoint is."""
        from ..resilience import elastic as _elastic
        from ..resilience import watchdog as _watchdog
        from .mesh import MeshShrinkError, rejoin, shrink_mesh, \
            shrink_mesh_hosts

        detected_at = time.time()
        t0 = time.perf_counter()
        old, gen = self.mesh, self.mesh.generation + 1
        dead = _watchdog.settle_dead(tag=f"recover-g{old.generation}") \
            or tuple(getattr(err, "ranks", ()))
        old_axes = dict(old.shape)
        new_topo, hosts = None, ()
        try:
            if self._pod is not None:
                hosts = tuple(sorted({self._pod.host_of(r) for r in dead}))
                shrunk, new_topo, kept = shrink_mesh_hosts(
                    old, hosts, self._pod, batch_axis=self._batch_axis)
            else:
                shrunk = shrink_mesh(old, dead, batch_axis=self._batch_axis)
        except MeshShrinkError:
            raise err
        t_settled = time.perf_counter()
        if old.rank not in {int(r) for r in shrunk.source_ranks.flat}:
            self._leave(old.rank, dead, hosts, dict(shrunk.shape))
        mesh = rejoin(shrunk, old.rank, gen, _watchdog.job_dir())
        _watchdog.reset_peers()
        _watchdog.configure_liveness(mesh.size, mesh.rank,
                                     _watchdog.job_dir(), generation=gen)
        self._bind_mesh(mesh)
        if new_topo is not None:
            self.bind_pod(new_topo)
            if getattr(self._ckpt_mgr, "_pod", None) is not None:
                self._ckpt_mgr.bind_pod(new_topo)
        t_joined = time.perf_counter()
        manifest = self._ckpt_mgr.restore_latest(trainer=self)
        if manifest is None:
            raise RuntimeError(
                f"rank(s) {list(dead)} lost and no valid checkpoint exists "
                f"to reload onto the shrunk mesh {mesh.shape}; cannot "
                "recover") from err
        batch = self._batch_axis_names()
        old_dp = math.prod(int(old_axes.get(a, 1)) for a in batch)
        new_dp = math.prod(int(mesh.shape.get(a, 1)) for a in batch)
        self._elastic_n = _elastic.rearm_microbatches(
            self._elastic_n, old_dp, new_dp)
        _elastic._STATS["elastic_mesh_shrinks"] += 1
        err.ranks, err.hosts = tuple(dead), tuple(hosts)
        _watchdog.note_peer_recovery(err, manifest, old_axes,
                                     dict(mesh.shape))
        self.last_recovery = manifest
        t1 = time.perf_counter()
        self.recovery_times = {"detected_at": detected_at,
                               "settle_s": t_settled - t0,
                               "rejoin_s": t_joined - t_settled,
                               "restore_s": t1 - t_joined,
                               "total_s": t1 - t0}
        what = (f"pod host(s) {list(hosts)}" if hosts
                else f"peer rank(s) {list(dead)}")
        warnings.warn(
            f"{what} lost: resumed from checkpoint step "
            f"{manifest.get('step')} on a mesh shrunk {old_axes} -> "
            f"{mesh.shape} (generation {gen}, this process rank "
            f"{mesh.rank}); the step runs again on the survivors")

    def _leave(self, rank, dead, hosts, new_axes):
        """This rank is not in the shrunk mesh: say so and leave the job
        (exit code 0, no cleanup: the old groups may hold work a dead peer
        left in flight)."""
        why = ("quarantined or of a dead host" if rank in dead
               else "benched by the power-of-two shrink")
        logging.getLogger("mxnet_tpu_torch.parallel").warning(
            "rank %d leaves the job: %s (dead ranks %s, hosts %s; the "
            "survivors go on over %s)", rank, why, list(dead), list(hosts),
            new_axes)
        sys.stderr.write(f"rank {rank} leaves the job: {why}; the "
                         f"survivors go on over {new_axes}\n")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

    def _bind_mesh(self, mesh):
        """Lay the trainer out over ``mesh`` (after a shrink): its tensors
        at the new layout, the optimizer state fresh and the captured
        programs dropped; a checkpoint restore fills them."""
        params = {k: v.detach().to(self.device, copy=True)
                  for k, v in param_arrays(self.net).items()}
        self._set_mesh(mesh, params, broadcast=False)
        self._exec = self._new_exec()

    # ----------------------------------------------- the state over ranks
    def _fault_id(self):
        """The id a device fault's victim is named by: over several ranks
        the process's rank when the job began, else the device's index."""
        if self._multi:
            return self._origin_rank
        return 0 if self.device.index is None else self.device.index

    def _counted(self, name):
        """Does this rank add leaf ``name`` (a parameter's, or a tensor laid
        out as it) to a fingerprint over the ranks: its coordinate is 0 on
        every axis of the mesh the leaf is not split over, so each element
        is added by one rank."""
        split = set(self._shards[name].axes) if name in self._shards \
            else set()
        if name in self._tp_split:
            split.add(self._tp_axis)
        coords = self.mesh.coords
        return all(coords[a] == 0 for a in self.mesh.axis_names
                   if self.mesh.shape[a] > 1 and a not in split)

    def _fold(self, named_by_param):
        """The fingerprint of ``{fold name: (parameter name, tensor)}``,
        the tensors laid out as the parameters: over several ranks
        ``integrity.fold_sharded`` (equal to the gathered state's), else
        ``integrity.fold_tree``."""
        from ..resilience import integrity as _integrity

        named = {k: v.contiguous() for k, (_, v) in named_by_param.items()}
        if not self._multi:
            return _integrity.fold_tree(named)
        counted = {k: self._counted(p)
                   for k, (p, _) in named_by_param.items()}
        return _integrity.fold_sharded(named, counted, self.mesh)

    def _step_fingerprint(self, grads):
        """The step fingerprint (post-update parameters and gradients)
        on the device."""
        named = {f"param:{k}": (k, v) for k, v in self.params.items()}
        named.update({f"grad:{k}": (k, g) for k, g in grads.items()})
        return self._fold(named)

    def _state_fingerprint(self):
        """The parameter state's fingerprint as an int (every rank)."""
        from ..resilience import integrity as _integrity

        return _integrity.as_uint32(self._fold(
            {f"param:{k}": (k, v) for k, v in self.params.items()}))

    def _failed_ranks(self, passed):
        """The ranks whose self-test failed, the same list on every rank."""
        vec = torch.zeros(self.mesh.size, dtype=torch.int32,
                          device=self.device)
        vec[self.mesh.rank] = 0 if passed else 1
        collectives.all_reduce(vec, self.mesh, tuple(self.mesh.axis_names))
        return [r for r, v in enumerate(vec.tolist()) if v]

    def _hosts_of(self, ranks):
        if self._pod is None:
            return ()
        return tuple(sorted({self._pod.host_of(r) for r in ranks}))

    def _pod_shards(self):
        """[(key, shape, dtype, spec, [(index, tensor or None, owner)])]:
        each array of :meth:`_checkpoint_arrays` as the distributed commit
        writes it -- its unique shards (``index``: [start, stop) a
        dimension), each owned by the lowest rank holding it, with this
        rank's tensor where it holds the shard. Tensor-parallel leaves are
        gathered (every rank calls this) and owned by rank 0."""
        tp = set(self._tp_split)
        out = []

        def add(key, name, value):
            if name in tp:
                full = self._full({name: value})[name]
                shards = [(_box(full.shape), full, 0)]
                shape = tuple(full.shape)
            elif name in self._shards:
                sh = self._shards[name]
                shape = list(value.shape)
                shape[sh.dim] = sh.full
                mine = self.mesh.axis_index(sh.axes)
                owners = {}
                for r in range(self.mesh.size):
                    p = type(self.mesh)(self.mesh.devices,
                                        self.mesh.axis_names,
                                        r).axis_index(sh.axes)
                    owners.setdefault(p, r)
                shards = []
                for p in range(sh.parts):
                    lo, hi = p * sh.chunk, min((p + 1) * sh.chunk, sh.full)
                    if hi <= lo:
                        continue        # a piece of zero padding only
                    index = _box(shape)
                    index[sh.dim] = (lo, hi)
                    shards.append((index, value.narrow(sh.dim, 0, hi - lo)
                                   if p == mine else None, owners[p]))
                shape = tuple(shape)
            else:
                shards = [(_box(value.shape), value, 0)]
                shape = tuple(value.shape)
            out.append((key, shape, _dtype_str(value), None, shards))

        for k, v in self.params.items():
            add(f"param:{k}", k, v)
        for k, v in self.aux.items():
            add(f"aux:{k}", None, v)
        for suffix, leaves in self._opt_leaves().items():
            for k, leaf in leaves.items():
                add(f"opt:['state'][{k!r}]{suffix}", k, leaf)
        add("opt:['t']", None, torch.tensor(int(self.opt_state["t"]),
                                            dtype=torch.int32))
        return out

    # ---------------------------------------------------------- the rate
    def set_learning_rate(self, lr):
        """Change the learning rate (``mxnet_tpu/parallel/trainer.py:
        510-521``). The update is rebuilt with it; a captured step reads
        the rate from its slot, so nothing is captured again."""
        self._optimizer_params["learning_rate"] = float(lr)
        self._opt_init, self._update = make_update_fn(
            self._optimizer, dict(self._optimizer_params))

    @property
    def learning_rate(self):
        return self._optimizer_params.get("learning_rate")

    # ------------------------------------------------------------ the net
    def sync_to_net(self):
        """Write the trainer's parameters (sharded ones all-gathered: every
        rank calls it) and aux state into the net's tensors, in the net's
        dtypes (``mxnet_tpu/parallel/trainer.py:1159-1190``)."""
        full = self._full(self.params)
        for name, p in self.net._param_objects().items():
            if name in full:
                p.set_data(full[name])
            elif name in self.aux:
                p.set_data(self.aux[name])

    # ----------------------------------------------------- checkpoints
    def _opt_leaves(self):
        """[(keystr, {name: tensor})]: each optimizer-state leaf position
        of every parameter, keyed as ``jax.tree_util.keystr`` names
        ``mxnet_tpu``'s opt_state leaves (``['state']['w'][0]``), plus
        ``['t']``."""
        out = {}
        for k, s in self.opt_state["state"].items():
            if isinstance(s, torch.Tensor):
                out.setdefault("", {})[k] = s
            else:
                for i, leaf in enumerate(s):
                    out.setdefault(f"[{i}]", {})[k] = leaf
        return out

    def _full_state(self, by_param):
        """{name: full tensor} of a {name: tensor as this rank holds it}
        that follows the parameters' layout."""
        if not self._multi:
            return dict(by_param)
        return self._full(by_param)

    def _checkpoint_arrays(self):
        """[(key, tensor)]: every array of the trainer's state at its
        logical (full) shape, under ``mxnet_tpu``'s checkpoint keys
        (``param:``, ``aux:``, ``opt:``). Over several ranks every rank
        calls it (the shards are all-gathered)."""
        out = [(f"param:{k}", v) for k, v in self._full_state(
            self.params).items()]
        out += [(f"aux:{k}", v) for k, v in self.aux.items()]
        for suffix, leaves in self._opt_leaves().items():
            full = self._full_state(leaves)
            out += [(f"opt:['state'][{k!r}]{suffix}", full[k])
                    for k in leaves]
        out.append(("opt:['t']", torch.tensor(int(self.opt_state["t"]),
                                              dtype=torch.int32)))
        return out

    def _local_value(self, name, full):
        """``full`` (a parameter-shaped value at its logical shape) as this
        rank holds it: its tp shard, then its _Shard piece."""
        v = self._tp_piece(name, full.to(self.device))
        sh = self._shards.get(name)
        if sh is not None:
            v = sh.piece(v, self.mesh.axis_index(sh.axes))
        return v

    def _restore_checkpoint_arrays(self, entries, opt):
        """Place a checkpoint's full arrays (``param:``/``aux:`` keys, CPU
        tensors) and optimizer leaves into the trainer's own tensors, in
        place and in this trainer's layout. Everything is checked before
        anything is written. ``mxnet_tpu``'s ``aux:__rng_key__`` (a JAX
        key) is skipped: it cannot cross (ROADMAP Queue 3)."""
        from ..resilience.checkpoint import CheckpointCorruptError

        params, aux = {}, {}
        for key, v in entries.items():
            group, _, name = key.partition(":")
            if group == "param":
                if name not in self.params:
                    raise CheckpointCorruptError(
                        f"checkpoint param '{name}' unknown to trainer")
                params[name] = self._local_value(name, v)
            elif group == "aux":
                if name == "__rng_key__" and name not in self.aux:
                    continue  # mxnet_tpu's JAX key: no torch counterpart
                if name not in self.aux:
                    raise CheckpointCorruptError(
                        f"checkpoint aux '{name}' unknown to trainer")
                aux[name] = v
        missing = set(self.params) - set(params)
        if missing:
            raise CheckpointCorruptError(
                f"checkpoint lacks sharded params {sorted(missing)[:5]}")
        for name, v in params.items():
            if tuple(v.shape) != tuple(self.params[name].shape):
                raise CheckpointCorruptError(
                    f"checkpoint param '{name}' has shape "
                    f"{tuple(v.shape)} here, the trainer "
                    f"{tuple(self.params[name].shape)}")
        placed = self._placed_opt(opt)
        with torch.no_grad():
            for name, v in params.items():
                self.params[name].copy_(v)
            for name, v in aux.items():
                self.aux[name].copy_(v)
        self._write_opt(placed)

    def _placed_opt(self, mapping):
        """The optimizer leaves of ``mapping`` ({keystr: array or tensor})
        placed as this trainer holds them; raises on a missing or extra
        leaf or a shape that disagrees."""
        stored = {k: torch.as_tensor(v) for k, v in mapping.items()}
        placed = {}
        for suffix, leaves in self._opt_leaves().items():
            for k, leaf in leaves.items():
                key = f"['state'][{k!r}]{suffix}"
                if key not in stored:
                    raise ValueError(
                        f"trainer states are missing opt_state leaf {key} "
                        "(saved from a different optimizer/model?)")
                v = stored.pop(key)
                if self._multi and tuple(v.shape) != tuple(leaf.shape):
                    v = self._local_value(k, v)
                if tuple(v.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"opt_state leaf {key} has shape {tuple(v.shape)} in "
                        f"the states but {tuple(leaf.shape)} in this trainer")
                placed[key] = (leaf, v)
        t = stored.pop("['t']", None)
        if t is None:
            raise ValueError("trainer states are missing opt_state leaf "
                             "['t']")
        if stored:
            raise ValueError(
                "trainer states have extra opt_state leaves "
                f"{sorted(stored)[:3]} (saved from a different "
                "optimizer/model?)")
        placed["['t']"] = int(t)
        return placed

    def _write_opt(self, placed):
        with torch.no_grad():
            for key, val in placed.items():
                if key != "['t']":
                    leaf, v = val
                    leaf.copy_(v)
        self.opt_state["t"] = placed["['t']"]

    def set_states_arrays(self, mapping):
        """Restore the optimizer state from ``{keystr: array}``
        (``mxnet_tpu``'s opt_state leaf names), in place."""
        self._write_opt(self._placed_opt(mapping))

    def get_states_bytes(self):
        """The optimizer state as npz bytes keyed by ``mxnet_tpu``'s
        opt_state leaf names, at full shape (over several ranks every rank
        calls it)."""
        import io

        from ..resilience.checkpoint import _as_numpy

        entries = {k[len("opt:"):]: _as_numpy(v)
                   for k, v in self._checkpoint_arrays()
                   if k.startswith("opt:")}
        buf = io.BytesIO()
        np.savez(buf, **entries)
        return buf.getvalue()

    def set_states_bytes(self, data):
        import io

        f = np.load(io.BytesIO(data), allow_pickle=False)
        self.set_states_arrays({k: f[k] for k in f.files})

    def save_states(self, fname):
        """Save the optimizer state atomically (temp file, fsync,
        rename)."""
        from ..resilience.checkpoint import atomic_write_bytes

        data = self.get_states_bytes()
        if self._is_writer():
            atomic_write_bytes(fname, data)
        if self._multi:
            self._barrier()

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())

    def _is_writer(self):
        """Does this rank write shared files (rank 0 of the world)?"""
        return not self._multi or self.mesh.rank == 0

    def _barrier(self):
        """Every rank of the mesh waits for the others."""
        collectives.all_reduce(torch.zeros(1, device=self.device),
                               self.mesh, tuple(self.mesh.axis_names))

