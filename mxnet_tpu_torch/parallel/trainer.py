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

Not ported, and raising where asked for: mesh axes of more than one rank
other than the batch axes, 'sp' and 'tp' ('pp', 'ep'), 'tp' together
with 'sp', and a spec splitting two dimensions of a parameter outside a
tensor-parallel layer (ROADMAP Queue 1 item 6); a ``checkpoint_manager``,
the pad mask ``length=``, the step watchdog, fault injection, integrity
fingerprints, elastic OOM retry, pod recovery and optimizer-state
save/load (Queue 1 item 12).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .. import autograd, capture
from ..base import torch_dtype
from ..remat import checkpointed, mirror_enabled
from . import collectives
from .functional import functional_call, param_arrays, aux_arrays
from .layout import PartitionSpec
from .mesh import _torch_device, create_mesh
from .optim import make_update_fn
from . import tensor_parallel

__all__ = ["ShardedTrainer", "make_update_fn"]


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
    checkpoint_manager : not ported; anything but None raises
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=(), batch_axis_name="dp",
                 dtype=None, remat=None, checkpoint_manager=None):
        if checkpoint_manager is not None:
            raise _queued("checkpoint_manager (elastic mesh-shrink resume)",
                          12)
        mesh = mesh if mesh is not None else create_mesh()
        self.mesh = mesh
        self._batch_axis = (batch_axis_name if isinstance(batch_axis_name,
                                                          str)
                            else tuple(batch_axis_name))
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
        self.device = mesh.device
        self.net = net
        self.loss_fn = loss_fn
        self._compute_dtype = None if dtype is None else torch_dtype(dtype)
        self._rules = [(re.compile(pat), spec) for pat, spec in param_rules]
        params = {k: v.detach().to(self.device, copy=True)
                  for k, v in param_arrays(net).items()}
        self.aux = {k: v.detach().to(self.device, copy=True)
                    for k, v in aux_arrays(net).items()}
        # {name: (dim, qkv)}: the tp shards the tensor-parallel layers
        # compute on, and the context that names those layers
        self._tp_split, tp = self._tp_plan(params)
        self._fwd = functional_call(net, train=True, mesh=mesh,
                                    batch_axes=self._batch_axes, tp=tp)
        if remat is None:
            remat = mirror_enabled()
        if remat:
            self._fwd = checkpointed(self._fwd, remat)
        if self._multi:
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
        self._optimizer = optimizer
        self._optimizer_params = dict(optimizer_params or {})
        init, self._update = make_update_fn(optimizer,
                                            dict(self._optimizer_params))
        self.opt_state = init(self.params)
        self._slots = capture.SlotTable(self.device)
        self._step_vals = None
        self._exec = capture.CapturedExec(
            self._captured_program, label="sharded_step",
            device=self.device, state=self._state_tensors,
            eager=self._eager_program, warmup_guard=self._warmup_guard)

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

        from ..context import as_device

        if not dist.is_initialized():
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
            dist.init_process_group(backend, init_method=init, **kw)
        elif backend is not None and dist.get_backend() != backend:
            raise ValueError(
                f"for_multihost(backend={backend!r}): torch.distributed is "
                f"already initialized with {dist.get_backend()!r}")
        world = dist.get_world_size()
        if devices is None:
            devices = [as_device(None)] * world
        mesh = create_mesh(dict(axes or {"dp": world}), devices)
        return cls(net, loss_fn, optimizer, optimizer_params, mesh=mesh,
                   **kwargs)

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
        out.update(self._gathered({k: tensors[k] for k in self._shards}))
        return out

    def _full(self, tensors):
        """``tensors`` ({name: tensor} as the trainer holds them) at their
        full shapes: the _Shards all-gathered, then the tp shards
        all-gathered over tp (the qkv rows back in the net's order)."""
        full = self._local(tensors)
        for k, (dim, qkv) in self._tp_split.items():
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

    def _captured_program(self, x, y, n):
        return self._program(x, y, n, None if self._step_vals is None
                             else self._slots.views)

    def _eager_program(self, x, y, n):
        return self._program(x, y, n, self._step_vals)

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for k, v in new_aux.items():
                self.aux[k].copy_(v)

    def _loss_and_mean_grads(self, x, y, n):
        """(loss, {name: grad}): the mean of the ``n`` microbatch losses
        and gradients of this rank's rows, running statistics written back;
        over several ranks, the global loss and mean gradients (shards for
        sharded parameters)."""
        full = self._local(self.params) if self._multi else self.params
        if n == 1:
            loss, grads, new_aux = self._loss_and_grads(x, y, full)
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

    def _program(self, x, y, n, scal):
        """The whole step on the batch: loss, gradients, aux written back,
        the update in place with the scalars ``scal`` (None: the update
        computes them itself)."""
        loss, grads = self._loss_and_mean_grads(x, y, n)
        if scal is not None:
            self.opt_state["scalars"] = scal
        try:
            self._update(self.params, grads, self.opt_state)
        finally:
            self.opt_state.pop("scalars", None)
        return loss

    # ------------------------------------------------------------ the step
    def _loss_and_grads(self, x, y, params=None):
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
            loss = self.loss_fn(out, y).mean()
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
        rows raises. ``length=`` (the pad mask) is not ported and raises.
        """
        if length is not None:
            raise _queued("length= (the pad-masked step)", 12)
        x, y = self._place(x), self._place(y)
        n = self._microbatches(x, microbatches)
        t = self.opt_state["t"] + 1
        scalars = getattr(self._update, "scalars", None)
        if self.device.type == "cuda" and capture.enabled():
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
        self._step_vals = None if scalars is None else scalars(t)
        if self._step_vals is not None:
            self._slots.write(self._step_vals)
        loss = self._exec(x, y, key=(n,))
        self.opt_state["t"] = t
        return loss

    # ---------------------------------------------------------- the rate
    def set_learning_rate(self, lr):
        """Change the learning rate (``mxnet_tpu/parallel/trainer.py:
        510-521``). The update is rebuilt with it; a captured step reads
        the rate from its slot, so nothing is captured again."""
        self._optimizer_params["learning_rate"] = float(lr)
        _, self._update = make_update_fn(self._optimizer,
                                         dict(self._optimizer_params))

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
