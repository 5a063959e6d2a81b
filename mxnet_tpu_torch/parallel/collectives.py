"""The collectives a multi-rank step runs, written out.

``mxnet_tpu`` runs one program over a mesh and GSPMD inserts its
collectives: the gradient all-reduce over the batch axes, the fsdp
all-gather and reduce-scatter, BatchNorm's cross-replica moments and the
ring's ``lax.ppermute``. The port runs one process per rank, so each is a
call here, over the process group that :meth:`Mesh.group` gives for a
tuple of axes. A group of one rank makes each call the identity.

The transport follows the group's backend and nothing else:

- NCCL moves CUDA tensors in place; a CPU tensor raises.
- gloo moves CPU tensors in place. It also takes CUDA tensors for
  all-reduce, broadcast, all-gather and reduce-scatter (it copies them
  through the host itself: torch 2.11, measured on an H100), but not for
  send and receive, where a CUDA pointer reaches a socket write and the
  process aborts. So :func:`ring_shift` stages CUDA tensors through pinned
  host buffers on a gloo group: one device-to-host copy of all the shifted
  tensors packed together, the exchange on the host, one copy back.
- A CUDA stream that is capturing a graph can hold no host-side exchange:
  a gloo collective on a CUDA tensor then raises.

:func:`stats` counts calls by kind, the bytes handed to collectives (in
all and by kind), the bytes staged through host buffers (both
directions) and the host seconds spent in the calls (for NCCL the
enqueue; for gloo the whole exchange, which blocks). Under "tp" it also
counts the all-reduces that tensor parallelism's pair issues:
:func:`copy_to_tp` in its backward, :func:`reduce_from_tp` in its
forward, by kind and axes.
"""
from __future__ import annotations

import time

import torch

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ring_shift", "all_reduce_sum_differentiable", "copy_to_tp",
           "reduce_from_tp", "stats", "reset_stats"]

_STATS = {"calls": {}, "bytes": 0, "bytes_by_kind": {}, "staged_bytes": 0,
          "seconds": 0.0, "tp": {}}


def stats():
    """{"calls": {kind: n}, "bytes", "bytes_by_kind": {kind: bytes},
    "staged_bytes", "seconds", "tp": {kind: {axes: {"calls", "bytes"}}}}
    since the last :func:`reset_stats` (``axes`` joined by commas)."""
    return {"calls": dict(_STATS["calls"]), "bytes": _STATS["bytes"],
            "bytes_by_kind": dict(_STATS["bytes_by_kind"]),
            "staged_bytes": _STATS["staged_bytes"],
            "seconds": _STATS["seconds"],
            "tp": {k: {a: dict(c) for a, c in v.items()}
                   for k, v in _STATS["tp"].items()}}


def reset_stats():
    _STATS["calls"] = {}
    _STATS["bytes"] = 0
    _STATS["bytes_by_kind"] = {}
    _STATS["staged_bytes"] = 0
    _STATS["seconds"] = 0.0
    _STATS["tp"] = {}


class _counted:
    """Counts one collective call of ``kind`` handed ``nbytes``, of which
    ``staged`` cross the host (both directions)."""

    def __init__(self, kind, nbytes, staged=0):
        self.kind, self.nbytes, self.staged = kind, int(nbytes), int(staged)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _STATS["calls"][self.kind] = _STATS["calls"].get(self.kind, 0) + 1
        _STATS["bytes"] += self.nbytes
        by = _STATS["bytes_by_kind"]
        by[self.kind] = by.get(self.kind, 0) + self.nbytes
        _STATS["staged_bytes"] += self.staged
        _STATS["seconds"] += time.perf_counter() - self.t0


def _check_transport(x, group, kind):
    """``group``'s backend; raises where it cannot take ``x``."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "nccl" and x.device.type != "cuda":
        raise ValueError(f"{kind}: an NCCL group moves CUDA tensors, got "
                         f"one on {x.device}")
    if backend == "gloo" and x.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kind}: a gloo group exchanges CUDA tensors through the host, "
            "which a capturing CUDA graph cannot hold (run the multi-rank "
            "step eagerly: MXNET_TPU_TORCH_CAPTURE=0)")
    return backend


def _staged(x, group, kind, nbytes):
    """The bytes a call on ``x`` moves through the host: ``nbytes`` for a
    CUDA tensor on a gloo group (which copies it through host memory
    itself), else 0."""
    backend = _check_transport(x, group, kind)
    return nbytes if backend == "gloo" and x.device.type == "cuda" else 0


def all_reduce(x, mesh, axes, op="sum"):
    """``x`` summed (``op="sum"``) or averaged (``"mean"``) over ``mesh``'s
    ranks along ``axes``, in place; returns ``x``."""
    import torch.distributed as dist

    group = mesh.group(axes)
    if group is None:
        return x
    nbytes = x.numel() * x.element_size()
    with _counted("all_reduce", nbytes,
                  _staged(x, group, "all_reduce", 2 * nbytes)):
        dist.all_reduce(x, group=group)
    if op == "mean":
        x.div_(mesh.axis_size(axes))
    elif op != "sum":
        raise ValueError(f"all_reduce: op must be 'sum' or 'mean', got "
                         f"{op!r}")
    return x


def all_gather(x, mesh, axes, dim=0):
    """The ranks' ``x`` (equal shapes) along ``axes``, concatenated along
    ``dim`` in their order along the axes."""
    import torch.distributed as dist

    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axis_size(axes)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    nbytes = out.numel() * out.element_size()
    with _counted("all_gather", nbytes,
                  _staged(x, group, "all_gather", nbytes + nbytes // n)):
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x, mesh, axes, dim=0):
    """``x`` summed over the ranks along ``axes`` and split into as many
    equal chunks along ``dim``: this rank's chunk (by its index along the
    axes)."""
    import torch.distributed as dist

    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split into {n} chunks")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    nbytes = x.numel() * x.element_size()
    with _counted("reduce_scatter", nbytes,
                  _staged(x, group, "reduce_scatter", nbytes + nbytes // n)):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def broadcast(x, mesh, src=0):
    """``x`` from global rank ``src`` to every rank of ``mesh``, in
    place; returns ``x``."""
    import torch.distributed as dist

    group = mesh.group(mesh.axis_names)
    if group is None:
        return x
    nbytes = x.numel() * x.element_size()
    with _counted("broadcast", nbytes, _staged(x, group, "broadcast",
                                               nbytes)):
        dist.broadcast(x, src=src, group=group)
    return x


_ALIGN = 16     # each tensor's offset in a packed buffer: TMA-readable


def _padded(nbytes):
    return -(-nbytes // _ALIGN) * _ALIGN


def _as_bytes(tensors):
    """One contiguous uint8 buffer holding ``tensors`` back to back, each
    at a 16-byte-aligned offset."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if _padded(b.numel()) > b.numel():
            parts.append(b.new_zeros(_padded(b.numel()) - b.numel()))
    return torch.cat(parts)


def _from_bytes(buf, like):
    """Tensors shaped and typed as ``like``, cut from ``buf`` (views, on
    buf's device)."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += _padded(n)
    return out


def ring_shift(tensors, mesh, axis, shift=1):
    """The ``lax.ppermute`` of ``mxnet_tpu/parallel/ring_attention.py``:
    each rank sends ``tensors`` to the rank ``shift`` further along
    ``axis`` (cyclically) and returns those it receives from the rank
    ``shift`` before it: new contiguous tensors of the same shapes and
    dtypes, on the same device. The tensors travel packed as one buffer."""
    import torch.distributed as dist

    tensors = list(tensors)
    group = mesh.group(axis)
    if group is None:
        return [t.contiguous() for t in tensors]
    buf = _as_bytes(tensors)
    backend = _check_transport(buf, group, "ring_shift")
    ranks = mesh.group_ranks(axis)
    n, me = len(ranks), mesh.axis_index(axis)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    staged = backend == "gloo" and buf.device.type == "cuda"
    nbytes = buf.numel()
    with _counted("ring_shift", nbytes, 2 * nbytes if staged else 0):
        if staged:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf)
            send, recv = host, torch.empty(nbytes, dtype=torch.uint8,
                                           pin_memory=True)
        else:
            send, recv = buf, torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, send, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            recv = recv.to(buf.device, non_blocking=True)
    return _from_bytes(recv, tensors)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks along ``axes``; its gradient is the sum of the
    ranks' cotangents (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


def all_reduce_sum_differentiable(x, mesh, axes):
    """``x`` summed over the ranks along ``axes``, with the gradient that
    sum has: BatchNorm's moments over a batch split across ranks."""
    if mesh.group(axes) is None:
        return x
    return _AllReduceSum.apply(x, mesh, axes)


def _count_tp(kind, axes, x):
    """One all-reduce of ``x`` issued by tensor parallelism's ``kind``."""
    key = ",".join((axes,) if isinstance(axes, str) else axes)
    c = _STATS["tp"].setdefault(kind, {}).setdefault(
        key, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += x.numel() * x.element_size()


class _CopyToTP(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the backward sums the ranks'
    cotangents (each rank's product with its own rows of a
    column-parallel weight contributes to the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count_tp("copy_to_tp", ctx.axes, g)
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's *g*: the forward sums the ranks' partial products of a
    row-parallel weight; the backward is the identity (every rank holds
    the same cotangent of the sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        x = x.contiguous().clone()
        _count_tp("reduce_from_tp", axes, x)
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp(x, mesh, axes):
    """``x`` as it is, whose gradient is summed over the ranks along
    ``axes``: the input of a column-parallel product. The identity outside
    a group of more than one rank."""
    if mesh.group(axes) is None:
        return x
    return _CopyToTP.apply(x, mesh, axes)


def reduce_from_tp(x, mesh, axes):
    """``x`` summed over the ranks along ``axes``, whose gradient passes
    through as it is: the output of a row-parallel product. The identity
    outside a group of more than one rank. Unlike
    :func:`all_reduce_sum_differentiable` (BatchNorm's moments over other
    rows), the ranks' cotangents here are equal, and summing them would
    scale the gradient by the group's size."""
    if mesh.group(axes) is None:
        return x
    return _ReduceFromTP.apply(x, mesh, axes)
