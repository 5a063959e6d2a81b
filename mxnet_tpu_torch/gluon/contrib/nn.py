"""Contrib layers (subset of ``mxnet_tpu/gluon/contrib/nn.py``):
multi-head self-attention with a selectable attention kernel, and
segment-level activation rematerialization."""
from __future__ import annotations

import contextlib

import torch

from ... import autograd
from ..block import HybridBlock
from .. import nn as _nn
from ...ops import kernels as _kernels
from ...ops import nn as _ops
from ...parallel import tensor_parallel as _tp

__all__ = ["MultiHeadAttention", "Remat"]


class Remat(HybridBlock):
    """Activation rematerialization around any block
    (``mxnet_tpu/gluon/contrib/nn.py:97-160``): while a graph is recorded,
    ``block`` runs under ``torch.utils.checkpoint`` with the policy of
    ``policy`` (:func:`mxnet_tpu_torch.remat.resolve_policy`), so its
    activations are recomputed in the backward; otherwise it is a
    pass-through. The wrapped block keeps its parameters' names.

    The recomputation runs in the backward, after any
    ``parallel.functional_call`` that gave the block other tensors has
    returned, and outside the caller's ``autograd.record()``: so the
    block's tensors as the forward found them are passed in and bound
    again (``torch.func.functional_call``), in the forward's recording
    and training mode, under its BatchNorm synchronization
    (``ops.nn.sync_batch_stats``, a multi-rank step's) and in its tensor
    parallelism context (``parallel.tensor_parallel``), so the
    recomputation issues the same all-reduces. Tensors that take
    no gradient (BatchNorm's running statistics) are bound as copies, and
    only the forward's copies are written back: the recomputation updates
    no running statistic twice.
    """

    def __init__(self, block, policy=None, **kwargs):
        super().__init__(**kwargs)
        from ...remat import checkpointed

        with self.name_scope():
            self.block = block
        self._run = checkpointed(self._recorded,
                                 True if policy is None else policy)

    def _recorded(self, training, sync, tp, tensors, first, *args):
        state = {n: t for n, t in tensors.items() if not t.requires_grad}
        bound = dict(tensors)
        bound.update((n, t.clone()) for n, t in state.items())
        synced = _ops.sync_batch_stats(*sync) if sync is not None \
            else contextlib.nullcontext()
        with autograd._Scope(recording=True, training=bool(training)), \
                synced, _tp.context(tp):
            out = torch.func.functional_call(self.block, bound, args)
        if first:                       # the forward, not a recomputation
            first.clear()
            with torch.no_grad():
                for n, t in state.items():
                    t.copy_(bound[n])
        return out

    def forward(self, *args):
        if torch.is_grad_enabled():
            return self._run(autograd.is_training(), _ops.batch_stats_sync(),
                             _tp.current(),
                             dict(self.block.named_parameters()), [True],
                             *args)
        return self.block(*args)


class MultiHeadAttention(HybridBlock):
    """Multi-head self-attention: ``block(x)`` with x (B, L, units) ->
    (B, L, units).

    impl:
      - 'dense': the plain PyTorch composition
      - 'flash': the streaming flash kernels (ops/kernels.py), which on a
        CUDA tensor are the hand-written CUDA kernels: K1 reads q, k, v as
        views of the qkv projection's output, and K2 writes the
        projection's gradient as one buffer (``flash_attention_qkv``)
      - 'ring': sequence-parallel ring attention over ``mesh``'s
        ``sp_axis`` (:mod:`mxnet_tpu_torch.parallel.ring_attention`): x is
        this rank's slice of the sequence, K1 and K2 run once a hop on
        CUDA
      - 'auto': picks per shape and device (``parallel.attention``): the
        ring where ``mesh`` has an ``sp_axis`` of more than one rank, else
        the flash kernels on CUDA and the dense composition on the CPU

    Inside a tensor parallelism context that names ``qkv_proj``
    (``ShardedTrainer`` over a 'tp' axis), the block holds this rank's
    heads: the qkv projection is column-parallel on their head-aligned
    rows, attention runs on ``num_heads / tp`` heads through the same
    ``impl``, and the output projection is row-parallel.
    """

    def __init__(self, units, num_heads, impl="dense", causal=False,
                 use_bias=True, mesh=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if impl not in ("dense", "flash", "ring", "auto"):
            raise ValueError(f"unknown impl {impl!r}")
        self._units = units
        self._heads = num_heads
        self._impl = impl
        self._causal = causal
        self._mesh = mesh
        self._sp_axis = sp_axis
        with self.name_scope():
            self.qkv_proj = _nn.Dense(3 * units, use_bias=use_bias,
                                      flatten=False, in_units=units,
                                      prefix="qkv_")
            self.out_proj = _nn.Dense(units, use_bias=use_bias,
                                      flatten=False, in_units=units,
                                      prefix="out_")

    def _tp_layers(self):
        """The (column, row) Dense pair that runs tensor-parallel inside
        a tp context (``parallel.tensor_parallel``), whether the column
        layer's rows are a qkv projection's, and the width that tp must
        split."""
        return [(self.qkv_proj, self.out_proj, True,
                 ("num_heads", self._heads))]

    def _attend(self, qkv, heads):
        """O (B, H, L, d) of ``heads`` heads from the packed projection
        ``qkv`` (B, L, 3 * heads * d)."""
        if self._impl == "flash":
            return _kernels.flash_attention_qkv(qkv, heads,
                                                causal=self._causal)
        if self._impl == "dense":
            return _ops.scaled_dot_product_attention(
                *_kernels._split_qkv(qkv, heads), causal=self._causal)
        from ...parallel import ring

        return ring.attention(
            *_kernels._split_qkv(qkv, heads), causal=self._causal,
            mesh=self._mesh, axis_name=self._sp_axis, impl="auto")

    def forward(self, x):
        tp = _tp.running(self.qkv_proj)
        if tp is not None:
            # this rank's heads: its head-aligned rows of the qkv
            # projection, its columns of the output projection
            heads = tp.local(self._heads, "num_heads")
            qkv = _tp.column_parallel(x, self.qkv_proj.weight,
                                      self.qkv_proj.bias)
        else:
            heads = self._heads
            qkv = self.qkv_proj(x)
        out = self._attend(qkv, heads)
        b, h, l, d = out.shape
        # the tensor-core flash kernel writes O as (B, L, H, d) memory, so
        # this merge of the heads is a view there, not a copy
        out = out.transpose(1, 2).reshape(b, l, h * d)
        if tp is not None:
            return _tp.row_parallel(out, self.out_proj.weight,
                                    self.out_proj.bias)
        return self.out_proj(out)
