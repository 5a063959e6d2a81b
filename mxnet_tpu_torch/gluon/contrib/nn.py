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
    and training mode and under its BatchNorm synchronization
    (``ops.nn.sync_batch_stats``, a multi-rank step's). Tensors that take
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

    def _recorded(self, training, sync, tensors, first, *args):
        state = {n: t for n, t in tensors.items() if not t.requires_grad}
        bound = dict(tensors)
        bound.update((n, t.clone()) for n, t in state.items())
        synced = _ops.sync_batch_stats(*sync) if sync is not None \
            else contextlib.nullcontext()
        with autograd._Scope(recording=True, training=bool(training)), \
                synced:
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

    def forward(self, x):
        qkv = self.qkv_proj(x)
        if self._impl == "flash":
            out = _kernels.flash_attention_qkv(qkv, self._heads,
                                               causal=self._causal)
        elif self._impl == "dense":
            out = _ops.scaled_dot_product_attention(
                *_kernels._split_qkv(qkv, self._heads), causal=self._causal)
        else:
            from ...parallel import ring

            out = ring.attention(
                *_kernels._split_qkv(qkv, self._heads), causal=self._causal,
                mesh=self._mesh, axis_name=self._sp_axis, impl="auto")
        b, h, l, d = out.shape
        # the tensor-core flash kernel writes O as (B, L, H, d) memory, so
        # this merge of the heads is a view there, not a copy
        return self.out_proj(out.transpose(1, 2).reshape(b, l, h * d))
