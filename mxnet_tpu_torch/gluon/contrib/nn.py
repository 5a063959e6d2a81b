"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn.py``; parity:
python/mxnet/gluon/contrib/nn/basic_layers.py): parallel branches
concatenated (``Concurrent``, ``HybridConcurrent``), ``Identity``,
``SparseEmbedding`` and ``SyncBatchNorm``, multi-head self- and
cross-attention with a selectable attention kernel, and segment-level
activation rematerialization."""
from __future__ import annotations

import contextlib
import warnings

import torch

from ... import autograd
from ..block import Block, HybridBlock, _is_symbol
from .. import nn as _nn
from ...base import MXNetError
from ...ops import kernels as _kernels
from ...ops import nn as _ops
from ...parallel import tensor_parallel as _tp

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "MultiHeadAttention", "Remat"]


class Concurrent(_nn.Sequential):
    """Feeds the input to every child and concatenates their outputs on
    ``axis`` (``mxnet_tpu/gluon/contrib/nn.py:19-31``)."""

    def __init__(self, axis=-1, prefix=None):
        super().__init__(prefix=prefix)
        self.axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self.axis)


class HybridConcurrent(_nn.HybridSequential):
    """The hybridizable :class:`Concurrent`; on a Symbol it writes one
    ``Concat`` node (``mxnet_tpu/gluon/contrib/nn.py:34-62``)."""

    def __init__(self, axis=-1, prefix=None):
        super().__init__(prefix=prefix)
        self.axis = axis

    def forward(self, x):
        outs = [block(x) for block in self._modules.values()]
        if _is_symbol(x):
            from ... import symbol

            return symbol.concat(*outs, dim=self.axis)
        return torch.cat(outs, dim=self.axis)


class Identity(HybridBlock):
    """Returns its input (``mxnet_tpu/gluon/contrib/nn.py:65-67``)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """``contrib.nn.SparseEmbedding`` over a dense :class:`nn.Embedding`,
    as ``mxnet_tpu`` has it (``mxnet_tpu/gluon/contrib/nn.py:67-82``): the
    gradient is dense; row-sparse gradients are ROADMAP Queue 1 item 9."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        warnings.warn("SparseEmbedding uses dense gradients (row_sparse "
                      "gradients are not ported)", stacklevel=2)
        with self.name_scope():
            self._embed = _nn.Embedding(input_dim, output_dim, dtype=dtype,
                                        weight_initializer=weight_initializer)

    def forward(self, x):
        return self._embed(x)


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device BatchNorm (``mxnet_tpu/gluon/contrib/nn.py:85-95``).
    Under ``parallel.ShardedTrainer`` the port's BatchNorm already takes
    its moments over the batch axes (``ops.nn.sync_batch_stats``), so this
    is a BatchNorm; ``num_devices`` is accepted and ignored, as there."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)


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
    """Multi-head attention (``mxnet_tpu/gluon/contrib/nn.py:163-263``).
    Self-attention: ``block(x)`` with x (B, L, units) -> (B, L, units).
    Cross-attention (``cross_attention=True``): ``block(x, key_value)``,
    q projected from x by ``q_proj``, k and v from key_value (B, S, units)
    by one ``kv_proj`` whose output channels are [k | v], heads inside
    each, as ``mxnet_tpu`` splits them.

    impl:
      - 'dense': the plain PyTorch composition
      - 'flash': the streaming flash kernels (ops/kernels.py), which on a
        CUDA tensor are the hand-written CUDA kernels: K1 reads q, k, v as
        views of the projections' outputs, and in self-attention K2 writes
        the qkv projection's gradient as one buffer
        (``flash_attention_qkv``); cross-attention runs K1 / K2 through
        ``flash_attention_with_grad`` on the q and kv views. The kernels
        take self-attention shapes only: cross-attention with S != L
        raises (``mxnet_tpu`` warns and computes the dense composition,
        ROADMAP Queue 3)
      - 'ring': sequence-parallel ring attention over ``mesh``'s
        ``sp_axis`` (:mod:`mxnet_tpu_torch.parallel.ring_attention`): x is
        this rank's slice of the sequence, K1 and K2 run once a hop on
        CUDA
      - 'auto': picks per shape and device (``parallel.attention``): the
        ring where ``mesh`` has an ``sp_axis`` of more than one rank, else
        the flash kernels on CUDA and the dense composition on the CPU

    Inside a tensor parallelism context that names ``qkv_proj``
    (``ShardedTrainer`` over a 'tp' axis), a self-attention block holds
    this rank's heads: the qkv projection is column-parallel on their
    head-aligned rows, attention runs on ``num_heads / tp`` heads through
    the same ``impl``, and the output projection is row-parallel.
    """

    def __init__(self, units, num_heads, impl="dense", causal=False,
                 use_bias=True, mesh=None, sp_axis="sp",
                 cross_attention=False, **kwargs):
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
            if cross_attention:
                self.q_proj = _nn.Dense(units, use_bias=use_bias,
                                        flatten=False, in_units=units,
                                        prefix="q_")
                self.kv_proj = _nn.Dense(2 * units, use_bias=use_bias,
                                         flatten=False, in_units=units,
                                         prefix="kv_")
                self.qkv_proj = None
            else:
                self.qkv_proj = _nn.Dense(3 * units, use_bias=use_bias,
                                          flatten=False, in_units=units,
                                          prefix="qkv_")
                self.q_proj = self.kv_proj = None
            self.out_proj = _nn.Dense(units, use_bias=use_bias,
                                      flatten=False, in_units=units,
                                      prefix="out_")

    def _tp_layers(self):
        """The (column, row) Dense pair that runs tensor-parallel inside
        a tp context (``parallel.tensor_parallel``), whether the column
        layer's rows are a qkv projection's, and the width that tp must
        split; none for cross-attention."""
        if self.qkv_proj is None:
            return []
        return [(self.qkv_proj, self.out_proj, True,
                 ("num_heads", self._heads))]

    def _heads_of(self, x, n):
        """The n (B, H, T, d) head views of a projection's output x
        (B, T, n * units), channels [first | second | ...], heads inside
        each (``mxnet_tpu/gluon/contrib/nn.py:225-232``)."""
        b, t, _ = x.shape
        x = x.reshape(b, t, n * self._heads, -1).transpose(1, 2)
        return [x[:, i * self._heads:(i + 1) * self._heads]
                for i in range(n)]

    def _attend(self, q, k, v):
        if self._impl in ("dense", "flash"):
            return _ops.scaled_dot_product_attention(
                q, k, v, causal=self._causal,
                impl="flash" if self._impl == "flash" else "xla")
        from ...parallel import ring

        return ring.attention(q, k, v, causal=self._causal, mesh=self._mesh,
                              axis_name=self._sp_axis, impl="auto")

    def _attend_qkv(self, qkv, heads):
        """O (B, H, L, d) of ``heads`` heads from the packed projection
        ``qkv`` (B, L, 3 * heads * d)."""
        if self._impl == "flash":
            return _kernels.flash_attention_qkv(qkv, heads,
                                                causal=self._causal)
        return self._attend(*_kernels._split_qkv(qkv, heads))

    def _cross(self, x, key_value):
        q, = self._heads_of(self.q_proj(x), 1)
        k, v = self._heads_of(self.kv_proj(key_value), 2)
        if self._impl == "flash" and k.shape[2] != q.shape[2]:
            raise MXNetError(
                f"MultiHeadAttention(impl='flash', cross_attention=True): "
                f"key_value's length {k.shape[2]} differs from x's "
                f"{q.shape[2]}, and the flash kernels take self-attention "
                "shapes only (ops/kernels.py _check: q, k and v of one "
                "shape); use impl='dense' for S != L")
        return self._attend(q, k, v)

    def forward(self, x, key_value=None):
        if key_value is not None or self.qkv_proj is None:
            if self.q_proj is None:
                raise ValueError("pass cross_attention=True at construction "
                                 "for the cross-attention path")
            if key_value is None:
                raise ValueError("this block was built with "
                                 "cross_attention=True; pass key_value")
            out, tp = self._cross(x, key_value), None
        else:
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
            out = self._attend_qkv(qkv, heads)
        b, h, l, d = out.shape
        # the tensor-core flash kernel writes O as (B, L, H, d) memory, so
        # this merge of the heads is a view there, not a copy
        out = out.transpose(1, 2).reshape(b, l, h * d)
        if tp is not None:
            return _tp.row_parallel(out, self.out_proj.weight,
                                    self.out_proj.bias)
        return self.out_proj(out)
