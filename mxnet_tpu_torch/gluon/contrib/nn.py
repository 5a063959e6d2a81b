"""Contrib layers (subset of ``mxnet_tpu/gluon/contrib/nn.py``):
multi-head self-attention with a selectable attention kernel."""
from __future__ import annotations

from ..block import HybridBlock
from .. import nn as _nn
from ...ops import kernels as _kernels
from ...ops import nn as _ops

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(HybridBlock):
    """Multi-head self-attention: ``block(x)`` with x (B, L, units) ->
    (B, L, units).

    impl:
      - 'dense': the plain PyTorch composition
      - 'flash': the streaming flash kernels (ops/kernels.py), which on a
        CUDA tensor are the hand-written CUDA kernels: K1 reads q, k, v as
        views of the qkv projection's output, and K2 writes the
        projection's gradient as one buffer (``flash_attention_qkv``)
      - 'ring' / 'auto': not ported yet (ROADMAP, sharding and ring
        attention)
    """

    def __init__(self, units, num_heads, impl="dense", causal=False,
                 use_bias=True, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if impl in ("ring", "auto"):
            raise NotImplementedError(
                f"MultiHeadAttention(impl={impl!r}) is not ported yet: see "
                "ROADMAP.md, Queue 1 item 6 'Sharded training and ring "
                "attention'")
        if impl not in ("dense", "flash"):
            raise ValueError(f"unknown impl {impl!r}")
        self._units = units
        self._heads = num_heads
        self._impl = impl
        self._causal = causal
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
        else:
            out = _ops.scaled_dot_product_attention(
                *_kernels._split_qkv(qkv, self._heads), causal=self._causal)
        b, h, l, d = out.shape
        # the tensor-core flash kernel writes O as (B, L, H, d) memory, so
        # this merge of the heads is a view there, not a copy
        return self.out_proj(out.transpose(1, 2).reshape(b, l, h * d))
