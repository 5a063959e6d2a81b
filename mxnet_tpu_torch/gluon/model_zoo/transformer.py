"""Decoder-only transformer LM (subset of
``mxnet_tpu/gluon/model_zoo/transformer.py``).

Pre-norm residual blocks (ln -> attn -> +x; ln -> ff -> +x), a tanh-GELU
MLP, learned positional embeddings, causal attention, a final LayerNorm
and an untied head with a bias. Parameter names match ``mxnet_tpu`` letter
for letter (``tlm_blocks_transformerblock0_attn_qkv_weight`` ...). Unlike
the JAX package every layer is built with its input width, since the port
has no deferred initialization. ``impl`` is 'dense' or 'flash'; the paged
decode functions come with the decode slice.
"""
from __future__ import annotations

from .. import nn
from ..block import HybridBlock
from ..contrib import nn as contrib_nn
from ...ops import math as _math

__all__ = ["TransformerBlock", "TransformerLM", "transformer_lm",
           "decode_spec", "decode_param_names"]


class TransformerBlock(HybridBlock):
    """One pre-norm decoder block: causal self-attention + GELU MLP."""

    def __init__(self, units, num_heads, impl="dense", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.attn = contrib_nn.MultiHeadAttention(
                units, num_heads, impl=impl, causal=True, prefix="attn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.ff1 = nn.Dense(units * 4, activation="gelu",
                                flatten=False, in_units=units,
                                prefix="ff1_")
            self.ff2 = nn.Dense(units, flatten=False, in_units=units * 4,
                                prefix="ff2_")

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ff2(self.ff1(self.ln2(x)))


class TransformerLM(HybridBlock):
    """Decoder-only LM: token+position embed -> blocks -> [norm] -> head.

    Input is (B, T) token ids; output is (B, T, vocab) logits.
    """

    def __init__(self, vocab, units, num_heads, num_layers, max_len=512,
                 impl="dense", final_norm=True, **kwargs):
        super().__init__(**kwargs)
        self._max_len = max_len
        with self.name_scope():
            self.embed = nn.Embedding(vocab, units, prefix="embed_")
            self.pos = nn.Embedding(max_len, units, prefix="pos_")
            self.blocks = nn.HybridSequential(prefix="blocks_")
            with self.blocks.name_scope():
                for _ in range(num_layers):
                    self.blocks.add(TransformerBlock(units, num_heads,
                                                     impl=impl))
            self.norm = nn.LayerNorm(in_channels=units, prefix="norm_") \
                if final_norm else None
            self.head = nn.Dense(vocab, flatten=False, in_units=units,
                                 prefix="head_")

    def forward(self, x):
        t = x.shape[1]
        if t > self._max_len:
            raise ValueError(f"sequence length {t} exceeds max_len "
                             f"{self._max_len}")
        pos = _math.arange(0, t, dtype="int64", device=x.device)
        h = self.embed(x) + self.pos(pos)
        h = self.blocks(h)
        if self.norm is not None:
            h = self.norm(h)
        return self.head(h)


def transformer_lm(vocab=64, units=64, num_heads=2, num_layers=2,
                   max_len=512, impl="dense", final_norm=True, **kwargs):
    """Factory with the JAX package's CI-sized defaults."""
    return TransformerLM(vocab, units, num_heads, num_layers,
                         max_len=max_len, impl=impl, final_norm=final_norm,
                         **kwargs)


# canonical per-block parameter suffix order (matches name_scope output)
_BLOCK_PARAM_SUFFIXES = (
    "ln1_gamma", "ln1_beta", "attn_qkv_weight", "attn_qkv_bias",
    "attn_out_weight", "attn_out_bias", "ln2_gamma", "ln2_beta",
    "ff1_weight", "ff1_bias", "ff2_weight", "ff2_bias")


def decode_spec(net):
    """Static decode identity of an initialized :class:`TransformerLM`:
    the shape facts a decode program specializes on."""
    blocks = list(net.blocks)
    for blk in blocks:
        if not isinstance(blk, TransformerBlock):
            raise ValueError(
                "decode_spec: TransformerLM blocks must be plain "
                f"TransformerBlock (got {type(blk).__name__})")
    vocab, units = net.embed.weight.shape
    return {
        "vocab": int(vocab), "units": int(units),
        "num_heads": int(blocks[0].attn._heads),
        "num_layers": len(blocks), "max_len": int(net._max_len),
        "final_norm": net.norm is not None,
    }


def decode_param_names(spec, names):
    """Order parameter names (``collect_params()`` keys) into the flat
    layout: embed, pos, per-block suffixes, [final norm,] head. Matching is
    by unambiguous name suffix, so the gensym block prefix never matters."""
    names = list(names)

    def find(suffix):
        hits = [n for n in names if n.endswith(suffix)]
        if len(hits) != 1:
            raise ValueError(
                f"decode_param_names: expected exactly one param ending "
                f"'{suffix}', found {hits or 'none'}")
        return hits[0]

    ordered = [find("embed_weight"), find("pos_weight")]
    for i in range(spec["num_layers"]):
        blk = f"block{i}_"
        for suffix in _BLOCK_PARAM_SUFFIXES:
            ordered.append(find(blk + suffix))
    if spec["final_norm"]:
        ordered += [find("norm_gamma"), find("norm_beta")]
    ordered += [find("head_weight"), find("head_bias")]
    return ordered
