"""Decoder-only transformer LM (subset of
``mxnet_tpu/gluon/model_zoo/transformer.py``).

Pre-norm residual blocks (ln -> attn -> +x; ln -> ff -> +x), a tanh-GELU
MLP, learned positional embeddings, causal attention, a final LayerNorm
and an untied head with a bias. Parameter names match ``mxnet_tpu`` letter
for letter (``tlm_blocks_transformerblock0_attn_qkv_weight`` ...). Unlike
the JAX package every layer is built with its input width, so the net is
whole at ``initialize``. ``impl`` is 'dense' or 'flash'.

The paged decode functions (``flat_forward``, ``paged_prefill``,
``paged_step``; ``mxnet_tpu/gluon/model_zoo/transformer.py:170-371``) run
the same math op for op over a flat parameter tuple in
:func:`decode_param_names` order, reading and writing the paged KV cache
that ``serving.DecodePredictor`` owns. Where ``mxnet_tpu`` returns new
cache arrays, the port writes the pages in place (``index_put_``, no
accumulation; masked and padded rows land on scratch page 0), so the
writes are idempotent and a CUDA graph's warm-up runs are harmless. The
prefill and the flat forward keep the reference's dense causal softmax; the
step calls :func:`ops.decode_attention.paged_decode_attention` (K4) once a
layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import nn
from ..block import HybridBlock
from ..contrib import nn as contrib_nn
from ...ops import math as _math
from ...parallel import tensor_parallel as _tp

__all__ = ["TransformerBlock", "TransformerLM", "transformer_lm",
           "decode_spec", "decode_param_names", "flat_forward",
           "paged_prefill", "paged_step"]


class TransformerBlock(HybridBlock):
    """One pre-norm decoder block: causal self-attention + GELU MLP.

    Inside a tensor parallelism context that names ``ff1``
    (``ShardedTrainer`` over a 'tp' axis), the MLP's first layer is
    column-parallel and its second row-parallel."""

    def __init__(self, units, num_heads, impl="dense", mesh=None,
                 sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        self._ffn = units * 4
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.attn = contrib_nn.MultiHeadAttention(
                units, num_heads, impl=impl, causal=True, mesh=mesh,
                sp_axis=sp_axis, prefix="attn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.ff1 = nn.Dense(self._ffn, activation="gelu",
                                flatten=False, in_units=units,
                                prefix="ff1_")
            self.ff2 = nn.Dense(units, flatten=False, in_units=self._ffn,
                                prefix="ff2_")

    def _tp_layers(self):
        """The FFN's (column, row) Dense pair, run tensor-parallel inside
        a tp context (``parallel.tensor_parallel``), and the width that tp
        must split."""
        return [(self.ff1, self.ff2, False, ("ffn width", self._ffn))]

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        tp = _tp.running(self.ff1)
        if tp is None:
            return x + self.ff2(self.ff1(self.ln2(x)))
        # this rank's columns of the hidden layer (gelu is elementwise),
        # its rows of the second product summed over the tp ranks
        h = self.ff1.act(_tp.column_parallel(self.ln2(x), self.ff1.weight,
                                             self.ff1.bias))
        return x + _tp.row_parallel(h, self.ff2.weight, self.ff2.bias)


class TransformerLM(HybridBlock):
    """Decoder-only LM: token+position embed -> blocks -> [norm] -> head.

    Input is (B, T) token ids; output is (B, T, vocab) logits. Under ring
    attention (an sp axis of n > 1 ranks) the input is this rank's (B,
    T_local) slice and the global length n * T_local is held to max_len.
    """

    def __init__(self, vocab, units, num_heads, num_layers, max_len=512,
                 impl="dense", mesh=None, sp_axis="sp", remat=None,
                 final_norm=True, **kwargs):
        super().__init__(**kwargs)
        self._max_len = max_len
        ring = impl in ("ring", "auto") and mesh is not None and \
            mesh.shape.get(sp_axis, 1) > 1
        self._sp = (mesh, sp_axis) if ring else None
        with self.name_scope():
            self.embed = nn.Embedding(vocab, units, prefix="embed_")
            self.pos = nn.Embedding(max_len, units, prefix="pos_")
            self.blocks = nn.HybridSequential(prefix="blocks_")
            with self.blocks.name_scope():
                for _ in range(num_layers):
                    blk = TransformerBlock(units, num_heads, impl=impl,
                                           mesh=mesh, sp_axis=sp_axis)
                    if remat is not None:
                        blk = contrib_nn.Remat(blk, policy=remat)
                    self.blocks.add(blk)
            self.norm = nn.LayerNorm(in_channels=units, prefix="norm_") \
                if final_norm else None
            self.head = nn.Dense(vocab, flatten=False, in_units=units,
                                 prefix="head_")

    def forward(self, x):
        t = x.shape[1]
        start, total = 0, t
        if self._sp is not None:
            mesh, axis = self._sp
            start = mesh.axis_index(axis) * t
            total = mesh.axis_size(axis) * t
        if total > self._max_len:
            raise ValueError(f"sequence length {total} exceeds max_len "
                             f"{self._max_len}")
        pos = _math.arange(start, start + t, dtype="int64", device=x.device)
        h = self.embed(x) + self.pos(pos)
        h = self.blocks(h)
        if self.norm is not None:
            h = self.norm(h)
        return self.head(h)


def transformer_lm(vocab=64, units=64, num_heads=2, num_layers=2,
                   max_len=512, impl="dense", mesh=None, sp_axis="sp",
                   remat=None, final_norm=True, **kwargs):
    """Factory with the JAX package's CI-sized defaults."""
    return TransformerLM(vocab, units, num_heads, num_layers,
                         max_len=max_len, impl=impl, mesh=mesh,
                         sp_axis=sp_axis, remat=remat,
                         final_norm=final_norm, **kwargs)


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


def _ln(x, gamma, beta):
    """LayerNorm over the last axis, biased variance, eps 1e-5, in x's
    dtype (a 16-bit mean and variance accumulate in f32 and round to it,
    as ``jnp.mean`` and ``jnp.var`` do)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * gamma + beta


def _dense(x, w, b):
    """x (..., in) against w (out, in), then + b: two ops, as the
    reference's dot_general and add."""
    return torch.matmul(x, w.t()) + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _split_qkv(qkv, num_heads):
    """(..., 3U) fused projection -> q, k, v views of (..., H, D), the
    channel layout of ``contrib.nn.MultiHeadAttention``."""
    u = qkv.shape[-1] // 3
    d = u // num_heads
    shape = tuple(qkv.shape[:-1]) + (num_heads, d)
    return (qkv[..., :u].reshape(shape), qkv[..., u:2 * u].reshape(shape),
            qkv[..., 2 * u:].reshape(shape))


def _page_scatter(kv, i, k, v, page_idx, slot_idx):
    """Write layer ``i``'s per-token K and V rows (N, H, D) into the cache
    ``kv`` (k_pages, v_pages (L, P, page_size, H, D), k_scales, v_scales)
    at (page_idx, slot_idx), in place. An int8 pool quantizes on write and
    updates its scales (L, P, page_size, H) through ``kv_quantize_write``:
    one kernel for K and V on the card, ``kv_quantize`` and ``index_put_``
    on the CPU."""
    k_pages, v_pages, k_scales, v_scales = kv
    if k_pages.dtype == torch.int8:
        from ...ops.decode_attention import kv_quantize_write

        kv_quantize_write(k_pages[i], v_pages[i], k_scales[i], v_scales[i],
                          k, v, page_idx, slot_idx)
    else:
        k_pages[i].index_put_((page_idx, slot_idx), k.to(k_pages.dtype))
        v_pages[i].index_put_((page_idx, slot_idx), v.to(v_pages.dtype))


def _block_params(params, i):
    base = 2 + i * len(_BLOCK_PARAM_SUFFIXES)
    return params[base:base + len(_BLOCK_PARAM_SUFFIXES)]


def _head_logits(params, spec, h):
    if spec["final_norm"]:
        h = _ln(h, params[-4], params[-3])
    return _dense(h, params[-2], params[-1])


def _embed(params, spec, tokens, pos_ids):
    """Token + position embeddings; out-of-range ids clamp, as JAX's gather
    does."""
    tokens = tokens.long().clamp(0, spec["vocab"] - 1)
    return params[0][tokens] + params[1][pos_ids.long()]


def _ffn(h, ln2_g, ln2_b, ff1_w, ff1_b, ff2_w, ff2_b):
    return h + _dense(_gelu(_dense(_ln(h, ln2_g, ln2_b), ff1_w, ff1_b)),
                      ff2_w, ff2_b)


def _dense_attention(q, k, v, causal, d):
    """Causal softmax attention, dense, in q's dtype: q, k, v (..., T, H,
    D) -> (..., T, H, D)."""
    # sqrt(D) in q's dtype and a true division, as the reference; a fill,
    # not a host copy, so the step captures in a CUDA graph
    root = torch.full((), float(d), dtype=q.dtype, device=q.device).sqrt()
    s = torch.einsum("...qhd,...khd->...hqk", q, k) / root
    s = s.masked_fill(~causal, -1e30)
    return torch.einsum("...hqk,...khd->...qhd", torch.softmax(s, dim=-1), v)


def flat_forward(params, spec, tokens):
    """Full-context forward over the flat parameter tuple: (B, T) int ids
    -> (B, T, vocab) logits, the math ``hybrid_forward`` runs (dense causal
    attention)."""
    b, t = tokens.shape
    heads = spec["num_heads"]
    d = spec["units"] // heads
    pos = torch.clamp(torch.arange(t, device=tokens.device),
                      max=spec["max_len"] - 1)
    h = _embed(params, spec, tokens, pos)
    causal = pos[:, None] >= pos[None, :]
    for i in range(spec["num_layers"]):
        (ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_g, ln2_b,
         ff1_w, ff1_b, ff2_w, ff2_b) = _block_params(params, i)
        q, k, v = _split_qkv(_dense(_ln(h, ln1_g, ln1_b), qkv_w, qkv_b),
                             heads)                   # (B, T, H, D)
        attn = _dense_attention(q, k, v, causal, d)
        h = h + _dense(attn.reshape(b, t, -1), out_w, out_b)
        h = _ffn(h, ln2_g, ln2_b, ff1_w, ff1_b, ff2_w, ff2_b)
    return _head_logits(params, spec, h)


def paged_prefill(params, spec, tokens, true_len, kv, page_row):
    """Run one prompt through the stack, writing each layer's K and V into
    the pages ``page_row`` maps, and return the last true token's logits
    (vocab,).

    ``tokens`` (1, T) int ids padded to the bucket; ``true_len`` (1,) int32
    on the device; ``kv`` the cache (k_pages, v_pages, k_scales, v_scales),
    each with the layer axis first, written in place; ``page_row``
    (max_pages,) int32 with unused entries on scratch page 0. Padded
    positions write the scratch page, and their keys are causally invisible
    to the true rows.
    """
    page_size = kv[0].shape[2]
    t = tokens.shape[1]
    heads = spec["num_heads"]
    d = spec["units"] // heads
    pos = torch.arange(t, device=tokens.device)
    live = pos < true_len[0]
    pos_ids = torch.clamp(pos, max=spec["max_len"] - 1)
    h = _embed(params, spec, tokens[0], pos_ids)      # (T, U)
    page_idx = torch.where(live, page_row.long()[pos // page_size], 0)
    slot_idx = pos % page_size
    causal = pos[:, None] >= pos[None, :]             # q >= k
    for i in range(spec["num_layers"]):
        (ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_g, ln2_b,
         ff1_w, ff1_b, ff2_w, ff2_b) = _block_params(params, i)
        q, k, v = _split_qkv(_dense(_ln(h, ln1_g, ln1_b), qkv_w, qkv_b),
                             heads)                   # (T, H, D)
        _page_scatter(kv, i, k, v, page_idx, slot_idx)
        attn = _dense_attention(q, k, v, causal, d)
        h = h + _dense(attn.reshape(t, -1), out_w, out_b)
        h = _ffn(h, ln2_g, ln2_b, ff1_w, ff1_b, ff2_w, ff2_b)
    last = h.index_select(0, (true_len[:1] - 1).long())[0]
    return _head_logits(params, spec, last)


def paged_step(params, spec, tokens, positions, active, kv, page_table):
    """ONE fixed-shape decode step for every sequence slot: embed each
    row's last token, append its K and V to the paged cache, attend over
    the row's pages through K4, and return (next greedy tokens (B,) int32,
    logits (B, vocab)).

    ``tokens``/``positions``/``active`` (B,) int32; ``kv`` the cache,
    written in place; ``page_table`` (B, max_pages) int32. Inactive rows
    write the scratch page and attend with length 1; the caller ignores
    their outputs. Membership, lengths and the table are runtime operands.
    """
    from ...ops.decode_attention import paged_decode_attention

    k_pages, v_pages, k_scales, v_scales = kv
    quantize = k_pages.dtype == torch.int8
    page_size = k_pages.shape[2]
    heads = spec["num_heads"]
    b = tokens.shape[0]
    pos_ids = torch.clamp(positions.long(), max=spec["max_len"] - 1)
    h = _embed(params, spec, tokens, pos_ids)         # (B, U)
    on = active > 0
    page_idx = torch.where(
        on, torch.gather(page_table.long(), 1,
                         (pos_ids // page_size)[:, None])[:, 0], 0)
    slot_idx = pos_ids % page_size
    lengths = torch.where(on, positions + 1, 1).to(torch.int32)
    for i in range(spec["num_layers"]):
        (ln1_g, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_g, ln2_b,
         ff1_w, ff1_b, ff2_w, ff2_b) = _block_params(params, i)
        q, k, v = _split_qkv(_dense(_ln(h, ln1_g, ln1_b), qkv_w, qkv_b),
                             heads)                   # (B, H, D)
        _page_scatter(kv, i, k, v, page_idx, slot_idx)
        attn = paged_decode_attention(
            q, k_pages[i], v_pages[i], page_table, lengths,
            k_scales=k_scales[i] if quantize else None,
            v_scales=v_scales[i] if quantize else None)
        h = h + _dense(attn.reshape(b, -1), out_w, out_b)
        h = _ffn(h, ln2_g, ln2_b, ff1_w, ff1_b, ff2_w, ff2_b)
    logits = _head_logits(params, spec, h)            # (B, vocab)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits
