"""Paged decode attention, K4 of the port (``mxnet_tpu/ops/decode_attention.py``).

One query token per sequence slot attends over that slot's KV history,
which lies scattered across a shared page pool: ``k_pages``/``v_pages`` are
(P, page_size, H, D) and each slot owns an int32 page-table row (page 0 is
the scratch page). ``mxnet_tpu`` writes it as a ``fori_loop`` over blocks
of ``block_pages`` pages carrying online-softmax statistics (``:55``), not
as a ``pallas_call``; its block width is schedule-registered
(``mxnet_tpu/tune/schedule.py:366``). An int8 pool dequantizes on the
gather against fp32 scales per (page, slot, head), written by
:func:`kv_quantize`.

:func:`paged_decode_attention_reference` is the plain version: the
reference's page-block loop and its ``-1e30`` masking. The wrapper
:func:`paged_decode_attention` takes it only for tensors on the CPU; a CUDA
tensor launches ``csrc/paged_decode_attn.cu`` or raises. The kernel splits
each slot's pages over CTAs (the split count from the shapes and the card's
SM count only, never from ``lengths``, so a launch is capturable in a CUDA
graph) and combines the splits in a fixed order, so a second launch is
bitwise equal. ``block_pages`` shapes only the plain version's loop.

Rows of length 0 give zeros, in the kernel and the plain version. The
reference gives the mean of the V pages its table names there; its model
path never sends such a row (ROADMAP Queue 3, deliberate differences).
A table entry outside [0, P) is clamped into it, as JAX's gather clamps.

``paged_decode_attention.launches`` counts kernel launches, ticking where a
launch is enqueued (at a CUDA graph's warm-up runs and capture, never at a
replay); ``.launches_by_route`` splits them by the pool's dtype, "float32"
or "int8".
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "kv_quantize", "kv_dequantize", "decode_attn_block_pages",
           "decode_splits"]

_NEG = -1e30
DEFAULT_BLOCK_PAGES = 8      # mxnet_tpu/tune/schedule.py:88
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_DTYPES = (torch.float32, torch.int8)
_MAX_D = 256
_CTAS_PER_SM = 4             # the split rule's target CTAs per SM


def decode_attn_block_pages(pages, block_pages=None):
    """The plain version's page-block width: ``block_pages`` (default 8)
    legalized down to the largest divisor of ``pages`` at or under it, as
    ``mxnet_tpu``'s ``decode_attn_block_pages`` does with an empty schedule
    table. A fixed rule for now (ROADMAP Queue 1 item 13)."""
    pages = max(1, int(pages))
    bp = DEFAULT_BLOCK_PAGES if block_pages is None else int(block_pages)
    bp = max(1, min(bp, pages))
    while pages % bp:
        bp -= 1
    return bp


def kv_quantize(x):
    """Symmetric int8 quantization of K or V rows: ``x`` (..., D) ->
    (int8 values, fp32 scales (...,)), one scale per row. The scale is
    ``amax / 127`` computed in x's dtype (a 16-bit input rounds it there
    before the cast to fp32, as ``mxnet_tpu`` does), 1 for an all-zero row;
    values round half to even and clip to +-127."""
    amax = x.abs().amax(dim=-1)
    # a true division by a tensor (a CUDA division by a Python scalar
    # multiplies by its reciprocal)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale):
    """Inverse of :func:`kv_quantize`, in fp32."""
    return q.float() * scale[..., None]


def _check(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales):
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"paged_decode_attention: {name} must be a "
                            f"tensor, got {type(x).__name__}")
    if q.dim() != 3 or q.dtype not in _Q_DTYPES:
        raise ValueError(f"paged_decode_attention: q must be (B, H, D) in "
                         f"float32, bfloat16 or float16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, h, d = q.shape
    if min(b, h, d) < 1 or d > _MAX_D:
        raise ValueError(f"paged_decode_attention: unsupported q shape "
                         f"{tuple(q.shape)} (non-empty, D <= {_MAX_D})")
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (h, d) or \
            v_pages.shape != k_pages.shape or k_pages.shape[0] < 1 or \
            k_pages.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: pages must both be "
                         f"(P, page_size, {h}, {d}), got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if k_pages.dtype not in _KV_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_decode_attention: pages must be float32 or "
                         f"int8, both alike (got {k_pages.dtype}, "
                         f"{v_pages.dtype})")
    quantized = k_pages.dtype == torch.int8
    if quantized:
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            if not isinstance(s, torch.Tensor) or s.dtype != torch.float32 \
                    or tuple(s.shape) != tuple(k_pages.shape[:3]):
                raise ValueError(
                    f"paged_decode_attention: an int8 pool needs {name} as "
                    f"float32 {tuple(k_pages.shape[:3])}")
    elif k_scales is not None or v_scales is not None:
        raise ValueError("paged_decode_attention: scales go with an int8 "
                         "pool only")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            page_table.shape[1] < 1 or page_table.dtype != torch.int32:
        raise ValueError(f"paged_decode_attention: page_table must be int32 "
                         f"({b}, max_pages), got {tuple(page_table.shape)} "
                         f"{page_table.dtype}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"paged_decode_attention: lengths must be int32 "
                         f"({b},), got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    devs = {x.device for x in (q, k_pages, v_pages, page_table, lengths)}
    if quantized:
        devs |= {k_scales.device, v_scales.device}
    if len(devs) != 1:
        raise ValueError("paged_decode_attention: operands lie on different "
                         f"devices {sorted(map(str, devs))}")


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, scale=None, block_pages=None,
                                     k_scales=None, v_scales=None):
    """The plain version of K4: ``mxnet_tpu``'s page-block loop. Blocks of
    ``block_pages`` table entries are gathered (int8 dequantized against
    its scales), positions at or beyond a row's length are masked to
    -1e30, and each block is folded into running max, sum and accumulator
    in f32. Rows of length 0 give zeros. Returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    page_size = k_pages.shape[1]
    max_pages = page_table.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    bp = decode_attn_block_pages(max_pages, block_pages)
    quantized = k_pages.dtype == torch.int8
    table = page_table.long().clamp(0, k_pages.shape[0] - 1)
    lengths = lengths.long()
    qf = q.float()

    def gather(pages, scales, tbl):
        slab = pages[tbl]                     # (B, bp, page_size, H, D)
        if quantized:
            slab = slab.float() * scales[tbl][..., None]
        return slab.float().reshape(b, bp * page_size, h, d)

    m = torch.full((b, h), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for i in range(max_pages // bp):
        tbl = table[:, i * bp:(i + 1) * bp]
        k = gather(k_pages, k_scales, tbl)
        v = gather(v_pages, v_scales, tbl)
        sc = torch.einsum("bhd,bkhd->bhk", qf, k) * s
        pos = i * bp * page_size + torch.arange(bp * page_size,
                                                device=q.device)
        dead = pos[None, :] >= lengths[:, None]            # (B, K)
        sc = torch.where(dead[:, None, :], _NEG, sc)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhk,bkhd->bhd", p, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((lengths > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(batch, max_pages, sm_count):
    """(splits, pages per split) for the kernel: enough CTAs (batch x
    splits) for ``_CTAS_PER_SM`` on each SM, every split holding the same
    number of table entries. From the shapes and the SM count only, so a
    captured launch fits every later ``lengths``."""
    want = max(1, min(max_pages, -(-_CTAS_PER_SM * sm_count // batch)))
    per = -(-max_pages // want)
    return -(-max_pages // per), per


def _library():
    lib = _build.load("paged_decode_attn")
    fn = lib.paged_decode_attn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [ctypes.c_longlong] * 2 + [i] * 9 + \
            [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.paged_decode_attn_error_string.argtypes = [i]
        lib.paged_decode_attn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pages, v_pages, page_table, lengths, scale, k_scales,
            v_scales):
    """K4 on q (unit stride in D; any batch and head strides), contiguous
    pages, table and lengths; returns contiguous (B, H, D) in q's dtype."""
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous on CUDA (the kernel reads the "
                             "pool in place)")
    if q.stride(2) != 1:
        q = q.contiguous()
    lib = _library()
    b, h, d = q.shape
    n_pool, page_size = k_pages.shape[:2]
    max_pages = page_table.shape[1]
    splits, per = decode_splits(b, max_pages, _sm_count(q.device.index or 0))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    work = torch.empty((b, splits, h, d + 2), dtype=torch.float32,
                       device=q.device)
    quantized = k_pages.dtype == torch.int8
    ks = k_scales.data_ptr() if quantized else None
    vs = v_scales.data_ptr() if quantized else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr(), q.stride(0), q.stride(1), b, h, d, n_pool,
            page_size, max_pages, splits, per, _Q_DTYPES[q.dtype] +
            (4 if quantized else 0), float(scale), stream)
    if err:
        raise MXNetError("paged_decode_attn launch failed: "
                         f"{lib.paged_decode_attn_error_string(err).decode()}"
                         f" (error {err})")
    route = "int8" if quantized else "float32"
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_route[route] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, block_pages=None, k_scales=None,
                           v_scales=None):
    """Single-token attention over paged KV state.

    q (B, H, D) float32/bfloat16/float16, D <= 256; k_pages, v_pages (P,
    page_size, H, D) float32, or int8 with ``k_scales``/``v_scales`` (P,
    page_size, H) float32; page_table (B, max_pages) int32, each row
    mapping a slot's logical pages to pool pages; lengths (B,) int32, the
    valid KV tokens of each slot (positions at or beyond it are masked;
    0 gives zeros). ``scale`` defaults to 1/sqrt(D). Returns (B, H, D) in
    q's dtype, with the softmax and accumulation in f32. The table and
    lengths are runtime operands, read on the device."""
    _check(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k_pages, v_pages, page_table, lengths, s,
                       k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, scale=s,
            block_pages=block_pages, k_scales=k_scales, v_scales=v_scales)
    raise ValueError(f"paged_decode_attention: unsupported device "
                     f"{q.device}")


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_route = {"float32": 0, "int8": 0}
