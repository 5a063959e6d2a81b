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

A fixed rule, :func:`_decode_route`, picks the kernel: an int8 pool whose
pages the copy engine can move (16-byte-aligned tensors, and a shape that
the kernel's own geometry query, :func:`_int8_geometry`, accepts: D a
multiple of 16 up to 128, a page's scales a multiple of 16 bytes, a ring
of pages that fits in shared memory) takes
``csrc/paged_decode_attn_int8.cu``, route "int8_bulk": whole pages by
``cp.async.bulk`` into a ring of stages, 16-byte reads a lane, with its own
split rule (:func:`int8_splits`: a row's pages dealt round-robin over the
splits); every other int8 pool takes
``csrc/paged_decode_attn.cu``'s int8 instance, route "int8", and every f32
pool its f32 one, route "float32".

The int8 write, :func:`kv_quantize_write`, quantizes one layer's K and V
rows and scatters them and their scales into the pool in one launch of
``csrc/kv_quantize_write.cu``, bitwise equal to its plain version
:func:`kv_quantize_write_reference` (:func:`kv_quantize` and two
``index_put_`` for each of K and V).

``paged_decode_attention.launches`` counts kernel launches, ticking where a
launch is enqueued (at a CUDA graph's warm-up runs and capture, never at a
replay); ``.launches_by_route`` splits them by route, "float32", "int8"
or "int8_bulk". ``kv_quantize_write.launches`` counts the write's.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "kv_quantize", "kv_dequantize", "kv_quantize_write",
           "kv_quantize_write_reference", "decode_attn_block_pages",
           "decode_splits", "int8_splits"]

_NEG = -1e30
DEFAULT_BLOCK_PAGES = 8      # mxnet_tpu/tune/schedule.py:88
# the kernels' codes for q (and for k and v of the int8 write)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_DTYPES = (torch.float32, torch.int8)
_MAX_D = 256
_CTAS_PER_SM = 4             # the split rule's target CTAs per SM
# route "int8_bulk" (csrc/paged_decode_attn_int8.cu): its split rule's
# target CTAs per SM, measured best of 1, 2, 4 at the slice's shape
# (tools/torch_k4_variants.py); its geometry comes from its source
_INT8_CTAS_PER_SM = 1


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


def int8_splits(batch, max_pages, sm_count):
    """Splits of route "int8_bulk": as many CTAs (batch x splits) as
    ``_INT8_CTAS_PER_SM`` on each SM hold at once, at most one split a
    table entry. Split s takes a row's entries s, s + splits, ..., so the
    live pages of a row of any length spread over all of them. From the
    shapes and the SM count only, so a captured launch fits every later
    ``lengths``."""
    return max(1, min(max_pages, _INT8_CTAS_PER_SM * sm_count // batch))


@functools.lru_cache(maxsize=None)
def _int8_geometry(heads, d, page_size):
    """Route "int8_bulk"'s geometry at this shape, from its source
    (``paged_decode_attn_int8_geometry``): {"head_warps", "token_warps",
    "stages", "smem_bytes"} of a CTA, or None where the kernel does not
    take the shape (D not a multiple of 16 in [16, 128], a page's scales
    not a multiple of 16 bytes, more head warps than its consumers, a ring
    beyond shared memory). Builds the kernel's library on first use."""
    lib = _library("paged_decode_attn_int8")
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_longlong()]
    if lib.paged_decode_attn_int8_geometry(
            int(heads), int(d), int(page_size), *map(ctypes.byref, out)):
        return None
    return dict(zip(("head_warps", "token_warps", "stages", "smem_bytes"),
                    (x.value for x in out)))


def _decode_route(kv_dtype, d, heads, page_size, ptrs,
                  geometry=_int8_geometry):
    """Which K4 kernel takes a pool of ``kv_dtype`` with head dim ``d``,
    ``heads`` heads and pages of ``page_size`` tokens, whose K and V pages
    and scales start at the addresses ``ptrs``: "float32" for an f32 pool;
    "int8_bulk" (whole pages by bulk copy) for an int8 pool with
    16-byte-aligned addresses at a shape that ``geometry`` (the kernel's
    own query, :func:`_int8_geometry`) accepts; "int8" (one element a
    lane) for every other int8 pool. A fixed rule, not a fall-back: a
    failure of the chosen kernel raises."""
    if kv_dtype != torch.int8:
        return "float32"
    if any(p % 16 for p in ptrs) or geometry(heads, d, page_size) is None:
        return "int8"
    return "int8_bulk"


_SIGNATURES = {
    # K4 one element a lane: 9 pointers, 2 strides, 9 ints, scale, stream
    "paged_decode_attn": ["p"] * 9 + ["ll"] * 2 + ["i"] * 9 + ["f", "p"],
    # K4 "int8_bulk": the same but the pages per split
    "paged_decode_attn_int8": ["p"] * 9 + ["ll"] * 2 + ["i"] * 8 +
    ["f", "p"],
    # the int8 write: k and 3 strides, v and 3 strides, 6 pointers, 6
    # ints, stream
    "kv_quantize_write": ["p"] + ["ll"] * 3 + ["p"] + ["ll"] * 3 +
    ["p"] * 6 + ["i"] * 6 + ["p"],
}
_CTYPES = {"p": ctypes.c_void_p, "ll": ctypes.c_longlong, "i": ctypes.c_int,
           "f": ctypes.c_float}


def _library(name):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _call(name, *args):
    """Launch entry point ``name`` of its library; raises on a nonzero
    return."""
    lib = _library(name)
    err = getattr(lib, name)(*args)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise MXNetError(f"{name} launch failed: {msg} (error {err})")


def _launch(q, k_pages, v_pages, page_table, lengths, scale, k_scales,
            v_scales, route=None):
    """K4 on q (unit stride in D; any batch and head strides), contiguous
    pages, table and lengths; returns contiguous (B, H, D) in q's dtype.
    ``route`` defaults to :func:`_decode_route`'s; chip_smoke.py names
    "int8" to time the one-element-a-lane kernel on the pools that
    "int8_bulk" takes."""
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous on CUDA (the kernel reads the "
                             "pool in place)")
    if q.stride(2) != 1:
        q = q.contiguous()
    b, h, d = q.shape
    n_pool, page_size = k_pages.shape[:2]
    max_pages = page_table.shape[1]
    quantized = k_pages.dtype == torch.int8
    pool = (k_pages, v_pages, k_scales, v_scales) if quantized else ()
    if route is None:
        route = _decode_route(k_pages.dtype, d, h, page_size,
                              [x.data_ptr() for x in pool])
    sms = _sm_count(q.device.index or 0)
    if route == "int8_bulk":
        splits, per = int8_splits(b, max_pages, sms), None
    else:
        splits, per = decode_splits(b, max_pages, sms)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    work = torch.empty((b, splits, h, d + 2), dtype=torch.float32,
                       device=q.device)
    ks = k_scales.data_ptr() if quantized else None
    vs = v_scales.data_ptr() if quantized else None
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr(), q.stride(0), q.stride(1), b, h, d, n_pool,
            page_size, max_pages, splits)
    code = _Q_DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if per is None:
            _call("paged_decode_attn_int8", *args, code, float(scale),
                  stream)
        else:
            _call("paged_decode_attn", *args, per,
                  code + (4 if quantized else 0), float(scale), stream)
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
paged_decode_attention.launches_by_route = {"float32": 0, "int8": 0,
                                            "int8_bulk": 0}


def kv_quantize_write_reference(k_pages, v_pages, k_scales, v_scales, k, v,
                                page_idx, slot_idx):
    """The plain version of the int8 write: :func:`kv_quantize` of K and of
    V, then ``index_put_`` of the values and the scales at (page_idx,
    slot_idx), in place. Where two rows name the same (page, slot), either
    may win."""
    for pages, scales, x in ((k_pages, k_scales, k), (v_pages, v_scales, v)):
        qv, sc = kv_quantize(x)
        pages.index_put_((page_idx, slot_idx), qv)
        scales.index_put_((page_idx, slot_idx), sc)


def _check_write(k_pages, v_pages, k_scales, v_scales, k, v, page_idx,
                 slot_idx):
    tensors = (("k_pages", k_pages), ("v_pages", v_pages),
               ("k_scales", k_scales), ("v_scales", v_scales), ("k", k),
               ("v", v), ("page_idx", page_idx), ("slot_idx", slot_idx))
    for name, x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"kv_quantize_write: {name} must be a tensor, "
                            f"got {type(x).__name__}")
    if k.dim() != 3 or v.shape != k.shape or k.dtype not in _Q_DTYPES \
            or v.dtype != k.dtype or k.shape[2] > _MAX_D or k.numel() == 0:
        raise ValueError(f"kv_quantize_write: k and v must both be (N, H, "
                         f"D <= {_MAX_D}) in float32, bfloat16 or float16, "
                         f"got {tuple(k.shape)} {k.dtype} and "
                         f"{tuple(v.shape)} {v.dtype}")
    n, h, d = k.shape
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (h, d) or \
            v_pages.shape != k_pages.shape or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise ValueError(f"kv_quantize_write: pages must both be int8 (P, "
                         f"page_size, {h}, {d}), got {tuple(k_pages.shape)} "
                         f"{k_pages.dtype} and {tuple(v_pages.shape)} "
                         f"{v_pages.dtype}")
    for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if sc.dtype != torch.float32 or \
                tuple(sc.shape) != tuple(k_pages.shape[:3]):
            raise ValueError(f"kv_quantize_write: {name} must be float32 "
                             f"{tuple(k_pages.shape[:3])}, got "
                             f"{tuple(sc.shape)} {sc.dtype}")
    for name, ix in (("page_idx", page_idx), ("slot_idx", slot_idx)):
        if tuple(ix.shape) != (n,) or ix.dtype != torch.int64:
            raise ValueError(f"kv_quantize_write: {name} must be int64 "
                             f"({n},), got {tuple(ix.shape)} {ix.dtype}")
    devs = {x.device for _, x in tensors}
    if len(devs) != 1:
        raise ValueError("kv_quantize_write: operands lie on different "
                         f"devices {sorted(map(str, devs))}")


def _launch_write(k_pages, v_pages, k_scales, v_scales, k, v, page_idx,
                  slot_idx):
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scales", k_scales), ("v_scales", v_scales)):
        if not x.is_contiguous():
            raise ValueError(f"kv_quantize_write: {name} must be contiguous "
                             "on CUDA (the kernel writes the pool in place)")
    page_idx, slot_idx = page_idx.contiguous(), slot_idx.contiguous()
    n, h, d = k.shape
    n_pool, page_size = k_pages.shape[:2]
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        _call("kv_quantize_write", k.data_ptr(), *k.stride(), v.data_ptr(),
              *v.stride(), page_idx.data_ptr(), slot_idx.data_ptr(),
              k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
              v_scales.data_ptr(), n, h, d, n_pool, page_size,
              _Q_DTYPES[k.dtype], stream)
    kv_quantize_write.launches += 1


def kv_quantize_write(k_pages, v_pages, k_scales, v_scales, k, v, page_idx,
                      slot_idx):
    """Quantize one layer's K and V rows (N, H, D) as :func:`kv_quantize`
    does and write them, in place, into the int8 pages (P, page_size, H,
    D) at (page_idx, slot_idx) (int64 (N,)), their f32 scales into
    ``k_scales``/``v_scales`` (P, page_size, H). k and v are read through
    their strides (the qkv projection's views), in f32, bf16 or f16. A CUDA
    tensor launches ``csrc/kv_quantize_write.cu`` (one launch for K and V,
    bitwise equal to the plain version) or raises; a CPU tensor takes
    :func:`kv_quantize_write_reference`. Where two rows name the same
    (page, slot), either may win; a row outside the pool is dropped by the
    kernel (``index_put_`` raises on it)."""
    _check_write(k_pages, v_pages, k_scales, v_scales, k, v, page_idx,
                 slot_idx)
    if k.device.type == "cuda":
        _launch_write(k_pages, v_pages, k_scales, v_scales, k, v, page_idx,
                      slot_idx)
    elif k.device.type == "cpu":
        kv_quantize_write_reference(k_pages, v_pages, k_scales, v_scales, k,
                                    v, page_idx, slot_idx)
    else:
        raise ValueError(f"kv_quantize_write: unsupported device {k.device}")


kv_quantize_write.launches = 0
