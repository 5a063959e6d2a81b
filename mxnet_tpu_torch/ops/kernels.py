"""Hand-written kernels of the port and their plain PyTorch versions.

K1, the flash-attention forward, replaces the TPU kernel
``mxnet_tpu/ops/pallas_kernels.py:_mha_kernel`` (built by ``_build_flash``,
entered through ``flash_attention``). It has three CUDA sources, chosen by
the fixed rule of :func:`_flash_route`: ``csrc/flash_attn_fwd_tc.cu`` on
the tensor cores (wgmma + TMA; 16-bit, D 64 or 128, any 16-byte-aligned
layout with a unit-stride D), ``csrc/flash_attn_fwd_tf32x3.cu`` on the
tensor cores in fp32 as 3xTF32 (route "tf32x3": f32 operands split into
TF32 hi and lo parts, three wgmma passes; D 64 or 128, the same layouts)
and ``csrc/flash_attn_fwd.cu`` on the CUDA cores (everything else, after
``.contiguous()``).

K3, the fused 3x3 conv + BatchNorm statistics, replaces the TPU kernel
``mxnet_tpu/ops/pallas_kernels.py:conv3x3_bn_stats``, and
:func:`conv3x3_bn_relu_train` is its trainable wrapper. It has three CUDA
sources, chosen by the fixed rule of :func:`_conv_route`:
``csrc/conv3x3_bn_stats_tc.cu`` on the tensor cores (wgmma + TMA im2col;
16-bit, Cin and Cout multiples of 64, tiles from :func:`_conv_tiles`),
``csrc/conv3x3_bn_stats_tf32x3.cu`` on the tensor cores in fp32 as 3xTF32
(route "tf32x3": the same im2col loads, A split into TF32 hi and lo in
registers, w packed into TF32 hi and lo K-major panels by a pre-pass; Cin
a multiple of 32, Cout of 64) and ``csrc/conv3x3_bn_stats.cu`` on the CUDA
cores (everything else). The three share the statistics' fixed-order
second pass (``csrc/bn_stats.cuh``). Each source's header says what bounds
it on the H100 and how it is laid out.

K2, the flash-attention backward, replaces
``mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_blockwise`` (a ``lax.scan``
there), behind :func:`flash_attention_backward`. It has three CUDA
sources, chosen by the fixed rule of :func:`_flash_bwd_route`:
``csrc/flash_attn_bwd_tc.cu`` on the tensor cores (wgmma + TMA; 16-bit, D
64 or 128, 16-byte-aligned rows; dq, dk, dv written through their own
strides), ``csrc/flash_attn_bwd_tf32x3.cu`` (route "tf32x3": fp32 as
3xTF32 on wgmma + TMA, the same layouts) and ``csrc/flash_attn_bwd.cu``
on the CUDA cores (everything else). :class:`_FlashAttention` pairs it with K1 as one
``torch.autograd.Function``, entered through
:func:`flash_attention_with_grad` and :func:`flash_attention_with_lse`;
:class:`_FlashAttentionQKV` does the same over the qkv projection's packed
output (:func:`flash_attention_qkv`, the LM's path), so that K2 writes the
projection's gradient as one buffer.

Each wrapper (:func:`flash_attention`, :func:`flash_attention_backward`,
:func:`conv3x3_bn_stats`) takes its plain version (``*_reference``) only
for tensors on the CPU. For a CUDA tensor it launches the kernel or
raises: a build or launch failure is an error, never a quiet fall-back.
``<wrapper>.launches`` counts kernel launches, and nothing else;
``<wrapper>.launches_by_route`` splits the count by route.

The counters tick where a launch is enqueued. Under a CUDA graph
(:mod:`mxnet_tpu_torch.capture`) that is during the warm-up runs and once
in the capture; a replay launches the graph's kernel nodes without passing
through a wrapper, so it adds nothing: count a graph's nodes
(``CapturedExec.debug_dump``) for what a replay runs. Every wrapper
launches on ``torch.cuda.current_stream()``, allocates its outputs and
scratch with ``torch.empty``, and never synchronises or reads device
memory on the host, so each captures as it is; the tensor maps of the
tensor-core kernels go to the kernel by value, so a captured launch keeps
its tensors' addresses, which the captured program's key holds fixed.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_attention_with_grad", "flash_attention_with_lse",
           "flash_attention_qkv", "conv3x3_bn_stats",
           "conv3x3_bn_stats_reference", "conv3x3_bn_relu_train",
           "tf32_split_reference", "conv_weight_tf32x3_pack_reference"]

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT32 = (-2 ** 31, 2 ** 31 - 1)


def _check(q, k, v, q_offset, k_offset):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a tensor, "
                            f"got {type(x).__name__}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, T, D), got "
                         f"shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: unsupported shape — q {tuple(q.shape)} vs k "
            f"{tuple(k.shape)} / v {tuple(v.shape)} (self-attention only)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype} "
                         "(float32, bfloat16 or float16)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    b, h, t, d = q.shape
    if min(b, h, t, d) < 1 or d > 256:
        raise ValueError(f"flash_attention: unsupported shape "
                         f"{tuple(q.shape)} (needs non-empty dims, D <= 256)")
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not _INT32[0] <= int(off) <= _INT32[1]:
            raise ValueError(f"flash_attention: {name}={off} is outside "
                             "int32")


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              return_lse=False, q_offset=0, k_offset=0):
    """The plain version of K1: dense f32 attention with the kernel's
    masking, offsets and lse guard. q, k, v (B, H, T, D); returns O in the
    input dtype (and lse (B, H, T, 1) in f32 with ``return_lse``).

    Key j is visible to query i when ``q_offset + i >= k_offset + j`` (under
    ``causal``). A row with no visible key gives O = 0 and
    lse = -1e30 + log(1e-20), the kernel's definition.
    """
    t, d, dtype = q.shape[-2], q.shape[-1], q.dtype
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    # contiguous operands, so that the products take one BLAS layout
    # whatever the callers' strides (the LM's q/k/v are views): strided
    # and contiguous inputs then give bitwise equal results
    q, k, v = (x.float().contiguous() for x in (q, k, v))
    logits = torch.matmul(q * s, k.transpose(-1, -2))
    if causal:
        pos = torch.arange(t, device=q.device)
        visible = (q_offset + pos)[:, None] >= (k_offset + pos)[None, :]
        logits = logits.masked_fill(~visible, float("-inf"))
    # the kernel's running max starts at -1e30, so a row with no visible
    # key keeps m = -1e30 and every exp(-inf - m) is exactly 0
    m = logits.amax(dim=-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = (torch.matmul(p, v) / l).to(dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


_TC_MAX_T = 65535 * 128      # the tensor-core grid's Q tiles, 128 rows each
_TF32_MAX_T = 65535 * 64     # the 3xTF32 grids' tiles, at least 64 rows each


def _tma_layout(strides, ptrs, elems):
    """Whether operands given by their (B, H, T, D) element strides and
    base addresses can be read by TMA in place: unit stride in D, every
    other stride a positive multiple of ``elems`` elements (16 bytes) and
    16-byte-aligned bases."""
    for st in strides:
        if st[3] != 1 or any(x <= 0 or x % elems for x in st[:3]):
            return False
    return all(p % 16 == 0 for p in ptrs)


def _flash_route(dtype, d, strides, ptrs, t):
    """Which K1 kernel takes these inputs (q, k, v given by their (B, H,
    T, D) element strides and base addresses): "tc" (tensor cores) for
    bf16 or fp16, "tf32x3" (tensor cores, 3xTF32) for fp32, each with D of
    64 or 128, unit stride in D, every other stride a positive multiple of
    16 bytes (8 or 4 elements), 16-byte-aligned bases and T up to its
    grid's limit (65535 * 128, 65535 * 64); "simt" (CUDA cores, contiguous
    copies) for everything else. A fixed rule, not a fall-back: a failure
    of the chosen kernel raises."""
    if d not in (64, 128):
        return "simt"
    if dtype in (torch.bfloat16, torch.float16):
        ok = t <= _TC_MAX_T and _tma_layout(strides, ptrs, 8)
        return "tc" if ok else "simt"
    if dtype == torch.float32:
        ok = t <= _TF32_MAX_T and _tma_layout(strides, ptrs, 4)
        return "tf32x3" if ok else "simt"
    return "simt"


def tf32_split_reference(x):
    """The plain version of the 3xTF32 kernels' operand split: f32 x as
    (hi, lo), hi = x rounded to TF32 (10 mantissa bits, the low 13 bits
    zero) to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds, and lo = the same rounding of x - hi (exact in f32). hi + lo
    holds x to within ~2^-22 of |x|; a product a b is taken as
    lo_a hi_b + hi_a lo_b + hi_a hi_b. Used by the tests and chip_smoke.py
    to emulate the kernels' products on the CPU."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        rounded = (bits + 0x1000) & -0x2000
        special = (bits & 0x7F800000) == 0x7F800000   # inf, nan: kept
        return torch.where(special, bits, rounded).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _tma_strides(x):
    """x's (B, H, T) element strides for a tensor map; a size-1 dim, whose
    stride never matters, takes its contiguous stride so that it meets the
    map's rules."""
    contiguous = (x.shape[1] * x.shape[2] * x.shape[3],
                  x.shape[2] * x.shape[3], x.shape[3])
    return tuple(c if n == 1 else s for n, s, c in
                 zip(x.shape[:3], x.stride()[:3], contiguous))


def _library():
    lib = _build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [i]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


# route -> the tensor-core K1 and K2 entry points; each library also
# exports "<entry>_error_string", and a route's two entries share one C
# signature (the dtype code included)
_TC_ENTRY = {"tc": ("flash_attn_fwd_tc", "flash_attn_bwd_tc"),
             "tf32x3": ("flash_attn_fwd_tf32x3", "flash_attn_bwd_tf32x3")}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TC_ARGS = ([_P] * 5 + [_I] * 4 + [_P, _I, _F, _I, _I, _I, _P],
            [_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _P])


def _bind(lib, name, argtypes):
    """``lib``'s entry point ``name`` and its ``name``_error_string,
    typed once."""
    fn, why = getattr(lib, name), getattr(lib, name + "_error_string")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        why.argtypes, why.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, why


def _tc_library(route):
    """The library of K1's tensor-core kernel for ``route``."""
    return _build.load(_TC_ENTRY[route][0])


def _launch_tc(q, k, v, causal, scale, q_offset, k_offset, route="tc"):
    """A tensor-core K1 (``route`` "tc", or "tf32x3" for fp32) on q, k, v
    as they lie (strided views welcome). O is written into (B, T, H, D)
    memory and returned as its (B, H, T, D) view, so merging the heads
    afterwards is free."""
    name = _TC_ENTRY[route][0]
    fn, why = _bind(_tc_library(route), name, _TC_ARGS[0])
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *(s for x in (q, k, v) for s in _tma_strides(x)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, t, d, strides, _DTYPE_CODE[q.dtype],
                 float(scale), int(bool(causal)), int(q_offset),
                 int(k_offset), stream)
    if err:
        raise MXNetError(f"{name} launch failed: {why(err).decode()} "
                         f"(error {err})")
    return out.transpose(1, 2), lse


def _launch_simt(q, k, v, causal, scale, q_offset, k_offset):
    """The CUDA-core K1 on contiguous q, k, v."""
    lib = _library()
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, t, d, _DTYPE_CODE[q.dtype], float(scale),
            int(bool(causal)), int(q_offset), int(k_offset), stream)
    if err:
        raise MXNetError("flash_attn_fwd launch failed: "
                         f"{lib.flash_attn_error_string(err).decode()} "
                         f"(cudaError {err})")
    return out, lse


def _launch(q, k, v, causal, scale, q_offset, k_offset):
    qkv = (q, k, v)
    route = _flash_route(q.dtype, q.shape[-1],
                         [_tma_strides(x) + (x.stride(3),) for x in qkv],
                         [x.data_ptr() for x in qkv], q.shape[2])
    if route in ("tc", "tf32x3"):
        out, lse = _launch_tc(q, k, v, causal, scale, q_offset, k_offset,
                              route)
    else:
        out, lse = _launch_simt(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, scale, q_offset,
                                k_offset)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False,
                    q_offset=0, k_offset=0):
    """Fused attention forward: q, k, v (B, H, T, D) -> O (B, H, T, D), plus
    the per-row log-sum-exp (B, H, T, 1) in f32 with ``return_lse``.

    ``q_offset``/``k_offset`` place the Q rows and K/V rows in a larger
    global sequence for causal masking (the ring-attention hop case).
    ``scale`` defaults to 1/sqrt(D). Self-attention shapes only, D <= 256,
    float32/bfloat16/float16; any T and any strides. On CUDA,
    :func:`_flash_route` picks the kernel; on its tensor-core routes ("tc",
    "tf32x3") O is the (B, H, T, D) view of (B, T, H, D) memory.
    """
    _check(q, k, v, q_offset, k_offset)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, s, q_offset, k_offset)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(
            q, k, v, causal=causal, scale=s, return_lse=True,
            q_offset=q_offset, k_offset=k_offset)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_route = {"tc": 0, "tf32x3": 0, "simt": 0}


# ----------------------------------------------------------------------- K2
def _check_bwd(q, k, v, out, lse, dout, dlse, q_offset, k_offset):
    _check(q, k, v, q_offset, k_offset)
    for name, x in (("out", out), ("dout", dout)):
        if not isinstance(x, torch.Tensor) or x.shape != q.shape or \
                x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} must be a "
                             f"{q.dtype} tensor of q's shape "
                             f"{tuple(q.shape)} on {q.device}")
    want = tuple(q.shape[:3]) + (1,)
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is None and name == "dlse":
            continue
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != want or \
                not x.is_floating_point() or x.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} must be a "
                             f"float tensor of shape {want} on {q.device}")
    if lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: lse must be float32 "
                         "(K1's row log-sum-exp)")
    if q.shape[0] * q.shape[1] * q.shape[2] > _INT32[1]:
        raise ValueError(f"flash_attention_backward: {tuple(q.shape)} "
                         "exceeds the kernel's int32 row indexing")


def flash_attention_backward_reference(q, k, v, out, lse, dout, causal=False,
                                       scale=None, dlse=None, q_offset=0,
                                       k_offset=0):
    """The plain version of K2, after ``_flash_bwd_blockwise``: P
    recomputed from the saved ``lse`` (exactly 0 where a key is masked,
    by K1's rule), ``D = rowsum(dO * O) - dlse``, ``ds = p * (dp - D)``,
    then ``dq = ds k scale``, ``dk = ds^T q scale``, ``dv = p^T dO``; all
    in f32, the results cast to the input dtype. A row that sees no key
    has p = 0, so its dq is 0 and it adds nothing to dk or dv."""
    t, d = q.shape[-2], q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    delta = (do32 * out.float()).sum(dim=-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float()
    logits = torch.matmul(q32, k32.transpose(-1, -2)) * s
    if causal:
        pos = torch.arange(t, device=q.device)
        visible = (q_offset + pos)[:, None] >= (k_offset + pos)[None, :]
        logits = logits.masked_fill(~visible, float("-inf"))
    p = torch.exp(logits - lse)
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k32) * s
    dk = torch.matmul(ds.transpose(-1, -2), q32) * s
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_library():
    lib = _build.load("flash_attn_bwd")
    fn = lib.flash_attn_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attn_bwd_error_string.argtypes = [i]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_tc_library(route):
    """The library of K2's tensor-core kernel for ``route``."""
    return _build.load(_TC_ENTRY[route][1])


_BWD_TC_ROWS = 128           # lse and delta rows are padded to this
_BWD_TC_MAX_T = 65535 * 64   # the grids' tiles, at least 64 rows each


def _flash_bwd_route(dtype, d, strides, ptrs, t):
    """Which K2 kernel takes these operands (q, k, v, O, dO, given as for
    :func:`_flash_route`): K1's rule for its tensor-core kernels -- "tc"
    (wgmma + TMA) for bf16 or fp16, "tf32x3" (3xTF32 on wgmma + TMA) for
    fp32, each with D of 64 or 128, unit stride in D, every other stride a
    positive multiple of 16 bytes, 16-byte-aligned bases -- and T up to
    65535 * 64; "simt" (CUDA cores) for everything else. A fixed rule, not
    a fall-back."""
    if t > _BWD_TC_MAX_T:
        return "simt"
    return _flash_route(dtype, d, strides, ptrs, t)


def _check_grads(grads, q):
    """``grads`` (dq, dk, dv) to write into: tensors of q's shape, dtype
    and device with unit stride in D and 4-byte-aligned rows."""
    if len(grads) != 3:
        raise ValueError("flash_attention_backward: grads must hold dq, dk "
                         "and dv")
    for g in grads:
        if not isinstance(g, torch.Tensor) or g.shape != q.shape or \
                g.dtype != q.dtype or g.device != q.device or \
                g.stride(3) != 1 or any(st % 2 for st in g.stride()[:3]) \
                or g.data_ptr() % 4:
            raise ValueError(
                f"flash_attention_backward: each of grads must be a "
                f"{q.dtype} tensor of shape {tuple(q.shape)} on {q.device} "
                "with unit stride in D and even, 4-byte-aligned rows")


def _launch_bwd_tc(ops, lse, dlse, grads, causal, scale, q_offset,
                   k_offset, route="tc"):
    """A tensor-core K2 (``route`` "tc", or "tf32x3" for fp32) on q, k, v,
    O, dO (``ops``) as they lie, writing dq, dk, dv into ``grads`` through
    their strides."""
    name = _TC_ENTRY[route][1]
    fn, why = _bind(_bwd_tc_library(route), name, _TC_ARGS[1])
    b, h, t, d = ops[0].shape
    t_pad = -(-t // _BWD_TC_ROWS) * _BWD_TC_ROWS
    scratch = torch.empty((2, b * h, t_pad), dtype=torch.float32,
                          device=ops[0].device)
    ins = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in ops))
    outs = (ctypes.c_void_p * 3)(*(g.data_ptr() for g in grads))
    strides = (ctypes.c_longlong * 15)(*(s for x in ops
                                          for s in _tma_strides(x)))
    out_strides = (ctypes.c_longlong * 9)(*(s for g in grads
                                             for s in g.stride()[:3]))
    dl = None if dlse is None else dlse.data_ptr()
    with torch.cuda.device(ops[0].device):
        stream = torch.cuda.current_stream(ops[0].device).cuda_stream
        err = fn(ins, strides, lse.data_ptr(), dl, scratch.data_ptr(), outs,
                 out_strides, b, h, t, d, _DTYPE_CODE[ops[0].dtype],
                 float(scale), int(bool(causal)), int(q_offset),
                 int(k_offset), stream)
    if err:
        raise MXNetError(f"{name} launch failed: {why(err).decode()} "
                         f"(error {err})")


def _launch_bwd_simt(ops, lse, dlse, causal, scale, q_offset, k_offset):
    """The CUDA-core K2 on q, k, v, O, dO as they lie (unit stride in D);
    returns contiguous (dq, dk, dv)."""
    lib = _bwd_library()
    b, h, t, d = ops[0].shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=ops[0].device)
    grads = [torch.empty((b, h, t, d), dtype=ops[0].dtype,
                         device=ops[0].device) for _ in range(3)]
    strides = (ctypes.c_longlong * 15)(*(s for x in ops
                                          for s in x.stride()[:3]))
    with torch.cuda.device(ops[0].device):
        stream = torch.cuda.current_stream(ops[0].device).cuda_stream
        err = lib.flash_attn_bwd(
            *(x.data_ptr() for x in ops), lse.data_ptr(),
            None if dlse is None else dlse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), strides, b, h, t, d,
            _DTYPE_CODE[ops[0].dtype], float(scale), int(bool(causal)),
            int(q_offset), int(k_offset), stream)
    if err:
        raise MXNetError("flash_attn_bwd launch failed: "
                         f"{lib.flash_attn_bwd_error_string(err).decode()} "
                         f"(cudaError {err})")
    return grads


def _launch_bwd(q, k, v, out, lse, dout, dlse, causal, scale, q_offset,
                k_offset, route=None, grads=None):
    """K2 on q, k, v, O, dO as they lie (any strides with a unit stride in
    D; others are copied), lse and dlse as contiguous f32; ``route``
    overrides :func:`_flash_bwd_route` with "simt", for design
    measurements. Writes into ``grads`` (dq, dk, dv) when given: the
    tensor-core kernels through their strides, the CUDA-core one by a copy
    of its contiguous results."""
    ops = [x if x.stride(3) == 1 else x.contiguous()
           for x in (q, k, v, out, dout)]
    route = route or _flash_bwd_route(
        q.dtype, q.shape[-1], [_tma_strides(x) + (x.stride(3),) for x in ops],
        [x.data_ptr() for x in ops], q.shape[2])
    lse = lse.contiguous()
    dlse = None if dlse is None else dlse.float().contiguous()
    if route in ("tc", "tf32x3"):
        if grads is None:
            grads = [torch.empty_like(q, memory_format=torch.contiguous_format)
                     for _ in range(3)]
        _launch_bwd_tc(ops, lse, dlse, grads, causal, scale, q_offset,
                       k_offset, route)
    else:
        got = _launch_bwd_simt(ops, lse, dlse, causal, scale, q_offset,
                               k_offset)
        if grads is None:
            grads = got
        else:
            for g, x in zip(grads, got):
                g.copy_(x)
    flash_attention_backward.launches += 1
    flash_attention_backward.launches_by_route[route] += 1
    return tuple(grads)


def flash_attention_backward(q, k, v, out, lse, dout, causal=False,
                             scale=None, dlse=None, q_offset=0, k_offset=0,
                             grads=None):
    """Fused attention backward: (dq, dk, dv) in q's dtype from q, k, v,
    the forward's O and f32 ``lse`` (B, H, T, 1), the output cotangent
    ``dout`` and, optionally, the lse cotangent ``dlse`` (None: no such
    term). Same shapes, masking, offsets and ``scale`` as
    :func:`flash_attention`. ``grads``, three tensors of q's shape, dtype
    and device (unit stride in D, any other strides), receive dq, dk, dv
    and are returned: the views of one (B, T, 3H, D) buffer give the qkv
    projection's gradient with no scatter. On CUDA it launches K2, on the
    kernel :func:`_flash_bwd_route` picks (strided operands read in
    place); on the CPU it runs the plain version."""
    _check_bwd(q, k, v, out, lse, dout, dlse, q_offset, k_offset)
    if grads is not None:
        _check_grads(grads, q)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, dlse, causal, s,
                           q_offset, k_offset, grads=grads)
    if q.device.type == "cpu":
        got = flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, scale=s, dlse=dlse,
            q_offset=q_offset, k_offset=k_offset)
        if grads is None:
            return got
        for g, x in zip(grads, got):
            g.copy_(x)
        return tuple(grads)
    raise ValueError(f"flash_attention_backward: unsupported device "
                     f"{q.device}")


flash_attention_backward.launches = 0
flash_attention_backward.launches_by_route = {"tc": 0, "tf32x3": 0,
                                              "simt": 0}


class _FlashAttention(torch.autograd.Function):
    """K1 forward (O and lse), K2 backward: ``mxnet_tpu``'s custom_vjp
    pair (pallas_kernels.py:300-344). The lse cotangent reaches K2 as
    ``dlse``; an unused output's cotangent arrives as None, not zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True, q_offset=q_offset,
                                   k_offset=k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset, k_offset)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset, k_offset = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=causal, scale=scale, dlse=dlse,
            q_offset=q_offset, k_offset=k_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None, q_offset=0,
                             k_offset=0):
    """Differentiable (O, lse) pair (``pallas_kernels.py:300``): K1 forward,
    K2 backward, with a gradient path through lse too (the ring-attention
    merge). Arguments as :func:`flash_attention`."""
    _check(q, k, v, q_offset, k_offset)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(s),
                                 int(q_offset), int(k_offset))


def flash_attention_with_grad(q, k, v, causal=False, scale=None):
    """Differentiable flash attention (``pallas_kernels.py:347``): O from
    K1, gradients from K2 through the lse saved by the forward."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


def _split_qkv(x, heads):
    """q, k, v (B, H, T, D): the strided views of the qkv projection's
    output x (B, T, 3 H D), whose channels are [q | k | v], heads inside
    each (``mxnet_tpu/gluon/contrib/nn.py:225-232``)."""
    b, t, c = x.shape
    x = x.reshape(b, t, 3 * heads, c // (3 * heads)).transpose(1, 2)
    return x[:, :heads], x[:, heads:2 * heads], x[:, 2 * heads:]


class _FlashAttentionQKV(torch.autograd.Function):
    """K1 forward, K2 backward over the qkv projection's output: the same
    function as :class:`_FlashAttention` on its three head views, whose
    backward allocates one (B, T, 3H, D) gradient and has K2 write dq, dk
    and dv into its three head ranges. Autograd gets the projection's
    gradient whole, with nothing to scatter."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, scale):
        q, k, v = _split_qkv(qkv, heads)
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (heads, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        heads, causal, scale = ctx.args
        grad = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        flash_attention_backward(
            *_split_qkv(qkv, heads), out, lse, dout, causal=causal,
            scale=scale, grads=_split_qkv(grad, heads))
        return grad, None, None, None


def flash_attention_qkv(qkv, num_heads, causal=False, scale=None):
    """Differentiable flash attention over the qkv projection's output
    ``qkv`` (B, T, 3 * num_heads * D), channels [q | k | v]: O (B, H, T, D)
    from K1 on the three strided head views, and in the backward one
    d(qkv) buffer that K2 fills through its strides (the LM's path,
    ``MultiHeadAttention(impl='flash')``)."""
    if not isinstance(qkv, torch.Tensor) or qkv.dim() != 3 or \
            qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv: qkv must be (B, T, 3 * "
                         f"{num_heads} * D), got {getattr(qkv, 'shape', qkv)}")
    q, k, v = _split_qkv(qkv, num_heads)
    _check(q, k, v, 0, 0)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionQKV.apply(qkv, int(num_heads), bool(causal),
                                    float(s))


# ----------------------------------------------------------------------- K3
def _check_conv(x, w):
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"conv3x3_bn_stats: {name} must be a tensor, "
                            f"got {type(t).__name__}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv3x3_bn_stats: x must be (N, H, W, Cin) and w "
                         f"(3, 3, Cin, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_bn_stats: the weight must be 3x3 HWIO, "
                         f"got shape {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_bn_stats: x has {x.shape[3]} channels but "
                         f"w expects {w.shape[2]}")
    if w.dtype != x.dtype:
        raise ValueError(f"conv3x3_bn_stats: x and w dtypes differ "
                         f"({x.dtype}, {w.dtype})")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3x3_bn_stats: unsupported dtype {x.dtype} "
                         "(float32, bfloat16 or float16)")
    if w.device != x.device:
        raise ValueError("conv3x3_bn_stats: x and w lie on different devices")
    if min(x.shape) < 1 or w.shape[3] < 1:
        raise ValueError(f"conv3x3_bn_stats: empty shape x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def conv3x3_bn_stats_reference(x, w):
    """The plain version of K3: the 3x3 stride-1 SAME conv in f32 (TF32 off)
    on x (N, H, W, Cin) and w (3, 3, Cin, Cout), with the per-channel sum
    and sum of squares taken from the f32 result before y is cast to x's
    dtype. Returns (y, sum (Cout,) f32, sumsq (Cout,) f32)."""
    xc = x.float().permute(0, 3, 1, 2)           # NCHW view, NHWC memory
    wc = w.float().permute(3, 2, 0, 1)           # HWIO -> OIHW
    with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False):
        acc = F.conv2d(xc, wc, padding=1)
    y = acc.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return y, acc.sum(dim=(0, 2, 3)), (acc * acc).sum(dim=(0, 2, 3))


_CONV_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))


def _conv_route(dtype, cin, cout, contiguous, ptrs):
    """Which K3 kernel takes these inputs: "tc" (tensor cores) for bf16 or
    fp16 with Cin a multiple of 64, "tf32x3" (tensor cores, 3xTF32) for
    fp32 with Cin a multiple of 32 (one 128-byte TF32 row), each with Cout
    a multiple of 64 and x and w contiguous with 16-byte-aligned base
    addresses ``ptrs``; "simt" (CUDA cores) for everything else. A fixed
    rule, not a fall-back: a failure of the chosen kernel raises."""
    if cout % 64 or not contiguous or any(p % 16 for p in ptrs):
        return "simt"
    if dtype in (torch.bfloat16, torch.float16):
        return "simt" if cin % 64 else "tc"
    if dtype == torch.float32:
        return "simt" if cin % 32 else "tf32x3"
    return "simt"


def _conv_tiles(m_total, cout, sms):
    """(BM, BN) of the tensor-core K3 for M = N*H*W output pixels and Cout
    channels on a card of ``sms`` streaming multiprocessors: the first of
    (128, 128), (64, 128), (128, 64), (64, 64) whose BN divides Cout and
    whose grid has a CTA for each SM, else 64 x 64. The order is measured
    (tools/torch_k3_variants.py, PERF.md). The 3xTF32 kernel has one
    tiling, 64 x 64 (its source's header says why)."""
    for bm, bn in _CONV_TILES:
        if cout % bn == 0 and -(-m_total // bm) * (cout // bn) >= sms:
            return bm, bn
    return 64, 64


def conv_weight_tf32x3_pack_reference(w):
    """The plain version of the 3xTF32 K3's pre-pass: w (3, 3, Cin, Cout)
    as (2, 9, Cout, Cin) f32, [0] the TF32 hi parts and [1] the lo parts
    (:func:`tf32_split_reference`) of each tap's weights transposed: for
    each output channel a K-major row of Cin values, the B operand TF32
    wgmma takes (it has no transpose flags)."""
    cin, cout = w.shape[2], w.shape[3]
    return torch.stack([t.reshape(9, cin, cout).transpose(1, 2)
                        for t in tf32_split_reference(w)]).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _conv_library():
    lib = _build.load("conv3x3_bn_stats")
    fn = lib.conv3x3_bn_stats
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.conv3x3_bn_stats_block_m.restype = ctypes.c_int
        lib.conv3x3_bn_stats_error_string.argtypes = [i]
        lib.conv3x3_bn_stats_error_string.restype = ctypes.c_char_p
    return lib


def _conv_tc_library():
    lib = _build.load("conv3x3_bn_stats_tc")
    fn = lib.conv3x3_bn_stats_tc
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.conv3x3_tc_error_string.argtypes = [i]
        lib.conv3x3_tc_error_string.restype = ctypes.c_char_p
    return lib


def _conv_tf32x3_library():
    lib = _build.load("conv3x3_bn_stats_tf32x3")
    fn = lib.conv3x3_bn_stats_tf32x3
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        lib.conv3x3_tf32x3_block_m.restype = ctypes.c_int
        lib.conv3x3_tf32x3_pack_w.argtypes = [p, p, i, i, p]
        lib.conv3x3_tf32x3_pack_w.restype = ctypes.c_int
        lib.conv3x3_tf32x3_error_string.argtypes = [i]
        lib.conv3x3_tf32x3_error_string.restype = ctypes.c_char_p
    return lib


def _tf32x3_error(lib, what, err):
    return MXNetError(f"{what} launch failed: "
                      f"{lib.conv3x3_tf32x3_error_string(err).decode()} "
                      f"(error {err})")


def _launch_conv_tf32x3(x, w):
    """The 3xTF32 K3 on contiguous fp32 x and w: the pre-pass packs w into
    a (2, 9, Cout, Cin) workspace allocated here, then the conv and the
    statistics' reduction run."""
    lib = _conv_tf32x3_library()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    m_tiles = -(-(n * h * wd) // lib.conv3x3_tf32x3_block_m())
    f32 = torch.float32
    wpack = torch.empty((2, 9, cout, cin), dtype=f32, device=x.device)
    y = torch.empty((n, h, wd, cout), dtype=f32, device=x.device)
    part = torch.empty((2, m_tiles, cout), dtype=f32, device=x.device)
    sums = torch.empty((2, cout), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_bn_stats_tf32x3(
            x.data_ptr(), w.data_ptr(), wpack.data_ptr(), y.data_ptr(),
            part.data_ptr(), sums.data_ptr(), n, h, wd, cin, cout, stream)
    if err:
        raise _tf32x3_error(lib, "conv3x3_bn_stats_tf32x3", err)
    return y, sums[0], sums[1]


def _launch_pack_w_tf32x3(w):
    """The 3xTF32 K3's pre-pass alone on contiguous fp32 w (3, 3, Cin,
    Cout): the packed (2, 9, Cout, Cin) weight, to hold against
    :func:`conv_weight_tf32x3_pack_reference` on the card."""
    lib = _conv_tf32x3_library()
    cin, cout = w.shape[2], w.shape[3]
    wpack = torch.empty((2, 9, cout, cin), dtype=torch.float32,
                        device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.conv3x3_tf32x3_pack_w(w.data_ptr(), wpack.data_ptr(), cin,
                                        cout, stream)
    if err:
        raise _tf32x3_error(lib, "conv3x3_tf32x3_pack_w", err)
    return wpack


def _launch_conv_tc(x, w, tiles=None):
    """The tensor-core K3 on contiguous 16-bit x and w; ``tiles`` (BM, BN)
    overrides :func:`_conv_tiles`, for design measurements."""
    lib = _conv_tc_library()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    m_total = n * h * wd
    bm, bn = tiles or _conv_tiles(m_total, cout, _sm_count(x.device.index))
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, -(-m_total // bm), cout), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_bn_stats_tc(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
            sums.data_ptr(), n, h, wd, cin, cout, _DTYPE_CODE[x.dtype], bm,
            bn, stream)
    if err:
        raise MXNetError("conv3x3_bn_stats_tc launch failed: "
                         f"{lib.conv3x3_tc_error_string(err).decode()} "
                         f"(error {err})")
    return y, sums[0], sums[1]


def _launch_conv_simt(x, w):
    """The CUDA-core K3 on contiguous x and w of any of its dtypes."""
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3_bn_stats: {name} must be contiguous")
    lib = _conv_library()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    m_tiles = -(-(n * h * wd) // lib.conv3x3_bn_stats_block_m())
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, m_tiles, cout), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_bn_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
            sums.data_ptr(), n, h, wd, cin, cout, _DTYPE_CODE[x.dtype],
            stream)
    if err:
        raise MXNetError("conv3x3_bn_stats launch failed: "
                         f"{lib.conv3x3_bn_stats_error_string(err).decode()}"
                         f" (cudaError {err})")
    return y, sums[0], sums[1]


def _launch_conv(x, w):
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if n * h * wd * max(cin, cout) > _INT32[1]:
        raise ValueError(f"conv3x3_bn_stats: x {tuple(x.shape)} with Cout "
                         f"{cout} exceeds the kernel's int32 pixel indexing")
    route = _conv_route(x.dtype, cin, cout,
                        x.is_contiguous() and w.is_contiguous(),
                        (x.data_ptr(), w.data_ptr()))
    if route == "tc":
        out = _launch_conv_tc(x, w)
    elif route == "tf32x3":
        out = _launch_conv_tf32x3(x, w)
    else:
        out = _launch_conv_simt(x, w)
    conv3x3_bn_stats.launches += 1
    conv3x3_bn_stats.launches_by_route[route] += 1
    return out


def conv3x3_bn_stats(x, w):
    """Fused 3x3 stride-1 SAME conv + BatchNorm statistics.

    x (N, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, one dtype of float32,
    bfloat16 or float16. Returns y (N, H, W, Cout) in x's dtype and the
    per-channel sum and sum of squares (Cout,) in f32, taken from the f32
    accumulator (not from the rounded y). CUDA tensors must be contiguous;
    on CUDA, :func:`_conv_route` picks the kernel.
    """
    _check_conv(x, w)
    if x.device.type == "cuda":
        return _launch_conv(x, w)
    if x.device.type == "cpu":
        return conv3x3_bn_stats_reference(x, w)
    raise ValueError(f"conv3x3_bn_stats: unsupported device {x.device}")


conv3x3_bn_stats.launches = 0
conv3x3_bn_stats.launches_by_route = {"tc": 0, "tf32x3": 0, "simt": 0}


def _conv_nchw(t):
    return t.permute(0, 3, 1, 2)


class _Conv3x3BnReluTrain(torch.autograd.Function):
    """K3, then the batch-statistics BatchNorm fold and relu; the backward
    is ``mxnet_tpu``'s ``f_bwd`` (pallas_kernels.py:506-542) in plain ops."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps):
        n, h, wd, _ = x.shape
        cnt = n * h * wd
        y_raw, s, q = conv3x3_bn_stats(x, w)
        mean = s / cnt
        var = torch.clamp_min(q / cnt - mean * mean, 0.0)
        inv32 = torch.rsqrt(var + eps) * gamma.float()
        shift = beta.float() - mean * inv32
        pre = y_raw * inv32.to(y_raw.dtype) + shift.to(y_raw.dtype)
        out = torch.relu(pre)
        ctx.save_for_backward(x, w, gamma, y_raw, mean, var, out)
        ctx.eps, ctx.cnt = eps, cnt
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        x, w, gamma, y_raw, mean, var, out = ctx.saved_tensors
        cnt = ctx.cnt
        red = (0, 1, 2)
        inv = torch.rsqrt(var + ctx.eps)
        dy = torch.where(out > 0, dout, torch.zeros_like(dout)).float()
        y32 = y_raw.float()
        xhat = (y32 - mean) * inv
        dbeta = dy.sum(dim=red)
        dgamma = (dy * xhat).sum(dim=red)
        dxhat = dy * gamma.float()
        # batch-stats BN backward (mean and var are functions of y_raw)
        dy_raw = (inv / cnt) * (cnt * dxhat - dxhat.sum(dim=red)
                                - xhat * (dxhat * xhat).sum(dim=red))
        # cotangents of the exposed statistics: mean = sum(y) / cnt and
        # var = sum(y^2) / cnt - mean^2, so dvar/dy = 2 (y - mean) / cnt
        if dmean is not None:
            dy_raw = dy_raw + dmean.float() / cnt
        if dvar is not None:
            dy_raw = dy_raw + dvar.float() * 2.0 * (y32 - mean) / cnt
        dy_raw = _conv_nchw(dy_raw.to(y_raw.dtype))
        w_oihw = w.permute(3, 2, 0, 1)
        x_nchw = _conv_nchw(x)
        dx = torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dy_raw,
                                        padding=1)
        dw = torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape, dy_raw,
                                         padding=1)
        return (dx.permute(0, 2, 3, 1).to(x.dtype),
                dw.permute(2, 3, 1, 0).to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None)


def conv3x3_bn_relu_train(x, w, gamma, beta, eps=1e-3):
    """Trainable fused conv3x3 (stride 1, SAME) + batch-statistics
    BatchNorm + relu: K3's forward, then the normalise fold and relu.

    x (N, H, W, Cin), w (3, 3, Cin, Cout), gamma and beta (Cout,). Returns
    (out (N, H, W, Cout), mean (Cout,) f32, var (Cout,) f32); mean and var
    feed the moving-average update and carry gradients like any output.
    """
    return _Conv3x3BnReluTrain.apply(x, w, gamma, beta, eps)
