"""Hand-written kernels of the port and their plain PyTorch versions.

K1, the flash-attention forward, replaces the TPU kernel
``mxnet_tpu/ops/pallas_kernels.py:_mha_kernel`` (built by ``_build_flash``,
entered through ``flash_attention``). Its CUDA source is
``mxnet_tpu_torch/csrc/flash_attn_fwd.cu``; the source's header says what
bounds it on the H100 and how it is laid out.

:func:`flash_attention` takes the plain version,
:func:`flash_attention_reference`, only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: a build or launch failure is an
error, never a quiet fall-back. ``flash_attention.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_reference"]

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
    t, d = q.shape[-2], q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float() * s, k.float().transpose(-1, -2))
    if causal:
        pos = torch.arange(t, device=q.device)
        visible = (q_offset + pos)[:, None] >= (k_offset + pos)[None, :]
        logits = logits.masked_fill(~visible, float("-inf"))
    # the kernel's running max starts at -1e30, so a row with no visible
    # key keeps m = -1e30 and every exp(-inf - m) is exactly 0
    m = logits.amax(dim=-1, keepdim=True).clamp_min(_NEG)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = (torch.matmul(p, v.float()) / l).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


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


def _launch(q, k, v, causal, scale, q_offset, k_offset):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: its backward kernel "
            "(K2) is not ported yet; run under torch.inference_mode()")
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
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False,
                    q_offset=0, k_offset=0):
    """Fused attention forward: q, k, v (B, H, T, D) -> O (B, H, T, D), plus
    the per-row log-sum-exp (B, H, T, 1) in f32 with ``return_lse``.

    ``q_offset``/``k_offset`` place the Q rows and K/V rows in a larger
    global sequence for causal masking (the ring-attention hop case).
    ``scale`` defaults to 1/sqrt(D). Self-attention shapes only, D <= 256,
    float32/bfloat16/float16; any T. CUDA tensors must be contiguous.
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
