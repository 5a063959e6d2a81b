"""INT8 quantization ops (port of ``mxnet_tpu/ops/quantization.py``;
parity: src/operator/quantization/) and K5, their compute core.

Every op of ``mxnet_tpu`` is registered here under its MXNet name with its
signature: quantize / quantize_v2 / dequantize / requantize, the int8
FullyConnected and Convolution (int32 accumulation), and the quantized
pooling, relu, flatten, elementwise add and multiply, concat, embedding
and BatchNorm that keep a whole graph on the integer grid. Symmetric int8
(scale 127 / max|range|) and affine uint8 (255 / (max - min)), the
reference's conventions, so calibrated ranges carry across. Ranges are
0-d float32 device tensors: calibrated ones are device fills, and with the
NaN poison on (``MXNET_TPU_INT8_NAN_POISON``, default on) every calibrated
boundary adds ``0 * sum(x)`` to them, so a non-finite batch comes out NaN
at the graph's dequantize instead of as finite garbage. Nothing reads a
tensor back to the host, so a quantized forward captures as one CUDA graph.

K5 replaces ``mxnet_tpu/ops/quantization.py:174`` ``_s8_matmul``, ``:190``
``_s8_conv`` and ``:207`` ``_requant_epilogue`` (XLA int8 ``dot_general`` /
``conv_general_dilated`` with int32 accumulation, and the int32 -> int8
step) with hand-written CUDA kernels:

- :func:`s8_conv` / :func:`s8_matmul` -> one int8 tensor-core GEMM core
  with two entry points, an implicit-GEMM conv (stride, pad, dilation) and
  x (M, K) @ W (N, K)^T, the int32 bias added in the epilogue, in two
  sources that the fixed rule :func:`_s8_route` picks between: route
  "wgmma", ``csrc/s8_gemm_wgmma.cu`` (s8 ``wgmma`` fed by TMA; a conv's
  operands laid out NHWC and (Cout, KH, KW, Cin) by its pre-pass, whose
  plain version is :func:`s8_conv_pack_reference`), for every 2-D
  one-group conv (NCHW or NHWC) and every GEMM it takes; route "mma_s8",
  ``csrc/s8_gemm.cu`` (``mma.sync`` m16n8k32, A gathered byte by byte),
  for the rest (a GEMM whose K is not a multiple of 16 or whose operands
  are not 16-byte aligned, a conv stride past 8);
- :func:`requant_epilogue` -> ``csrc/requant_int8.cu``, both paths,
  bitwise equal to the plain version, under a calibrated range or, as
  :func:`_requantize` without one, under the batch's own range: given by
  its producer or computed by the kernel (plain version
  :func:`requant_range_reference`);
- :func:`s8_conv_requant` -> ``s8_wgmma_conv`` with a fused epilogue: relu
  and a calibrated requantize (int8 out, the int32 never stored), or the
  int32 and its batch range in one device word; plain version
  :func:`s8_conv_requant_reference`. The executor runs a conv -> [relu] ->
  requantize chain through it (``executor.py``, the plan), as XLA fuses
  ``_requant_epilogue`` into the conv's output fusion on the TPU.

On a CPU tensor each takes its plain version (``*_reference``: the GEMM and
conv in float64, exact since |sum| <= K * 127^2 < 2^53, then int32; the
epilogue in the kernel's order of float32 operations). On a CUDA tensor it
launches the kernel its route names or raises (grouped int8 convs raise:
ROADMAP Queue 2); nothing moves to the other route. ``<wrapper>.launches``
counts launches and ``launches_by_route`` splits them. ``mxnet_tpu``'s
schedule axes keep a fixed rule here (``tune/`` is ROADMAP Queue 1 item
13): ``operand_width`` "int8" and requantize ``path`` "via_fp32"; "int32"
and "fused_scale" stay callable.
"""
from __future__ import annotations

import collections
import ctypes
import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build
from .registry import register

__all__ = ["s8_conv", "s8_conv_reference", "s8_conv_pack_reference",
           "s8_matmul", "s8_matmul_reference", "requant_epilogue",
           "requant_epilogue_reference", "requant_range_reference",
           "s8_conv_requant", "s8_conv_requant_reference",
           "quantized_conv_requantize", "nan_poison_enabled"]

_I32_MAX = 2147483647.0      # float32(2147483647) == 2^31, as in mxnet_tpu
_QUEUE = "ROADMAP Queue 2, K5"


def nan_poison_enabled():
    """``MXNET_TPU_INT8_NAN_POISON`` (default on; "0", "false", "off"
    disable), read when a graph runs (``mxnet_tpu/ops/quantization.py:
    24-37``)."""
    return os.environ.get("MXNET_TPU_INT8_NAN_POISON", "1") \
        .strip().lower() not in ("0", "false", "off")


def _int8_range(min_r, max_r):
    return torch.maximum(min_r.abs(), max_r.abs())


def _scalar(v, like):
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _div(num, den):
    """``num / den`` for a Python ``num``: a true division (PyTorch's
    ``float / tensor`` multiplies by the reciprocal)."""
    return torch.full_like(den, float(num)) / den


# ---------------------------------------------------------------------------
# K5: plain versions, kernels and their wrappers
# ---------------------------------------------------------------------------

def _pairs(v, n):
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * n


def s8_matmul_reference(x, weight):
    """The plain version of the int8 GEMM: x (..., K) @ weight (N, K)^T in
    float64, exact, cast to int32."""
    return (x.double() @ weight.double().t()).to(torch.int32)


def s8_conv_reference(data, weight, stride, pad, dilate, num_group=1,
                      layout=None, bias=None):
    """The plain version of the int8 convolution: the conv in float64
    (exact), cast to int32, plus the int32 ``bias`` (num_filter,). NCW /
    NCHW / NCDHW with OI* weights, or channels-last with O*I weights;
    ``pad`` symmetric per spatial dim."""
    sdims = data.dim() - 2
    last = bool(layout) and layout[1] != "C"
    x, w = data.double(), weight.double()
    if last:
        x = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
        w = w.permute(0, w.dim() - 1, *range(1, w.dim() - 1))
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[sdims]
    out = conv(x, w, None, _pairs(stride, sdims), _pairs(pad, sdims),
               _pairs(dilate, sdims), int(num_group)).to(torch.int32)
    if bias is not None:
        out = out + bias.to(torch.int32).view((1, -1) + (1,) * sdims)
    if last:
        out = out.permute(0, *range(2, out.dim()), 1)
    return out


def requant_epilogue_reference(data, real_in, out_min, out_max,
                               path="via_fp32"):
    """The plain version of the requantize step (``mxnet_tpu/ops/
    quantization.py:207``): int32 ``data`` on the grid of ``real_in`` ->
    int8 under the output range max(|out_min|, |out_max|), rounded half to
    even. Returns (int8, -real_out, real_out); the ranges are 0-d float32
    tensors and propagate NaN."""
    real_out = _int8_range(out_min, out_max)
    den = torch.clamp_min(real_out, 1e-20)
    if path == "fused_scale":
        scale = (real_in / _I32_MAX) * _div(127.0, den)
        q = torch.round(data.float() * scale)
    elif path == "via_fp32":
        fp = data.float() * (real_in / _I32_MAX)
        q = torch.round(fp * 127.0 / den)
    else:
        raise ValueError(f"requant path {path!r} (via_fp32 or fused_scale)")
    return q.clamp(-127, 127).to(torch.int8), -real_out, real_out


def requant_range_reference(data, real_in):
    """The plain version of the batch range of a requantize without a
    calibrated one (``mxnet_tpu/ops/quantization.py:141-144``): max |int32
    ``data`` on the grid of ``real_in``| as a 0-d float32 tensor, NaN
    propagating."""
    return (data.float() * (real_in / _I32_MAX)).abs().max()


def s8_conv_requant_reference(data, weight, stride, pad, dilate, layout=None,
                              bias=None, *, real_in, out_min=None,
                              out_max=None, relu=False):
    """The plain version of :func:`s8_conv_requant`: the chain of plain
    versions :func:`s8_conv_reference` -> relu (``relu``) -> with
    ``out_min`` and ``out_max`` :func:`requant_epilogue_reference`, giving
    (int8, -real_out, real_out); without them the int32 and
    :func:`requant_range_reference` of it, (int32, batch range)."""
    out = s8_conv_reference(data, weight, stride, pad, dilate, 1, layout,
                            bias)
    if relu:
        out = out.clamp_min(0)
    if out_min is None:
        return out, requant_range_reference(out, real_in)
    return requant_epilogue_reference(out, real_in, out_min, out_max)


_S8_LIB = "s8_gemm"
_WG_LIB = "s8_gemm_wgmma"
_RQ_LIB = "requant_int8"
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, w, bias, out, N, C, H, W, Cout, KH, KW, SH, SW, PH, PW, DH, DW,
    # Ho, Wo, stream
    "s8_conv": (_S8_LIB, [_VP] * 4 + [_I] * 15 + [_VP]),
    # x, w, bias, out, M, N, K, stream
    "s8_matmul": (_S8_LIB, [_VP] * 4 + [_I] * 3 + [_VP]),
    # x, its N C H W strides, N, C, H, W, wq, fold, fs, fp, fd, w, its O I
    # H W strides, Cout, KH, KW, cp, kpad, xp, wp, stream
    "s8_wgmma_prep": (_WG_LIB, [_VP] + [_LL] * 4 + [_I] * 9 + [_VP]
                      + [_LL] * 4 + [_I] * 5 + [_VP] * 3),
    # xp, wp, bias, out, N, H, W, cp, Cout, KH, KW, SH, SW, PH, PW, DH, DW,
    # Ho, Wo, kpad, nchw, warpgroups, epilogue, relu, real_in, out_min,
    # out_max, lo, hi, amax, stream
    "s8_wgmma_conv": (_WG_LIB, [_VP] * 4 + [_I] * 20 + [_VP] * 7),
    # x, w, bias, out, M, N, K, stream
    "s8_wgmma_matmul": (_WG_LIB, [_VP] * 4 + [_I] * 3 + [_VP]),
    # x, q, n, real_in, out_min, out_max, amax, lo, hi, mode, path, stream
    "requant_int8": (_RQ_LIB, [_VP, _VP, _LL] + [_VP] * 6 + [_I, _I, _VP]),
}


def _entry(name):
    lib_name, argtypes = _SIGNATURES[name]
    lib = _build.load(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{lib_name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, fn


def _call(name, *args):
    lib, fn = _entry(name)
    err = fn(*args)
    if err:
        msg = getattr(lib, f"{_SIGNATURES[name][0]}_error_string")(err)
        raise MXNetError(f"{name} launch failed: {msg.decode()} "
                         f"(error {err})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_s8(name, **tensors):
    for what, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
            raise ValueError(f"{name}: {what} must be an int8 tensor, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands lie on different devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def _check_bias(name, bias, n, device):
    if bias is None:
        return None
    if bias.dtype != torch.int32 or tuple(bias.shape) != (n,) or \
            bias.device != device:
        raise ValueError(f"{name}: bias must be int32 ({n},) on {device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on "
                         f"{bias.device}")
    return bias.contiguous()


def _s8_route(op, k=None, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
              dilate=(1, 1), ptrs=()):
    """The fixed rule naming the kernel of a K5 GEMM or conv on CUDA:
    "wgmma" (``csrc/s8_gemm_wgmma.cu``) or "mma_s8" (``csrc/s8_gemm.cu``).

    ``op`` "matmul": "wgmma" where ``k`` is a multiple of 16 and every
    operand address in ``ptrs`` (integers) is 16-byte aligned -- TMA reads
    rows 16-byte aligned. ``op`` "conv" (2-D, one group; the pre-pass
    copies the operands, so their addresses do not matter): "wgmma" where
    TMA's im2col mode takes the geometry per axis -- a stride of 1 to 8,
    the box corners -pad and pad - (kernel - 1) * dilate in [-128, 127],
    the last tap's offset (kernel - 1) * dilate at most 127."""
    if op == "matmul":
        ok = int(k) % 16 == 0 and all(int(p) % 16 == 0 for p in ptrs)
    elif op == "conv":
        ok = all(1 <= s <= 8 and 0 <= p <= 128 and (kk - 1) * d <= 127
                 and -128 <= p - (kk - 1) * d <= 127
                 for kk, s, p, d in zip(kernel, stride, pad, dilate))
    else:
        raise ValueError(f"_s8_route: op {op!r} (matmul or conv)")
    return "wgmma" if ok else "mma_s8"


class _Pack(collections.namedtuple(
        "_Pack", "fold cp kpad kw stride_w pad_w dilate_w")):
    """How the wgmma route's pre-pass lays a conv out (:func:`_s8_pack`)."""


def _s8_pack(c, kernel, stride, pad, dilate):
    """The wgmma route's layout for a conv of C channels: ``fold`` -- the
    KW taps along W folded into the channels (``fold`` = KW: channel s C +
    ci of output column q holds x[ci, q SW - PW + s DW], and the conv
    becomes KH x 1 with stride, pad and dilation 1, 0, 1 along W) where
    that gives K fewer columns (a few channels: the stem's 3), else 1; cp
    -- the channels padded to a multiple of 16; kpad -- the weight's K (KH
    kw cp) padded to whole stages of the kernel's ring, a stage 128, 64 or
    32 bytes of K as cp is a multiple of 128, of 64, or else; and the W
    axis's kernel, stride, pad and dilation of the conv the kernel runs."""
    (kh, kw), (_, sw), (_, pw), (_, dw) = kernel, stride, pad, dilate
    pad16 = lambda v: -(-int(v) // 16) * 16   # noqa: E731
    fold = kw if kw > 1 and pad16(kw * c) < kw * pad16(c) else 1
    cp = pad16(fold * c)
    kw1 = kw // fold
    stage = 128 if cp % 128 == 0 else 64 if cp % 64 == 0 else 32
    kpad = -(-(kh * kw1 * cp) // stage) * stage
    if fold > 1:
        return _Pack(fold, cp, kpad, 1, 1, 0, 1)
    return _Pack(1, cp, kpad, kw, sw, pw, dw)


def _s8_warpgroups(cout):
    """Consumer warpgroups a CTA of the wgmma conv (64 output channels
    each): the fewest that cover Cout, at most 2."""
    return 1 if cout <= 64 else 2


def s8_conv_pack_reference(data, weight, stride, pad, dilate, layout=None):
    """The plain version of the wgmma route's pre-pass (layout by
    :func:`_s8_pack`): (xp, wp) with xp (N, H, Wq, cp) int8 -- NHWC data
    with its channels zero-padded (Wq = W), or with a fold each output
    column's KW input pixels as channels (Wq = Wo) -- and wp the weight as
    (Cout, kpad) int8 rows of k = (r kw + s) cp + j, zeros past the
    channels and past the last tap. NCHW data with OIHW weights, or with
    ``layout`` "NHWC" OHWI weights."""
    last = bool(layout) and layout[1] != "C"
    x = data.permute(0, 3, 1, 2) if last else data        # NCHW
    wt = weight if last else weight.permute(0, 2, 3, 1)   # (Cout, KH, KW, C)
    n, c, h, w = x.shape
    cout, kh, kw = wt.shape[:3]
    st, pd, dl = _pairs(stride, 2), _pairs(pad, 2), _pairs(dilate, 2)
    pk = _s8_pack(c, (kh, kw), st, pd, dl)
    if pk.fold > 1:
        wo = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
        xw = F.pad(x, (pd[1], pd[1]))
        taps = [xw[..., s * dl[1]:s * dl[1] + (wo - 1) * st[1] + 1:st[1]]
                for s in range(kw)]                      # each (N, C, H, Wo)
        xq = torch.stack(taps, 1).permute(0, 3, 4, 1, 2).reshape(
            n, h, wo, kw * c)
        wq = wt.reshape(cout, kh, 1, kw * c)
    else:
        xq, wq = x.permute(0, 2, 3, 1), wt
    xp = F.pad(xq, (0, pk.cp - xq.shape[3])).contiguous()
    k = kh * pk.kw * pk.cp
    wp = F.pad(F.pad(wq, (0, pk.cp - wq.shape[3])).reshape(cout, k),
               (0, pk.kpad - k)).contiguous()
    return xp, wp


def s8_matmul(x, weight, operand_width="int8", bias=None):
    """x (..., K) int8 @ weight (N, K)^T int8 -> int32 (..., N), plus the
    int32 ``bias`` (N,) (``mxnet_tpu/ops/quantization.py:174``). A CUDA
    tensor launches the GEMM of the kernel :func:`_s8_route` names
    (``s8_wgmma_matmul`` or ``s8_matmul``); a CPU tensor takes
    :func:`s8_matmul_reference`. ``operand_width`` ("int8" or "int32",
    the schedule axis) changes no result and no kernel."""
    if operand_width not in ("int8", "int32"):
        raise ValueError(f"operand_width {operand_width!r} (int8 or int32)")
    device = _check_s8("s8_matmul", x=x, weight=weight)
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"s8_matmul: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} do not contract over K")
    n, k = weight.shape
    bias = _check_bias("s8_matmul", bias, n, device)
    if device.type == "cpu":
        out = s8_matmul_reference(x, weight)
        return out if bias is None else out + bias
    if device.type != "cuda":
        raise ValueError(f"s8_matmul: unsupported device {device}")
    x2 = x.reshape(-1, k).contiguous()
    w = weight.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=device)
    if m and n:
        route = _s8_route("matmul", k=k, ptrs=(x2.data_ptr(), w.data_ptr()))
        with torch.cuda.device(device):
            _call("s8_wgmma_matmul" if route == "wgmma" else "s8_matmul",
                  x2.data_ptr(), w.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), m, n, k, _stream(x2))
        s8_matmul.launches += 1
        s8_matmul.launches_by_route[route] += 1
    return out.reshape(*x.shape[:-1], n)


s8_matmul.launches = 0
s8_matmul.launches_by_route = {"wgmma": 0, "mma_s8": 0}


def _conv_shape(data, weight, stride, pad, dilate, last):
    """(n, c, h, w, cout, kh, kw, (sh, sw), (ph, pw), (dh, dw), ho, wo) of a
    2-D conv: NCHW / OIHW, or with ``last`` NHWC / OHWI."""
    n, c, h, w = data.shape[0], *((data.shape[3], *data.shape[1:3]) if last
                                  else data.shape[1:])
    if weight.dim() != 4 or weight.shape[3 if last else 1] != c:
        raise ValueError(f"s8_conv: weight {tuple(weight.shape)} does not "
                         f"match data {tuple(data.shape)} "
                         f"({'OHWI' if last else 'OIHW'})")
    cout = weight.shape[0]
    kh, kw = weight.shape[1:3] if last else weight.shape[2:]
    st, pd, dl = _pairs(stride, 2), _pairs(pad, 2), _pairs(dilate, 2)
    ho = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    wo = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"s8_conv: empty output {ho}x{wo}")
    if n * ho * wo >= 2 ** 31 or c * kh * kw >= 2 ** 31:
        raise ValueError("s8_conv: the GEMM's M or K exceeds int32")
    return n, c, h, w, cout, kh, kw, st, pd, dl, ho, wo


def _s8_conv_prepare(data, weight, shape, last=False):
    """The wgmma route's pre-pass on the card: (xp, wp, pack), xp and wp as
    :func:`s8_conv_pack_reference` lays them out, made by one launch of
    ``s8_wgmma_prep`` into scratch from the caller's allocator (an NHWC x
    that needs no fold, with C a multiple of 16, contiguous on a
    16-byte-aligned base, is read in place). ``shape`` is
    :func:`_conv_shape`'s tuple."""
    n, c, h, w, cout, kh, kw, st, pd, dl, _, wo = shape
    pk = _s8_pack(c, (kh, kw), st, pd, dl)
    wq = wo if pk.fold > 1 else w
    in_place = last and pk.fold == 1 and c == pk.cp and \
        data.is_contiguous() and data.data_ptr() % 16 == 0
    xp = data if in_place else torch.empty((n, h, wq, pk.cp),
                                           dtype=torch.int8,
                                           device=data.device)
    wp = torch.empty((cout, pk.kpad), dtype=torch.int8, device=data.device)
    sx, sw = data.stride(), weight.stride()
    if last:     # (N, H, W, C) and (O, H, W, I) strides as N C H W, O I H W
        sx = (sx[0], sx[3], sx[1], sx[2])
        sw = (sw[0], sw[3], sw[1], sw[2])
    fs, fp, fd = (st[1], pd[1], dl[1]) if pk.fold > 1 else (1, 0, 0)
    with torch.cuda.device(data.device):
        _call("s8_wgmma_prep", None if in_place else data.data_ptr(), *sx,
              n, c, h, w, wq, pk.fold, fs, fp, fd, weight.data_ptr(), *sw,
              cout, kh, kw, pk.cp, pk.kpad, xp.data_ptr(), wp.data_ptr(),
              _stream(data))
    return xp, wp, pk


_EPILOGUES = {"int32": 0, "requant": 1, "range": 2}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _s8_conv_product(xp, wp, pk, bias, shape, last=False, warpgroups=None,
                     epilogue=("int32", False, None, None, None)):
    """The wgmma route's conv on the pre-pass's operands, NCHW, or with
    ``last`` NHWC. ``shape`` is :func:`_conv_shape`'s tuple, ``pk`` the
    layout :func:`_s8_conv_prepare` returns; ``warpgroups`` (1 or 2)
    overrides :func:`_s8_warpgroups` (the fused modes take 1: the kernel
    has them on one consumer warpgroup only). ``epilogue`` (mode, relu,
    real_in,
    out_min, out_max), the 0-d float32 scalars contiguous on the device:
    mode "int32" returns the int32 output; "requant" the output requantized
    under (out_min, out_max), (int8, -real_out, real_out); "range" (int32,
    its batch range on the grid of ``real_in``); relu before each."""
    n, _, h, _, cout, kh, _, (sh, _), (ph, _), (dh, _), ho, wo = shape
    mode, relu, real_in, out_min, out_max = epilogue
    dev = xp.device
    out = torch.empty((n, ho, wo, cout) if last else (n, cout, ho, wo),
                      dtype=torch.int8 if mode == "requant" else torch.int32,
                      device=dev)
    rng = torch.empty(2, dtype=torch.float32, device=dev) \
        if mode == "requant" else None
    word = torch.empty((), dtype=torch.float32, device=dev) \
        if mode == "range" else None
    with torch.cuda.device(dev):
        _call("s8_wgmma_conv", xp.data_ptr(), wp.data_ptr(), _ptr(bias),
              out.data_ptr(), n, h, xp.shape[2], pk.cp, cout, kh, pk.kw, sh,
              pk.stride_w, ph, pk.pad_w, dh, pk.dilate_w, ho, wo, pk.kpad,
              0 if last else 1,
              warpgroups or (_s8_warpgroups(cout) if mode == "int32" else 1),
              _EPILOGUES[mode], int(bool(relu)), _ptr(real_in),
              _ptr(out_min), _ptr(out_max), _ptr(rng),
              None if rng is None else rng.data_ptr() + 4, _ptr(word),
              _stream(xp))
    if mode == "requant":
        return out, rng[0], rng[1]
    if mode == "range":
        return out, word
    return out


def s8_conv(data, weight, stride, pad, dilate, num_group=1, layout=None,
            bias=None, operand_width="int8"):
    """int8 convolution with int32 accumulation plus the int32 ``bias``
    (``mxnet_tpu/ops/quantization.py:190``): NCHW data and OIHW weights, or
    with ``layout`` "NHWC" NHWC data and OHWI weights; symmetric ``pad``.
    A CUDA tensor of a 2-D one-group conv launches the kernel
    :func:`_s8_route` names: "wgmma" (``csrc/s8_gemm_wgmma.cu``, after its
    pre-pass) or "mma_s8" (``csrc/s8_gemm.cu``, NCHW only); anything else
    raises. A CPU tensor takes :func:`s8_conv_reference`, which also takes
    groups and 1-D / 3-D."""
    if operand_width not in ("int8", "int32"):
        raise ValueError(f"operand_width {operand_width!r} (int8 or int32)")
    device = _check_s8("s8_conv", data=data, weight=weight)
    last = bool(layout) and layout[1] != "C"
    nf = weight.shape[0]
    bias = _check_bias("s8_conv", bias, nf, device)
    if device.type == "cpu":
        return s8_conv_reference(data, weight, stride, pad, dilate,
                                 num_group, layout, bias)
    if device.type != "cuda":
        raise ValueError(f"s8_conv: unsupported device {device}")
    if int(num_group) != 1 or data.dim() != 4:
        raise MXNetError(
            f"s8_conv: grouped and non-2-D int8 convs are not ported to "
            f"CUDA ({_QUEUE}); got num_group={num_group}, layout={layout}, "
            f"data {tuple(data.shape)}")
    shape = _conv_shape(data, weight, stride, pad, dilate, last)
    n, c, h, w, _, kh, kw, st, pd, dl, ho, wo = shape
    route = _s8_route("conv", kernel=(kh, kw), stride=st, pad=pd, dilate=dl)
    if route == "wgmma":
        xp, wp, pk = _s8_conv_prepare(data, weight, shape, last)
        out = _s8_conv_product(xp, wp, pk, bias, shape, last)
    elif last:
        raise MXNetError(
            f"s8_conv: a channels-last int8 conv outside the wgmma kernel's "
            f"geometry (stride {st}, pad {pd}, dilation {dl}) has no CUDA "
            f"kernel ({_QUEUE})")
    else:
        x, wt = data.contiguous(), weight.contiguous()
        out = torch.empty((n, nf, ho, wo), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            _call("s8_conv", x.data_ptr(), wt.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), n, c, h, w, nf, kh, kw, *st, *pd, *dl, ho,
                  wo, _stream(x))
    s8_conv.launches += 1
    s8_conv.launches_by_route[route] += 1
    return out


s8_conv.launches = 0
s8_conv.launches_by_route = {"wgmma": 0, "mma_s8": 0}


def _check_scalars(name, device, **scalars):
    """Each given 0-d float32 range on ``device``, reshaped to 0-d and
    contiguous; None stays None."""
    out = []
    for what, t in scalars.items():
        if t is None:
            out.append(None)
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or \
                t.numel() != 1 or t.device != device:
            raise ValueError(f"{name}: {what} must be a float32 scalar "
                             f"tensor on {device}")
        out.append(t.reshape(()).contiguous())
    return out


def s8_conv_requant(data, weight, stride, pad, dilate, layout=None,
                    bias=None, *, real_in, out_min=None, out_max=None,
                    relu=False):
    """The int8 conv (:func:`s8_conv`: 2-D, one group) with relu
    (``relu``) and a requantize in its epilogue. With the calibrated
    ``out_min`` and ``out_max``: the output requantized (via_fp32) under
    them, (int8, -real_out, real_out), the int32 never stored; without
    them: (int32, its batch range max |x * real_in / 2147483647|), the
    range folded into one device word as the tiles are stored, for
    :func:`requant_epilogue`'s ``amax``. ``real_in`` is the int32 grid's
    range; the ranges are 0-d float32 tensors on the data's device. A CUDA
    tensor launches ``s8_wgmma_conv`` with the mode's epilogue (after its
    pre-pass) where :func:`_s8_route` names "wgmma", and raises otherwise;
    a CPU tensor takes :func:`s8_conv_requant_reference`."""
    device = _check_s8("s8_conv_requant", data=data, weight=weight)
    if (out_min is None) != (out_max is None):
        raise ValueError("s8_conv_requant: give both out_min and out_max, "
                         "or neither")
    real_in, out_min, out_max = _check_scalars(
        "s8_conv_requant", device, real_in=real_in, out_min=out_min,
        out_max=out_max)
    last = bool(layout) and layout[1] != "C"
    bias = _check_bias("s8_conv_requant", bias, weight.shape[0], device)
    mode = "range" if out_min is None else "requant"
    if device.type == "cpu":
        return s8_conv_requant_reference(
            data, weight, stride, pad, dilate, layout, bias, real_in=real_in,
            out_min=out_min, out_max=out_max, relu=relu)
    if device.type != "cuda":
        raise ValueError(f"s8_conv_requant: unsupported device {device}")
    if data.dim() != 4:
        raise MXNetError(f"s8_conv_requant: a 2-D conv only, got data "
                         f"{tuple(data.shape)}")
    shape = _conv_shape(data, weight, stride, pad, dilate, last)
    _, _, _, _, _, kh, kw, st, pd, dl, _, _ = shape
    route = _s8_route("conv", kernel=(kh, kw), stride=st, pad=pd, dilate=dl)
    if route != "wgmma":
        raise MXNetError(
            f"s8_conv_requant: the conv's route is {route!r}; only the "
            f"wgmma kernel has the fused epilogue (stride {st}, pad {pd}, "
            f"dilation {dl})")
    xp, wp, pk = _s8_conv_prepare(data, weight, shape, last)
    res = _s8_conv_product(xp, wp, pk, bias, shape, last, epilogue=(
        mode, relu, real_in, out_min, out_max))
    s8_conv_requant.launches += 1
    s8_conv_requant.launches_by_mode[mode] += 1
    return res


s8_conv_requant.launches = 0
s8_conv_requant.launches_by_mode = {"requant": 0, "range": 0}

_RQ_MODES = {"calibrated": 0, "given": 1, "own": 2}


def requant_epilogue(data, real_in, out_min=None, out_max=None,
                     path="via_fp32", amax=None):
    """int32 accumulator -> int8 (``mxnet_tpu/ops/quantization.py:207``)
    under the calibrated output range (``out_min``, ``out_max``), or without
    one under the batch's own (``:141-144``): ``amax``, the range its
    producer folded (:func:`s8_conv_requant`'s), or else the range of
    ``data`` itself. ``real_in``, ``out_min``, ``out_max`` and ``amax`` are
    0-d float32 tensors on ``data``'s device, read there by the kernel
    (never on the host, so the call captures). Returns (int8, -real_out,
    real_out). A CUDA tensor launches ``csrc/requant_int8.cu`` (bitwise
    equal to the plain versions on finite values; mode "own" runs its range
    pass first); a CPU tensor takes :func:`requant_epilogue_reference`
    under :func:`requant_range_reference` where the range is the batch's.
    ``launches_by_mode`` counts "calibrated", "given" and "own"."""
    if path not in ("via_fp32", "fused_scale"):
        raise ValueError(f"requant path {path!r} (via_fp32 or fused_scale)")
    if data.dtype != torch.int32:
        raise ValueError(f"requant_epilogue: data must be int32, got "
                         f"{data.dtype}")
    if (out_min is None) != (out_max is None) or \
            (out_min is not None and amax is not None):
        raise ValueError("requant_epilogue: give out_min and out_max, or "
                         "neither (and optionally amax)")
    real_in, out_min, out_max, amax = _check_scalars(
        "requant_epilogue", data.device, real_in=real_in, out_min=out_min,
        out_max=out_max, amax=amax)
    mode = "calibrated" if out_min is not None else \
        "given" if amax is not None else "own"
    if data.device.type == "cpu":
        if mode != "calibrated":
            out_max = amax if amax is not None else \
                requant_range_reference(data, real_in)
            out_min = -out_max
        return requant_epilogue_reference(data, real_in, out_min, out_max,
                                          path)
    if data.device.type != "cuda":
        raise ValueError(f"requant_epilogue: unsupported device "
                         f"{data.device}")
    x = data.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    rng = torch.empty(2, dtype=torch.float32, device=x.device)
    if mode == "own":
        amax = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _call("requant_int8", x.data_ptr(), q.data_ptr(), x.numel(),
              real_in.data_ptr(), _ptr(out_min), _ptr(out_max), _ptr(amax),
              rng.data_ptr(), rng.data_ptr() + 4, _RQ_MODES[mode],
              0 if path == "via_fp32" else 1, _stream(x))
    requant_epilogue.launches += 1
    requant_epilogue.launches_by_route[path] += 1
    requant_epilogue.launches_by_mode[mode] += 1
    return q, rng[0], rng[1]


requant_epilogue.launches = 0
requant_epilogue.launches_by_route = {"via_fp32": 0, "fused_scale": 0}
requant_epilogue.launches_by_mode = {"calibrated": 0, "given": 0, "own": 0}


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------

def _poisoned(data, lo, hi):
    if nan_poison_enabled():
        flag = 0.0 * data.float().sum()
        return lo + flag, hi + flag
    return lo, hi


def _to_int8(data, real):
    scale = _div(127.0, torch.clamp_min(real, 1e-20))
    q = torch.round(data * scale).clamp(-127, 127)
    return q.to(torch.int8), -real, real


def _to_uint8(data, min_r, max_r):
    scale = _div(255.0, torch.clamp_min(max_r - min_r, 1e-20))
    q = torch.round((data - min_r) * scale).clamp(0, 255)
    return q.to(torch.uint8), min_r, max_r


@register("_contrib_quantize", num_outputs=3,
          aliases=("quantize",))
def _quantize(data, min_range, max_range, out_type="int8"):
    """fp32 -> int8 / uint8 under given ranges (quantize.cc)."""
    min_r, max_r = min_range.reshape(()), max_range.reshape(())
    if out_type == "uint8":
        return _to_uint8(data, min_r, max_r)
    return _to_int8(data, _int8_range(min_r, max_r))


@register("_contrib_quantize_v2", num_outputs=3,
          aliases=("quantize_v2",))
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """fp32 -> int8 / uint8 under the calibrated range, or the data's own
    min / max without one (quantize_v2.cc); ``out_type='auto'`` is uint8
    for a non-negative calibrated range, int8 otherwise."""
    if out_type not in ("int8", "uint8", "auto"):
        raise ValueError(f"unsupported out_type {out_type!r}")
    if min_calib_range is None or max_calib_range is None:
        min_r, max_r = data.min(), data.max()
        if out_type == "auto":
            out_type = "int8"
    else:
        min_r = _scalar(min_calib_range, data)
        max_r = _scalar(max_calib_range, data)
        if out_type == "auto":
            out_type = "uint8" if float(min_calib_range) >= 0.0 else "int8"
        min_r, max_r = _poisoned(data, min_r, max_r)
    if out_type == "uint8":
        return _to_uint8(data, min_r, max_r)
    return _to_int8(data, _int8_range(min_r, max_r))


@register("_contrib_dequantize", aliases=("dequantize",))
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8 / uint8 / int32 -> fp32 (dequantize.cc); an int32 accumulator
    spans the whole int32 grid."""
    min_r, max_r = min_range.reshape(()), max_range.reshape(())
    if data.dtype == torch.uint8:
        return data.float() * ((max_r - min_r) / 255.0) + min_r
    real = _int8_range(min_r, max_r)
    if data.dtype == torch.int32:
        return data.float() * (real / _I32_MAX)
    return data.float() * (real / 127.0)


@register("_contrib_requantize", num_outputs=3,
          aliases=("requantize",))
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """int32 -> int8 under the calibrated range, or under the data's own
    max |value| without one (requantize.cc); the step itself, the batch's
    range included, is K5's :func:`requant_epilogue`, path "via_fp32"."""
    return requant_epilogue(
        data, *_requant_ranges(min_range, max_range, min_calib_range,
                               max_calib_range), path="via_fp32")


def _requant_ranges(min_range, max_range, min_calib_range=None,
                    max_calib_range=None):
    """(real_in, out_min, out_max) of a requantize node over an int32 input
    on the grid (``min_range``, ``max_range``): what it hands
    :func:`requant_epilogue`; out_min and out_max None without a calibrated
    range (the kernel takes the batch's own)."""
    real_in = _int8_range(min_range.reshape(()), max_range.reshape(()))
    if min_calib_range is None or max_calib_range is None:
        return real_in, None, None
    out_min = _scalar(min_calib_range, real_in)
    out_max = _scalar(max_calib_range, real_in)
    if nan_poison_enabled():
        flag = 0.0 * real_in
        out_min, out_max = out_min + flag, out_max + flag
    return real_in, out_min, out_max


def _s8s8_out_range(min_d, max_d, min_w, max_w):
    """Range of an int32 accumulator of int8 x int8 products
    (QuantizationRangeForS8S8Multiplication): (-hi, hi, one step)."""
    level = (_int8_range(min_d.reshape(()), max_d.reshape(())) / 127.0) * \
        (_int8_range(min_w.reshape(()), max_w.reshape(())) / 127.0)
    hi = level * _I32_MAX
    return -hi, hi, level


def _s8s8_bias(bias, min_data, max_data, min_weight, max_weight,
               min_bias=None, max_bias=None, no_bias=False):
    """(lo, hi, int32 bias or None) of a quantized FC or conv: its
    accumulator's range, and the int8 bias rescaled onto its grid, which
    K5 adds in its epilogue."""
    lo, hi, level = _s8s8_out_range(min_data, max_data, min_weight,
                                    max_weight)
    if bias is None or no_bias:
        return lo, hi, None
    real_b = _int8_range(min_bias.reshape(()), max_bias.reshape(()))
    bias_fp = bias.float() * (real_b / 127.0)
    return lo, hi, torch.round(bias_fp / level).to(torch.int32)


@register("_contrib_quantized_fully_connected", num_outputs=3,
          aliases=("quantized_fully_connected",))
def _quantized_fully_connected(data, weight, bias, min_data, max_data,
                               min_weight, max_weight, min_bias=None,
                               max_bias=None, num_hidden=None, no_bias=False,
                               flatten=True):
    """int8 GEMM with int32 accumulation (quantized_fully_connected.cc):
    K5's :func:`s8_matmul`, the int8 bias rescaled onto the accumulator's
    grid and added in its epilogue. Returns (int32, min, max)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    lo, hi, b = _s8s8_bias(bias, min_data, max_data, min_weight, max_weight,
                           min_bias, max_bias, no_bias)
    return s8_matmul(x, weight, bias=b), lo, hi


@register("_contrib_quantized_conv", num_outputs=3,
          aliases=("quantized_conv",))
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=None,
                    stride=None, dilate=None, pad=None, num_filter=None,
                    num_group=1, no_bias=False, layout=None, workspace=None,
                    cudnn_tune=None, cudnn_off=False):
    """int8 convolution with int32 accumulation (quantized_conv.cc): K5's
    :func:`s8_conv`, the bias as in the FC. Returns (int32, min, max)."""
    sdims = data.dim() - 2
    lo, hi, b = _s8s8_bias(bias, min_data, max_data, min_weight, max_weight,
                           min_bias, max_bias, no_bias)
    out = s8_conv(data, weight, _pairs(stride or 1, sdims),
                  _pairs(pad or 0, sdims), _pairs(dilate or 1, sdims),
                  num_group, layout, bias=b)
    return out, lo, hi


def quantized_conv_requantize(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, kernel=None, stride=None,
                              dilate=None, pad=None, num_filter=None,
                              num_group=1, no_bias=False, layout=None,
                              workspace=None, cudnn_tune=None,
                              cudnn_off=False, relu=False,
                              min_calib_range=None, max_calib_range=None):
    """The chain ``_contrib_quantized_conv`` -> [``_contrib_quantized_act``
    relu, with ``relu``] -> ``_contrib_requantize`` (with or without the
    calibrated range) as one call, the executor's plan for it: the conv's
    inputs and parameters, then the requantize's. Returns the requantize's
    (int8, min, max), bitwise those of the three ops in turn. Calibrated:
    one :func:`s8_conv_requant` (mode "requant"); else its mode "range"
    then :func:`requant_epilogue` reading the range it folded."""
    if int(num_group) != 1:
        raise ValueError("quantized_conv_requantize: one group only")
    lo, hi, b = _s8s8_bias(bias, min_data, max_data, min_weight, max_weight,
                           min_bias, max_bias, no_bias)
    real_in, out_min, out_max = _requant_ranges(lo, hi, min_calib_range,
                                                max_calib_range)
    args = (data, weight, _pairs(stride or 1, 2), _pairs(pad or 0, 2),
            _pairs(dilate or 1, 2), layout, b)
    if out_min is not None:
        return s8_conv_requant(*args, real_in=real_in, out_min=out_min,
                               out_max=out_max, relu=relu)
    out, amax = s8_conv_requant(*args, real_in=real_in, relu=relu)
    return requant_epilogue(out, real_in, amax=amax, path="via_fp32")


def _windows(x, k, s, pads, fill):
    """The window views of x (N, C, *spatial) padded with ``fill``: one
    strided slice per window offset, in row-major offset order."""
    sdims = len(k)
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
              value=fill) if any(p != (0, 0) for p in pads) else x
    out_sz = [(x.shape[2 + i] - k[i]) // s[i] + 1 for i in range(sdims)]
    offsets = [()]
    for i in range(sdims):
        offsets = [o + (j,) for o in offsets for j in range(k[i])]
    for off in offsets:
        idx = (slice(None), slice(None)) + tuple(
            slice(off[i], off[i] + (out_sz[i] - 1) * s[i] + 1, s[i])
            for i in range(sdims))
        yield x[idx]


@register("_contrib_quantized_pooling", num_outputs=3,
          aliases=("quantized_pooling",))
def _quantized_pooling(data, min_data, max_data, kernel=(2, 2), stride=None,
                       pad=None, pool_type="max", global_pool=False,
                       pooling_convention="valid", count_include_pad=True,
                       layout=None):
    """Pooling on the int8 or int32 grid (quantized_pooling.cc): max is
    exact; avg sums in float32 over the window in row-major order (XLA's
    order on the CPU for odd windows, ResNet's 7x7 global pool among
    them), divides and rounds. The range passes through. Channels-first
    only."""
    if layout is not None and (len(layout) < 2 or layout[1] != "C"):
        raise ValueError(f"quantized_pooling: channels-first layouts only, "
                         f"got {layout!r}")
    sdims = data.dim() - 2
    k = tuple(data.shape[2:]) if global_pool else _pairs(kernel, sdims)
    s = (1,) * sdims if global_pool else _pairs(stride or (1,) * sdims,
                                                sdims)
    p = (0,) * sdims if global_pool else _pairs(pad or (0,) * sdims, sdims)
    pads = [(x, x) for x in p]
    if pooling_convention == "full" and not global_pool:
        for i in range(sdims):
            span = data.shape[2 + i] + 2 * p[i]
            n_out = -(-(span - k[i]) // s[i]) + 1
            need = (n_out - 1) * s[i] + k[i] - span
            pads[i] = (p[i], p[i] + max(need, 0))
    is_i32 = data.dtype == torch.int32
    if pool_type == "max":
        lo_init = -2 ** 31 if is_i32 else -128
        wins = _windows(data.to(torch.int32), k, s, pads, lo_init)
        out = next(wins)
        for w in wins:
            out = torch.maximum(out, w)
        out = out.to(data.dtype)
    elif pool_type == "avg":
        ssum = None
        for w in _windows(data.float(), k, s, pads, 0.0):
            ssum = w if ssum is None else ssum + w
        if count_include_pad:
            cnt = float(math.prod(k))
        else:
            cnt = None
            ones = torch.ones((1, 1) + tuple(data.shape[2:]),
                              device=data.device)
            for w in _windows(ones, k, s, pads, 0.0):
                cnt = w if cnt is None else cnt + w
            cnt = torch.clamp_min(cnt, 1.0)
        out = torch.round(ssum / cnt)
        if not is_i32:
            out = out.clamp(-127, 127)
        out = out.to(data.dtype)
    else:
        raise ValueError(f"quantized_pooling: pool_type {pool_type!r}")
    return out, min_data.reshape(()), max_data.reshape(())


@register("_contrib_quantized_act", num_outputs=3,
          aliases=("quantized_act",))
def _quantized_act(data, min_data, max_data, act_type="relu"):
    """ReLU on the integer grid (quantized_activation.cc); the range passes
    through."""
    if act_type != "relu":
        raise ValueError("quantized_act supports act_type='relu' only "
                         "(like quantized_activation.cc)")
    return data.clamp_min(0), min_data.reshape(()), max_data.reshape(())


@register("_contrib_quantized_flatten", num_outputs=3,
          aliases=("quantized_flatten",))
def _quantized_flatten(data, min_data, max_data):
    return (data.reshape(data.shape[0], -1), min_data.reshape(()),
            max_data.reshape(()))


@register("_contrib_quantized_concat", num_outputs=3,
          aliases=("quantized_concat",))
def _quantized_concat(*arrays, num_args=None, dim=1):
    """Concat int8 inputs rescaled onto the widest input's grid
    (quantized_concat.cc); inputs [d0..dn, min0, max0, min1, max1, ...]."""
    n = int(num_args) if num_args else len(arrays) // 3
    datas, ranges = arrays[:n], arrays[n:]
    reals = [_int8_range(ranges[2 * i].reshape(()),
                         ranges[2 * i + 1].reshape(())) for i in range(n)]
    real_out = reals[0]
    for r in reals[1:]:
        real_out = torch.maximum(real_out, r)
    scaled = [torch.round(d.float() * (r / real_out)).clamp(-127, 127)
              .to(datas[0].dtype) for d, r in zip(datas, reals)]
    return torch.cat(scaled, dim=int(dim)), -real_out, real_out


@register("_contrib_quantized_elemwise_add", num_outputs=3,
          aliases=("quantized_elemwise_add",))
def _quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 + int8 -> int32 on the widened grid of range rA + rB
    (quantized_elemwise_add.cc)."""
    ra = _int8_range(lhs_min.reshape(()), lhs_max.reshape(()))
    rb = _int8_range(rhs_min.reshape(()), rhs_max.reshape(()))
    r_out = ra + rb
    step = r_out / _I32_MAX
    sa, sb = (ra / 127.0) / step, (rb / 127.0) / step
    out = torch.round(lhs.float() * sa) + torch.round(rhs.float() * sb)
    return out.to(torch.int32), -r_out, r_out


@register("_contrib_quantized_elemwise_mul", num_outputs=3,
          aliases=("quantized_elemwise_mul",))
def _quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 * int8 -> int32 products (quantized_elemwise_mul.cc)."""
    ra = _int8_range(lhs_min.reshape(()), lhs_max.reshape(()))
    rb = _int8_range(rhs_min.reshape(()), rhs_max.reshape(()))
    out = lhs.to(torch.int32) * rhs.to(torch.int32)
    hi = (ra / 127.0) * (rb / 127.0) * _I32_MAX
    return out, -hi, hi


@register("_contrib_quantized_embedding", num_outputs=3,
          aliases=("quantized_embedding",))
def _quantized_embedding(data, weight, min_weight, max_weight,
                         input_dim=None, output_dim=None, dtype=None):
    """int8 table gather (quantized_embedding.cc); the table's range."""
    return (weight[data.to(torch.int64)], min_weight.reshape(()),
            max_weight.reshape(()))


@register("_contrib_quantized_batch_norm", num_outputs=3,
          aliases=("quantized_batch_norm",))
def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data, max_data, eps=1e-3,
                          min_calib_range=None, max_calib_range=None,
                          momentum=0.9, fix_gamma=False,
                          use_global_stats=True, axis=1):
    """Inference BatchNorm as a per-channel affine on the int8 grid
    (quantized_batch_norm.cc); needs the calibrated output range."""
    if min_calib_range is None or max_calib_range is None:
        raise ValueError("quantized_batch_norm needs calibrated output "
                         "range (min_calib_range/max_calib_range)")
    real_in = _int8_range(min_data.reshape(()), max_data.reshape(()))
    real_out = _int8_range(_scalar(min_calib_range, data),
                           _scalar(max_calib_range, data))
    if nan_poison_enabled():
        real_out = real_out + 0.0 * real_in
    g = torch.ones_like(moving_var) if fix_gamma else gamma
    inv = g / torch.sqrt(moving_var + eps)
    ch = [1] * data.dim()
    ch[int(axis)] = -1
    out_scale = real_out / 127.0
    a = ((real_in / 127.0) * inv / out_scale).reshape(ch)
    b = ((beta - moving_mean * inv) / out_scale).reshape(ch)
    out = torch.round(data.float() * a + b).clamp(-127, 127)
    return out.to(torch.int8), -real_out, real_out
