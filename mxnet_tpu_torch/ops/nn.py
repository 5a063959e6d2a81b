"""Neural-network ops (subset of ``mxnet_tpu/ops/nn.py``): dense layers,
convolution, pooling, batch and layer norm, activations, softmax and
log-softmax, flatten and scaled dot-product attention.

Convolution and pooling take ``mxnet_tpu``'s layouts: channels-first
(NCHW, OIHW weights) or channels-last (NHWC, OHWI weights). A
channels-last tensor is a contiguous (N, H, W, C) tensor; its
``permute(0, 3, 1, 2)`` is torch's ``channels_last`` NCHW view of the same
memory, so the library runs its NHWC kernels with no copy, and the
result's inverse permute is contiguous NHWC again."""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..amp.amp import cast_op
from ..base import torch_dtype
from .registry import register

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "sync_batch_stats", "batch_stats_sync", "layer_norm",
           "activation", "leaky_relu", "softmax", "log_softmax", "flatten",
           "scaled_dot_product_attention", "ctc_loss"]

_NEG = -1e30


@cast_op("FullyConnected")
def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` with weight ``(num_hidden, in)``
    (parity: fully_connected-inl.h; ``mxnet_tpu/ops/nn.py:34-45``)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return F.linear(x, weight, bias)


def _pair(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _channels_last(layout):
    return bool(layout) and layout[1] != "C"


def _to_channels_first(t):
    """(N, *spatial, C) -> the (N, C, *spatial) view of the same memory."""
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def _to_channels_last(t):
    return t.permute(0, *range(2, t.dim()), 1)


def _torch_pad(pads):
    """[(lo, hi) per spatial dim] -> F.pad's last-dim-first flat list."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@cast_op("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    """N-d convolution (``mxnet_tpu/ops/nn.py:73-98``; parity:
    convolution.cc). Channels-first layouts take OI* weights, channels-last
    ones (``layout='NHWC'``) O*I weights. ``pad`` entries are ints
    (symmetric) or (lo, hi) pairs; an asymmetric pad is applied with
    ``F.pad`` in the data's own layout, then the conv runs unpadded."""
    sdims = data.dim() - 2
    stride = _pair(stride or 1, sdims)
    dilate = _pair(dilate or 1, sdims)
    pad = pad if isinstance(pad, (tuple, list)) else _pair(pad or 0, sdims)
    pads = [tuple(p) if isinstance(p, (tuple, list)) else (p, p)
            for p in pad]
    last = _channels_last(layout)
    x = data
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, ([0, 0] if last else []) + _torch_pad(pads))
        padding = 0
    b = None if no_bias else bias
    if last:
        out = _CONV[sdims](_to_channels_first(x), _to_channels_first(weight),
                           b, stride, padding, dilate, num_group)
        return _to_channels_last(out)
    return _CONV[sdims](x, weight, b, stride, padding, dilate, num_group)


_POOL = {"max": {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d},
         "avg": {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}}


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Max/avg/sum pooling (``mxnet_tpu/ops/nn.py:138-208``; parity:
    pooling.cc). ``pooling_convention='full'`` is ceil mode with the extra
    window padded on the high side; an avg window always divides by the
    full kernel size with ``count_include_pad`` (padding included), else
    by the count of real elements."""
    sdims = data.dim() - 2
    last = _channels_last(layout)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"pooling: pool_type {pool_type!r} is not ported "
                         "(max, avg or sum)")
    if global_pool:
        axes = tuple(range(1, data.dim() - 1)) if last \
            else tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        red = torch.mean if pool_type == "avg" else torch.sum
        return red(data, dim=axes, keepdim=True)
    kernel = _pair(kernel, sdims)
    stride = _pair(stride or 1, sdims)
    pad = _pair(pad or 0, sdims)
    x = _to_channels_first(data) if last else data
    spatial = x.shape[2:]
    if pooling_convention == "full":
        pads = []
        for i in range(sdims):
            out = -(-(spatial[i] + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            need = (out - 1) * stride[i] + kernel[i] - spatial[i] - pad[i]
            pads.append((pad[i], max(need, pad[i])))
    else:
        pads = [(p, p) for p in pad]
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        # torch pads implicitly; valid windows never reach past the pad, so
        # every avg window divides as the reference's does
        padding = tuple(lo for lo, _ in pads)
    else:
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(x, _torch_pad(pads), value=fill)
        padding = 0
    if pool_type == "max":
        out = _POOL["max"][sdims](x, kernel, stride, padding)
    elif pool_type == "sum" or (not count_include_pad and padding == 0):
        out = _POOL["avg"][sdims](x, kernel, stride, padding,
                                  divisor_override=1)
        if pool_type == "avg":   # divide by the real elements per window
            ones = F.pad(x.new_ones((1, 1) + tuple(spatial)),
                         _torch_pad(pads))
            out = out / _POOL["avg"][sdims](ones, kernel, stride, 0,
                                            divisor_override=1)
    else:
        out = _POOL["avg"][sdims](x, kernel, stride, padding,
                                  count_include_pad=count_include_pad)
    return _to_channels_last(out) if last else out


_BN_SYNC = threading.local()


@contextlib.contextmanager
def sync_batch_stats(reduce_sum, ranks):
    """Within this scope (on this thread) a training BatchNorm takes its
    moments over a batch split across ``ranks`` ranks, each holding as
    many rows: ``reduce_sum(t)`` returns ``t`` summed over them, with the
    gradient of that sum. A sharded step is then, as in ``mxnet_tpu``, the
    one-device step over the global batch, running statistics included."""
    prev = batch_stats_sync()
    _BN_SYNC.sync = (reduce_sum, int(ranks))
    try:
        yield
    finally:
        _BN_SYNC.sync = prev


def batch_stats_sync():
    """The ``(reduce_sum, ranks)`` of the :func:`sync_batch_stats` scope
    this thread is in, or None."""
    return getattr(_BN_SYNC, "sync", None)


@cast_op("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, _train=True):
    """BatchNorm (``mxnet_tpu/ops/nn.py:242-279``; parity: batch_norm.cc).
    Returns (out, new_moving_mean, new_moving_var), the functional form of
    the reference's aux-state mutation.

    In training (``_train`` and not ``use_global_stats``) the statistics
    are single-pass f32 moments (E[x^2] - E[x]^2, clamped at 0) and the
    moving stats take an EMA step; otherwise the moving stats are used.
    Inside :func:`sync_batch_stats` the moments' sums are all-reduced over
    the ranks first. Either way scale and shift are folded per channel in
    f32, cast to the data's dtype, and applied in one multiply-add."""
    axis = axis if axis >= 0 else data.dim() + axis
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    if _train and not use_global_stats:
        x32 = data.float()
        sync = batch_stats_sync()
        if sync is None:
            mean = x32.mean(dim=red)
            sq = (x32 * x32).mean(dim=red)
        else:
            reduce_sum, ranks = sync
            count = x32.numel() // x32.shape[axis] * ranks
            sums = reduce_sum(torch.stack([x32.sum(dim=red),
                                           (x32 * x32).sum(dim=red)]))
            mean, sq = sums[0] / count, sums[1] / count
        var = torch.clamp_min(sq - mean * mean, 0.0)
        new_mm = (moving_mean.float() * momentum
                  + mean * (1 - momentum)).to(moving_mean.dtype)
        new_mv = (moving_var.float() * momentum
                  + var * (1 - momentum)).to(moving_var.dtype)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    if not fix_gamma:
        inv = inv * gamma.float()
    shift = beta.float() - mean * inv
    out = torch.addcmul(shift.to(data.dtype).view(bshape), data,
                        inv.to(data.dtype).view(bshape))
    return out, new_mm, new_mv


def flatten(data):
    """(N, ...) -> (N, prod(...)) (parity: Flatten)."""
    return data.reshape(data.shape[0], -1)


@cast_op("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over the last axis with the population variance
    (``mxnet_tpu/ops/nn.py:282-293``)."""
    if axis not in (-1, data.dim() - 1):
        raise ValueError("layer_norm: only the last axis is supported, got "
                         f"axis={axis}")
    return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign, "silu": F.silu,
    "swish": F.silu,
    # jax.nn.gelu's default is the tanh approximation (ops/nn.py:337)
    "gelu": _gelu_tanh,
}


def activation(data, act_type="relu"):
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"unknown act_type {act_type!r}") from None
    return fn(data)


def leaky_relu(data, act_type="leaky", slope=0.25):
    """LeakyReLU family (subset). ``act_type="gelu"`` is the EXACT erf form
    here, unlike :func:`activation` (``mxnet_tpu/ops/nn.py:355-356``)."""
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "gelu":
        return F.gelu(data)
    raise ValueError(f"unsupported LeakyReLU act_type {act_type!r}")


def _softmax_input(data, temperature):
    return data / temperature if temperature else data


@cast_op("softmax")
def softmax(data, axis=-1, temperature=None, dtype=None):
    """Softmax over ``axis``, after dividing by ``temperature`` if given
    (``mxnet_tpu/ops/nn.py:362-366``); cast to ``dtype`` if given."""
    out = torch.softmax(_softmax_input(data, temperature), dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


@cast_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    """Log-softmax over ``axis`` (``mxnet_tpu/ops/nn.py:369-373``)."""
    out = torch.log_softmax(_softmax_input(data, temperature), dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


def scaled_dot_product_attention(q, k, v, mask=None, causal=False,
                                 scale=None, impl="xla"):
    """Attention over (B, H, L, D) tensors.

    ``impl="xla"`` is the plain dense composition (``mxnet_tpu``'s XLA
    path, ops/nn.py:661-671): masked logits are set to -1e30 before the
    softmax. ``impl="flash"`` runs the streaming kernels through
    :func:`~mxnet_tpu_torch.ops.kernels.flash_attention_with_grad`, as
    ``mxnet_tpu/ops/nn.py:654`` does: K1 forward, K2 backward. On a CUDA
    tensor each launches its hand-written CUDA kernel or raises; there is
    no fall-back to the dense path. q, k, v go as they are: K1's route
    decides whether it reads the strided views in place (the tensor-core
    kernel) or takes contiguous copies (the CUDA-core one); K2 reads them
    in place.
    """
    if impl == "flash":
        if mask is not None:
            raise ValueError(
                "impl='flash' does not support an explicit mask (only "
                "causal=True); the dense path would defeat the O(T) memory "
                "guarantee you opted into")
        from .kernels import flash_attention_with_grad

        return flash_attention_with_grad(q, k, v, causal=causal, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * s
    if causal:
        L, S = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((L, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~cm, _NEG)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool), _NEG)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v)


@cast_op("CTCLoss")
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss, one value per sequence
    (``mxnet_tpu/ops/nn.py:519-567``; parity: ctc_loss.cc): ``data`` (T,
    N, C) scores (the blank among the C classes: first or last), ``label``
    (N, L) ids, padded with the blank ("first") or -1 ("last"). The
    log-alpha recursion over the extended label sequence (blanks between
    and around the labels), with -1e30 for log 0, as the reference."""
    t_len, n, _ = data.shape
    blank = 0 if blank_label == "first" else data.shape[2] - 1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    ext_len = 2 * lab.shape[1] + 1
    ext = torch.full((n, ext_len), blank, dtype=torch.int64,
                     device=data.device)
    ext[:, 1::2] = lab
    if use_label_lengths and label_lengths is not None:
        lab_lens = label_lengths.to(torch.int64)
    else:
        pad = blank if blank_label == "first" else -1
        lab_lens = (lab != pad).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        dat_lens = data_lengths.to(torch.int64)
    else:
        dat_lens = torch.full((n,), t_len, dtype=torch.int64,
                              device=data.device)
    # padding ids (-1) sit past each row's extended length, which no read
    # reaches; any valid class stands in for them
    gather_ix = ext.clamp(0, data.shape[2] - 1)
    prev2 = torch.full_like(ext, -1)
    prev2[:, 2:] = ext[:, :-2]
    can_skip = (ext != prev2) & (ext != blank)
    # the alphas are float32 whatever the scores' dtype, as the reference's
    neg = torch.full((n, 1), _NEG, dtype=torch.float32, device=data.device)
    alpha = torch.full((n, ext_len), _NEG, dtype=torch.float32,
                       device=data.device)
    first = torch.gather(logp[0], 1, gather_ix[:, :2]).float()
    alpha = torch.cat([first, alpha[:, 2:]], dim=1)
    alphas = [alpha]
    for t in range(1, t_len):
        p = torch.gather(logp[t], 1, gather_ix)
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a2 = torch.where(can_skip, a2, torch.full_like(a2, _NEG))
        alpha = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + p
        alphas.append(alpha)
    all_alphas = torch.stack(alphas)                      # (T, N, ext)
    t_idx = (dat_lens - 1).clamp(0, t_len - 1)
    final = all_alphas[t_idx, torch.arange(n, device=data.device)]
    ext_lens = 2 * lab_lens + 1
    last1 = torch.gather(final, 1, (ext_lens - 1).clamp(
        0, ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(final, 1, (ext_lens - 2).clamp(
        0, ext_len - 1)[:, None])[:, 0]
    return -torch.logaddexp(last1, last2)


# ------------------------------------------------- ops under their MXNet names
# The Symbol layer's graphs name these (``mxnet_tpu/ops/nn.py:34, 73, 138,
# 242, 332``); the signatures are ``mxnet_tpu``'s, so the symbol creators
# find the same array inputs and the JSON the same parameters.

@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected_op(data, weight, bias=None, num_hidden=None,
                        no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias,
                           flatten=flatten)


@register("Convolution")
def _convolution_op(data, weight, bias=None, kernel=None, stride=None,
                    dilate=None, pad=None, num_filter=None, num_group=1,
                    no_bias=False, cudnn_tune=None, cudnn_off=False,
                    workspace=None, layout=None):
    return convolution(data, weight, bias, kernel=kernel, stride=stride,
                       dilate=dilate, pad=pad, num_filter=num_filter,
                       num_group=num_group, no_bias=no_bias, layout=layout)


@register("Pooling")
def _pooling_op(data, kernel=None, pool_type="max", global_pool=False,
                stride=None, pad=None, pooling_convention="valid",
                count_include_pad=True, cudnn_off=False, p_value=2,
                layout=None):
    return pooling(data, kernel=kernel, pool_type=pool_type,
                   global_pool=global_pool, stride=stride, pad=pad,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad, layout=layout)


@register("BatchNorm", aliases=("batch_norm",), mutate=(3, 4))
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   min_calib_range=None, max_calib_range=None, _train=True):
    """Returns (out, new_moving_mean, new_moving_var): one output, the
    moving statistics through the mutate slots."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats, axis=axis,
                      _train=_train)


@register("Activation")
def _activation_op(data, act_type="relu"):
    return activation(data, act_type=act_type)


@register("Flatten", aliases=("flatten",))
def _flatten_op(data):
    return flatten(data)


@register("softmax")
def _softmax_op(data, axis=-1, temperature=None, dtype=None):
    return softmax(data, axis=axis, temperature=temperature, dtype=dtype)


@register("CTCLoss", aliases=("ctc_loss",))
def _ctc_loss_op(data, label, data_lengths=None, label_lengths=None,
                 use_data_lengths=False, use_label_lengths=False,
                 blank_label="first"):
    return ctc_loss(data, label, data_lengths, label_lengths,
                    use_data_lengths, use_label_lengths, blank_label)
