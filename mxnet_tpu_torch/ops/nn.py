"""Neural-network ops (port of ``mxnet_tpu/ops/nn.py``, its 30
registrations): dense layers, convolution and deconvolution, pooling,
up-sampling and resizing, batch / layer / group / instance norm and LRN,
activations, the softmax family, the Module API's output heads
(``SoftmaxOutput`` and the regression and SVM heads, whose backward
ignores the head gradient), Dropout, CTC loss, the interleaved attention
matmuls and scaled dot-product attention (K1 / K2 with ``impl='flash'``).

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
from .registry import drop_num_args, register

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
            count_include_pad=True, layout=None, p_value=2):
    """Max/avg/sum pooling (``mxnet_tpu/ops/nn.py:138-208``; parity:
    pooling.cc). ``pooling_convention='full'`` is ceil mode with the extra
    window padded on the high side; an avg window always divides by the
    full kernel size with ``count_include_pad`` (padding included), else
    by the count of real elements."""
    sdims = data.dim() - 2
    last = _channels_last(layout)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"pooling: unknown pool_type {pool_type!r} "
                         "(max, avg, sum or lp)")
    if pool_type == "lp":
        # (sum |x|^p over the window)^(1/p) (``mxnet_tpu/ops/nn.py:200-208``)
        s = pooling(torch.abs(data).pow(p_value), kernel, "sum", global_pool,
                    stride, pad, pooling_convention, count_include_pad,
                    layout)
        return s.pow(1.0 / p_value)
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
                   count_include_pad=count_include_pad, layout=layout,
                   p_value=p_value)


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
def _softmax_op(data, axis=-1, length=None, temperature=None, dtype=None,
                use_length=False):
    return softmax(data, axis=axis, temperature=temperature, dtype=dtype)


@register("CTCLoss", aliases=("ctc_loss",))
def _ctc_loss_op(data, label, data_lengths=None, label_lengths=None,
                 use_data_lengths=False, use_label_lengths=False,
                 blank_label="first"):
    return ctc_loss(data, label, data_lengths, label_lengths,
                    use_data_lengths, use_label_lengths, blank_label)


@register("log_softmax")
def _log_softmax_op(data, axis=-1, temperature=None, dtype=None,
                    use_length=False):
    return log_softmax(data, axis=axis, temperature=temperature, dtype=dtype)


@register("softmin")
@cast_op("softmin")
def _softmin(data, axis=-1, temperature=None, dtype=None):
    """``softmax(-data)`` (``mxnet_tpu/ops/nn.py:376-378``: temperature and
    dtype are accepted and, as there, unused)."""
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
@cast_op("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """The summed cross entropy of ``softmax(data)`` against int labels."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(pick_rows(logp, label))


def pick_rows(x, label):
    """``x[i, label[i]]`` for each row (labels as any numeric dtype)."""
    return torch.gather(x, -1, label.to(torch.int64).unsqueeze(-1)).squeeze(
        -1)


# ------------------------------------------------------------ LeakyReLU family

_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def _leaky_relu_op(data, gamma=None, act_type="leaky", slope=0.25,
                   lower_bound=0.125, upper_bound=0.334):
    """``mxnet_tpu/ops/nn.py:343-359``: leaky, prelu (``gamma`` per
    channel), elu, selu, the exact (erf) gelu, and rrelu at its mean slope
    (the reference's inference slope)."""
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(data >= 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "rrelu":
        return F.leaky_relu(data, (lower_bound + upper_bound) / 2)
    return leaky_relu(data, act_type=act_type, slope=slope)


# ------------------------------------------------------------- normalization

def _norm_affine(x, mean, var, eps):
    return (x - mean) * torch.rsqrt(var + eps)


@register("LayerNorm", aliases=("layer_norm",),
          num_outputs=lambda p: 3 if p.get("output_mean_var") else 1)
@cast_op("LayerNorm")
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                   output_mean_var=False):
    """Normalisation over ``axis`` with the population variance, then
    ``* gamma + beta`` (``mxnet_tpu/ops/nn.py:280-291``)."""
    ax = axis % data.dim()
    mean = torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=ax, keepdim=True)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    out = _norm_affine(data, mean, var, eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


@register("GroupNorm")
@cast_op("GroupNorm")
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):
    """Per-group statistics; ``gamma`` / ``beta`` per group, as
    ``mxnet_tpu`` has them (``ops/nn.py:294-305``)."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    red = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=red, keepdim=True)
    bshape = (1, num_groups) + (1,) * (x.dim() - 2)
    out = _norm_affine(x, mean, var, eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)
    return out.reshape(data.shape)


@register("InstanceNorm")
@cast_op("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.dim()))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=red, keepdim=True)
    bshape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return _norm_affine(data, mean, var, eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register("LRN")
@cast_op("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across channels (NCHW)."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    ssum = padded[:, 0:data.shape[1]]
    for i in range(1, nsize):
        ssum = ssum + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha / nsize * ssum, beta)


# ---------------------------------------------- deconvolution and resampling

_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
@cast_op("Deconvolution")
def _deconvolution(data, weight, bias=None, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=None, num_group=1, no_bias=True,
                   cudnn_tune=None, cudnn_off=False, workspace=None,
                   layout=None):
    """Transposed convolution (``mxnet_tpu/ops/nn.py:101-135``; parity:
    deconvolution.cc): weight (in, out / group, *kernel), output size
    ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + adj + 1``.
    ``target_shape`` is accepted and, as there, unused."""
    sdims = data.dim() - 2
    b = None if no_bias else bias
    return _DECONV[sdims](data, weight, b, _pair(stride or 1, sdims),
                          _pair(pad or 0, sdims), _pair(adj or 0, sdims),
                          num_group, _pair(dilate or 1, sdims))


def _resize_bilinear(data, size):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres,
    antialiased when shrinking."""
    shrink = size[0] < data.shape[2] or size[1] < data.shape[3]
    return F.interpolate(data, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=shrink)


@register("UpSampling", param_normalizer=drop_num_args)
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                multi_input_mode="concat", workspace=None):
    """Nearest: each input repeated up to the first one's size times
    ``scale``, then concatenated on channels (or summed); bilinear: the
    first input resized by ``scale`` (``mxnet_tpu/ops/nn.py:211-226``,
    whose bilinear mode takes no weight input)."""
    data = args[0]
    if sample_type == "nearest":
        outs = [data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)]
        for extra in args[1:]:
            s = data.shape[2] * scale // extra.shape[2]
            outs.append(extra.repeat_interleave(s, 2).repeat_interleave(s, 3))
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "concat":
            return torch.cat(outs, dim=1)
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return _resize_bilinear(data, (data.shape[2] * scale,
                                   data.shape[3] * scale))


@register("BilinearResize2D", aliases=("_contrib_BilinearResize2D",))
def _bilinear_resize(data, like=None, height=0, width=0, scale_height=None,
                     scale_width=None, mode="size"):
    h, w = data.shape[2:]
    if like is not None:
        height, width = like.shape[2], like.shape[3]
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return _resize_bilinear(data, (height, width))


# --------------------------------------------------------------- output heads
# The Module API's heads (``mxnet_tpu/ops/nn.py:384-475``): the forward is
# the prediction, the backward the loss gradient, whatever head gradient
# arrives (``custom_vjp`` there, an autograd Function here).

class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax over the last axis of ``x`` (N, K); backward ``(p -
    target) * scale`` per row, 0 on ignored rows; the head gradient is not
    read."""

    @staticmethod
    def forward(ctx, x, label, scale, ignore_label, use_ignore, smooth,
                soft_label):
        out = torch.softmax(x, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.args = (scale, ignore_label, use_ignore, smooth, soft_label)
        return out

    @staticmethod
    def backward(ctx, _grad):
        out, label = ctx.saved_tensors
        scale, ignore_label, use_ignore, smooth, soft_label = ctx.args
        if soft_label:
            target = label.to(out.dtype)
        else:
            k = out.shape[-1]
            hit = label.to(torch.int64).unsqueeze(-1) == torch.arange(
                k, device=out.device)
            on = 1.0 - smooth
            off = smooth / (k - 1) if k > 1 else 0.0
            target = torch.where(hit, torch.full_like(out, on),
                                 torch.full_like(out, off))
        grad = out - target
        if use_ignore and not soft_label:
            keep = (label != ignore_label).to(out.dtype)
            grad = grad * keep.unsqueeze(-1)
        return grad * scale, None, None, None, None, None, None


def _softmax_output_scale(label, grad_scale, ignore_label, normalization,
                          spatial):
    """MXNet 1.6's normalisation (softmax_output-inl.h): 'null' keeps
    ``grad_scale``, 'batch' divides by the batch, 'valid' by the labels
    that are not ``ignore_label``; a multi-output head also divides by its
    spatial size unless 'valid'. ``mxnet_tpu`` ignores ``normalization``
    (``ops/nn.py:431-435``: 1 both ways; ROADMAP "Reference defects")."""
    if normalization == "batch":
        cnt = label.shape[0]
    elif normalization == "valid":
        cnt = torch.clamp((label != ignore_label).sum(), min=1).item()
    elif normalization == "null":
        cnt = 1
    else:
        raise ValueError(f"SoftmaxOutput: unknown normalization "
                         f"{normalization!r} (null, batch or valid)")
    if normalization != "valid":
        cnt = cnt * spatial
    return grad_scale / cnt


@register("SoftmaxOutput", aliases=("Softmax",))
@cast_op("SoftmaxOutput")
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Softmax forward; backward ``(p - onehot(label)) * grad_scale``
    (parity: softmax_output.cc), over axis 1 with ``multi_output``, over
    the last axis with ``preserve_shape``, else over all trailing axes
    flattened, as MXNet. ``smooth_alpha`` spreads that much of the target
    over the other classes; ``normalization`` as
    :func:`_softmax_output_scale`. A label of the data's shape is a soft
    target. ``mxnet_tpu`` reads neither ``smooth_alpha`` nor
    ``preserve_shape``; the port follows MXNet, and with
    ``normalization='null'`` the two agree."""
    soft = label.dim() == data.dim() and tuple(label.shape) == tuple(
        data.shape)
    if multi_output:
        x = torch.movedim(data, 1, -1)
        spatial = x[..., 0].numel() // x.shape[0] if x.dim() > 2 else 1
        lab = torch.movedim(label, 1, -1) if soft else label
    elif preserve_shape or data.dim() <= 2:
        x, lab, spatial = data, label, 1
    else:
        x = data.reshape(data.shape[0], -1)
        lab = label.reshape(x.shape) if soft else label
        spatial = 1
    scale = _softmax_output_scale(label, grad_scale, ignore_label,
                                  normalization, spatial)
    out = _SoftmaxOutputFn.apply(x.reshape(-1, x.shape[-1]),
                                 lab.reshape(-1, x.shape[-1]) if soft
                                 else lab.reshape(-1),
                                 float(scale), float(ignore_label),
                                 bool(use_ignore), float(smooth_alpha), soft)
    out = out.reshape(x.shape)
    if multi_output:
        return torch.movedim(out, -1, 1)
    return out.reshape(data.shape)


class _RegressionFn(torch.autograd.Function):
    """Linear (0), logistic (1) and MAE (2) heads: forward the prediction,
    backward ``(out - label)`` (MAE: its sign) ``* grad_scale / outputs per
    row``."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == 1 else data.clone()
        ctx.save_for_backward(out, label)
        ctx.args = (kind, grad_scale)
        return out

    @staticmethod
    def backward(ctx, _grad):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.args
        diff = out - label.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if kind == 2 else diff
        num = out.shape[1] if out.dim() > 1 else 1
        return grad * (grad_scale / num), None, None, None


@register("LinearRegressionOutput")
def _linear_regression_output(data, label, grad_scale=1.0):
    return _RegressionFn.apply(data, label, 0, float(grad_scale))


@register("LogisticRegressionOutput")
def _logistic_regression_output(data, label, grad_scale=1.0):
    return _RegressionFn.apply(data, label, 1, float(grad_scale))


@register("MAERegressionOutput")
def _mae_regression_output(data, label, grad_scale=1.0):
    return _RegressionFn.apply(data, label, 2, float(grad_scale))


class _SVMOutputFn(torch.autograd.Function):
    """Identity forward; backward the hinge loss's gradient, L1 with
    ``use_linear`` else L2 (svm_output-inl.h L1_SVM / L2_SVM)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _grad):
        x, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.args
        hit = label.to(torch.int64).unsqueeze(-1) == torch.arange(
            x.shape[-1], device=x.device)
        if use_linear:
            own = -(margin > x).to(x.dtype) * reg
            other = (margin > -x).to(x.dtype) * reg
        else:
            own = -torch.where(margin > x, 2 * (margin - x),
                               torch.zeros_like(x)) * reg
            other = torch.where(margin > -x, -2 * (-margin - x),
                                torch.zeros_like(x)) * reg
        return torch.where(hit, own, other), None, None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """The SVM head (parity: svm_output.cc). ``mxnet_tpu`` returns the data
    with the identity's gradient (``ops/nn.py:482-484``); the port takes
    MXNet's hinge gradient (ROADMAP "Reference defects")."""
    return _SVMOutputFn.apply(data, label, float(margin),
                              float(regularization_coefficient),
                              bool(use_linear))


# -------------------------------------------------------------------- dropout

@register("Dropout", mutate=(1,))
def _dropout(data, rng_key=None, p=0.5, mode="training", axes=(),
             cudnn_off=False, _train=True, generator=None):
    """Inverted dropout (parity: dropout-inl.h): in training (or
    ``mode='always'``) each element (each slice along ``axes``) is kept
    with probability ``1 - p`` and scaled by ``1 / (1 - p)``. The draw
    comes from ``generator`` (the device's ``mx.random`` generator);
    ``rng_key`` is ``mxnet_tpu``'s key input, kept so graphs and JSON carry
    across, passed through unchanged."""
    if (not _train and mode != "always") or p == 0:
        return data.clone(), rng_key
    shape = tuple(1 if i in tuple(axes) else s
                  for i, s in enumerate(data.shape))
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator, device=data.device)
    mask = (u < keep).to(data.dtype) / keep
    return data * mask, rng_key


# ------------------------------------------------- attention primitives

@register("_contrib_interleaved_matmul_selfatt_qk")
@cast_op("_contrib_interleaved_matmul_selfatt_qk")
def _interleaved_qk(qkv, heads=1):
    """qkv (L, N, 3 H d), interleaved per head -> (N H, L, L) scores over
    sqrt(d) (transformer.cc:650)."""
    seq, n, p = qkv.shape
    d = p // (3 * heads)
    x = qkv.reshape(seq, n, heads, 3, d)
    q = x[..., 0, :].permute(1, 2, 0, 3).reshape(n * heads, seq, d)
    k = x[..., 1, :].permute(1, 2, 0, 3).reshape(n * heads, seq, d)
    return torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)


@register("_contrib_interleaved_matmul_selfatt_valatt")
@cast_op("_contrib_interleaved_matmul_selfatt_valatt")
def _interleaved_valatt(qkv, att, heads=1):
    seq, n, p = qkv.shape
    d = p // (3 * heads)
    x = qkv.reshape(seq, n, heads, 3, d)
    v = x[..., 2, :].permute(1, 2, 0, 3).reshape(n * heads, seq, d)
    out = torch.matmul(att, v)
    return out.reshape(n, heads, seq, d).permute(2, 0, 1, 3).reshape(
        seq, n, heads * d)


@register("_contrib_interleaved_matmul_encdec_qk")
@cast_op("_contrib_interleaved_matmul_encdec_qk")
def _interleaved_encdec_qk(queries, keys_values, heads=1):
    """queries (Lq, N, H d), keys_values (Lkv, N, H 2 d) -> (N H, Lq,
    Lkv), the queries scaled by 1/sqrt(d) first (transformer.cc:736)."""
    lq, n, p = queries.shape
    d = p // heads
    lkv = keys_values.shape[0]
    q = queries.reshape(lq, n, heads, d).permute(1, 2, 0, 3).reshape(
        n * heads, lq, d)
    kv = keys_values.reshape(lkv, n, heads, 2, d)
    k = kv[..., 0, :].permute(1, 2, 0, 3).reshape(n * heads, lkv, d)
    return torch.matmul(q * (1.0 / math.sqrt(d)), k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_encdec_valatt")
@cast_op("_contrib_interleaved_matmul_encdec_valatt")
def _interleaved_encdec_valatt(keys_values, attention, heads=1):
    lkv, n, p2 = keys_values.shape
    d = p2 // (2 * heads)
    kv = keys_values.reshape(lkv, n, heads, 2, d)
    v = kv[..., 1, :].permute(1, 2, 0, 3).reshape(n * heads, lkv, d)
    out = torch.matmul(attention, v)
    lq = out.shape[1]
    return out.reshape(n, heads, lq, d).permute(2, 0, 1, 3).reshape(
        lq, n, heads * d)


@register("scaled_dot_product_attention")
def _sdpa_op(q, k, v, mask=None, causal=False, scale=None, impl="xla"):
    """``mxnet_tpu/ops/nn.py:625-671`` under its name: ``impl='flash'``
    runs K1 forward and K2 backward (on a CUDA tensor each launches its
    kernel or raises; ``mxnet_tpu``'s fall-back to the dense path with a
    warning is not ported), ``impl='xla'`` the dense composition. Shape
    inference (``meta`` tensors) takes the dense path's shapes."""
    if q.device.type == "meta":
        impl = "xla"
    return scaled_dot_product_attention(q, k, v, mask=mask, causal=causal,
                                        scale=scale, impl=impl)
