"""Neural-network ops (subset of ``mxnet_tpu/ops/nn.py``): dense layers,
layer norm, activations and scaled dot-product attention."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "activation", "leaky_relu",
           "scaled_dot_product_attention"]

_NEG = -1e30


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` with weight ``(num_hidden, in)``
    (parity: fully_connected-inl.h; ``mxnet_tpu/ops/nn.py:34-45``)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    return F.linear(x, weight, bias)


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


def scaled_dot_product_attention(q, k, v, mask=None, causal=False,
                                 scale=None, impl="xla"):
    """Attention over (B, H, L, D) tensors.

    ``impl="xla"`` is the plain dense composition (``mxnet_tpu``'s XLA
    path, ops/nn.py:661-671): masked logits are set to -1e30 before the
    softmax. ``impl="flash"`` runs the streaming kernel
    (:func:`~mxnet_tpu_torch.ops.kernels.flash_attention`): on a CUDA
    tensor it launches the hand-written CUDA kernel or raises; there is
    no fall-back to the dense path.
    """
    if impl == "flash":
        if mask is not None:
            raise ValueError(
                "impl='flash' does not support an explicit mask (only "
                "causal=True); the dense path would defeat the O(T) memory "
                "guarantee you opted into")
        from .kernels import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, scale=scale)
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
