"""Optimizer update ops (subset of ``mxnet_tpu/ops/optimizer_ops.py``;
parity: src/operator/optimizer_op.cc).

Each op updates its weight and state tensors in place under
``torch.no_grad()``, as MXNet's kernels do, and returns the weight. The
arithmetic is ``mxnet_tpu``'s, in the weight's dtype: a bf16 weight keeps
bf16 states (``multi_precision`` covers float16 only, as in the
reference). The gradient is scaled by ``rescale_grad`` and then clipped to
``[-clip_gradient, clip_gradient]`` when ``clip_gradient`` is given and not
negative.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """``w -= lr * (g + wd * w)`` (``mxnet_tpu/ops/optimizer_ops.py:24-30``).
    """
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (g + wd * weight))
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum * mom - lr * (g + wd * w); w += mom``
    (``mxnet_tpu/ops/optimizer_ops.py:33-40``)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * (g + wd * weight))
    weight.add_(mom)
    return weight


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """Adam without bias correction, which the optimizer folds into ``lr``
    (``mxnet_tpu/ops/optimizer_ops.py:73-82``): ``g += wd * w``, the two
    moment EMAs, ``w -= lr * mean / (sqrt(var) + epsilon)``."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight
