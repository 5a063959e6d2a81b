"""Optimizer update ops (subset of ``mxnet_tpu/ops/optimizer_ops.py``;
parity: src/operator/optimizer_op.cc).

Each op updates its weight and state tensors in place under
``torch.no_grad()``, as MXNet's kernels do, and returns the weight. The
arithmetic is ``mxnet_tpu``'s, in the weight's dtype: a bf16 weight keeps
bf16 states (``multi_precision`` covers float16 only, as in the
reference). The gradient is scaled by ``rescale_grad`` and then clipped to
``[-clip_gradient, clip_gradient]`` when ``clip_gradient`` is given and not
negative.

The multi-tensor ops (``multi_sgd_update``, ``multi_sgd_mom_update``,
``multi_adam_update``; ``mxnet_tpu/ops/optimizer_ops.py:373-412``,
``ops/parity_aliases.py:307``) update a list of weights. Its
full-precision weights go as one group through a few
``torch._foreach_*`` launches; its 16-bit weights go one at a time
through per-tensor ops (``_groups``). The momentum and the moments are
updated in place. The per-parameter ops are the same code on a list of
one, so the two agree bit for bit.

Scalar operands. ``lr`` and ``wd`` are one scalar for every weight or a
list of one per weight, ``rescale_grad`` one scalar. Each is a Python
float or a 0-d float32 tensor on the weights' device (a "slot", which a
captured step refreshes before each replay without re-capturing). A
product of a tensor and such a scalar is taken in float32 and rounded once
to the tensor's dtype, which is what PyTorch does with a Python float, so
a slot and a float holding the same value give the same bits (``_mul``).
The other hyper-parameters (momentum, betas, epsilon, clip_gradient) are
constants.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update",
           "multi_sgd_update", "multi_sgd_mom_update", "multi_adam_update"]

_FULL = (torch.float32, torch.float64)


def _groups(weights):
    """The index groups an update runs as one: every full-precision weight
    in one ``_foreach`` group, each 16-bit weight alone. PyTorch's
    vectorized per-tensor kernels beat ``multi_tensor_apply`` on large bf16
    tensors, and tensor by tensor each temporary is read back while it is
    still in L2: on the H100 the LM's bf16 Adam update took 10.6 ms as
    one-tensor ``_foreach`` calls, 7.9 ms op by op over all its tensors
    and 6.0 ms tensor by tensor (``chip_smoke.py`` phase h, PERF.md)."""
    full = [i for i, w in enumerate(weights) if w.dtype in _FULL]
    half = [[i] for i, w in enumerate(weights) if w.dtype not in _FULL]
    return ([full] if full else []) + half


def _pick(o, ix):
    """``o``'s entries at ``ix`` (a list), or ``o`` (one scalar for all)."""
    return [o[i] for i in ix] if isinstance(o, (list, tuple)) else o


def _checked(s, n):
    """``s`` (one scalar, or one per weight) with its length checked."""
    if isinstance(s, (list, tuple)) and len(s) != n:
        raise ValueError(f"{len(s)} scalars for {n} weights")
    return s


def _each(name, xs, *others):
    """``torch._foreach_<name>(xs, *others)`` on a full-precision group,
    the per-tensor method on a 16-bit one; each of ``others`` is a list
    (one per tensor) or one Python number. Both take the same float ops,
    so the bits agree. Returns the new list, or None for an in-place
    name."""
    if xs[0].dtype in _FULL:
        return getattr(torch, f"_foreach_{name}")(xs, *others)
    method = getattr(torch.Tensor, name)
    out = [method(x, *(o[i] if isinstance(o, (list, tuple)) else o
                       for o in others)) for i, x in enumerate(xs)]
    return None if name.endswith("_") else out


def _mul(xs, ss):
    """``[x * s]``, each taken in float32 and rounded once to x's dtype.
    ``ss`` is one scalar (float or 0-d f32 tensor) or one per tensor. A
    full-precision group goes through one ``_foreach_mul`` (one shared
    slot: its tensor overload). A 16-bit tensor meets a float as PyTorch
    applies one (in float32, rounded once), and a slot as a one-element
    float32 tensor, which promotes the product to float32 before the one
    rounding: the two give the same bits. (A 0-d CUDA tensor, or a
    ``_foreach`` scalar on a CPU build, would be rounded to the 16-bit
    dtype first.)"""
    if xs[0].dtype in _FULL:
        return torch._foreach_mul(xs, ss)
    out = []
    for i, x in enumerate(xs):
        s = ss[i] if isinstance(ss, (list, tuple)) else ss
        out.append(torch.mul(x, s.reshape(1)).to(x.dtype)
                   if isinstance(s, torch.Tensor) else torch.mul(x, s))
    return out


def _scaled_grads(grads, weights, rescale_grad, clip_gradient, wds):
    """``clip(g * rescale_grad) + wd * w`` for each weight."""
    g = _mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = [torch.clamp(x, -clip_gradient, clip_gradient) for x in g]
    _each("add_", g, _mul(weights, wds))
    return g


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs=0.01, wds=0.0, rescale_grad=1.0,
                     clip_gradient=None):
    """``w -= lr * (g + wd * w)`` for each weight
    (``mxnet_tpu/ops/optimizer_ops.py:373``)."""
    lrs, wds = _checked(lrs, len(weights)), _checked(wds, len(weights))
    for ix in _groups(weights):
        ws = _pick(weights, ix)
        step = _scaled_grads(_pick(grads, ix), ws, rescale_grad,
                             clip_gradient, _pick(wds, ix))
        _each("sub_", ws, _mul(step, _pick(lrs, ix)))
    return weights


@torch.no_grad()
def multi_sgd_mom_update(weights, grads, moms, lrs=0.01, wds=0.0,
                         momentum=0.0, rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum * mom - lr * (g + wd * w); w += mom`` for each
    weight (``mxnet_tpu/ops/optimizer_ops.py:391``)."""
    lrs, wds = _checked(lrs, len(weights)), _checked(wds, len(weights))
    for ix in _groups(weights):
        ws, ms = _pick(weights, ix), _pick(moms, ix)
        step = _scaled_grads(_pick(grads, ix), ws, rescale_grad,
                             clip_gradient, _pick(wds, ix))
        _each("mul_", ms, momentum)
        _each("sub_", ms, _mul(step, _pick(lrs, ix)))
        _each("add_", ws, ms)
    return weights


@torch.no_grad()
def multi_adam_update(weights, grads, means, variances, lrs=0.001,
                      wds=0.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                      rescale_grad=1.0, clip_gradient=None):
    """Adam without bias correction, which the optimizer folds into each
    ``lr`` (``mxnet_tpu/ops/optimizer_ops.py:73-82``), for each weight:
    ``g += wd * w``, the two moment EMAs,
    ``w -= lr * mean / (sqrt(var) + epsilon)``."""
    lrs, wds = _checked(lrs, len(weights)), _checked(wds, len(weights))
    for ix in _groups(weights):
        ws, ms, vs = (_pick(t, ix) for t in (weights, means, variances))
        g = _scaled_grads(_pick(grads, ix), ws, rescale_grad, clip_gradient,
                          _pick(wds, ix))
        _each("mul_", ms, beta1)
        _each("add_", ms, _mul(g, 1 - beta1))
        _each("mul_", vs, beta2)
        _each("add_", vs, _mul(_each("mul", g, g), 1 - beta2))
        denom = _each("sqrt", vs)
        _each("add_", denom, epsilon)
        step = _mul(ms, _pick(lrs, ix))
        _each("div_", step, denom)
        _each("sub_", ws, step)
    return weights


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """``w -= lr * (g + wd * w)`` (``mxnet_tpu/ops/optimizer_ops.py:24-30``).
    """
    multi_sgd_update([weight], [grad], lr, wd, rescale_grad, clip_gradient)
    return weight


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum * mom - lr * (g + wd * w); w += mom``
    (``mxnet_tpu/ops/optimizer_ops.py:33-40``)."""
    multi_sgd_mom_update([weight], [grad], [mom], lr, wd, momentum,
                         rescale_grad, clip_gradient)
    return weight


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """Adam without bias correction, which the optimizer folds into ``lr``
    (``mxnet_tpu/ops/optimizer_ops.py:73-82``): ``g += wd * w``, the two
    moment EMAs, ``w -= lr * mean / (sqrt(var) + epsilon)``."""
    multi_adam_update([weight], [grad], [mean], [var], lr, wd, beta1, beta2,
                      epsilon, rescale_grad, clip_gradient)
    return weight
