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

The other optimizers' ops (``mxnet_tpu/ops/optimizer_ops.py:43-475`` and
the optimizer families of ``ops/parity_aliases.py:290-460``) are plain
tensor arithmetic on one weight, in place; ``multi_lamb`` runs a group of
full-precision weights through ``torch._foreach_*`` as the SGD and Adam
groups do. Every op is registered (``ops/registry.py``) under
``mxnet_tpu``'s name with ``mxnet_tpu``'s signature -- the multi-tensor
ops take their tensors interleaved (``[w0, g0, m0, w1, ...]``) -- and
writes in place the slots ``mxnet_tpu`` returns as mutated, returning its
primary outputs. Where ``mxnet_tpu`` differs from MXNet the port follows
MXNet (ROADMAP Queue 3): ``lamb_update_phase1`` and
``mp_lamb_update_phase1`` update the moments in place,
``_multi_mp_lamb_update`` takes five tensors a weight (the fp32 master
last), and the AdamW family skips the whole update when the rescale it is
given is not finite or is 0 (a loss scale after an overflow).
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update",
           "multi_sgd_update", "multi_sgd_mom_update", "multi_adam_update",
           "multi_lamb_update", "multi_all_finite"]

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


# ------------------------------------------------------ the other optimizers
# One weight each, in place under no_grad; ``lr``, ``wd`` and
# ``rescale_grad`` are floats or 0-d float32 slots, as above.

def _rc(grad, rescale_grad, clip_gradient):
    """``grad * rescale_grad`` clipped to ``[-c, c]`` when ``c >= 0``."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _pos(clip):
    """The multi-tensor ops' convention: clip only when ``clip > 0``."""
    return clip if clip is not None and clip > 0 else None


def _sqrt(s):
    return s.sqrt() if isinstance(s, torch.Tensor) else math.sqrt(s)


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """Nesterov momentum (``mxnet_tpu/ops/optimizer_ops.py:43-51``):
    ``g += wd * w; mom = momentum * mom + g;
    w -= lr * (g + momentum * mom)``."""
    g = _rc(grad, rescale_grad, clip_gradient) + wd * weight
    mom.mul_(momentum).add_(g)
    weight.sub_(lr * (g + momentum * mom))
    return weight


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """SGD on the float32 master ``weight32``; ``weight`` gets its
    rounding (``optimizer_ops.py:54-60``)."""
    g = _rc(grad.float(), rescale_grad, clip_gradient)
    weight32.sub_(lr * (g + wd * weight32))
    weight.copy_(weight32)
    return weight


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """SGD with momentum on the float32 master (``optimizer_ops.py:63-71``).
    """
    g = _rc(grad.float(), rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(lr * (g + wd * weight32))
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight


@torch.no_grad()
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """NAG on the float32 master (``optimizer_ops.py:286-298``)."""
    g = _rc(grad.float(), rescale_grad, clip_gradient) + wd * weight32
    mom.mul_(momentum).add_(g)
    weight32.sub_(lr * (g + momentum * mom))
    weight.copy_(weight32)
    return weight


def _skip_unless_valid(rs, news, olds):
    """Write ``news`` into ``olds``; with a tensor rescale ``rs`` only where
    it is finite and not 0 (MXNet's AdamW: a loss scale that overflowed
    leaves weights and moments as they were), on the device."""
    if isinstance(rs, torch.Tensor):
        ok = torch.isfinite(rs) & (rs != 0)
        for new, old in zip(news, olds):
            old.copy_(torch.where(ok, new, old))
    elif math.isfinite(rs) and rs != 0:
        for new, old in zip(news, olds):
            old.copy_(new)


def _adamw(weight, grad, mean, var, w32, rs, lr, beta1, beta2, epsilon, wd,
           eta, clip):
    """The AdamW step of ``weight`` (its fp32 master ``w32`` if given):
    the new (weight, mean, var, master) values, written by the caller."""
    master = w32 if w32 is not None else weight
    g = grad.float() if w32 is not None else grad
    g = g * rs
    if clip is not None and clip >= 0:
        g = torch.clamp(g, -clip, clip)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * (g * g)
    new = master - eta * (lr * m / (torch.sqrt(v) + epsilon) + wd * master)
    return new, m, v


@torch.no_grad()
def adamw_update(weight, grad, mean, var, rescale_grad_arr=None, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 rescale_grad=1.0, clip_gradient=None):
    """AdamW, decoupled weight decay (``optimizer_ops.py:85-98``; MXNet's
    ``_adamw_update``): skipped when the rescale is not finite or 0."""
    rs = rescale_grad_arr if rescale_grad_arr is not None else rescale_grad
    new, m, v = _adamw(weight, grad, mean, var, None, rs, lr, beta1, beta2,
                       epsilon, wd, eta, clip_gradient)
    _skip_unless_valid(rs, (new, m, v), (weight, mean, var))
    return weight


@torch.no_grad()
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_arr=None,
                    lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, rescale_grad=1.0, clip_gradient=None):
    """AdamW on the float32 master (``parity_aliases.py:289-305``), skipped
    as :func:`adamw_update`."""
    rs = rescale_grad_arr if rescale_grad_arr is not None else rescale_grad
    new, m, v = _adamw(weight, grad, mean, var, weight32, rs, lr, beta1,
                       beta2, epsilon, wd, eta, clip_gradient)
    _skip_unless_valid(rs, (new, m, v, new),
                       (weight32, mean, var, weight))
    return weight


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=None):
    """FTRL-proximal (``optimizer_ops.py:101-113``)."""
    g = _rc(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z.copy_(z + g - sigma * weight)
    n.copy_(new_n)
    new_w = -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd)
    weight.copy_(torch.where(torch.abs(z) > lamda1, new_w,
                             torch.zeros_like(new_w)))
    return weight


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=None,
                   clip_weights=None):
    """RMSProp (``optimizer_ops.py:116-124``; ``clip_weights`` is accepted
    and, as there, not applied)."""
    g = _rc(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * (g * g))
    weight.sub_(lr * g / torch.sqrt(n + epsilon))
    return weight


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None, clip_weights=None):
    """Centered RMSProp (Graves 2013; ``optimizer_ops.py:127-137``)."""
    g = _rc(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * (g * g))
    g_avg.mul_(gamma1).add_((1 - gamma1) * g)
    delta.mul_(gamma2).sub_(
        lr * g / torch.sqrt(n - g_avg * g_avg + epsilon))
    weight.add_(delta)
    return weight


@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """``w -= lr * (sign(g) + wd * w)`` (``optimizer_ops.py:140-145``)."""
    g = _rc(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * weight))
    return weight


@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=None, wd_lh=0.0):
    """Signum (``optimizer_ops.py:148-154``)."""
    g = _rc(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_((1 - momentum) * (g + wd * weight))
    weight.copy_((1 - lr * wd_lh) * weight + lr * torch.sign(mom))
    return weight


@torch.no_grad()
def ftml_step(weight, grad, d, v, z, k, c2, beta1=0.6, beta2=0.999,
              epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML at step t with ``k = (1 - beta1^t) / lr`` and ``c2 = 1 -
    beta2^t`` given (floats or slots): wd inside the clipped gradient, as
    the reference's FTMLKernel (``optimizer_ops.py:268-283``)."""
    g = rescale_grad * grad + wd * weight
    if clip_grad is not None and clip_grad >= 0:
        g = torch.clamp(g, -clip_grad, clip_grad)
    v.mul_(beta2).add_((1 - beta2) * g * g)
    d_t = k * (torch.sqrt(v / c2) + epsilon)
    z.copy_(beta1 * z + (1 - beta1) * g - (d_t - beta1 * d) * weight)
    d.copy_(d_t)
    weight.copy_(-z / d_t)
    return weight


def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML at step ``t`` (``optimizer_ops.py:268-283``)."""
    return ftml_step(weight, grad, d, v, z, (1 - beta1 ** t) / lr,
                     1 - beta2 ** t, beta1, beta2, epsilon, wd, rescale_grad,
                     clip_grad)


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=None):
    """LAMB's direction ``m^ / (sqrt(v^) + eps) + wd * w``
    (``optimizer_ops.py:157-169``); the moments are updated in place, as
    MXNet's op does (FMutateInputs {2, 3}; ``mxnet_tpu``'s returns them
    unchanged)."""
    g = _rc(grad, rescale_grad, clip_gradient)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * (g * g))
    m, v = mean, var
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight


def _trust(r1, r2, lower_bound, upper_bound):
    """The trust ratio ``r1 / r2`` (1 unless both are positive), ``r1``
    clamped to the bounds that are >= 0 (``optimizer_ops.py:172-183``)."""
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp_max(r1, upper_bound)
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@torch.no_grad()
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    """``w -= lr * trust * g_update`` (``optimizer_ops.py:172-183``)."""
    ratio = _trust(r1.reshape(()), r2.reshape(()), lower_bound, upper_bound)
    weight.sub_(lr * ratio * g_update)
    return weight


@torch.no_grad()
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, lr=0.001,
                          beta1=0.9, beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """:func:`lamb_update_phase1` in float32 against the master
    (``parity_aliases.py:385-401``), the moments updated in place as
    MXNet's op does (``mxnet_tpu``'s has no ``mutate=``)."""
    return lamb_update_phase1(weight32, grad.float(), mean, var, beta1,
                              beta2, epsilon, t, bias_correction, wd,
                              rescale_grad, _pos(clip_gradient))


@torch.no_grad()
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr=0.001,
                          lower_bound=-1.0, upper_bound=-1.0):
    """Phase 2 on the float32 master; ``weight`` gets its rounding
    (``parity_aliases.py:404-414``; bounds apply when > 0)."""
    ratio = _trust(r1.reshape(()).float(), r2.reshape(()).float(),
                   _pos(lower_bound), _pos(upper_bound))
    weight32.sub_(lr * ratio * g)
    weight.copy_(weight32)
    return weight


@torch.no_grad()
def multi_lamb_update(weights, grads, means, variances, lrs, wds,
                      beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                      clip_gradient=None, bias_corrections=None,
                      lower_bound=None, upper_bound=None, weights32=None):
    """LAMB over a group (``optimizer_ops.py:186-245``): for each weight
    the moments' EMAs in place, the direction ``u = m^ / (sqrt(v^) + eps)
    + wd * w`` and ``w -= lr * trust * u`` with ``trust = ||w|| / ||u||``
    (1 unless both are positive; ``||w||`` clamped to the bounds that are
    not None and >= 0; the gradient clipped when ``clip_gradient >= 0``).
    ``bias_corrections`` is None (none) or one ``(1 - beta1^t, 1 -
    beta2^t)`` pair per weight, each a float or a slot. With ``weights32``
    (fp32 masters, one per weight or None) the step runs on the master
    and the weight takes its rounding. Full-precision weights go through
    ``torch._foreach_*`` as one group, 16-bit ones one at a time."""
    n = len(weights)
    lrs, wds = _checked(lrs, n), _checked(wds, n)
    masters = list(weights) if weights32 is None else [
        w if m is None else m for w, m in zip(weights, weights32)]
    for ix in _groups(masters):
        ws, ms, vs = (_pick(t, ix) for t in (masters, means, variances))
        gs = [g.float() if g.dtype != w.dtype else g
              for g, w in zip(_pick(grads, ix), ws)]
        g = _mul(gs, rescale_grad)
        if clip_gradient is not None and clip_gradient >= 0:
            g = [torch.clamp(x, -clip_gradient, clip_gradient) for x in g]
        _each("mul_", ms, beta1)
        _each("add_", ms, _mul(g, 1 - beta1))
        _each("mul_", vs, beta2)
        _each("add_", vs, _mul(_each("mul", g, g), 1 - beta2))
        mh, vh = ms, vs
        if bias_corrections is not None:
            bc = _pick(bias_corrections, ix)
            mh = _each("div", ms, [c[0] for c in bc])
            vh = _each("div", vs, [c[1] for c in bc])
        u = _each("sqrt", vh)
        _each("add_", u, epsilon)
        u = _each("div", mh, u)
        _each("add_", u, _mul(ws, _pick(wds, ix)))
        r1 = torch.stack(torch._foreach_norm(ws))
        r2 = torch.stack(torch._foreach_norm(u))
        trust = _trust(r1, r2, lower_bound, upper_bound)
        lr = _pick(lrs, ix)
        if not isinstance(lr, (list, tuple)):
            lr = [lr] * len(ix)
        steps = [trust[k] * lr[k] for k in range(len(ix))]
        _each("sub_", ws, _each("mul", u, steps))
        for k in ix:
            if masters[k] is not weights[k]:
                weights[k].copy_(masters[k])
    return weights


@torch.no_grad()
def group_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """Group AdaGrad, one statistic per row (``optimizer_ops.py:456-475``):
    ``history += mean_j g^2; w -= lr * g / sqrt(history + eps)``."""
    g = _rc(grad, rescale_grad, _pos(clip_gradient))
    history.add_((g * g).mean(dim=tuple(range(1, g.dim()))))
    denom = torch.sqrt(history + epsilon)
    weight.sub_(lr * g / denom.reshape((-1,) + (1,) * (g.dim() - 1)))
    return weight


def multi_all_finite(*arrays, init_output=True, num_arrays=None):
    """1.0 (a 0-d float32 tensor) if every element of every array is
    finite, else 0.0 (``optimizer_ops.py:186-197``): the largest |x| of
    each array (``torch._foreach_norm``, ord inf) is finite exactly when
    the array is."""
    if not arrays:
        return torch.ones((), dtype=torch.float32)
    norms = torch._foreach_norm(list(arrays), float("inf"))
    return torch.isfinite(torch.stack(
        [n.float() for n in norms])).all().float()


def all_finite(*arrays, init_output=True):
    return multi_all_finite(*arrays)


def multi_sum_sq(*arrays, num_arrays=1):
    """Each array's float32 sum of squares (``optimizer_ops.py:200-204``).
    """
    return tuple(torch.sum(torch.square(a.float())) for a in arrays)


@torch.no_grad()
def reset_arrays(*arrays, num_arrays=None):
    """Zero every array in place (MXNet's ``reset_arrays``) and return
    them."""
    for a in arrays:
        a.zero_()
    return arrays


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """LARS rates over a group of layers (``optimizer_ops.py:214-224``):
    ``lr * eta * ||w|| / (||g|| + wd * ||w|| + eps)`` where both norms are
    positive."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * w_norm / (g_norm + wds * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), lrs * ratio, lrs)


def sparse_adagrad_update(*args, **kwargs):
    raise NotImplementedError(
        "_sparse_adagrad_update needs the row-sparse arrays of ROADMAP "
        "Queue 1 item 9, which are not ported")


# ------------------------------------- the ops under mxnet_tpu's names
# Each takes mxnet_tpu's arguments, writes its mutated slots in place and
# returns its primary outputs: the new weight, or a tuple of them.

def _reg(name, fn, aliases=()):
    register(name, aliases=aliases)(fn)


for _name, _fn in (
        ("sgd_update", sgd_update), ("sgd_mom_update", sgd_mom_update),
        ("adam_update", adam_update), ("nag_mom_update", nag_mom_update),
        ("mp_sgd_update", mp_sgd_update),
        ("mp_sgd_mom_update", mp_sgd_mom_update),
        ("mp_nag_mom_update", mp_nag_mom_update),
        ("ftrl_update", ftrl_update), ("rmsprop_update", rmsprop_update),
        ("rmspropalex_update", rmspropalex_update),
        ("signsgd_update", signsgd_update), ("signum_update", signum_update),
        ("ftml_update", ftml_update),
        ("lamb_update_phase1", lamb_update_phase1),
        ("lamb_update_phase2", lamb_update_phase2),
        ("mp_lamb_update_phase1", mp_lamb_update_phase1),
        ("mp_lamb_update_phase2", mp_lamb_update_phase2),
        ("all_finite", all_finite), ("multi_all_finite", multi_all_finite),
        ("multi_lars", multi_lars), ("reset_arrays", reset_arrays)):
    _reg(_name, _fn)
_reg("adamw_update", adamw_update, aliases=("_adamw_update",))
_reg("_mp_adamw_update", mp_adamw_update, aliases=("mp_adamw_update",))
_reg("_contrib_group_adagrad_update", group_adagrad_update,
     aliases=("group_adagrad_update",))
_reg("_sparse_adagrad_update", sparse_adagrad_update,
     aliases=("adagrad_update",))
_reg("multi_sum_sq", multi_sum_sq)


def _floats(v, n):
    return [float(v)] * n if isinstance(v, (int, float)) else \
        [float(x) for x in v]


@register("multi_sgd_update")
def _multi_sgd_update_op(*tensors, lrs=(0.01,), wds=(0.0,),
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """[w0, g0, w1, g1, ...] (``optimizer_ops.py:379-395``)."""
    ws, gs = list(tensors[0::2]), list(tensors[1::2])
    multi_sgd_update(ws, gs, _floats(lrs, num_weights),
                     _floats(wds, num_weights), rescale_grad,
                     _pos(clip_gradient))
    return tuple(ws)


@register("multi_sgd_mom_update")
def _multi_sgd_mom_update_op(*tensors, lrs=(0.01,), wds=(0.0,),
                             momentum=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0, num_weights=1):
    """[w0, g0, mom0, ...] (``optimizer_ops.py:398-419``)."""
    ws, gs, ms = (list(tensors[i::3]) for i in range(3))
    multi_sgd_mom_update(ws, gs, ms, _floats(lrs, num_weights),
                         _floats(wds, num_weights), momentum, rescale_grad,
                         _pos(clip_gradient))
    return tuple(ws)


@register("multi_mp_sgd_update")
def _multi_mp_sgd_update_op(*tensors, lrs=(0.01,), wds=(0.0,),
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """[w0, g0, w32_0, ...] (``optimizer_ops.py:422-443``)."""
    lrs, wds = _floats(lrs, num_weights), _floats(wds, num_weights)
    for i in range(num_weights):
        w, g, w32 = tensors[3 * i:3 * i + 3]
        mp_sgd_update(w, g, w32, lrs[i], wds[i], rescale_grad,
                      _pos(clip_gradient))
    return tuple(tensors[0::3])


@register("multi_mp_sgd_mom_update")
def _multi_mp_sgd_mom_update_op(*tensors, lrs=(0.01,), wds=(0.0,),
                                momentum=0.0, rescale_grad=1.0,
                                clip_gradient=-1.0, num_weights=1):
    """[w0, g0, mom0, w32_0, ...] (``optimizer_ops.py:446-470``)."""
    lrs, wds = _floats(lrs, num_weights), _floats(wds, num_weights)
    for i in range(num_weights):
        w, g, mom, w32 = tensors[4 * i:4 * i + 4]
        mp_sgd_mom_update(w, g, mom, w32, lrs[i], momentum, wds[i],
                          rescale_grad, _pos(clip_gradient))
    return tuple(tensors[0::4])


def _preloaded(tensors, stride, step):
    """[w0, g0, ..., lrs, wds] with device-resident rates: ``step(i, ts,
    lr, wd)`` for each weight's ``stride`` tensors; the new weights."""
    lrs, wds = tensors[-2], tensors[-1]
    body = tensors[:-2]
    for i in range(len(body) // stride):
        step(body[stride * i:stride * (i + 1)], lrs[i], wds[i])
    return tuple(body[0::stride])


@register("preloaded_multi_sgd_update")
def _preloaded_multi_sgd_update_op(*tensors, num_weights=1,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    """(``optimizer_ops.py:248-265``): the step in float32, rounded once."""
    def step(ts, lr, wd):
        w, g = ts
        w32 = w.float()
        mp_sgd_update(w, g, w32, lr, wd, rescale_grad, _pos(clip_gradient))
    return _preloaded(tensors, 2, step)


@register("preloaded_multi_sgd_mom_update")
def _preloaded_multi_sgd_mom_update_op(*tensors, num_weights=1,
                                       momentum=0.0, rescale_grad=1.0,
                                       clip_gradient=-1.0):
    """[w0, g0, mom0, ..., lrs, wds] (``optimizer_ops.py:268-289``)."""
    def step(ts, lr, wd):
        w, g, mom = ts
        m32 = mom.float()
        mp_sgd_mom_update(w, g, m32, w.float(), lr, momentum, wd,
                          rescale_grad, _pos(clip_gradient))
        mom.copy_(m32)
    return _preloaded(tensors, 3, step)


@register("preloaded_multi_mp_sgd_update")
def _preloaded_multi_mp_sgd_update_op(*tensors, num_weights=1,
                                      rescale_grad=1.0, clip_gradient=-1.0):
    """[w0, g0, w32_0, ..., lrs, wds] (``parity_aliases.py:417-432``)."""
    def step(ts, lr, wd):
        w, g, w32 = ts
        mp_sgd_update(w, g, w32, lr, wd, rescale_grad, _pos(clip_gradient))
    return _preloaded(tensors, 3, step)


@register("preloaded_multi_mp_sgd_mom_update")
def _preloaded_multi_mp_sgd_mom_update_op(*tensors, num_weights=1,
                                          momentum=0.0, rescale_grad=1.0,
                                          clip_gradient=-1.0):
    """[w0, g0, mom0, w32_0, ..., lrs, wds] (``parity_aliases.py:
    435-452``)."""
    def step(ts, lr, wd):
        w, g, mom, w32 = ts
        mp_sgd_mom_update(w, g, mom, w32, lr, momentum, wd, rescale_grad,
                          _pos(clip_gradient))
    return _preloaded(tensors, 4, step)


def _multi_adamw(tensors, stride, num_weights, lrs, wds, etas, beta1, beta2,
                 epsilon, rescale_grad, clip_gradient):
    rs = rescale_grad
    if len(tensors) == stride * num_weights + 1:    # a trailing loss scale
        rs, tensors = tensors[-1], tensors[:-1]
    lrs, wds = _floats(lrs, num_weights), _floats(wds, num_weights)
    etas = _floats(etas, num_weights)
    for i in range(num_weights):
        ts = tensors[stride * i:stride * (i + 1)]
        w32 = ts[4] if stride == 5 else None
        new, m, v = _adamw(ts[0], ts[1], ts[2], ts[3], w32, rs, lrs[i],
                           beta1, beta2, epsilon, wds[i], etas[i],
                           _pos(clip_gradient))
        olds = (ts[0], ts[2], ts[3]) + ((w32,) if stride == 5 else ())
        _skip_unless_valid(rs, (new, m, v) + ((new,) if stride == 5 else ()),
                           olds)
    return tuple(tensors[0::stride])


@register("_multi_adamw_update", aliases=("multi_adamw_update",))
def _multi_adamw_update_op(*tensors, num_weights=1, lrs=(0.001,),
                           wds=(0.0,), etas=(1.0,), beta1=0.9, beta2=0.999,
                           epsilon=1e-8, rescale_grad=1.0,
                           clip_gradient=-1.0):
    """[w, g, mean, var]* and an optional trailing rescale tensor
    (``parity_aliases.py:308-337``), skipped as :func:`adamw_update`."""
    return _multi_adamw(tensors, 4, num_weights, lrs, wds, etas, beta1,
                        beta2, epsilon, rescale_grad, clip_gradient)


@register("_multi_mp_adamw_update", aliases=("multi_mp_adamw_update",))
def _multi_mp_adamw_update_op(*tensors, num_weights=1, lrs=(0.001,),
                              wds=(0.0,), etas=(1.0,), beta1=0.9,
                              beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                              clip_gradient=-1.0):
    """[w, g, mean, var, w32]* and an optional trailing rescale tensor
    (``parity_aliases.py:340-370``)."""
    return _multi_adamw(tensors, 5, num_weights, lrs, wds, etas, beta1,
                        beta2, epsilon, rescale_grad, clip_gradient)


def _multi_lamb_op(tensors, stride, num_tensors, learning_rates, wds, beta1,
                   beta2, epsilon, rescale_grad, clip_gradient,
                   bias_correction, step_count, lower_bound, upper_bound):
    ts = [tensors[stride * i:stride * (i + 1)] for i in range(num_tensors)]
    steps = [step_count[i] if i < len(step_count) else 1
             for i in range(num_tensors)]
    bc = [(1 - beta1 ** t, 1 - beta2 ** t) for t in steps] \
        if bias_correction else None
    weights = [t[0] for t in ts]
    multi_lamb_update(
        weights, [t[1] for t in ts], [t[2] for t in ts], [t[3] for t in ts],
        list(learning_rates), list(wds), beta1, beta2, epsilon,
        rescale_grad, _pos(clip_gradient), bc, _pos(lower_bound),
        _pos(upper_bound),
        weights32=[t[4] for t in ts] if stride == 5 else None)
    return tuple(weights)


@register("multi_lamb_update", aliases=("_multi_lamb_update",))
def _multi_lamb_update_op(*tensors, num_tensors=1, learning_rates=(),
                          wds=(), beta1=0.9, beta2=0.999, epsilon=1e-6,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          bias_correction=True, step_count=(),
                          lower_bound=-1.0, upper_bound=-1.0):
    """[w0, g0, mean0, var0, w1, ...] (``optimizer_ops.py:248-...``, MXNet's
    multi_lamb.cc): weights and moments in place."""
    return _multi_lamb_op(tensors, 4, num_tensors, learning_rates, wds,
                          beta1, beta2, epsilon, rescale_grad, clip_gradient,
                          bias_correction, step_count, lower_bound,
                          upper_bound)


@register("_multi_mp_lamb_update", aliases=("multi_mp_lamb_update",))
def _multi_mp_lamb_update_op(*tensors, num_tensors=1, learning_rates=(),
                             wds=(), beta1=0.9, beta2=0.999, epsilon=1e-6,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             bias_correction=True, step_count=(),
                             lower_bound=-1.0, upper_bound=-1.0):
    """[w0, g0, mean0, var0, w32_0, w1, ...]: five tensors a weight, the
    step on the fp32 master, as MXNet's multi_lamb.cc (``mxnet_tpu``
    aliases the four-tensor op, ``parity_aliases.py:473``)."""
    return _multi_lamb_op(tensors, 5, num_tensors, learning_rates, wds,
                          beta1, beta2, epsilon, rescale_grad, clip_gradient,
                          bias_correction, step_count, lower_bound,
                          upper_bound)
