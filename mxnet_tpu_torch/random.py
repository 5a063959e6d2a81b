"""``mx.random``: seeded sampling over one generator per device (port of
``mxnet_tpu/random.py``; parity: python/mxnet/random.py).

``mxnet_tpu`` keeps one JAX key in an NDArray cell and threads it through
every sampling op. The port keeps one ``torch.Generator`` per device
instead (:func:`generator`), which ``mx.nd`` hands to every op that takes
one (the samplers, Dropout, ``NDArrayIter``'s shuffle on the CPU).
:func:`seed` seeds every generator, those made later included, so a seed
repeats every draw bit for bit on the same device. A torch generator
cannot repeat JAX's bits: the two packages agree on the distributions, not
on the draws. Unseeded, a generator starts from a seed drawn from numpy's
global generator, as ``mxnet_tpu``'s key cell does.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint",
           "gamma", "exponential", "poisson", "bernoulli", "multinomial",
           "shuffle"]

_GENERATORS: dict = {}
_SEED = {"value": None}


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device="cpu"):
    """The generator of ``device`` (a ``torch.device`` or its name), made
    and seeded at its first use."""
    device = _key(device)
    g = _GENERATORS.get(device)
    if g is None:
        g = torch.Generator(device=device)
        s = _SEED["value"]
        g.manual_seed(int(_np.random.randint(0, 2 ** 31 - 1)) if s is None
                      else s)
        _GENERATORS[device] = g
    return g


def seed(seed_state, ctx="all"):
    """Seed the generator of ``ctx`` (a Context), or every generator with
    ``ctx='all'`` (those made later too)."""
    s = int(seed_state)
    if ctx == "all":
        _SEED["value"] = s
        for g in _GENERATORS.values():
            g.manual_seed(s)
    else:
        generator(ctx.torch_device()).manual_seed(s)


def _invoke(opname, *arrays, ctx=None, out=None, **kw):
    from .ndarray.ndarray import imperative_invoke

    if ctx is None and out is not None:
        ctx = out.context
    if ctx is not None:
        kw["ctx"] = ctx
    return imperative_invoke(opname, *arrays, out=out, **kw)[0]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _is_nd(x):
    from .ndarray.ndarray import NDArray

    return isinstance(x, NDArray)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    if _is_nd(low):
        return _invoke("_sample_uniform", low, high, shape=_shape(shape),
                       dtype=dtype, out=out)
    return _invoke("_random_uniform", shape=_shape(shape), dtype=str(dtype),
                   low=float(low), high=float(high), ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    if _is_nd(loc):
        return _invoke("_sample_normal", loc, scale, shape=_shape(shape),
                       dtype=dtype, out=out)
    return _invoke("_random_normal", shape=_shape(shape), dtype=str(dtype),
                   loc=float(loc), scale=float(scale), ctx=ctx, out=out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _invoke("_random_randint", shape=_shape(shape), dtype=str(dtype),
                   low=int(low), high=int(high), ctx=ctx, out=out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    if _is_nd(alpha):
        return _invoke("_sample_gamma", alpha, beta, shape=_shape(shape),
                       dtype=dtype, out=out)
    return _invoke("_random_gamma", shape=_shape(shape), dtype=str(dtype),
                   alpha=float(alpha), beta=float(beta), ctx=ctx, out=out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _invoke("_random_exponential", shape=_shape(shape),
                   dtype=str(dtype), lam=1.0 / float(scale), ctx=ctx, out=out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _invoke("_random_poisson", shape=_shape(shape), dtype=str(dtype),
                   lam=float(lam), ctx=ctx, out=out)


def bernoulli(p=0.5, shape=None, dtype="float32", ctx=None, out=None):
    return _invoke("_random_bernoulli", shape=_shape(shape),
                   dtype=str(dtype), p=float(p), ctx=ctx, out=out)


def multinomial(data, shape=None, get_prob=False, dtype="int32"):
    return _invoke("_sample_multinomial", data, shape=_shape(shape),
                   get_prob=get_prob, dtype=str(dtype))


def shuffle(data, out=None):
    return _invoke("_shuffle", data, out=out)
