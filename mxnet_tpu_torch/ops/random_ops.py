"""Random sampling and density ops (port of ``mxnet_tpu/ops/random_ops.py``;
parity: src/operator/random/sample_op.cc, multisample_op.cc, pdf_op.cc).

``mxnet_tpu`` threads a JAX key cell through every sampler as a mutable
input. The port draws from an explicit ``torch.Generator`` instead: each
sampler takes ``generator`` (and the zero-input ones ``device``), which
``mx.nd`` supplies from :mod:`mxnet_tpu_torch.random` (one generator per
device, seeded by ``mx.random.seed``). A torch generator cannot repeat
JAX's bits, so samplers are held to their statistics and the pdf ops,
which are deterministic, to values. Every draw goes through the
generator: the gamma family by Marsaglia and Tsang's method on its
normals and uniforms (``torch._standard_gamma`` takes no generator).
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


def _dt(dtype):
    return torch_dtype(dtype) if dtype not in (None, "None") else \
        torch.float32


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape or ())


def standard_gamma(alpha, generator=None):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (float32 math) by
    Marsaglia and Tsang: ``d (1 + c z)^3`` accepted with ``log u < z^2 / 2
    + d - d v + d log v``, rounds repeated until every element is
    accepted; ``alpha < 1`` boosted by ``u^(1 / alpha)``."""
    a = alpha.float()
    boost = a < 1
    a1 = torch.where(boost, a + 1, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a1)
    todo = torch.ones_like(a1, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a1.shape, generator=generator, device=a1.device)
        u = torch.rand(a1.shape, generator=generator, device=a1.device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38)) < 0.5 * z * z + d
                        - d * v + d * torch.log(v.clamp_min(1e-38)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if bool(boost.any()):
        u = torch.rand(a1.shape, generator=generator, device=a1.device)
        out = torch.where(boost, out * u.pow(1.0 / a), out)
    return out


def _poisson(rate, generator):
    return torch.poisson(rate.float(), generator=generator)


# --------------------------------------------- scalar-parameter samplers

def _sampler(name, draw):
    def op(shape=(), dtype="float32", device=None, generator=None, **kw):
        return draw(_shape(shape), device, generator, **kw).to(_dt(dtype))

    op.__name__ = name
    op.__doc__ = f"{name}: draws of ``shape`` from ``generator``."
    register(name, no_grad=True)(op)


def _uniform(s, dev, g, low=0.0, high=1.0):
    return torch.rand(s, generator=g, device=dev) * (high - low) + low


def _normal(s, dev, g, loc=0.0, scale=1.0):
    return torch.randn(s, generator=g, device=dev) * scale + loc


def _gamma(s, dev, g, alpha=1.0, beta=1.0):
    return standard_gamma(torch.full(s, float(alpha), device=dev), g) * beta


def _exponential(s, dev, g, lam=1.0):
    return torch.empty(s, device=dev).exponential_(lam, generator=g)


def _poisson_draw(s, dev, g, lam=1.0):
    return _poisson(torch.full(s, float(lam), device=dev), g)


def _negative_binomial(s, dev, g, k=1, p=1.0, k_param=None):
    """``k`` failures (``k_param``: ``mxnet_tpu``'s name for it)."""
    k = k if k_param is None else k_param
    rate = standard_gamma(torch.full(s, float(k), device=dev), g)
    return _poisson(rate * (1 - p) / p, g)


def _gen_negative_binomial(s, dev, g, mu=1.0, alpha=1.0):
    rate = standard_gamma(torch.full(s, 1.0 / alpha, device=dev), g)
    return _poisson(rate * alpha * mu, g)


def _randint(s, dev, g, low=0, high=1):
    return torch.randint(int(low), int(high), s, generator=g, device=dev)


def _bernoulli(s, dev, g, p=0.5):
    return torch.bernoulli(torch.full(s, float(p), device=dev), generator=g)


for _name, _draw in (("_random_uniform", _uniform),
                     ("_random_normal", _normal),
                     ("_random_gamma", _gamma),
                     ("_random_exponential", _exponential),
                     ("_random_poisson", _poisson_draw),
                     ("_random_negative_binomial", _negative_binomial),
                     ("_random_generalized_negative_binomial",
                      _gen_negative_binomial),
                     ("_random_randint", _randint),
                     ("_random_bernoulli", _bernoulli)):
    _sampler(_name, _draw)


@register("_sample_multinomial", no_grad=True)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        generator=None):
    """Category draws from the probabilities in ``data``'s last axis: of
    ``shape`` for a 1-D ``data``, else of ``data.shape[:-1] + shape``."""
    shape = _shape(shape)
    n = max(1, math.prod(shape)) if shape else 1
    probs = data.reshape(-1, data.shape[-1]).float()
    out = torch.multinomial(probs, n, replacement=True, generator=generator)
    lead = tuple(data.shape[:-1])
    out = out.reshape(lead + shape) if shape else out.reshape(lead)
    return out.to(_dt(dtype))


@register("_shuffle", no_grad=True)
def _shuffle(data, generator=None):
    """``data``'s rows in a random order."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


# ---------------------------------------------- array-parameter samplers

def _bshape(p, s):
    return p.reshape(tuple(p.shape) + (1,) * (len(s) - p.dim()))


def _elem_sampler(name, draw):
    def op(param1, param2, shape=None, dtype="float32", generator=None):
        s = tuple(param1.shape) + _shape(shape)
        return draw(param1, param2, s, generator).to(_dt(dtype))

    op.__name__ = name
    op.__doc__ = (f"{name}: per-element parameters, ``shape`` draws each "
                  "(multisample_op.cc).")
    register(name, no_grad=True)(op)


_elem_sampler("_sample_uniform", lambda lo, hi, s, g: torch.rand(
    s, generator=g, device=lo.device) * _bshape(hi - lo, s) + _bshape(lo, s))
_elem_sampler("_sample_normal", lambda mu, sig, s, g: torch.randn(
    s, generator=g, device=mu.device) * _bshape(sig, s) + _bshape(mu, s))
_elem_sampler("_sample_gamma", lambda a, b, s, g: standard_gamma(
    _bshape(a, s).expand(s), g) * _bshape(b, s))


# -------------------------------------------------------------------- pdf ops
# Densities of ``sample`` (batch..., n) under parameters (batch...,)
# broadcast over the trailing sample axis; differentiable in both.

def _pdf_op(name, log_fn):
    def op(sample, *params, is_log=False):
        lp = log_fn(sample, *[p[..., None] for p in params])
        return lp if is_log else torch.exp(lp)

    op.__name__ = name
    op.__doc__ = (f"{name}: density (log-density with is_log=True) of "
                  "``sample`` under the parameters (pdf_op.cc).")
    register(name)(op)


def _neg_inf(x):
    return torch.full_like(x, -math.inf)


_pdf_op("_random_pdf_uniform", lambda x, lo, hi: torch.where(
    (x >= lo) & (x <= hi), -torch.log(hi - lo).expand_as(x), _neg_inf(x)))
_pdf_op("_random_pdf_normal", lambda x, mu, sigma: (
    -0.5 * torch.square((x - mu) / sigma) - torch.log(sigma)
    - 0.5 * math.log(2 * math.pi)))
_pdf_op("_random_pdf_exponential", lambda x, lam: torch.where(
    x >= 0, torch.log(lam) - lam * x, _neg_inf(x)))
_pdf_op("_random_pdf_gamma", lambda x, alpha, beta: torch.where(
    x > 0, alpha * torch.log(beta) + (alpha - 1) * torch.log(x) - beta * x
    - torch.lgamma(alpha), _neg_inf(x)))
_pdf_op("_random_pdf_poisson", lambda x, lam: (
    x * torch.log(lam) - lam - torch.lgamma(x + 1)))
_pdf_op("_random_pdf_negative_binomial", lambda x, k, p: (
    torch.lgamma(x + k) - torch.lgamma(x + 1) - torch.lgamma(k)
    + k * torch.log(p) + x * torch.log1p(-p)))


@register("_random_pdf_generalized_negative_binomial")
def _pdf_gnb(sample, mu, alpha, is_log=False):
    """Generalized negative binomial density: mean ``mu``, dispersion
    ``alpha``."""
    mu, alpha = mu[..., None], alpha[..., None]
    r = 1.0 / alpha
    p = r / (r + mu)
    x = sample
    lp = (torch.lgamma(x + r) - torch.lgamma(x + 1) - torch.lgamma(r)
          + r * torch.log(p) + x * torch.log1p(-p))
    return lp if is_log else torch.exp(lp)


@register("_random_pdf_dirichlet")
def _pdf_dirichlet(sample, alpha, is_log=False):
    """Dirichlet density: ``sample`` (..., n, k), ``alpha`` (..., k)."""
    a = alpha[..., None, :]
    lp = (torch.sum((a - 1) * torch.log(sample), dim=-1)
          + torch.lgamma(torch.sum(a, dim=-1))
          - torch.sum(torch.lgamma(a), dim=-1))
    return lp if is_log else torch.exp(lp)
