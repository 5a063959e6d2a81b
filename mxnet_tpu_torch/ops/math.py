"""Elementwise, reduction, matrix, linalg, layout, indexing and ordering
ops (port of ``mxnet_tpu/ops/math.py``; parity: src/operator/tensor/*).

Every op of ``mxnet_tpu/ops/math.py`` under its names and aliases, in its
sections: binary broadcast (``:25``), comparisons (``:77``), unary
(``:103``), reductions (``:180``), matmul (``:275``), linalg (``:309``),
reshape family (``:410``), indexing (``:620``), ordering (``:736``) and
misc (``:770``). ``mxnet_tpu`` computes them in XLA, not in Pallas, so
plain PyTorch is their port. Where torch differs the reference's
semantics are kept: comparisons return the input's float dtype as 0/1,
``take`` / ``pick`` / ``Embedding`` clip out-of-range ids, ``topk`` takes
``ret_typ`` and ``is_ascend``, argmax-style results are float32. Where
``mxnet_tpu`` differs from MXNet the port follows MXNet: ``Reshape``'s
special codes (``_reshape_shape``; ROADMAP "Reference defects") and
``pick``'s clip mode.
"""
from __future__ import annotations

import builtins

import numpy as _np
import torch
import torch.nn.functional as F

from ..amp.amp import cast_op
from ..base import MXNetError, torch_dtype
from .registry import drop_num_args, register

__all__ = ["embedding", "pick", "sum", "mean", "arange", "transpose",
           "space_to_depth", "log", "exp", "square", "norm"]


def _float_like(a):
    """The dtype a 0/1 result takes: ``a``'s when it is a float, else
    float32 (``mxnet_tpu/ops/math.py:77-83``)."""
    return a.dtype if a.is_floating_point() else torch.float32


def _as_tensor_like(v, a):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=a.dtype if a.is_floating_point() else None, device=a.device)


def _int_index(t):
    return t.to(torch.int64)


def _axis_tuple(axis, ndim):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in ax) if ndim else ax


# ------------------------------------------------------------ binary (bcast)
# The Symbol operators' ops under their MXNet names
# (``mxnet_tpu/ops/math.py:35-72``)
register("elemwise_add", aliases=("broadcast_add", "broadcast_plus",
                                  "_plus", "_add"))(lambda a, b: a + b)
register("elemwise_sub", aliases=("broadcast_sub", "broadcast_minus",
                                  "_sub", "_minus"))(lambda a, b: a - b)
register("elemwise_mul", aliases=("broadcast_mul", "_mul"))(
    lambda a, b: a * b)
register("elemwise_div", aliases=("broadcast_div", "_div"))(
    lambda a, b: a / b)


def _mod(a, b):
    """numpy's ``mod`` (the divisor's sign), as ``jnp.mod``."""
    return torch.remainder(a, b)


register("elemwise_mod", aliases=("broadcast_mod", "_mod"))(_mod)
register("elemwise_pow", aliases=("broadcast_power", "_power", "_pow"))(
    lambda a, b: torch.pow(a, b))
register("broadcast_maximum", aliases=("maximum", "_maximum"))(
    lambda a, b: torch.maximum(a, b))
register("broadcast_minimum", aliases=("minimum", "_minimum"))(
    lambda a, b: torch.minimum(a, b))
register("broadcast_hypot")(lambda a, b: torch.hypot(a, b))
register("broadcast_logaddexp")(lambda a, b: torch.logaddexp(a, b))


@register("elemwise_add_scalar", aliases=("_plus_scalar",))
def _add_scalar(a, scalar=0.0, reverse=False):
    return a + scalar


@register("elemwise_sub_scalar", aliases=("_minus_scalar",
                                          "_rminus_scalar"))
def _sub_scalar(a, scalar=0.0, reverse=False):
    return scalar - a if reverse else a - scalar


@register("elemwise_mul_scalar", aliases=("_mul_scalar",))
def _mul_scalar(a, scalar=1.0, reverse=False):
    return a * scalar


@register("elemwise_div_scalar", aliases=("_div_scalar", "_rdiv_scalar"))
def _div_scalar(a, scalar=1.0, reverse=False):
    return torch.full_like(a, scalar) / a if reverse else a / scalar


@register("elemwise_mod_scalar", aliases=("_mod_scalar", "_rmod_scalar"))
def _mod_scalar(a, scalar=1.0, reverse=False):
    s = _as_tensor_like(scalar, a)
    return _mod(s, a) if reverse else _mod(a, s)


@register("elemwise_pow_scalar", aliases=("_power_scalar",
                                          "_rpower_scalar"))
def _pow_scalar(a, scalar=1.0, reverse=False):
    return torch.pow(_as_tensor_like(scalar, a), a) if reverse \
        else torch.pow(a, scalar)


# ---------------------------------------------------------------- comparisons

def _cmp(name, fn):
    def _f(a, b):
        return fn(a, b).to(_float_like(a))

    def _fs(a, scalar=0.0, reverse=False):
        s = _as_tensor_like(scalar, a)
        return (fn(s, a) if reverse else fn(a, s)).to(_float_like(a))

    register(name, no_grad=True)(_f)
    register(name + "_scalar", no_grad=True)(_fs)


_cmp("broadcast_equal", torch.eq)
_cmp("broadcast_not_equal", torch.ne)
_cmp("broadcast_greater", torch.gt)
_cmp("broadcast_greater_equal", torch.ge)
_cmp("broadcast_lesser", torch.lt)
_cmp("broadcast_lesser_equal", torch.le)
register("broadcast_logical_and", no_grad=True)(
    lambda a, b: torch.logical_and(a, b).to(a.dtype))
register("broadcast_logical_or", no_grad=True)(
    lambda a, b: torch.logical_or(a, b).to(a.dtype))
register("broadcast_logical_xor", no_grad=True)(
    lambda a, b: torch.logical_xor(a, b).to(a.dtype))
register("logical_not", no_grad=True)(
    lambda a: torch.logical_not(a).to(a.dtype))


# ---------------------------------------------------------------------- unary

@cast_op("log")
def log(data):
    return torch.log(data)


@cast_op("exp")
def exp(data):
    return torch.exp(data)


@cast_op("square")
def square(data):
    return data * data


def _cbrt(a):
    return torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "square": square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt, "rcbrt": lambda a: 1.0 / _cbrt(a),
    "exp": exp, "log": log, "log10": torch.log10, "log2": torch.log2,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "gamma": lambda a: torch.exp(torch.lgamma(a)), "gammaln": torch.lgamma,
    "erf": torch.erf, "erfinv": torch.erfinv,
    "reciprocal": lambda a: 1.0 / a,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "relu": torch.relu, "sigmoid": torch.sigmoid,
    "softsign": F.softsign, "digamma": torch.digamma,
}
_UNARY_NO_GRAD = {
    "sign": torch.sign, "round": torch.round, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc,
}


def _unary(fn):
    def op(data):
        return fn(data)
    return op


for _name, _fn in _UNARY.items():
    register(_name)(_unary(_fn))
for _name, _fn in _UNARY_NO_GRAD.items():
    register(_name, no_grad=True)(_unary(_fn))
register("negative", aliases=("_np_negative",))(lambda a: -a)
register("identity", aliases=("_copy", "stop_gradient_identity",
                              "BlockGrad_inner"))(lambda a: a.clone())
register("BlockGrad", no_grad=True, aliases=("stop_gradient",))(
    lambda a: a.detach().clone())
register("make_loss")(lambda a, grad_scale=1.0: a.clone())
register("isnan", no_grad=True)(lambda a: torch.isnan(a).float())
register("isinf", no_grad=True)(lambda a: torch.isinf(a).float())
register("isfinite", no_grad=True)(lambda a: torch.isfinite(a).float())


@register("clip")
def _clip(a, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return a.clone()
    return torch.clamp(a, a_min, a_max)


@register("Cast", aliases=("cast",))
def _cast(a, dtype="float32"):
    return a.to(torch_dtype(dtype))


@register("amp_cast")
def _amp_cast(a, dtype="float32"):
    return a.to(torch_dtype(dtype))


@register("amp_multicast", num_outputs=lambda p: p.get("num_outputs", 1))
def _amp_multicast(*arrays, num_outputs=1):
    widest = arrays[0].dtype
    for a in arrays[1:]:
        widest = torch.promote_types(widest, a.dtype)
    return tuple(a.to(widest) for a in arrays)


# ----------------------------------------------------------------- reductions

def _axes(data, axis, exclude):
    """The reduced axes: ``axis`` (all when None), or with ``exclude``
    every axis but those (``mxnet_tpu/ops/math.py:192-196``)."""
    if axis is None:
        return tuple(range(data.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    if exclude:
        keep = {a % data.dim() for a in ax}
        return tuple(i for i in range(data.dim()) if i not in keep)
    return ax


@cast_op("sum")
def sum(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    """Sum over ``axis`` (``mxnet_tpu/ops/math.py:186-189``)."""
    axes = _axes(data, axis, exclude)
    return torch.sum(data, dim=axes, keepdim=keepdims) if axes \
        else data.clone()


@cast_op("mean")
def mean(data, axis=None, keepdims=False, exclude=False):
    """Mean over ``axis`` (``mxnet_tpu/ops/math.py:199-201``)."""
    axes = _axes(data, axis, exclude)
    return torch.mean(data, dim=axes, keepdim=keepdims) if axes \
        else data.clone()


register("sum", aliases=("sum_axis", "_np_sum"))(sum)
register("mean")(mean)


@cast_op("prod")
def _prod(a, axis=None, keepdims=False, exclude=False):
    out = a
    for ax in sorted(_axes(a, axis, exclude), reverse=True):
        out = torch.prod(out, dim=ax, keepdim=keepdims)
    return out


register("prod")(_prod)


@register("max", aliases=("max_axis",))
def _max(a, axis=None, keepdims=False, exclude=False):
    return torch.amax(a, dim=_axes(a, axis, exclude), keepdim=keepdims)


@register("min", aliases=("min_axis",))
def _min(a, axis=None, keepdims=False, exclude=False):
    return torch.amin(a, dim=_axes(a, axis, exclude), keepdim=keepdims)


@register("nansum")
@cast_op("nansum")
def _nansum(a, axis=None, keepdims=False):
    return torch.nansum(a, dim=_axes(a, axis, False), keepdim=keepdims)


@register("nanprod")
@cast_op("nanprod")
def _nanprod(a, axis=None, keepdims=False):
    return _prod(torch.where(torch.isnan(a), torch.ones_like(a), a), axis,
                 keepdims)


@cast_op("norm")
def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    """The ``ord`` norm over ``axis`` (all axes when None; the L2 norm of
    the flattened array there, ``mxnet_tpu/ops/math.py:216-220``)."""
    if ord == 2 and axis is None:
        return torch.sqrt(torch.sum(data * data, dim=tuple(range(
            data.dim())), keepdim=keepdims))
    return torch.linalg.vector_norm(data, ord=ord, dim=axis,
                                    keepdim=keepdims)


register("norm")(norm)


@register("L2Normalization")
@cast_op("L2Normalization")
def _l2norm(a, eps=1e-10, mode="instance"):
    if mode == "instance":
        flat = a.reshape(a.shape[0], -1)
        n = torch.sqrt(torch.sum(flat * flat, dim=1, keepdim=True) + eps)
        return (flat / n).reshape(a.shape)
    if mode == "channel":
        return a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + eps)
    return a / torch.sqrt(torch.sum(a * a) + eps)


def _arg_reduce(fn, a, axis, keepdims):
    if axis is None:
        out = fn(a.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * a.dim())
    else:
        out = fn(a, dim=axis, keepdim=bool(keepdims))
    return out.float()


@register("argmax", no_grad=True)
def _argmax(a, axis=None, keepdims=False):
    return _arg_reduce(torch.argmax, a, axis, keepdims)


@register("argmin", no_grad=True)
def _argmin(a, axis=None, keepdims=False):
    return _arg_reduce(torch.argmin, a, axis, keepdims)


@register("argmax_channel", no_grad=True)
def _argmax_channel(a):
    return torch.argmax(a, dim=1).float()


def _cum(fn, a, axis, dtype):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return fn(a, dim=axis, dtype=torch_dtype(dtype) if dtype else None)


@register("cumsum")
@cast_op("cumsum")
def _cumsum(a, axis=None, dtype=None):
    return _cum(torch.cumsum, a, axis, dtype)


@register("cumprod")
def _cumprod(a, axis=None, dtype=None):
    return _cum(torch.cumprod, a, axis, dtype)


# -------------------------------------------------------------------- matmul

@register("dot")
@cast_op("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """``mxnet_tpu/ops/math.py:275-289``: the product over ``a``'s last and
    ``b``'s first axis; a transpose moves ``a``'s first axis last or ``b``'s
    last axis first."""
    if transpose_a:
        a = a.t() if a.dim() == 2 else torch.movedim(a, 0, -1)
    if transpose_b:
        b = b.t() if b.dim() == 2 else torch.movedim(b, -1, 0)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
@cast_op("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("khatri_rao", param_normalizer=drop_num_args)
def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


# ---------------------------------------------------------------- linalg

def _t(a):
    return a.transpose(-1, -2)


@register("linalg_gemm")
@cast_op("linalg_gemm")
def _linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * torch.matmul(a, b) + beta * c


@register("linalg_gemm2")
@cast_op("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
@cast_op("linalg_potrf")
def _potrf(a):
    return torch.linalg.cholesky(a)


@register("linalg_potri")
def _potri(a):
    """The inverse of ``L L^T`` from its Cholesky factor ``a``."""
    inv_l = torch.linalg.inv(a)
    return torch.matmul(_t(inv_l), inv_l)


def _tri_solve(a, b, lower, trans):
    """Solve ``op(a) x = b`` for triangular ``a`` (``op`` a transpose when
    ``trans``), reading only ``a``'s triangle, as ``solve_triangular``."""
    m = _t(a) if trans else a
    return torch.linalg.solve_triangular(m, b, upper=lower == bool(trans))


@register("linalg_trsm")
@cast_op("linalg_trsm")
def _trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    if rightside:
        return alpha * _t(_tri_solve(_t(a), _t(b), not lower, transpose))
    return alpha * _tri_solve(a, b, lower, transpose)


@register("linalg_trmm")
def _trmm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    t = torch.tril(a) if lower else torch.triu(a)
    t = _t(t) if transpose else t
    return alpha * (torch.matmul(b, t) if rightside else torch.matmul(t, b))


@register("linalg_syrk")
def _syrk(a, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


@register("linalg_gelqf", num_outputs=2)
def _gelqf(a):
    """(L, Q) with ``a = L Q``, from the QR of ``a^T``; unique up to the
    signs of Q's rows."""
    q, r = torch.linalg.qr(_t(a))
    return _t(r), _t(q)


@register("linalg_syevd", num_outputs=2)
def _syevd(a):
    """(U, w): the eigenvectors as rows of U, ascending eigenvalues w."""
    w, v = torch.linalg.eigh(a)
    return _t(v), w


@register("linalg_sumlogdiag")
def _sumlogdiag(a):
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_extractdiag")
def _extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1).clone()


@register("linalg_makediag")
def _makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


@register("linalg_det")
def _det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet", num_outputs=2)
def _slogdet(a):
    s, logabs = torch.linalg.slogdet(a)
    return s, logabs


@register("linalg_inverse")
def _inverse(a):
    return torch.linalg.inv(a)


# ------------------------------------------------------------------- reshape

def _reshape_shape(src, shape, reverse=False):
    """MXNet's ``Reshape`` target (matrix_op-inl.h InferReshapeShape):
    0 copies an input dim, -1 is inferred, -2 copies every remaining dim,
    -3 merges two dims, -4 splits one into the next two entries (one of
    them may be -1). Each code but -2 and -3 consumes one input dim.
    ``mxnet_tpu``'s reading (``ops/math.py:412-437``) differs: its -1
    consumes none, -2 copies one dim and -4 is skipped (ROADMAP
    "Reference defects")."""
    src, shape = list(src), list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out += [d1, d2]
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out[::-1] if reverse else out)


@register("Reshape", aliases=("reshape",))
def _reshape(a, shape=None, reverse=False):
    return a.reshape(_reshape_shape(a.shape, shape, reverse))


@register("transpose")
def transpose(data, axes=None):
    """Permute the axes (reversed when ``axes`` is None or empty)."""
    if not axes:
        axes = tuple(range(data.dim() - 1, -1, -1))
    return data.permute(*axes)


@register("expand_dims")
def _expand_dims(a, axis=0):
    return a.unsqueeze(axis)


@register("squeeze")
def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(_axis_tuple(axis, a.dim()))


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(a, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(a.shape)
    for ax, s in zip(axis, size):
        shape[ax] = s
    return a.expand(shape).contiguous()


@register("broadcast_to")
def _broadcast_to(a, shape=()):
    lead = len(shape) - a.dim()
    shape = tuple(a.shape[i - lead] if s == 0 else s
                  for i, s in enumerate(shape))
    return a.expand(shape).contiguous()


@register("broadcast_like")
def _broadcast_like(a, b, lhs_axes=None, rhs_axes=None):
    return a.expand(b.shape).contiguous()


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxes(a, dim1=0, dim2=0):
    return a.transpose(dim1, dim2)


def _take_slice(a, dim, sl):
    """``a`` sliced along ``dim`` by a Python slice; a negative step
    gathers (torch slices take positive steps only)."""
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * a.dim()
        idx[dim] = sl
        return a[tuple(idx)]
    ids = torch.arange(*sl.indices(a.shape[dim]), device=a.device)
    return torch.index_select(a, dim, ids)


@register("slice")
def _slice(a, begin=(), end=(), step=()):
    step = step or [None] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        a = _take_slice(a, d, slice(b, e, s or None))
    return a


@register("slice_axis")
def _slice_axis(a, axis=0, begin=0, end=None):
    return _take_slice(a, axis % a.dim(), slice(begin, end))


@register("slice_like")
def _slice_like(a, b, axes=()):
    for ax in (axes or range(a.dim())):
        a = _take_slice(a, ax % a.dim(), slice(0, b.shape[ax]))
    return a


@register("Concat", aliases=("concat",), param_normalizer=drop_num_args)
@cast_op("Concat")
def _concat(*arrays, dim=1):
    return torch.cat(arrays, dim=dim)


@register("stack", param_normalizer=drop_num_args)
@cast_op("stack")
def _stack(*arrays, axis=0):
    return torch.stack(arrays, dim=axis)


def _squeezed(parts, axis, squeeze_axis):
    return tuple(p.squeeze(axis) for p in parts) if squeeze_axis \
        else tuple(parts)


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda p: p.get("num_outputs", 1))
def _split(a, num_outputs=1, axis=1, squeeze_axis=False):
    if a.shape[axis] % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {a.shape[axis]} does "
                         f"not split into {num_outputs} equal parts")
    parts = _squeezed(torch.tensor_split(a, num_outputs, dim=axis), axis,
                      squeeze_axis)
    return parts if len(parts) > 1 else parts[0]


def _split_v2_nout(p):
    if p.get("_num_outputs"):
        return p["_num_outputs"]
    ind = p.get("indices", ())
    if isinstance(ind, int):
        return p.get("sections") or ind
    return p.get("sections") or (len(tuple(ind)) + 1)


@register("split_v2", aliases=("_split_v2",), num_outputs=_split_v2_nout)
def _split_v2(a, indices=(), axis=0, squeeze_axis=False, sections=0,
              _num_outputs=None):
    """numpy's split: an int (or ``sections``) gives equal sections, a
    tuple the split points."""
    if isinstance(indices, int) and not sections:
        sections, indices = indices, ()
    if sections:
        parts = torch.tensor_split(a, sections, dim=axis)
    else:
        parts = torch.tensor_split(a, list(indices), dim=axis)
    return _squeezed(parts, axis, squeeze_axis)


@register("tile")
def _tile(a, reps=()):
    return torch.tile(a, (reps,) if isinstance(reps, int) else tuple(reps))


@register("repeat")
def _repeat(a, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


@register("pad", aliases=("Pad",))
def _pad(a, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` (before, after) per axis, first axis first."""
    pairs = list(zip(pad_width[::2], pad_width[1::2]))
    flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
    if mode == "constant":
        return F.pad(a, flat, value=constant_value)
    # replicate / reflect pad the trailing axes of a batched input
    lead = next((i for i, p in enumerate(pairs) if p != (0, 0)), a.dim())
    lead = builtins.min(lead, a.dim() - 1)
    x = a.reshape((-1,) + tuple(a.shape[lead:])) if lead else a.unsqueeze(0)
    tail = [p for lo_hi in reversed(pairs[lead:]) for p in lo_hi]
    out = F.pad(x, tail, mode={"edge": "replicate",
                               "reflect": "reflect"}[mode])
    return out.reshape(tuple(a.shape[:lead]) + tuple(out.shape[1:])) \
        if lead else out.squeeze(0)


@register("flip")
def _flip(a, axis=0):
    return torch.flip(a, _axis_tuple(axis, a.dim()))


@register("reverse", aliases=("_reverse",))
def _reverse(a, axis=0):
    """Reverse along axes (matrix_op.cc reverse)."""
    return torch.flip(a, _axis_tuple(axis, a.dim()))


@register("depth_to_space")
def _depth_to_space(a, block_size=1):
    n, c, h, w = a.shape
    b = block_size
    x = a.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    """(N, C, H, W) -> (N, C*b*b, H/b, W/b) with output channels ordered
    (bh, bw, C) (``mxnet_tpu/ops/math.py:584-590``). ``F.pixel_unshuffle``
    orders them (C, bh, bw), which would permute a carried stem weight."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def _diag(a, k=0, axis1=0, axis2=1):
    if a.dim() == 1:
        return torch.diag(a, k)
    return torch.diagonal(a, offset=k, dim1=axis1, dim2=axis2).clone()


@register("shape_array", no_grad=True)
def _shape_array(a):
    return torch.tensor(a.shape, dtype=torch.int32, device=a.device)


@register("size_array", no_grad=True)
def _size_array(a):
    return torch.tensor([a.numel()], dtype=torch.int32, device=a.device)


register("zeros_like", no_grad=True)(lambda a: torch.zeros_like(a))
register("ones_like", no_grad=True)(lambda a: torch.ones_like(a))


@register("Flatten", aliases=("flatten",))
def _flatten(a):
    return a.reshape(a.shape[0], -1)


# ------------------------------------------------------------------- indexing

def _clip_ids(ids, n, mode="clip"):
    ids = _int_index(ids)
    if mode == "wrap":
        return torch.remainder(ids, n)
    if mode != "clip":
        raise ValueError(f"take: mode {mode!r} is not ported (clip, wrap)")
    return ids.clamp(0, n - 1)


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis`` at ``indices``; an id outside ``[0,
    n)`` reads the nearest edge (``mode='clip'``) or wraps."""
    axis = axis % a.dim()
    ids = _clip_ids(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, ids.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("batch_take")
def _batch_take(a, indices):
    ids = _clip_ids(indices, a.shape[1])
    return torch.gather(a, 1, ids[:, None])[:, 0]


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """The element of ``data`` at ``index`` along ``axis``
    (``mxnet_tpu/ops/math.py:632-640``; parity: broadcast_reduce_op_index.cc
    pick). ``index`` has ``data``'s shape without ``axis``, or with it of
    size 1. An index outside ``[0, n)`` reads the nearest edge (MXNet's
    ``mode="clip"``, the only mode ported). ``mxnet_tpu``'s ``pick``
    ignores ``mode``: its ``take_along_axis`` fills an index past the end
    with NaN and wraps a negative one (ROADMAP Queue 3); the port follows
    MXNet."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported (only 'clip')")
    axis = axis % data.dim()
    idx = _int_index(index).clamp(0, data.shape[axis] - 1)
    if idx.dim() != data.dim():
        idx = idx.unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def embedding(data, weight):
    """Rows of ``weight`` at ids ``data`` (parity: indexing_op.cc Embedding).

    Ids are cast to integers (floats truncate, as ``astype(int32)`` does)
    and clipped into ``[0, input_dim)``: ``mxnet_tpu`` gathers with
    ``mode="clip"`` (ops/math.py:643-650), so an out-of-range id reads the
    nearest edge row instead of raising.
    """
    ids = _int_index(data).clamp(0, weight.shape[0] - 1)
    return F.embedding(ids, weight)


@register("Embedding", aliases=("_contrib_SparseEmbedding",))
def _embedding_op(data, weight, input_dim=None, output_dim=None,
                  dtype="float32", sparse_grad=False):
    return embedding(data, weight)


def _nd_index(indices):
    return tuple(_int_index(indices[i]) for i in range(indices.shape[0]))


@register("gather_nd")
def _gather_nd(a, indices):
    return a[_nd_index(indices)]


@register("scatter_nd", no_grad=True)
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    out[_nd_index(indices)] = data
    return out


@register("one_hot", no_grad=True)
def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """An id outside ``[0, depth)`` gives a row of ``off_value``, as
    ``jax.nn.one_hot``."""
    hit = _int_index(indices)[..., None] == torch.arange(
        depth, device=indices.device)
    oh = hit.to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("where")
@cast_op("where")
def _where(cond, x, y):
    return torch.where(cond.to(torch.bool), x, y)


@register("boolean_mask", aliases=("_contrib_boolean_mask",), host=True)
def _boolean_mask(data, mask, axis=0):
    """The slices of ``data`` along ``axis`` where ``mask`` is nonzero: a
    shape that depends on the data, so the mask is read on the host."""
    keep = torch.nonzero(mask.to(torch.bool).reshape(-1)).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


def _seq_mask(data, sequence_length, axis):
    steps = torch.arange(data.shape[axis], device=data.device)
    lens = _int_index(sequence_length)
    mask = steps[:, None] < lens[None, :] if axis == 0 \
        else steps[None, :] < lens[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))


@register("sequence_mask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.clone()
    return torch.where(_seq_mask(data, sequence_length, axis), data,
                       torch.full_like(data, value))


@register("SequenceMask")
def _SequenceMask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    return _sequence_mask(data, sequence_length, use_sequence_length,
                          value, axis)


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1).clone()
    idx = _int_index(sequence_length) - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    return data[idx, batch] if axis == 0 else data[batch, idx]


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = _int_index(sequence_length)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[rev, batch]


# ------------------------------------------------------------------- ordering

@register("argsort", no_grad=True)
def _argsort(a, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(a if is_ascend else -a, dim=axis, stable=True)
    return idx.to(torch_dtype(dtype))


@register("sort", no_grad=True)
def _sort(a, axis=-1, is_ascend=True):
    out = torch.sort(a, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("topk", no_grad=True,
          num_outputs=lambda p: 2 if p.get("ret_typ") == "both" else 1)
def _topk(a, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``:
    ``ret_typ`` "value", "indices", "both" (values, indices) or "mask"
    (``a``'s shape, 1 at the picked positions)."""
    ax = axis % a.dim()
    vals, idx = torch.topk(a, k, dim=ax, largest=not is_ascend, sorted=True)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(a).scatter_(ax, idx, 1.0)
    return idx.to(torch_dtype(dtype))


# ---------------------------------------------------------------------- misc

@register("histogram", aliases=("_histogram",), no_grad=True, num_outputs=2)
def _histogram(a, bin_cnt=10, range=None):  # noqa: A002
    """Counts over ``bin_cnt`` equal bins of ``range`` (the data's min and
    max when None) and the bin edges, as ``jnp.histogram``: a bin holds
    ``[lo, hi)``, the last one ``[lo, hi]``; values outside are dropped."""
    x = a.reshape(-1).float()
    lo, hi = (x.min(), x.max()) if range is None else \
        (torch.tensor(float(range[0])), torch.tensor(float(range[1])))
    edges = torch.linspace(0.0, 1.0, bin_cnt + 1, device=a.device) * (
        hi - lo).to(a.device) + lo.to(a.device)
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bin_cnt), idx)
    ok = (idx >= 1) & (idx <= bin_cnt)
    counts = torch.bincount(idx[ok] - 1, minlength=bin_cnt)
    return counts.float(), edges


@register("add_n", aliases=("ElementWiseSum", "_sum"),
          param_normalizer=drop_num_args)
def _add_n(*arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out if len(arrays) > 1 else out.clone()


@register("smooth_l1")
@cast_op("smooth_l1")
def _smooth_l1(a, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(a) < 1.0 / s2, 0.5 * s2 * a * a,
                       torch.abs(a) - 0.5 / s2)


@register("hard_sigmoid")
def _hard_sigmoid(a, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * a + beta, 0.0, 1.0)


@register("_ravel_multi_index", no_grad=True,
          aliases=("ravel_multi_index",))
def _ravel_multi_index(data, shape=None):
    """(K, N) coordinate rows -> flat indices (ravel.cc)."""
    strides = _np.cumprod([1] + list(shape[::-1]))[::-1][1:]
    s = torch.tensor(strides.copy(), dtype=data.dtype, device=data.device)
    return torch.sum(data * s[:, None], dim=0)


@register("_unravel_index", no_grad=True, aliases=("unravel_index",))
def _unravel_index(data, shape=None):
    """Flat indices -> (K, N) coordinates (ravel.cc UnravelIndex)."""
    idx = _int_index(data)
    coords = []
    for dim in reversed(shape):
        coords.append(torch.remainder(idx, dim))
        idx = torch.div(idx, dim, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).to(data.dtype)


@register("_contrib_index_copy", aliases=("index_copy",))
def _index_copy(old, index, new):
    """``old`` with rows ``index`` replaced by ``new`` (index_copy.cc)."""
    return old.index_copy(0, _int_index(index), new)


@register("_contrib_index_add", aliases=("index_add",))
def _index_add(old, index, new):
    """``old`` with ``new`` added into rows ``index``."""
    return old.index_add(0, _int_index(index), new)


@register("moments", num_outputs=2)
def _moments(data, axes=None, keepdims=False):
    """Mean and (population) variance over ``axes`` (all when None)."""
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    mean_ = torch.mean(data, dim=ax, keepdim=keepdims)
    mk = torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean(torch.square(data - mk), dim=ax, keepdim=keepdims)
    return mean_, var


@register("reshape_like")
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None):
    """``lhs`` reshaped to ``rhs``'s shape, or only its axes
    ``[lhs_begin, lhs_end)`` to ``rhs``'s ``[rhs_begin, rhs_end)``."""
    def norm_(v, nd, default):
        if v is None:
            return default
        v = int(v)
        return v + nd if v < 0 else v

    lb = norm_(lhs_begin, lhs.dim(), 0)
    le = norm_(lhs_end, lhs.dim(), lhs.dim())
    rb = norm_(rhs_begin, rhs.dim(), 0)
    re = norm_(rhs_end, rhs.dim(), rhs.dim())
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re])
                       + tuple(lhs.shape[le:]))


@register("_contrib_allclose", no_grad=True, aliases=("allclose",))
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=True):
    close = torch.abs(a - b) <= (atol + rtol * torch.abs(b))
    if equal_nan:
        close = close | (torch.isnan(a) & torch.isnan(b))
    return torch.all(close).float()


# ------------------------------------------------------ helpers kept by name

def arange(start, stop=None, step=1, dtype="float32", device=None):
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                        device=device)

