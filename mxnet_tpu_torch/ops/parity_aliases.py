"""Reference-name parity: MXNet's internal op names and the small-op tail
(port of ``mxnet_tpu/ops/parity_aliases.py``).

MXNet resolves ops by their NNVM registration names, many of them
internal spellings (``_zeros``, ``_linalg_gemm``, ``_slice_assign``)
behind the public ``mx.nd`` functions. This module registers those names
as aliases of ported ops and implements the tail: the creation ops that
``nd.zeros`` / ``nd.arange`` call (zero-input ops that take the caller's
``device``), the triangle extraction, im2col / col2im, the functional
slice and scatter assignments, and single-device SyncBatchNorm. The
multi-precision optimizer tail lives in ``optimizer_ops.py``. The
sparse-storage ops raise: row-sparse and CSR arrays are ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from . import nn as _nn
from .registry import add_alias, drop_num_args, register


# ------------------------------------------------------------------ creation
# Parity: src/operator/tensor/init_op.cc. Zero-input ops: params only.

def _dt(dtype):
    return torch_dtype(dtype) if dtype is not None else torch.float32


@register("_zeros", no_grad=True, aliases=("_zeros_without_dtype",))
def _zeros_op(shape=(), ctx=None, dtype=None, device=None):
    return torch.zeros(tuple(shape), dtype=_dt(dtype), device=device)


@register("_ones", no_grad=True)
def _ones_op(shape=(), ctx=None, dtype=None, device=None):
    return torch.ones(tuple(shape), dtype=_dt(dtype), device=device)


@register("_full", no_grad=True)
def _full_op(shape=(), value=0.0, ctx=None, dtype=None, device=None):
    return torch.full(tuple(shape), value, dtype=_dt(dtype), device=device)


@register("_eye", no_grad=True)
def _eye_op(N=0, M=0, k=0, ctx=None, dtype=None, device=None):
    n = int(N)
    m = int(M) if M else n
    out = torch.zeros((n, m), dtype=_dt(dtype), device=device)
    out.diagonal(int(k)).fill_(1)
    return out


@register("_arange", no_grad=True)
def _arange_op(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
               ctx=None, dtype=None, device=None):
    """numpy's arange in the target dtype (the reference builds it in numpy),
    each value ``repeat`` times."""
    a = _np.arange(start, stop, step, dtype=_np.dtype(str(_dt(dtype))[6:]))
    if int(repeat) > 1:
        a = _np.repeat(a, int(repeat))
    return torch.from_numpy(a).to(device)


@register("_linspace", no_grad=True)
def _linspace_op(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
                 dtype=None, device=None):
    num = int(num)
    if endpoint or num == 0:
        return torch.linspace(float(start), float(stop), num,
                              dtype=_dt(dtype), device=device)
    step = (float(stop) - float(start)) / num
    return torch.linspace(float(start), float(stop) - step, num,
                          dtype=_dt(dtype), device=device)


# --------------------------------------------------------------- linalg tail
# Parity: src/operator/tensor/la_op.cc:569-690.

def _trian_indices(n, offset, lower):
    if offset > 0:
        return _np.triu_indices(n, k=offset)
    if offset < 0:
        return _np.tril_indices(n, k=offset)
    return _np.tril_indices(n) if lower else _np.triu_indices(n)


@register("linalg_extracttrian")
def _extracttrian(a, offset=0, lower=True):
    """The triangle of (..., n, n), row-major, as (..., n (n + 1) / 2)."""
    r, c = _trian_indices(a.shape[-1], int(offset), bool(lower))
    return a[..., torch.from_numpy(r), torch.from_numpy(c)]


@register("linalg_maketrian")
def _maketrian(a, offset=0, lower=True):
    """The inverse of extracttrian: zeros off the triangle; the matrix
    grows by ``|offset|``."""
    L = a.shape[-1]
    n = int((_np.sqrt(8 * L + 1) - 1) / 2)
    if n * (n + 1) // 2 != L:
        n = L
    m = n + abs(int(offset))
    r, c = _trian_indices(m, int(offset), bool(lower))
    r, c = torch.from_numpy(r[:L]), torch.from_numpy(c[:L])
    out = torch.zeros(tuple(a.shape[:-1]) + (m, m), dtype=a.dtype,
                      device=a.device)
    out[..., r.to(a.device), c.to(a.device)] = a
    return out


for _la in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "sumlogdiag",
            "syrk", "gelqf", "syevd", "det", "slogdet", "inverse",
            "extractdiag", "makediag", "extracttrian", "maketrian"):
    add_alias(f"_linalg_{_la}", f"linalg_{_la}")


# ------------------------------------------------------------ im2col family
# Parity: src/operator/nn/im2col.cc. The unfold is the kernel's offsets'
# strided slices stacked on a new axis; col2im is that unfold's vector-
# Jacobian product, i.e. the accumulation kernel.

def _sliding_norm(kernel, stride, dilate, pad):
    kernel = tuple(int(k) for k in kernel)
    nd = len(kernel)

    def norm(v, default):
        if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
            return (default,) * nd
        if isinstance(v, (int, float)):
            return (int(v),) * nd
        return tuple(int(x) for x in v)

    return kernel, norm(stride, 1), norm(dilate, 1), norm(pad, 0)


def _im2col_core(data, kernel, stride, dilate, pad):
    n, c = data.shape[:2]
    spatial = data.shape[2:]
    nd = len(kernel)
    padded = torch.nn.functional.pad(
        data, [p for p in reversed(pad) for _ in range(2)])
    out_sp = tuple((spatial[i] + 2 * pad[i] - (1 + (kernel[i] - 1)
                                                * dilate[i])) // stride[i] + 1
                   for i in range(nd))
    pieces = []
    for koff in _np.ndindex(*kernel):
        idx = tuple(slice(koff[i] * dilate[i],
                          koff[i] * dilate[i] + (out_sp[i] - 1) * stride[i]
                          + 1, stride[i]) for i in range(nd))
        pieces.append(padded[(slice(None), slice(None)) + idx])
    col = torch.stack(pieces, dim=2)              # (N, C, K, *out)
    return col.reshape(n, c * int(_np.prod(kernel)), int(_np.prod(out_sp)))


@register("im2col")
def _im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    return _im2col_core(data, *_sliding_norm(kernel, stride, dilate, pad))


@register("col2im")
def _col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    kernel, stride, dilate, pad = _sliding_norm(kernel, stride, dilate, pad)
    c = data.shape[1] // int(_np.prod(kernel))
    ref = torch.zeros((data.shape[0], c) + tuple(int(s) for s in
                                                  output_size),
                      dtype=data.dtype, device=data.device)
    _, vjp = torch.func.vjp(
        lambda x: _im2col_core(x, kernel, stride, dilate, pad), ref)
    return vjp(data)[0]


# ----------------------------------------------- assignment / scatter tail
# Parity: matrix_op.cc:508 (_slice_assign) and indexing_op.cc:1097
# (_scatter_set_nd): functional, the lhs is copied.

def _slice_tuple(nd, begin, end, step):
    begin = tuple(begin) if begin is not None else (None,) * nd
    end = tuple(end) if end is not None else (None,) * nd
    step = tuple(step) if step not in (None, ()) else (None,) * nd
    out = []
    for i in range(nd):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) else None
        out.append(slice(b, e, s if s not in (0, None) else None))
    return tuple(out)


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, begin=None, end=None, step=None):
    out = lhs.clone()
    out[_slice_tuple(lhs.dim(), begin, end, step)] = rhs
    return out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(lhs, scalar=0.0, begin=None, end=None, step=None):
    out = lhs.clone()
    out[_slice_tuple(lhs.dim(), begin, end, step)] = scalar
    return out


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    """``lhs`` with the elements at ``indices`` (K, N) set from ``rhs``."""
    out = lhs.clone()
    out[tuple(indices[i].to(torch.int64)
              for i in range(indices.shape[0]))] = rhs
    return out


# ------------------------------------------------------------ identity tail

@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs.clone()


@register("_rnn_param_concat", param_normalizer=drop_num_args)
def _rnn_param_concat(*arrays, dim=0):
    return torch.cat(arrays, dim=int(dim))


@register("IdentityAttachKLSparseReg", mutate=(1,))
def _identity_kl_sparse_reg(data, moving_avg, sparseness_target=0.1,
                            penalty=0.001, momentum=0.9):
    """Identity forward; the moving average of the mean activation takes
    an EMA step (identity_attach_KL_sparse_reg.cc)."""
    avg = momentum * moving_avg + (1 - momentum) * torch.mean(data)
    return data.clone(), avg


# ------------------------------------------------------------- sparse tail

def _sparse(name):
    def op(*arrays, **params):
        raise MXNetError(f"{name} needs the row-sparse and CSR arrays of "
                         "ROADMAP Queue 1 item 9, which are not ported")
    op.__name__ = name
    op.__doc__ = f"{name}: raises until sparse storage is ported."
    return op


register("cast_storage")(_sparse("cast_storage"))
register("_sparse_retain")(_sparse("_sparse_retain"))
register("_contrib_getnnz", no_grad=True, aliases=("getnnz",))(
    _sparse("_contrib_getnnz"))


@register("_contrib_edge_id", no_grad=True, aliases=("edge_id",))
def _edge_id(data, u, v):
    """Edge ids of (u[i], v[i]) in a dense adjacency holding ids (0 where
    there is no edge); -1 where absent (dgl_graph.cc EdgeID)."""
    vals = data[u.to(torch.int64), v.to(torch.int64)]
    return torch.where(vals != 0, vals, torch.full_like(vals, -1.0))


# ------------------------------------------------- straight alias wiring
add_alias("BatchNorm_v1", "BatchNorm")


@register("_contrib_SyncBatchNorm", mutate=(3, 4),
          aliases=("SyncBatchNorm",))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key=None, _train=True):
    """Cross-device BatchNorm (sync_batch_norm.cc) on one device: BatchNorm.
    Across ranks, ``ops.nn.sync_batch_stats`` all-reduces the moments
    (``parallel.ShardedTrainer``); ``key`` / ``ndev`` are accepted for
    signature parity."""
    return _nn.batch_norm(data, gamma, beta, moving_mean, moving_var,
                          eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats, _train=_train)


@register("_contrib_calibrate_entropy", num_outputs=2, no_grad=True,
          aliases=("calibrate_entropy",), host=True)
def _calibrate_entropy_op(hist, hist_edges, num_quantized_bins=255):
    """The (min, max) range of the entropy (KL) threshold of an activation
    histogram (calibrate.cc), by the port's calibration
    (``contrib/quantization.py``), on the host."""
    from ..contrib.quantization import _entropy_threshold

    th = _entropy_threshold(hist.detach().cpu().numpy(),
                            hist_edges.detach().cpu().numpy(),
                            int(num_quantized_bins))
    return (torch.tensor(-th, dtype=torch.float32, device=hist.device),
            torch.tensor(th, dtype=torch.float32, device=hist.device))
