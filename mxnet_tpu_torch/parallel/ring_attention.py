"""Ring attention: sequence parallelism over the 'sp' mesh axis (port of
``mxnet_tpu/parallel/ring_attention.py``).

Each rank holds one block of the sequence's Q, K and V, ``(B, H, T_local,
D)``, rank r along the axis the tokens ``[r * T_local, (r + 1) *
T_local)``. K/V blocks go round the ring (:func:`collectives.ring_shift`,
the ``lax.ppermute`` of ``mxnet_tpu``) while each rank accumulates its
queries' attention over the global sequence. ``mxnet_tpu`` calls this on
global arrays inside ``shard_map``; the port is one process per rank, so
:func:`ring_attention` takes this rank's blocks and returns this rank's
block of the output.

Two hop implementations, as ``mxnet_tpu`` has:

- ``'dense'``: the plain ring (``ring_attention.py:97-123``): per hop the
  (T_local, T_local) f32 score block and an online softmax;
- ``'flash'``: K1 a hop (:func:`kernels.flash_attention`) with global
  offsets ``q_offset = my * T_local``, ``k_offset = src * T_local`` and its
  lse, the hops merged by log-sum-exp in f32 (``ring_attention.py:85-89``).
  On a CUDA tensor K1 is the hand-written kernel of its route; on the CPU
  its plain version.

The backward is one ``torch.autograd.Function`` over the whole ring (a
send carries no autograd). It saves the merged output O and the merged
lse L; each hop then runs K2 (:func:`kernels.flash_attention_backward`;
for ``'dense'`` its plain version) on ``(q, k_src, v_src, O, L, dO)`` with
the hop's offsets: p = exp(s - L) is then the global softmax's block, so
the hops' dq sum, on this rank, to the global dq, and each block's dk and
dv, accumulated in f32 as they travel with it, arrive back at its owner
after a full turn. That is the gradient ``mxnet_tpu``'s AD of its ring
gives (a per-hop VJP with the lse cotangent), up to rounding.

Under causal masking the hops where ``src > my`` see no key. K1 gives
those rows O = 0 and lse = -1e30 + log(1e-20); the first hop is the
diagonal, so the running max is finite from it on and such a hop merges
with weight exactly 0, and K2 gives it zero gradients (p = 0). Such hops
are run, not skipped: every rank launches K1 and K2 once a hop.

:func:`stats` counts the ring's K1 and K2 calls by route ("tc",
"tf32x3", "simt", and "plain" for the plain version, on any device) and
its hops.
"""
from __future__ import annotations

import math

import torch

from ..ops import kernels
from . import collectives

__all__ = ["ring_attention", "ring_attention_inner", "attention", "stats",
           "reset_stats"]

_NEG = -1e30
_ROUTES = ("tc", "tf32x3", "simt", "plain")
_STATS = {}


def reset_stats():
    _STATS.update({"k1": dict.fromkeys(_ROUTES, 0),
                   "k2": dict.fromkeys(_ROUTES, 0), "hops": 0})


reset_stats()


def stats():
    """{"k1": {route: calls}, "k2": {route: calls}, "hops": n}."""
    return {"k1": dict(_STATS["k1"]), "k2": dict(_STATS["k2"]),
            "hops": _STATS["hops"]}


def _counted(which, wrapper, x, call, plain=False):
    """``call()``, counting it under the route ``wrapper`` launched (its
    own per-route counter moves), or under "plain" when ``call`` runs the
    plain version (``plain``, or a CPU tensor, where the wrapper takes it),
    whatever the device."""
    if plain or x.device.type != "cuda":
        _STATS[which]["plain"] += 1
        return call()
    before = dict(wrapper.launches_by_route)
    out = call()
    for route, n in wrapper.launches_by_route.items():
        _STATS[which][route] += n - before[route]
    return out


def _pick_impl(impl, device):
    """``'auto'``: K1 on a CUDA tensor (the kernels take any T and D up to
    256), the plain ring on the CPU."""
    if impl != "auto":
        return impl
    return "flash" if device.type == "cuda" else "dense"


def _ring_forward(q, k, v, mesh, axis, causal, scale, impl):
    """(O in q's dtype, L (B, H, T, 1) f32): this rank's block of the
    output over the global sequence and its merged log-sum-exp."""
    b, h, t, d = q.shape
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    q32 = q.float()
    m = torch.full((b, h, t, 1), _NEG, dtype=torch.float32, device=q.device)
    w = torch.zeros_like(m)
    o = torch.zeros_like(q32)
    qpos = my * t + torch.arange(t, device=q.device)
    kc, vc = k, v
    for i in range(n):
        src = (my - i) % n
        if impl == "flash":
            out_i, lse_i = _counted("k1", kernels.flash_attention, q,
                                    lambda: kernels.flash_attention(
                                        q, kc, vc, causal=causal,
                                        scale=scale, return_lse=True,
                                        q_offset=my * t, k_offset=src * t))
            lse32 = lse_i.float()
            m_new = torch.maximum(m, lse32)
            corr = torch.exp(m - m_new)
            wi = torch.exp(lse32 - m_new)
            o = o * corr + wi * out_i.float()
            w = w * corr + wi
        else:
            logits = torch.matmul(q32, kc.float().transpose(-1, -2)) * scale
            if causal:
                kpos = src * t + torch.arange(t, device=q.device)
                logits = torch.where(qpos[:, None] >= kpos[None, :], logits,
                                     torch.full((), _NEG, device=q.device))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            corr = torch.exp(m - m_new)
            w = w * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + torch.matmul(p, vc.float())
        m = m_new
        _STATS["hops"] += 1
        if i + 1 < n:
            kc, vc = collectives.ring_shift((kc, vc), mesh, axis)
    w = torch.clamp_min(w, 1e-20)
    return (o / w).to(q.dtype), m + torch.log(w)


def _ring_backward(q, k, v, out, lse, dout, mesh, axis, causal, scale,
                   impl):
    """(dq, dk, dv) of this rank's blocks: K2 a hop against the merged O
    and L, dq summed here, dk and dv summed as they travel with their K/V
    block back to its owner."""
    t = q.shape[2]
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    k2 = kernels.flash_attention_backward if impl == "flash" \
        else kernels.flash_attention_backward_reference
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kc, vc = k, v
    for i in range(n):
        src = (my - i) % n
        dq_i, dk_i, dv_i = _counted(
            "k2", kernels.flash_attention_backward, q,
            lambda: k2(q, kc, vc, out, lse, dout, causal=causal,
                       scale=scale, q_offset=my * t, k_offset=src * t),
            plain=impl != "flash")
        dq += dq_i.float()
        dk += dk_i.float()
        dv += dv_i.float()
        if i + 1 < n:
            kc, vc, dk, dv = collectives.ring_shift((kc, vc, dk, dv), mesh,
                                                    axis)
        else:
            dk, dv = collectives.ring_shift((dk, dv), mesh, axis)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, impl):
        out, lse = _ring_forward(q, k, v, mesh, axis, causal, scale, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale, impl)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.args)
        return grads + (None,) * 5


def ring_attention_inner(q, k, v, mesh, axis_name="sp", causal=False,
                         scale=None, impl="dense", return_lse=False):
    """This rank's ring attention: q, k, v (B, H, T_local, D), its blocks
    along ``axis_name`` of ``mesh``, -> its (B, H, T_local, D) block of the
    output over the global sequence (and, with ``return_lse``, the merged
    (B, H, T_local, 1) f32 log-sum-exp, carrying no gradient).
    Differentiable in q, k and v; every rank along the axis calls it, with
    the same shapes, as it calls the backward."""
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown ring impl {impl!r}")
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out, lse = _RingAttention.apply(q, k, v, mesh, axis_name, bool(causal),
                                    float(s), impl)
    return (out, lse) if return_lse else out


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                   impl="auto"):
    """Sequence-parallel attention: q, k, v (B, H, T_local, D) are this
    rank's blocks of a sequence split over ``mesh``'s ``axis_name`` (rank
    r along it holds the tokens ``[r * T_local, (r + 1) * T_local)``);
    returns this rank's block of the output.

    impl: 'dense' | 'flash' | 'auto' ('auto': K1 a hop on CUDA, the plain
    ring on the CPU)."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} has no {axis_name!r} "
                         "axis; build it with parallel.create_mesh("
                         f"{{'{axis_name}': n}})")
    return ring_attention_inner(q, k, v, mesh, axis_name, causal, scale,
                                _pick_impl(impl, q.device))


def attention(q, k, v, causal=False, scale=None, mesh=None,
              axis_name="sp", impl="auto"):
    """Unified attention entry: ring attention over ``mesh``'s
    ``axis_name`` when it holds more than one rank (q, k, v this rank's
    blocks); otherwise the flash kernels (K1 + K2) or the plain dense
    composition, as ``impl`` ('auto': flash on CUDA) picks."""
    if mesh is not None and mesh.shape.get(axis_name, 1) > 1:
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name,
                              causal=causal, scale=scale, impl=impl)
    if _pick_impl(impl, q.device) == "flash":
        return kernels.flash_attention_with_grad(q, k, v, causal=causal,
                                                 scale=scale)
    from ..ops.nn import scaled_dot_product_attention

    return scaled_dot_product_attention(q, k, v, causal=causal, scale=scale)
