"""Automatic mixed precision (port of ``mxnet_tpu/amp/amp.py``; parity:
python/mxnet/contrib/amp/amp.py).

With AMP on, an op on :mod:`.lists`' target list (``FullyConnected``,
``Convolution``, ``dot`` ...) casts its float inputs to the target dtype,
an op on the fp32 list (``LayerNorm``, ``softmax``, ``log_softmax``,
``sum``, ``mean`` ..., and ``BatchNorm`` under fp16) casts them to
float32, and an op on the widest-type list casts them to the widest of
them. ``mxnet_tpu`` casts at its one dispatch chokepoint
(``imperative_invoke``); the port has none, since layers call op
functions directly, so every op function of the port that carries one of
those names applies the policy itself (:func:`cast_op`): the casts reach
an op however it is called. Gradients reach the float32 parameters
through the cast (``Tensor.to`` is differentiable), and an op's mutated
slots (BatchNorm's running statistics) are written back in their own
dtype. PyTorch's own type promotion already casts the float inputs of an
elementwise op to the widest of them.

The fp16 recipe (MXNet's)::

    amp.init("float16")
    trainer = gluon.Trainer(net.collect_params(), "lamb", {...})
    amp.init_trainer(trainer)
    with autograd.record():
        loss = loss_fn(net(x), y)
    with amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    if amp.unscale(trainer):       # False: an overflow, the step skipped
        trainer.step(batch_size)

``scale_loss`` multiplies the loss by the scale and sets the trainer's
``rescale_grad`` to undo it in the update; ``unscale`` reads the
gradients for inf / nan once (one host read), halves or grows the scale,
and counts a skipped step in :func:`health_stats` (the sentinel's
``health_skipped_steps`` series). A captured step
(``capture.capture(trainer, net=, loss_fn=, loss_scaler=)``) runs the
recipe in its graph instead: the scale a slot, the gradients unscaled
before the check, the overflow skip and the scaler's schedule from the
graph's flag, counted in the same series.
"""
from __future__ import annotations

import contextlib
import functools
import warnings

import torch

from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "amp_active",
           "cast_inputs_for", "cast_op", "reset", "health_stats",
           "reset_health_stats"]

_STATE = {"active": False, "target_dtype": None, "target_ops": frozenset(),
          "fp32_ops": frozenset(), "widest_ops": frozenset(),
          "loss_scaler": None}

_HEALTH_KEYS = ("health_skipped_steps", "amp_overflow_skips")


def health_stats():
    """``{"health_skipped_steps": n, "amp_overflow_skips": n}``: the
    sentinel's shared skip series (``resilience.sentinel``), which
    ``unscale`` counts an overflow skip in."""
    from ..resilience import sentinel

    s = sentinel.stats()
    return {k: s[k] for k in _HEALTH_KEYS}


def reset_health_stats():
    from ..resilience import sentinel

    for k in _HEALTH_KEYS:
        sentinel._STATS[k] = 0


def _note_skip(reason):
    from ..resilience import sentinel

    sentinel.note_skip(reason)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on (amp.py:251): ``target_dtype`` is "bfloat16" or
    "float16"; the op lists may be replaced. A new :class:`LossScaler`
    starts at 2^16 under fp16 and at 1.0 under bf16."""
    target_dtype = str(target_dtype)
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError("target_dtype must be bfloat16 or float16, got "
                         f"{target_dtype}")
    if conditional_fp32_ops:
        warnings.warn("conditional_fp32_ops is accepted for API parity but "
                      "treated as fp32_ops")
    fp32 = set(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    if conditional_fp32_ops:
        fp32.update(op for op, _, _ in conditional_fp32_ops)
    if target_dtype == "float16":
        fp32.update(lists.FP16_FP32_OPS)
    _STATE.update(
        active=True,
        target_dtype=torch.bfloat16 if target_dtype == "bfloat16"
        else torch.float16,
        target_ops=frozenset(target_precision_ops
                             if target_precision_ops is not None
                             else lists.TARGET_DTYPE_OPS),
        fp32_ops=frozenset(fp32),
        widest_ops=frozenset(lists.WIDEST_TYPE_CASTS),
        loss_scaler=LossScaler(
            init_scale=2. ** 16 if target_dtype == "float16" else 1.0),
    )


def reset():
    """Turn AMP off (the reference has no off switch; tests need one)."""
    _STATE.update(active=False, target_dtype=None,
                  target_ops=frozenset(), fp32_ops=frozenset(),
                  widest_ops=frozenset(), loss_scaler=None)


def amp_active():
    return _STATE["active"]


def _is_float(a):
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def _target(opname, arrays):
    """The dtype the policy gives ``opname``'s float inputs, or None."""
    if opname in _STATE["target_ops"]:
        return _STATE["target_dtype"]
    if opname in _STATE["fp32_ops"]:
        return torch.float32
    if opname in _STATE["widest_ops"]:
        dts = {a.dtype for a in arrays if _is_float(a)}
        if len(dts) > 1:
            return functools.reduce(torch.promote_types, dts)
    return None


def cast_inputs_for(opname, in_arrays):
    """``in_arrays`` with their float tensors cast as the active policy
    says for ``opname``; the same list when AMP is off or nothing
    changes."""
    if not _STATE["active"]:
        return in_arrays
    tgt = _target(opname, in_arrays)
    if tgt is None or not any(_is_float(a) and a.dtype != tgt
                              for a in in_arrays):
        return in_arrays
    return [a.to(tgt) if _is_float(a) and a.dtype != tgt else a
            for a in in_arrays]


def cast_op(opname):
    """Decorator: the op function named ``opname`` in :mod:`.lists` takes
    its tensor arguments (positional and keyword) cast by the policy."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _STATE["active"]:
                return fn(*args, **kwargs)
            names = [k for k, v in kwargs.items()
                     if isinstance(v, torch.Tensor)]
            cast = cast_inputs_for(
                opname, list(args) + [kwargs[k] for k in names])
            args = cast[:len(args)]
            kwargs = dict(kwargs, **dict(zip(names, cast[len(args):])))
            return fn(*args, **kwargs)

        return wrapped

    return deco


def _loss_scaler(trainer):
    return getattr(trainer, "_amp_loss_scaler", None)


def init_trainer(trainer):
    """Attach the loss scaler to a gluon Trainer (amp.py init_trainer)."""
    if not _STATE["active"]:
        raise RuntimeError("call amp.init() before amp.init_trainer()")
    trainer._amp_loss_scaler = _STATE["loss_scaler"]
    trainer._amp_original_scale = trainer._scale


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """The loss (or list of losses) times the loss scale, with the
    trainer's ``rescale_grad`` dividing it out again in the update
    (amp.py scale_loss)."""
    scaler = _loss_scaler(trainer)
    if scaler is None:
        yield loss
        return
    # a fresh eager step begins: a flag noted by an earlier step is about
    # its gradients, never this step's
    scaler.clear_note()
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Check this step's gradients for overflow and adapt the scale; True
    if they are safe to apply. A skip is counted in :func:`health_stats`
    (``health_skipped_steps`` and ``amp_overflow_skips``)."""
    scaler = _loss_scaler(trainer)
    if scaler is None:
        return True
    params = [p for p in trainer._params if p.grad_req != "null"]
    overflow = scaler.has_overflow(params)
    scaler.update_scale(overflow)
    if overflow:
        _note_skip("amp_overflow")
    return not overflow


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  cast_optional_params=False):
    """A symbolic model's parameters cast for low-precision inference
    (amp.py convert_model); the symbol is returned as it is, since its
    ops follow their inputs' dtypes."""
    from ..base import torch_dtype

    dt = torch_dtype(target_dtype)

    def cast(params):
        return {k: torch.as_tensor(v).to(dt) for k, v in params.items()}

    return sym, cast(arg_params), cast(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16", **kwargs):
    """Cast a Block's parameters in place for low-precision inference
    (amp.py convert_hybrid_block); BatchNorm keeps float32 under fp16."""
    block.cast(target_dtype)
    return block
