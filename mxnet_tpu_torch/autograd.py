"""Recording and training scopes, backward, ``grad``, ``mark_variables``
and custom ``Function``s (port of ``mxnet_tpu/autograd.py``; parity:
python/mxnet/autograd.py).

The tape is PyTorch's own. :func:`record` makes the thread record (torch
grad mode on) and, by default, train; :func:`pause` stops recording. As in
MXNet, nothing is recorded outside ``record()``: a Block called while not
recording runs under ``torch.no_grad()`` (``gluon/block.py``), so a forward
outside ``record()`` builds no graph even though parameters require grad.

Layers whose forward differs between training and inference (BatchNorm)
read :func:`is_training`, which is False unless ``record()`` or
``train_mode()`` says otherwise. The state is per thread.

Every function here takes NDArrays as well as tensors (``mx.nd``'s
arrays hold one tensor each): ``backward``, ``grad`` and
``mark_variables`` work on the tensors, and ``grad`` returns NDArrays for
NDArray variables.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "mark_variables", "Function"]

_STATE = threading.local()


def _nd_cls():
    from .ndarray.ndarray import NDArray

    return NDArray


def _tensors(xs):
    """A tensor, an NDArray or a list of them -> a list of tensors."""
    nd = _nd_cls()
    if isinstance(xs, (torch.Tensor, nd)):
        xs = [xs]
    return [x._data if isinstance(x, nd) else x for x in xs]


def is_recording():
    return getattr(_STATE, "recording", False)


def is_training():
    return getattr(_STATE, "training", False)


def set_recording(flag):
    """Set the recording flag; returns the previous value."""
    old = is_recording()
    _STATE.recording = bool(flag)
    return old


def set_training(flag):
    """Set the training flag; returns the previous value."""
    old = is_training()
    _STATE.training = bool(flag)
    return old


class _Scope:
    """Sets recording and/or training (None leaves one as it is); while
    recording is set, torch grad mode follows it."""

    def __init__(self, recording=None, training=None):
        self._rec, self._train = recording, training

    def __enter__(self):
        self._old = (is_recording(), is_training(),
                     torch.is_grad_enabled())
        if self._rec is not None:
            set_recording(self._rec)
            torch.set_grad_enabled(self._rec)
        if self._train is not None:
            set_training(self._train)
        return self

    def __exit__(self, *exc):
        rec, train, grad = self._old
        set_recording(rec)
        set_training(train)
        torch.set_grad_enabled(grad)


def record(train_mode=True):
    """Record operations for :func:`backward`, in training mode unless
    ``train_mode=False``."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Stop recording inside a ``record()`` scope."""
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (a tensor or a list) into the ``.grad`` of
    every recorded parameter, by its ``grad_req`` ('write' overwrites,
    'add' accumulates). ``head_grads`` default to ones
    (``mxnet_tpu/autograd.py:155-236``)."""
    heads = _tensors(heads)
    head_grads = [None] * len(heads) if head_grads is None \
        else _tensors(head_grads)
    if not any(h.grad_fn is not None for h in heads):
        raise MXNetError("backward: no recorded computation found (did you "
                         "run inside autograd.record()?)")
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` (tensors) leaves whose gradients a backward
    writes into ``gradients`` (same shapes), by ``grad_reqs`` ('write'
    overwrites, 'add' accumulates; one for all or one each)
    (``mxnet_tpu/autograd.py:128-133``). The buffers are the tensors'
    ``.grad``: autograd adds into them in place, and for 'write' a hook
    zeroes the buffer first. An NDArray variable becomes a leaf (its
    tensor detached, memory shared) before it is marked."""
    nd = _nd_cls()
    if isinstance(variables, (torch.Tensor, nd)):
        variables, gradients = [variables], [gradients]
    leaves = []
    for v in variables:
        if isinstance(v, nd):
            if v._data.grad_fn is not None:
                v._data = v._data.detach()
            leaves.append(v._data)
        else:
            leaves.append(v)
    variables, gradients = leaves, _tensors(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        v.requires_grad_(req != "null")
        if req == "null":
            continue
        v.grad = g
        if req == "write":
            v.register_hook(_zero_buffer(v, g))


def _zero_buffer(v, buf):
    def hook(grad):
        # runs before autograd adds ``grad`` into ``v.grad`` (= buf)
        if v.grad is buf:
            buf.zero_()
    return hook


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as a
    list and written into no ``.grad`` (``mxnet_tpu/autograd.py:239-303``).
    ``create_graph=True`` records the gradient computation, so a
    gradient of the result (second order) can be taken; ``retain_graph``
    defaults to ``create_graph``."""
    nd = _nd_cls()
    as_nd = [isinstance(v, nd) for v in (
        variables if isinstance(variables, (list, tuple)) else [variables])]
    heads, variables = _tensors(heads), _tensors(variables)
    head_grads = [None] * len(heads) if head_grads is None \
        else _tensors(head_grads)
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    if retain_graph is None:
        retain_graph = create_graph
    with torch.enable_grad() if create_graph else torch.no_grad():
        out = list(torch.autograd.grad(heads, variables, grads,
                                       retain_graph=retain_graph,
                                       create_graph=create_graph))
    return [nd(g) if w else g for g, w in zip(out, as_nd)]


class _FunctionBridge(torch.autograd.Function):
    """Runs a :class:`Function`'s ``forward`` and ``backward`` as one node
    of torch's tape."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        with _Scope(recording=False):
            outs = fn.forward(*inputs)
        fn._single = not isinstance(outs, (list, tuple))
        return outs if fn._single else tuple(outs)

    @staticmethod
    def backward(ctx, *out_grads):
        with _Scope(recording=False):
            igs = ctx.fn.backward(*out_grads)
        igs = [igs] if isinstance(igs, torch.Tensor) else list(igs)
        return (None, *igs)


class Function:
    """A differentiable function with a hand-written gradient
    (``mxnet_tpu/autograd.py:309-371``; parity: autograd.Function):
    subclass it, write ``forward(*inputs)`` and ``backward(*out_grads)``
    (one gradient per input), keep what backward needs with
    :meth:`save_for_backward` and read it from ``saved_tensors``. Called
    inside :func:`record`, it is one node of the tape; forward and
    backward themselves run unrecorded."""

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if is_recording() and torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in inputs):
            outs = _FunctionBridge.apply(self, *inputs)
        else:
            with _Scope(recording=False):
                outs = self.forward(*inputs)
            return outs
        return outs if self._single else list(outs)
