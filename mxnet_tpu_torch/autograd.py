"""Recording and training scopes, and backward (subset of
``mxnet_tpu/autograd.py``; parity: python/mxnet/autograd.py).

The tape is PyTorch's own. :func:`record` makes the thread record (torch
grad mode on) and, by default, train; :func:`pause` stops recording. As in
MXNet, nothing is recorded outside ``record()``: a Block called while not
recording runs under ``torch.no_grad()`` (``gluon/block.py``), so a forward
outside ``record()`` builds no graph even though parameters require grad.

Layers whose forward differs between training and inference (BatchNorm)
read :func:`is_training`, which is False unless ``record()`` or
``train_mode()`` says otherwise. The state is per thread.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward"]

_STATE = threading.local()


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
    heads = [heads] if isinstance(heads, torch.Tensor) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    if not any(h.grad_fn is not None for h in heads):
        raise MXNetError("backward: no recorded computation found (did you "
                         "run inside autograd.record()?)")
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
