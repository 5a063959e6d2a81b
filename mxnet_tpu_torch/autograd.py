"""Training-mode scopes (subset of ``mxnet_tpu/autograd.py``; parity:
python/mxnet/autograd.py).

Layers whose forward differs between training and inference (BatchNorm)
read :func:`is_training`, which is False unless a ``record()`` or
``train_mode()`` scope says otherwise, as in MXNet. The state is per
thread. Recording itself is PyTorch's own autograd tape; ``record`` here
only sets the training flag.
"""
from __future__ import annotations

import threading

__all__ = ["is_training", "set_training", "record", "train_mode"]

_STATE = threading.local()


def is_training():
    return getattr(_STATE, "training", False)


def set_training(flag):
    """Set the training flag; returns the previous value."""
    old = is_training()
    _STATE.training = bool(flag)
    return old


class _Scope:
    def __init__(self, training):
        self._train = training

    def __enter__(self):
        self._old = set_training(self._train)
        return self

    def __exit__(self, *exc):
        set_training(self._old)


def record(train_mode=True):
    return _Scope(train_mode)


def train_mode():
    return _Scope(True)
