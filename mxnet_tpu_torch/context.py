"""Device contexts (parity: python/mxnet/context.py).

Counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names a device
the way MXNet does (``cpu()``, ``gpu(i)``) and resolves to an explicit
``torch.device``. The default context is ``gpu(0)``: an entry point that is
given no context runs on the card, and raises :class:`MXNetError` where
there is none. It never moves to the CPU on its own; callers that want the
CPU pass ``ctx=cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context",
           "as_device"]


class Context:
    """A device: ``device_type`` in {'cpu', 'gpu'} plus an index.

    Usable as a ``with`` scope that changes :func:`current_context`.
    """

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r} "
                             "(the PyTorch port has 'cpu' and 'gpu')")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(Context._default_ctx, "stack", None)
        if stack is None:
            stack = Context._default_ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()

    def torch_device(self):
        """The ``torch.device`` this context names. A gpu context on a host
        without a usable CUDA device raises rather than running elsewhere."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} requested but CUDA is not available; pass "
                "ctx=cpu() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self} requested but only "
                             f"{torch.cuda.device_count()} GPU(s) exist")
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    raise MXNetError("the PyTorch port has no TPU context; use gpu() or "
                     "cpu()")


def current_context():
    """The innermost ``with Context`` scope, else ``gpu(0)``."""
    stack = getattr(Context._default_ctx, "stack", None)
    return stack[-1] if stack else gpu(0)


def as_device(ctx):
    """``ctx`` (a Context, None for the current one) -> ``torch.device``."""
    return (ctx if ctx is not None else current_context()).torch_device()
