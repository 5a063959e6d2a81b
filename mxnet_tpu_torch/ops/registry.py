"""Operator registry: MXNet op names -> PyTorch functions (port of
``mxnet_tpu/ops/registry.py:44-160``; parity: NNVM_REGISTER_OP).

An op is a plain function ``fn(*arrays, **params)`` on tensors that
returns a tensor or a tuple of them. The Symbol layer (``symbol/``) builds
graphs of registered names, and the :class:`~mxnet_tpu_torch.executor.
Executor` walks them by calling each node's function: dispatch is a plain
call. ``mxnet_tpu``'s per-op jit cache, op bulking and buffer donation
have no counterpart, since PyTorch runs eagerly and whole programs are
captured as CUDA graphs by :mod:`mxnet_tpu_torch.capture`.

``mutate`` names the input slots an op updates (BatchNorm's running
statistics): the function returns its primary outputs followed by the new
values of those slots, and a variable bound to such a slot is an
auxiliary state of the graph. MXNet's JSON carries every parameter as a
string ("(3, 3)", "True", "relu"); :func:`parse_param` reads one.
"""
from __future__ import annotations

import ast
import functools
import inspect

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "parse_param"]

_OPS: dict = {}
_ALIASES: dict = {}


class OpDef:
    """A registered operator: its canonical name, function, number of
    primary outputs and mutated input slots, and whether the function takes
    ``_train`` (training mode, which the caller supplies)."""

    __slots__ = ("name", "fn", "num_outputs", "mutate", "doc", "takes_train")

    def __init__(self, name, fn, num_outputs=1, mutate=()):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.mutate = tuple(mutate)
        self.doc = fn.__doc__
        self.takes_train = "_train" in inspect.signature(fn).parameters

    def normalize(self, params):
        """The params with None values dropped (the function's defaults
        apply), as ``mxnet_tpu`` normalizes them."""
        return {k: v for k, v in params.items() if v is not None}

    def closed(self, params):
        """``fn`` with ``params`` bound."""
        return functools.partial(self.fn, **params) if params else self.fn


def register(name, *, num_outputs=1, mutate=(), aliases=()):
    """Decorator registering ``fn`` under the MXNet op name ``name``."""

    def _reg(fn):
        _OPS[name] = OpDef(name, fn, num_outputs=num_outputs, mutate=mutate)
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return _reg


def get_op(name):
    op = _OPS.get(name)
    if op is None:
        canon = _ALIASES.get(name)
        if canon is None:
            raise MXNetError(f"operator '{name}' is not registered")
        op = _OPS[canon]
    return op


def list_ops():
    return sorted(_OPS)


def parse_param(value):
    """One MXNet JSON attribute string -> a Python value: literals parse
    ("64" -> 64, "(3, 3)" -> (3, 3), "True" -> True; lists become tuples),
    anything else ("relu", "NCHW") stays a string."""
    if not isinstance(value, str):
        return tuple(value) if isinstance(value, list) else value
    try:
        v = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    return tuple(v) if isinstance(v, list) else v


_SYMBOL_CLS = None    # set by symbol/symbol.py when it is imported
