"""Operator registry: MXNet op names -> PyTorch functions (port of
``mxnet_tpu/ops/registry.py:44-160``; parity: NNVM_REGISTER_OP).

An op is a plain function ``fn(*arrays, **params)`` on tensors that
returns a tensor or a tuple of them. The Symbol layer (``symbol/``) builds
graphs of registered names, the :class:`~mxnet_tpu_torch.executor.
Executor` walks them by calling each node's function, and ``mx.nd`` calls
them on the tensors NDArrays hold (``ndarray/ndarray.py``): dispatch is a
plain call. ``mxnet_tpu``'s per-op jit cache, op bulking and buffer
donation have no counterpart, since PyTorch runs eagerly and whole
programs are captured as CUDA graphs by :mod:`mxnet_tpu_torch.capture`.

``mutate`` names the input slots an op updates (BatchNorm's running
statistics; a tuple, or a function of the params for variadic ops): the
function returns its primary outputs followed by the new values of those
slots, and a variable bound to such a slot is an auxiliary state of the
graph. ``num_outputs`` is an int or a function of the params. ``no_grad``
marks an op with no gradient (BlockGrad, comparisons, samplers): ``mx.nd``
runs it outside the autograd tape. ``host`` marks an op whose output shape
depends on its data (``boolean_mask``), which reads its operands on the
host and so cannot be captured in a CUDA graph: the serving Predictor
refuses a graph holding one. Every caller runs an op through
:meth:`OpDef.call`, which supplies ``_train`` (training mode), ``device``
(the creation ops) and the device's ``mx.random`` generator (the samplers,
Dropout) to the functions that take them. MXNet's JSON carries every
parameter as a string ("(3, 3)", "True", "relu"); :func:`parse_param`
reads one.
"""
from __future__ import annotations

import ast
import functools
import inspect

import torch

from ..base import MXNetError

__all__ = ["OpDef", "register", "add_alias", "get_op", "list_ops",
           "parse_param"]

_OPS: dict = {}
_ALIASES: dict = {}

# parameters the caller supplies at the call, never stored in a graph
INJECTED = ("_train", "device", "generator")


class OpDef:
    """A registered operator: its canonical name, function, outputs and
    mutated input slots, its flags, and which of ``_train`` / ``device`` /
    ``generator`` the function takes (the caller supplies them)."""

    __slots__ = ("name", "fn", "num_outputs", "mutate", "no_grad", "host",
                 "param_normalizer", "doc", "takes_train", "takes_device",
                 "takes_generator")

    def __init__(self, name, fn, num_outputs=1, mutate=(), no_grad=False,
                 host=False, param_normalizer=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.mutate = mutate if callable(mutate) else tuple(mutate)
        self.no_grad = no_grad
        self.host = host
        self.param_normalizer = param_normalizer
        self.doc = fn.__doc__
        sig = inspect.signature(fn).parameters
        self.takes_train = "_train" in sig
        self.takes_device = "device" in sig
        self.takes_generator = "generator" in sig

    def n_out(self, params):
        """The number of primary outputs under ``params``."""
        n = self.num_outputs
        return n(params) if callable(n) else n

    def mutate_slots(self, params):
        """The mutated input slots under ``params``."""
        return tuple(self.mutate(params)) if callable(self.mutate) \
            else self.mutate

    def normalize(self, params):
        """The params with None values dropped (the function's defaults
        apply) and the op's normalizer applied, as ``mxnet_tpu`` normalizes
        them."""
        params = {k: v for k, v in params.items() if v is not None}
        if self.param_normalizer is not None:
            params = self.param_normalizer(params)
        return params

    def closed(self, params):
        """``fn`` with ``params`` bound."""
        return functools.partial(self.fn, **params) if params else self.fn

    def call(self, tensors, params, device, train):
        """``fn`` on ``tensors`` with ``params`` and what the caller
        supplies where the function takes it: ``_train``, ``device`` and
        ``device``'s ``mx.random`` generator (a ``_train`` or ``generator``
        already in ``params`` stands). Returns the function's result."""
        if self.takes_train and "_train" not in params:
            params = dict(params, _train=train)
        if self.takes_device:
            params = dict(params, device=device)
        if self.takes_generator and params.get("generator") is None:
            from .. import random as _random

            params = dict(params, generator=_random.generator(device))
        return self.fn(*tensors, **params)

    def write_back(self, tensors, params, raw):
        """Write the new values of the mutated slots in ``raw`` (a call's
        result) into ``tensors``, in place and outside autograd (MXNet's op
        updating its auxiliary states); returns the primary outputs as a
        tuple."""
        raw = raw if isinstance(raw, (tuple, list)) else (raw,)
        n = self.n_out(params)
        with torch.no_grad():
            for slot, new in zip(self.mutate_slots(params), raw[n:]):
                if slot < len(tensors) and new is not None and \
                        new is not tensors[slot]:
                    tensors[slot].copy_(new)
        return tuple(raw[:n])


def drop_num_args(params):
    """The normalizer of variadic ops: ``num_args`` is implied by the
    inputs."""
    return {k: v for k, v in params.items() if k != "num_args"}


def register(name, *, num_outputs=1, mutate=(), aliases=(), no_grad=False,
             host=False, param_normalizer=None):
    """Decorator registering ``fn`` under the MXNet op name ``name`` and
    its ``aliases``."""

    def _reg(fn):
        _OPS[name] = OpDef(name, fn, num_outputs=num_outputs, mutate=mutate,
                           no_grad=no_grad, host=host,
                           param_normalizer=param_normalizer)
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return _reg


def add_alias(alias, canonical):
    """Another name for a registered op (NNVM's ``.add_alias()``)."""
    if canonical not in _OPS:
        raise MXNetError(f"add_alias: canonical op '{canonical}' not "
                         "registered")
    _ALIASES[alias] = canonical


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
