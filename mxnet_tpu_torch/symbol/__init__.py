"""``mx.sym``: the symbolic namespace (port of ``mxnet_tpu/symbol``).

Every registered op is a creator here under its MXNet name
(``sym.Convolution``, ``sym.BatchNorm``, ...), made on first use by
:func:`~mxnet_tpu_torch.symbol.symbol.make_symbol_creator`;
``sym.contrib.<name>`` reaches the ``_contrib_<name>`` ops.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops.registry import get_op as _get_op
from .symbol import (Symbol, Variable, var, Group, load, load_json,  # noqa: F401
                     make_symbol_creator, reset_name_counters)
from . import contrib  # noqa: F401

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "make_symbol_creator", "reset_name_counters", "contrib"]

_MODULE = _sys.modules[__name__]


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        _get_op(name)
    except Exception:
        raise AttributeError(name) from None
    c = make_symbol_creator(name)
    setattr(_MODULE, name, c)
    return c
