"""``mx.sym.contrib``: short names for the ``_contrib_*`` ops (port of the
generated creators of ``mxnet_tpu/symbol/contrib.py``;
``sym.contrib.quantize_v2`` is ``_contrib_quantize_v2``). The control-flow
builders (foreach, while_loop, cond) wait for the word-LM slice (ROADMAP
Queue 1 item 15)."""
from __future__ import annotations

import sys as _sys

_MODULE = _sys.modules[__name__]
_PREFIX = "_contrib_"


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from ..ops.registry import get_op
    from .symbol import make_symbol_creator

    for candidate in (_PREFIX + name, name):
        try:
            get_op(candidate)
        except Exception:
            continue
        c = make_symbol_creator(candidate)
        setattr(_MODULE, name, c)
        return c
    raise AttributeError(name)

