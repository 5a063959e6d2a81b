"""``mx.nd``: the imperative NDArray namespace (port of
``mxnet_tpu/ndarray/__init__.py``).

A function for every registered op and alias is made at import, as
MXNet builds them from the op signatures (python/mxnet/ndarray/register.py):
``nd.<op>(*arrays, out=None, **params)``. Leading NDArray arguments are the
op's array inputs; later positional arguments fill its parameters in
order. ``_train`` (``autograd.is_training()``), the device and the
device's ``mx.random`` generator are supplied by
:func:`~.ndarray.imperative_invoke`, where ``mxnet_tpu``'s wrappers
insert the train flag and the global key cell
(``ndarray/__init__.py:24-63``). ``mx.nd.contrib`` has the ``_contrib_*``
ops under their short names and the eager control flow; ``mx.nd.image``
the ``_image_*`` ops under theirs.
"""
from __future__ import annotations

import inspect as _inspect
import sys as _sys

from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray, imperative_invoke
from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops import registry as _registry
from .. import random  # noqa: F401  (nd.random)

_MODULE = _sys.modules[__name__]


def _make_wrapper(opname):
    op = _registry.get_op(opname)
    params = _inspect.signature(op.fn).parameters.values()
    variadic = any(p.kind is p.VAR_POSITIONAL for p in params)
    names = [p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
             and p.name not in _registry.INJECTED and p.name != "rng_key"]

    def wrapper(*args, out=None, name=None, attr=None, **kwargs):
        k = 0
        while k < len(args) and isinstance(args[k], NDArray):
            k += 1
        arrays, rest = args[:k], args[k:]
        if rest:
            free = [n for n in names[0 if variadic else k:]
                    if n not in kwargs]
            kwargs.update(zip(free, rest))
        outs = imperative_invoke(opname, *arrays, out=out, **kwargs)
        return outs[0] if len(outs) == 1 else outs

    wrapper.__name__ = wrapper.__qualname__ = opname
    wrapper.__doc__ = op.doc
    return wrapper


def _populate():
    for name in _registry.list_ops():
        if not hasattr(_MODULE, name):
            setattr(_MODULE, name, _make_wrapper(name))
    for alias, canon in list(_registry._ALIASES.items()):
        if not hasattr(_MODULE, alias) and alias.isidentifier():
            setattr(_MODULE, alias, _make_wrapper(canon))


_populate()

from . import contrib, image  # noqa: E402,F401  (mx.nd.contrib, .image)


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    try:
        _registry.get_op(name)
    except Exception:
        raise AttributeError(name) from None
    w = _make_wrapper(name)
    setattr(_MODULE, name, w)
    return w
