"""AttrScope: attributes stamped on every Symbol node made inside it (port
of ``mxnet_tpu/attribute.py``; parity: python/mxnet/attribute.py).

``with mx.AttrScope(ctx_group="stage1", lr_mult="0.1"):`` gives each node
created in the scope ``__ctx_group__`` / ``__lr_mult__``; nested scopes
merge, the inner one winning. The attributes reach ``Symbol.attr_dict()``,
where ``Module.init_optimizer`` reads ``__lr_mult__`` / ``__wd_mult__``.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_TLS = threading.local()


def _stack():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


class AttrScope:
    """Attribute manager: values are strings, as in MXNet."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings, got "
                                 f"{type(v).__name__}")
        self._attrs = {k if k.startswith("__") else f"__{k}__": v
                       for k, v in kwargs.items()}

    def __enter__(self):
        _stack().append(self._attrs)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current_attrs():
    """The merged attributes of the scopes this thread is in."""
    merged = {}
    for attrs in _stack():
        merged.update(attrs)
    return merged
