"""``mx.nd.contrib``: short names for the ``_contrib_*`` ops and eager
control flow, ``foreach``, ``while_loop`` and ``cond`` (port of
``mxnet_tpu/ndarray/contrib.py``; parity: python/mxnet/ndarray/contrib.py
foreach :216, while_loop :361, cond :529).

The control flow is a Python loop over NDArrays, as MXNet's is: inside
``autograd.record()`` every step is on the tape. ``while_loop`` stacks the
step outputs and pads them with zero rows to ``max_iterations``, as the
symbolic loop does; ``cond`` and ``while_loop`` read their predicate on the
host.
"""
from __future__ import annotations

import sys as _sys

from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]

_MODULE = _sys.modules[__name__]
_PREFIX = "_contrib_"


def _listify(x):
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _truth(a):
    return bool(a.asnumpy().reshape(-1)[0])


def foreach(body, data, init_states, name=None):
    """``body(data_slice, states) -> (outputs, new_states)`` over axis 0
    of ``data``; (stacked outputs, final states)."""
    from . import stack

    data_list, data_is_list = _listify(data)
    states, state_is_list = _listify(init_states)
    n = data_list[0].shape[0]
    if n == 0:
        raise MXNetError("foreach over zero-length data: the output shapes "
                         "are unknown")
    collected, out_is_list = None, False
    for i in range(n):
        slices = [d[i] for d in data_list]
        outs, new_states = body(
            slices if data_is_list else slices[0],
            states if state_is_list else (states[0] if states else []))
        out_list, out_is_list = _listify(outs)
        states, _ = _listify(new_states)
        if collected is None:
            collected = [[] for _ in out_list]
        for k, o in enumerate(out_list):
            collected[k].append(o)
    stacked = [stack(*c, axis=0) for c in collected]
    return (stacked if out_is_list else stacked[0],
            states if state_is_list else (states[0] if states else []))


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """While ``cond(*loop_vars)`` holds (at most ``max_iterations`` times),
    ``func(*loop_vars) -> (outputs, new_loop_vars)``; (outputs stacked and
    zero-padded to ``max_iterations`` rows, final loop variables)."""
    from . import concat, stack, zeros

    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    states, state_is_list = _listify(loop_vars)
    collected, out_is_list, steps = None, False, 0
    while steps < max_iterations and _truth(cond(*states)):
        outs, new_states = func(*states)
        out_list, out_is_list = _listify(outs)
        states, _ = _listify(new_states)
        if collected is None:
            collected = [[] for _ in out_list]
        for k, o in enumerate(out_list):
            collected[k].append(o)
        steps += 1
    if collected is None:
        # no step: run the body once (its result dropped) to learn the
        # outputs' shapes, as mxnet_tpu does
        try:
            outs, _ = func(*states)
        except Exception as e:
            raise MXNetError(
                "while_loop made zero iterations and the output shapes "
                f"could not be probed (body raised: {e})") from e
        out_list, out_is_list = _listify(outs)
        bufs = [zeros((max_iterations,) + o.shape, o.context, o.dtype)
                for o in out_list]
    else:
        bufs = []
        for c in collected:
            s = stack(*c, axis=0)
            if steps < max_iterations:
                s = concat(s, zeros((max_iterations - steps,) + c[0].shape,
                                    c[0].context, c[0].dtype), dim=0)
            bufs.append(s)
    return (bufs if out_is_list else bufs[0],
            states if state_is_list else states[0])


def cond(pred, then_func, else_func, name=None):
    """``then_func()`` where the scalar NDArray ``pred`` is non-zero, else
    ``else_func()``."""
    return then_func() if _truth(pred) else else_func()


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from . import __getattr__ as _nd_getattr

    try:
        fn = _nd_getattr(_PREFIX + name)
    except AttributeError:
        fn = _nd_getattr(name)
    setattr(_MODULE, name, fn)
    return fn
