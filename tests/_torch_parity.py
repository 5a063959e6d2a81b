"""One op through both registries: ``mxnet_tpu``'s (the fixed side) and
the port's (``check_consistency``'s pattern, ``mxnet_tpu/test_utils.py``).

:func:`run_both` calls ``mx.nd.<name>`` of each package on the same numpy
inputs and params, and returns both outputs as float64 numpy arrays (and
the inputs' gradients, with ones as head gradients, when asked).
:func:`check_op` compares them within ``rtol`` / ``atol``. No test lives
here.
"""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _np(x):
    return np.asarray(x.asnumpy(), dtype=np.float64)


def _outs(out):
    return [_np(o) for o in (out if isinstance(out, (list, tuple))
                             else [out])]


def run_side(lib, name, inputs, params, grad=False):
    """``lib.nd.<name>(*inputs, **params)`` on the CPU: its outputs, and
    with ``grad`` the float inputs' gradients of the outputs' sum."""
    with lib.cpu():
        arrays = [lib.nd.array(a, dtype=a.dtype) for a in inputs]
        fn = getattr(lib.nd, name)
        if not grad:
            return _outs(fn(*arrays, **params)), None
        diff = [a for a, x in zip(arrays, inputs)
                if np.issubdtype(x.dtype, np.floating)]
        for a in diff:
            a.attach_grad()
        with lib.autograd.record():
            out = fn(*arrays, **params)
            outs = out if isinstance(out, (list, tuple)) else [out]
        lib.autograd.backward(list(outs))
        return _outs(out), [_np(a.grad) for a in diff]


def run_both(name, inputs, params=None, grad=False):
    """(reference outputs, port outputs, reference grads, port grads)."""
    params = dict(params or {})
    j, jg = run_side(mx, name, inputs, params, grad)
    t, tg = run_side(mt, name, inputs, params, grad)
    return j, t, jg, tg


def assert_close(got, want, rtol, atol, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} [{k}]")


def check_op(name, inputs, params=None, rtol=1e-5, atol=1e-6, grad=False):
    """The port's ``name`` against ``mxnet_tpu``'s within ``rtol`` /
    ``atol``, outputs and (with ``grad``) input gradients."""
    j, t, jg, tg = run_both(name, inputs, params, grad)
    assert_close(t, j, rtol, atol, f"{name} outputs")
    if grad:
        assert_close(tg, jg, rtol, atol, f"{name} gradients")
    return j, t
