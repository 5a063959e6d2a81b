"""The port's autograd.grad (first and second order), mark_variables and
custom Function against mxnet_tpu's, on the CPU, within 1e-5.

mxnet_tpu's ``grad(create_graph=True)`` records nothing (its
``create_graph`` branch is a no-op), so a second-order gradient cannot be
taken there: the port's is held to mxnet_tpu's first-order gradient of
the first derivative written out by hand (ROADMAP Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402

TOL = 1e-5
X = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)
W = np.array([[1.0, 2.0, -0.5], [0.3, -1.2, 0.8]], np.float32)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_grad_first_order_matches():
    jx, jw = mx.nd.array(X), mx.nd.array(W)
    jx.attach_grad()
    jw.attach_grad()
    with mx.autograd.record():
        jy = (jx * jx * jx * jw).sum() + (mx.nd.exp(jx) * jw).sum()
    jg = mx.autograd.grad(jy, [jx, jw])
    tx = torch.from_numpy(X.copy()).requires_grad_()
    tw = torch.from_numpy(W.copy()).requires_grad_()
    with mt.autograd.record():
        ty = (tx * tx * tx * tw).sum() + (torch.exp(tx) * tw).sum()
    tg = mt.autograd.grad(ty, [tx, tw])
    for a, b in zip(tg, jg):
        _close(a, b)
    assert tx.grad is None and tw.grad is None   # .grad untouched


def test_grad_with_head_grads_matches():
    hg = np.array([2.0, -1.0, 0.5], np.float32)
    jx = mx.nd.array(X[0])
    jx.attach_grad()
    with mx.autograd.record():
        jy = jx * jx
    jg = mx.autograd.grad(jy, [jx], head_grads=[mx.nd.array(hg)])
    tx = torch.from_numpy(X[0].copy()).requires_grad_()
    with mt.autograd.record():
        ty = tx * tx
    tg = mt.autograd.grad(ty, tx, head_grads=torch.from_numpy(hg))
    _close(tg[0], jg[0])


def test_grad_second_order_matches_the_written_out_derivative():
    """d/dx sum(w * d/dx sum(x^3 w)): the port by create_graph, mxnet_tpu
    by the first-order gradient of the written-out 3 x^2 w."""
    tx = torch.from_numpy(X.copy()).requires_grad_()
    tw = torch.from_numpy(W.copy())
    with mt.autograd.record():
        ty = (tx ** 3 * tw).sum()
        (g1,) = mt.autograd.grad(ty, [tx], create_graph=True)
        z = (g1 * tw).sum()
    (g2,) = mt.autograd.grad(z, [tx])
    jx, jw = mx.nd.array(X), mx.nd.array(W)
    jx.attach_grad()
    jw.attach_grad()
    with mx.autograd.record():
        jg1 = 3 * jx * jx * jw
        jz = (jg1 * jw).sum()
    # every array the tape reads is a variable of mxnet_tpu's grad (it
    # looks the others up with list.index, which compares arrays)
    jg2, _ = mx.autograd.grad(jz, [jx, jw])
    _close(g1, jg1)
    _close(g2, jg2)


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables_matches(req):
    """Gradients land in the given buffers: 'write' overwrites at each
    backward, 'add' accumulates, as mxnet_tpu's."""
    jx, jbuf = mx.nd.array(X), mx.nd.zeros(X.shape)
    mx.autograd.mark_variables([jx], [jbuf], grad_reqs=req)
    tx, tbuf = torch.from_numpy(X.copy()), torch.zeros(X.shape)
    mt.autograd.mark_variables([tx], [tbuf], grad_reqs=req)
    for k in range(2):
        with mx.autograd.record():
            jy = (jx * jx * (k + 1)).sum()
        jy.backward()
        with mt.autograd.record():
            ty = (tx * tx * (k + 1)).sum()
        ty.backward()
        _close(tbuf, jbuf)
        assert tx.grad is tbuf


def _functions(lib):
    """A sigmoid with a hand-written gradient, on either package's
    arrays."""
    exp = mx.nd.exp if lib is mx else torch.exp

    class Sigmoid(lib.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    class ScaleAdd(lib.autograd.Function):
        """Two inputs, two outputs: (a * b, a + b)."""

        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b

        def backward(self, d1, d2):
            a, b = self.saved_tensors
            return d1 * b + d2, d1 * a + d2

    return Sigmoid, ScaleAdd


def test_custom_function_matches():
    jsig, jsa = _functions(mx)
    tsig, tsa = _functions(mt)
    jx, jw = mx.nd.array(X), mx.nd.array(W)
    jx.attach_grad()
    jw.attach_grad()
    with mx.autograd.record():
        p, s = jsa()(jx, jw)
        jy = (jsig()(p) * s).sum()
    jy.backward()
    tx = torch.from_numpy(X.copy()).requires_grad_()
    tw = torch.from_numpy(W.copy()).requires_grad_()
    with mt.autograd.record():
        p, s = tsa()(tx, tw)
        ty = (tsig()(p) * s).sum()
    ty.backward()
    _close(ty, jy)
    _close(tx.grad, jx.grad)
    _close(tw.grad, jw.grad)
    # outside record() a Function is its forward, recording nothing
    out = tsig()(torch.from_numpy(X.copy()).requires_grad_())
    assert out.grad_fn is None
