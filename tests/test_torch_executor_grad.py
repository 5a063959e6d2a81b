"""Executor gradients: ``tests/test_symbol_executor.py``'s training cases
(``test_executor_backward``, ``test_softmax_output_grad``,
``test_batchnorm_aux_update``, ``test_attr_scope_and_lr_mult``) on both
packages, then the port against ``mxnet_tpu`` on one graph's gradients,
``grad_req`` 'add', head gradients, and the output heads' normalisation
where the port follows MXNet."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

LIBS = [pytest.param(mx, id="mxnet_tpu"), pytest.param(mt, id="port")]


# --------------------------------- tests/test_symbol_executor.py, both sides
@pytest.mark.parametrize("lib", LIBS)
def test_executor_backward(lib):
    sym, nd = lib.sym, lib.nd
    with lib.cpu():
        x = sym.Variable("x")
        y = x * x
        ex = y.simple_bind(lib.cpu(), x=(3,))
        ex.arg_dict["x"]._set_data(nd.array([1.0, 2.0, 3.0])._data)
        ex.forward(is_train=True)
        ex.backward()
        np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(),
                                   [2.0, 4.0, 6.0])


@pytest.mark.parametrize("lib", LIBS)
def test_softmax_output_grad(lib):
    sym, nd = lib.sym, lib.nd
    with lib.cpu():
        out = sym.SoftmaxOutput(sym.Variable("data"), sym.Variable("label"),
                                name="softmax")
        ex = out.simple_bind(lib.cpu(), data=(2, 3), label=(2,),
                             grad_req={"data": "write", "label": "null"})
        logits = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
        ex.arg_dict["data"]._set_data(nd.array(logits)._data)
        ex.arg_dict["label"]._set_data(nd.array([2.0, 0.0])._data)
        ex.forward(is_train=True)
        ex.backward()
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        expect = p.copy()
        expect[0, 2] -= 1
        expect[1, 0] -= 1
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), expect,
                                   rtol=1e-5)
        np.testing.assert_allclose(ex.outputs[0].asnumpy(), p, rtol=1e-5)


@pytest.mark.parametrize("lib", LIBS)
def test_batchnorm_aux_update(lib):
    sym, nd = lib.sym, lib.nd
    with lib.cpu():
        out = sym.BatchNorm(sym.Variable("data"), name="bn", fix_gamma=False,
                            momentum=0.5)
        ex = out.simple_bind(lib.cpu(), data=(4, 3))
        assert set(ex.aux_dict) == {"bn_moving_mean", "bn_moving_var"}
        ex.arg_dict["data"]._set_data(nd.array(
            np.random.RandomState(0).rand(4, 3).astype(np.float32) + 5)._data)
        ex.arg_dict["bn_gamma"][:] = 1.0
        before = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
        ex.forward(is_train=True)
        ex.backward()
        after = ex.aux_dict["bn_moving_mean"].asnumpy()
        assert not np.allclose(before, after)
        ex.forward(is_train=False)
        np.testing.assert_allclose(after,
                                   ex.aux_dict["bn_moving_mean"].asnumpy())


@pytest.mark.parametrize("lib", LIBS)
def test_attr_scope_and_lr_mult(lib):
    sym = lib.sym
    DataDesc, DataBatch = lib.io.DataDesc, lib.io.DataBatch
    with lib.cpu():
        with lib.AttrScope(ctx_group="stage1", lr_mult="0.0"):
            frozen = sym.Variable("frozen_w")
        h = sym.FullyConnected(sym.Variable("data"), frozen, num_hidden=4,
                               no_bias=True, name="fcA")
        out = sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=2,
                                                   name="fcB"),
                                sym.Variable("softmax_label"), name="softmax")
        assert frozen.attr("__ctx_group__") == "stage1"
        assert out.attr_dict()["frozen_w"]["__lr_mult__"] == "0.0"
        mod = lib.mod.Module(out, context=lib.cpu())
        mod.bind([DataDesc("data", (8, 6))],
                 [DataDesc("softmax_label", (8,))])
        mod.init_params(lib.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        before = mod.get_params()[0]["frozen_w"].asnumpy().copy()
        rng = np.random.RandomState(0)
        batch = DataBatch(
            data=[lib.nd.array(rng.rand(8, 6).astype(np.float32))],
            label=[lib.nd.array((rng.rand(8) * 2).astype(np.float32))])
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        after = mod.get_params()[0]
        np.testing.assert_array_equal(after["frozen_w"].asnumpy(), before)
        assert np.abs(after["fcB_weight"].asnumpy()).sum() > 0


# ------------------------------------------------------------ port vs jax

def _mlp(lib):
    sym = lib.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=6, name="fc1")
    net = sym.Activation(net, act_type="tanh", name="act")
    net = sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _bind_mlp(lib, values, grad_req):
    with lib.cpu():
        ex = _mlp(lib).simple_bind(lib.cpu(), grad_req=grad_req,
                                   data=(5, 3), softmax_label=(5,))
        for k, v in values.items():
            tgt = ex.arg_dict.get(k)
            if tgt is None:
                tgt = ex.aux_dict[k]
            tgt[:] = lib.nd.array(v)
    return ex


def test_graph_gradients_match_mxnet_tpu():
    """Every argument's gradient and the moving statistics after a training
    forward + backward, within 1e-5 of max|.|; 'add' doubles over two
    backward passes."""
    rng = np.random.RandomState(1)
    with mt.cpu():
        shapes = _mlp(mt).infer_shape(data=(5, 3), softmax_label=(5,))
    names = _mlp(mt).list_arguments()
    values = {n: rng.randn(*s).astype(np.float32)
              for n, s in zip(names, shapes[0])}
    values["softmax_label"] = np.array([0, 3, 1, 2, 3], np.float32)
    values["bn_moving_var"] = np.ones(6, np.float32)
    values["bn_moving_mean"] = np.zeros(6, np.float32)
    req = {n: "null" if n in ("data", "softmax_label") else "write"
           for n in names}
    jex, tex = _bind_mlp(mx, values, req), _bind_mlp(mt, values, req)
    for ex in (jex, tex):
        ex.forward(is_train=True)
        ex.backward()
    for n in names:
        if req[n] == "null":
            continue
        j = jex.grad_dict[n].asnumpy()
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(), j,
                                   atol=1e-5 * np.abs(j).max(), err_msg=n)
    for n in ("bn_moving_mean", "bn_moving_var"):
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(),
                                   jex.aux_dict[n].asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
    add = _bind_mlp(mt, values, {**req, "fc1_weight": "add"})
    for _ in range(2):
        add.forward(is_train=True)
        add.backward()
    np.testing.assert_allclose(add.grad_dict["fc1_weight"].asnumpy(),
                               2 * tex.grad_dict["fc1_weight"].asnumpy(),
                               rtol=1e-5, atol=1e-7)


def test_head_gradients_and_heads_that_ignore_them():
    """``out_grads`` feed a plain graph's heads; ``SoftmaxOutput``'s backward
    ignores them. A forward with ``is_train=False`` records nothing."""
    with mt.cpu():
        x = mt.sym.Variable("x")
        ex = (x * 3).simple_bind(mt.cpu(), x=(2,))
        ex.forward(is_train=True)
        ex.backward(out_grads=[mt.nd.array([1.0, 10.0])])
        np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), [3, 30])
        s = mt.sym.SoftmaxOutput(mt.sym.Variable("data"), name="sm")
        assert s.list_arguments() == ["data", "sm_label"]
        ex = s.simple_bind(mt.cpu(), data=(1, 3), sm_label=(1,))
        ex.forward(is_train=True)
        ex.backward(out_grads=[mt.nd.ones((1, 3)) * 100])
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                                   [[1 / 3 - 1, 1 / 3, 1 / 3]], rtol=1e-6)
        ex.forward(is_train=False)
        with pytest.raises(mt.MXNetError, match="forward"):
            ex.backward()


@pytest.mark.parametrize("norm,scale", [("null", 1.0), ("batch", 1 / 4),
                                        ("valid", 1 / 3)])
def test_softmax_output_normalization_follows_mxnet(norm, scale):
    """MXNet 1.6 divides by the batch ('batch') or by the labels that are
    not ignored ('valid'); ``mxnet_tpu`` ignores ``normalization``
    (ROADMAP "Reference defects"), so the two agree under 'null' only."""
    logits = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    label = np.array([1, -1, 4, 0], np.float32)
    grads = {}
    for lib in (mx, mt):
        with lib.cpu():
            x = lib.nd.array(logits)
            x.attach_grad()
            with lib.autograd.record():
                y = lib.nd.SoftmaxOutput(x, lib.nd.array(label),
                                         normalization=norm, use_ignore=True,
                                         ignore_label=-1.0)
            y.backward()
            grads[lib] = x.grad.asnumpy()
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = p.copy()
    for i, c in enumerate(label.astype(int)):
        want[i, c] -= 1
    want[1] = 0
    np.testing.assert_allclose(grads[mt], want * scale, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(grads[mx], want, rtol=1e-5, atol=1e-7)


def test_softmax_output_smoothing_and_shape_follow_mxnet():
    """``smooth_alpha`` puts alpha / (K - 1) on the other classes;
    ``preserve_shape=False`` takes the softmax over all trailing axes."""
    logits = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    with mt.cpu():
        x = mt.nd.array(logits)
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.SoftmaxOutput(x, mt.nd.array([1.0, 3.0]),
                                    smooth_alpha=0.3)
        y.backward()
        p = y.asnumpy()
        want = p - np.where(np.eye(4)[[1, 3]] > 0, 0.7, 0.1)
        np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-5,
                                   atol=1e-7)
        z = mt.nd.SoftmaxOutput(mt.nd.array(logits.reshape(2, 2, 2)),
                                mt.nd.array([1.0, 3.0])).asnumpy()
        np.testing.assert_allclose(z.reshape(2, 4), p, rtol=1e-6)


def test_svm_output_takes_mxnets_hinge_gradient():
    """L2 (default) and L1 SVM gradients (svm_output-inl.h); ``mxnet_tpu``'s
    head passes the head gradient through (ROADMAP "Reference
    defects")."""
    x = np.array([[0.5, -2.0, 1.5], [2.0, 0.2, -0.5]], np.float32)
    label = np.array([0, 2], np.float32)
    hit = np.eye(3)[[0, 2]] > 0
    l2 = np.where(hit, -np.where(1 > x, 2 * (1 - x), 0),
                  np.where(1 > -x, -2 * (-1 - x), 0))
    l1 = np.where(hit, -(1 > x).astype(np.float32),
                  (1 > -x).astype(np.float32))
    with mt.cpu():
        for use_linear, want in ((False, l2), (True, l1)):
            d = mt.nd.array(x)
            d.attach_grad()
            with mt.autograd.record():
                y = mt.nd.SVMOutput(d, mt.nd.array(label),
                                    use_linear=use_linear)
            y.backward()
            np.testing.assert_allclose(y.asnumpy(), x)
            np.testing.assert_allclose(d.grad.asnumpy(), want, rtol=1e-6)


def test_bind_with_args_grad_and_tensors():
    """``bind`` with NDArrays and ``args_grad`` fills the given buffers;
    bound with tensors, the executor's dicts stay tensors."""
    with mt.cpu():
        a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
        s = mt.sym.dot(a, b)
        ga = mt.nd.zeros((2, 3))
        ex = s.bind(mt.cpu(), {"a": mt.nd.ones((2, 3)),
                               "b": mt.nd.ones((3, 2)) * 2},
                    args_grad={"a": ga}, grad_req={"a": "write"})
        ex.forward(is_train=True)
        ex.backward()
        np.testing.assert_allclose(ga.asnumpy(), np.full((2, 3), 4.0))
        assert ex.grad_dict["a"] is ga
        tex = s.bind(mt.cpu(), {"a": torch.ones(2, 3), "b": torch.ones(3, 2)},
                     grad_req="write")
        out = tex.forward(is_train=True)[0]
        tex.backward()
        assert isinstance(out, torch.Tensor)
        assert torch.equal(tex.grad_dict["b"], torch.full((3, 2), 2.0))


def test_flash_attention_through_a_bound_graph():
    """``scaled_dot_product_attention(impl='flash')`` in a Symbol graph:
    on the CPU the kernels' plain versions, equal to the ``mx.nd`` call's
    forward and gradients."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3))
    with mt.cpu():
        s = mt.sym.scaled_dot_product_attention(
            mt.sym.Variable("q"), mt.sym.Variable("k"), mt.sym.Variable("v"),
            causal=True, impl="flash")
        ex = s.simple_bind(mt.cpu(), q=q.shape, k=k.shape, v=v.shape)
        for n, a in (("q", q), ("k", k), ("v", v)):
            ex.arg_dict[n][:] = a
        ex.forward(is_train=True)
        ex.backward()
        arrs = [mt.nd.array(a) for a in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        with mt.autograd.record():
            o = mt.nd.scaled_dot_product_attention(*arrs, causal=True,
                                                   impl="flash")
        o.backward()
        assert torch.equal(ex.outputs[0]._data, o._data)
        for n, a in zip("qkv", arrs):
            assert torch.equal(ex.grad_dict[n]._data, a.grad._data), n


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_backward_frees_the_graph_unless_it_is_needed(grad_req):
    """The recorded graph outlives ``backward`` only for 'add', where a
    second backward adds the same gradient again; once freed, another
    backward asks for a forward."""
    with mt.cpu():
        x = mt.sym.Variable("x")
        ex = (x * x).simple_bind(mt.cpu(), grad_req=grad_req, x=(3,))
        ex.arg_dict["x"][:] = np.array([1.0, 2.0, 3.0], np.float32)
        ex.forward(is_train=True)
        ex.backward()
        assert (ex._graph is not None) is (grad_req == "add")
        if grad_req == "write":
            with pytest.raises(mt.base.MXNetError, match="forward"):
                ex.backward()
            return
        ex.backward()
        np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(),
                                      [4.0, 8.0, 12.0])


def test_the_executor_holds_tensors_under_its_ndarrays():
    """``simple_bind``'s NDArrays are views of the tensor executor's
    dicts: the walk reads what an array holds at the call, also after it
    took a tensor of another shape, and the gradients it writes are the
    arrays' own."""
    with mt.cpu():
        x = mt.sym.Variable("x")
        ex = mt.sym.sum(x * 2).simple_bind(mt.cpu(), x=(2,))
        tex = ex._exec
        assert all(isinstance(t, torch.Tensor) for d in (
            tex.arg_dict, tex.grad_dict) for t in d.values())
        assert ex.arg_dict["x"]._data is tex.arg_dict["x"]
        ex.forward(is_train=True, x=mt.nd.array([1.0, 2.0, 3.0]))
        assert ex.arg_dict["x"].shape == (3,)
        np.testing.assert_array_equal(ex.outputs[0].asnumpy(), 12.0)
        ex.grad_dict["x"]._set_data(torch.zeros(3))
        ex.backward()
        np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(), [2.0] * 3)


def test_predictor_refuses_host_ops_it_would_capture(monkeypatch):
    """A graph holding an op that reads its operands on the host
    (``boolean_mask``, registered ``host=True``) cannot be a CUDA graph:
    the Predictor refuses it on the card, naming the op, and serves it
    where nothing is captured (``cpu()`` or the capture switch off)."""
    from mxnet_tpu_torch import capture
    from mxnet_tpu_torch.serving.predictor import Predictor, \
        _check_capturable

    s = mt.sym.boolean_mask(mt.sym.Variable("data"), mt.sym.Variable("m"))
    pred = Predictor(s, {}, input_names=("data", "m"), ctx=mt.cpu())
    out = pred.predict({"data": np.arange(6, dtype=np.float32).reshape(3, 2),
                        "m": np.array([1, 0, 1], np.float32)})
    np.testing.assert_array_equal(np.asarray(out[0] if isinstance(
        out, (list, tuple)) else out), [[0, 1], [4, 5]])
    with pytest.raises(capture.CaptureError, match="boolean_mask"):
        _check_capturable(pred._graph, torch.device("cuda", 0))
    monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    _check_capturable(pred._graph, torch.device("cuda", 0))
