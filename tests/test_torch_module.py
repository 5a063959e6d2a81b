"""The Module API, kvstore, checkpoints and callbacks against ``mxnet_tpu``.

The MNIST-shaped MLP (``examples/train_mnist.py``'s graph at a small
width) trains 2 epochs at batch 64 with shuffle off from ``mxnet_tpu``'s
initial parameters: every parameter after each epoch within 1e-5 of its
max|w|, and ``score`` equal. ``mxnet_tpu``'s own Module tests shuffle with
an unseeded generator, so parity runs never shuffle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402


def _data(n=512, dim=48, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(classes, dim).astype(np.float32)
    y = rng.randint(0, classes, n)
    x = centers[y] + rng.randn(n, dim).astype(np.float32) * 0.15
    return x, y.astype(np.float32)


def _mlp(lib, hidden=(32, 16)):
    sym = lib.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden[0],
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=hidden[1], name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _np(params):
    return {k: v.asnumpy().copy() for k, v in params.items()}


def _close(got, want, tol, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k],
                                   atol=tol * max(np.abs(want[k]).max(),
                                                  1e-12),
                                   rtol=0, err_msg=f"{what} {k}")


def _fit(lib, x, y, arg, aux, contexts, epochs, kvstore="local",
         batch=64):
    with lib.cpu():
        train = lib.io.NDArrayIter(x, y, batch, shuffle=False)
        mod = lib.mod.Module(_mlp(lib), context=contexts(lib))
        per_epoch = []
        mod.fit(train, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params=arg, aux_params=aux, kvstore=kvstore,
                epoch_end_callback=lambda e, s, a, x_: per_epoch.append(
                    _np(a)))
        return mod, per_epoch


def _initial():
    with mx.cpu():
        m = mx.mod.Module(_mlp(mx), context=mx.cpu())
        m.bind([("data", (64, 48))], [("softmax_label", (64,))])
        mx.random.seed(0)
        m.init_params(mx.initializer.Xavier())
        arg, aux = m.get_params()
        return ({k: v.asnumpy() for k, v in arg.items()},
                {k: v.asnumpy() for k, v in aux.items()})


def test_module_mlp_matches_mxnet_tpu_each_epoch():
    x, y = _data()
    arg, aux = _initial()
    one = lambda lib: lib.cpu()  # noqa: E731
    jmod, jep = _fit(mx, x, y, {k: mx.nd.array(v) for k, v in arg.items()},
                     aux, one, 2)
    tmod, tep = _fit(mt, x, y, arg, aux, one, 2)
    assert len(jep) == len(tep) == 2
    for e, (j, t) in enumerate(zip(jep, tep)):
        _close(t, j, 1e-5, f"epoch {e}")
    with mx.cpu():
        jscore = jmod.score(mx.io.NDArrayIter(x, y, 64), "acc")
    with mt.cpu():
        tscore = tmod.score(mt.io.NDArrayIter(x, y, 64), "acc")
    assert tscore == jscore and tscore[0][1] > 0.9
    # predict: the outputs over the data, pad rows dropped
    with mt.cpu():
        it = mt.io.NDArrayIter(x[:100], y[:100], 64)
        pred = tmod.predict(it)
        assert pred.shape == (100, 10)
        first = next(tmod.iter_predict(it))[0][0]
        np.testing.assert_array_equal(first.asnumpy(), pred.asnumpy()[:64])


def test_two_context_module_matches_mxnet_tpu():
    """The batch sliced over cpu(0) and cpu(1), gradients summed on a
    'device' kvstore in context order, the update on the store
    (``tests/test_module_train.py::test_module_multi_context_data_parallel``
    without the shuffle)."""
    x, y = _data(n=256)
    arg, aux = _initial()
    two = lambda lib: [lib.cpu(0), lib.cpu(1)]  # noqa: E731
    _, jep = _fit(mx, x, y, {k: mx.nd.array(v) for k, v in arg.items()},
                  aux, two, 2, kvstore="device")
    tmod, tep = _fit(mt, x, y, arg, aux, two, 2, kvstore="device")
    assert isinstance(tmod._kvstore, mt.kv.KVStoreDevice)
    assert tmod._update_on_kvstore
    for e, (j, t) in enumerate(zip(jep, tep)):
        _close(t, j, 1e-5, f"epoch {e}")


def test_kvstore_against_mxnet_tpu(tmp_path):
    """push of 4 values then pull: their sum in list order, bitwise on both
    packages; an optimizer on the store; optimizer states round trip."""
    rng = np.random.RandomState(3)
    vals = [rng.randn(5, 4).astype(np.float32) for _ in range(4)]
    w0 = rng.randn(5, 4).astype(np.float32)
    out = {}
    for lib in (mx, mt):
        with lib.cpu():
            kv = lib.kv.create("device")
            kv.init("w", lib.nd.zeros((5, 4)))
            kv.push("w", [lib.nd.array(v) for v in vals])
            got = lib.nd.zeros((5, 4))
            kv.pull("w", out=got)
            kv2 = lib.kv.create("local")
            kv2.set_optimizer(lib.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9))
            kv2.init(3, lib.nd.array(w0))
            for v in vals[:2]:
                kv2.push(3, lib.nd.array(v))
            upd = lib.nd.zeros((5, 4))
            kv2.pull(3, out=upd)
            fname = str(tmp_path / f"{lib.__name__}.states")
            kv2.save_optimizer_states(fname)
            kv2.load_optimizer_states(fname)
            kv2.push(3, lib.nd.array(vals[2]))
            kv2.pull(3, out=upd)
            out[lib] = (got.asnumpy(), upd.asnumpy())
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    np.testing.assert_array_equal(out[mt][0], want)
    np.testing.assert_array_equal(out[mx][0], want)
    np.testing.assert_allclose(out[mt][1], out[mx][1], rtol=1e-6, atol=1e-7)
    with mt.cpu():
        assert mt.kv.create("tpu").type == "tpu"
        assert mt.kv.create("nccl").num_workers == 1
        # outside a launched job a dist store is one worker's store
        for name in ("dist_sync", "dist_device_sync"):
            kv = mt.kv.create(name)
            assert (kv.type, kv.num_workers, kv.rank) == (name, 1, 0)
        with pytest.raises(mt.MXNetError, match="asynchronous"):
            mt.kv.create("dist_async")
        with pytest.raises(mt.MXNetError, match="item 11"):
            mt.kv.create("local").set_gradient_compression({"type": "2bit"})


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by either package's Module loads in the other's
    ``load_checkpoint`` / ``Module.load`` bitwise."""
    x, y = _data(n=128)
    arg, aux = _initial()
    one = lambda lib: lib.cpu()  # noqa: E731
    jmod, _ = _fit(mx, x, y, {k: mx.nd.array(v) for k, v in arg.items()},
                   aux, one, 1)
    tmod, _ = _fit(mt, x, y, arg, aux, one, 1)
    jpre, tpre = str(tmp_path / "jax"), str(tmp_path / "port")
    with mx.cpu():
        jmod.save_checkpoint(jpre, 1)
    with mt.cpu():
        tmod.save_checkpoint(tpre, 1, save_optimizer_states=True)
    with mt.cpu():
        sym, targ, taux = mt.model.load_checkpoint(jpre, 1)
        assert sym.list_arguments() == _mlp(mt).list_arguments()
        mod = mt.mod.Module.load(jpre, 1, context=mt.cpu())
        mod.bind([("data", (64, 48))], [("softmax_label", (64,))],
                 for_training=False)
        for k, v in _np(jmod.get_params()[0]).items():
            np.testing.assert_array_equal(targ[k].asnumpy(), v)
            np.testing.assert_array_equal(mod.get_params()[0][k].asnumpy(),
                                          v)
        got = mod.predict(mt.io.NDArrayIter(x, y, 64)).asnumpy()
        back = mt.mod.Module.load(tpre, 1, load_optimizer_states=True,
                                  context=mt.cpu())
        back.bind([("data", (64, 48))], [("softmax_label", (64,))])
        back.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9})
        assert back._updater.states
    with mx.cpu():
        np.testing.assert_allclose(
            got, jmod.predict(mx.io.NDArrayIter(x, y, 64)).asnumpy(),
            rtol=1e-5, atol=1e-6)
        sym, jarg, _ = mx.model.load_checkpoint(tpre, 1)
        assert sym.list_arguments() == _mlp(mx).list_arguments()
    for k, v in _np(tmod.get_params()[0]).items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v)


def test_module_surface(tmp_path):
    """bind / init / forward_backward / update / get_outputs /
    get_input_grads / reshape / optimizer states / borrow_optimizer and the
    callbacks, on the port."""
    x, y = _data(n=64)
    DataBatch = mt.io.DataBatch
    with mt.cpu():
        mt.random.seed(0)
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod.bind([("data", (32, 48))], [("softmax_label", (32,))],
                 inputs_need_grad=True)
        mod.init_params(mt.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = DataBatch([mt.nd.array(x[:32])], [mt.nd.array(y[:32])])
        mod.forward_backward(batch)
        before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
        mod.update()
        assert not np.array_equal(
            mod.get_params()[0]["fc1_weight"].asnumpy(), before)
        assert mod.get_outputs()[0].shape == (32, 10)
        assert mod.get_input_grads()[0].shape == (32, 48)
        assert mod.output_shapes == [("softmax_output", (32, 10))]
        fname = str(tmp_path / "opt.states")
        mod.save_optimizer_states(fname)
        mod.load_optimizer_states(fname)
        mod.reshape([("data", (16, 48))], [("softmax_label", (16,))])
        mod.forward(DataBatch([mt.nd.array(x[:16])]), is_train=False)
        assert mod.get_outputs()[0].shape == (16, 10)
        other = mt.mod.Module(_mlp(mt), context=mt.cpu())
        other.bind([("data", (16, 48))], [("softmax_label", (16,))])
        other.init_params(arg_params=mod.get_params()[0],
                          aux_params=mod.get_params()[1])
        other.borrow_optimizer(mod)
        assert other._updater is mod._updater
        # callbacks
        speed = mt.callback.Speedometer(16, frequent=2)
        prefix = str(tmp_path / "cb")
        mod2 = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod2.fit(mt.io.NDArrayIter(x, y, 16), num_epoch=2,
                 batch_end_callback=[speed, mt.callback.log_train_metric(2),
                                     mt.callback.ProgressBar(4)],
                 epoch_end_callback=[mt.callback.do_checkpoint(prefix),
                                     mt.callback.module_checkpoint(
                                         mod2, prefix + "m", 2)])
        assert len(speed.rates) == 2 and all(r > 0 for r in speed.rates)
        for f in (f"{prefix}-0001.params", f"{prefix}-0002.params",
                  f"{prefix}-symbol.json", f"{prefix}m-0002.params"):
            assert (tmp_path / f.rsplit("/", 1)[1]).exists(), f
        # resilient_checkpoint is ported: it saves through its manager
        mgr = mt.resilience.CheckpointManager(str(tmp_path / "ckpt"),
                                              keep_n=1)
        tnet = mt.gluon.nn.Dense(3, in_units=4)
        tnet.initialize(ctx=mt.cpu())
        cb = mt.callback.resilient_checkpoint(mgr, tnet, period=2)
        cb(0)
        assert mgr.list_checkpoints() == []
        cb(1)
        assert [s for s, _ in mgr.list_checkpoints()] == [2]


def test_module_without_context_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context works")
    mod = mt.mod.Module(_mlp(mt))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mod.bind([("data", (8, 48))], [("softmax_label", (8,))])


def test_ndarray_iter_batches():
    x, y = _data(n=10)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, 4)
        assert it.provide_data == [mt.io.DataDesc("data", (4, 48),
                                                  np.float32)]
        assert it.provide_label[0].name == "softmax_label"
        batches = list(it)
        assert [b.pad for b in batches] == [0, 0, 2]
        assert isinstance(batches[0].data[0], mt.nd.NDArray)
        np.testing.assert_array_equal(batches[2].data[0].asnumpy()[2:],
                                      x[:2])
        assert len(list(mt.io.NDArrayIter(
            x, y, 4, last_batch_handle="discard"))) == 2
        mt.random.seed(7)
        a = [b.label[0].asnumpy() for b in mt.io.NDArrayIter(
            x, y, 5, shuffle=True)]
        mt.random.seed(7)
        b = [b.label[0].asnumpy() for b in mt.io.NDArrayIter(
            x, y, 5, shuffle=True)]
        np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
        assert sorted(np.concatenate(a).tolist()) == sorted(y.tolist())


def test_gluon_trainer_takes_the_kvstore_names():
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    for kv in ("device", "local", "tpu", "nccl", None):
        mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
    mt.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    with pytest.raises(mt.MXNetError, match="asynchronous"):
        mt.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async")
    with pytest.raises(mt.MXNetError, match="item 11"):
        mt.gluon.Trainer(net.collect_params(), "sgd",
                         compression_params={"type": "2bit"})
