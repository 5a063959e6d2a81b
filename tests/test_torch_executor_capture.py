"""The captured Module executor (``mxnet_tpu_torch/executor.py``): the
forward and the fused forward + backward as ``capture.CapturedExec``
programs (on the CPU run directly, through the same keys, state and
counters as the card's CUDA graphs), the counterpart of ``mxnet_tpu``'s
``_jit_fwd`` / ``_jit_fwd_bwd``.

- ``examples/train_mnist.py``'s MLP (at a small width) fits 2 epochs
  through ``Module.fit``: every parameter after each epoch bitwise the
  eager walk's (the kill switch) and within 1e-5 of ``mxnet_tpu``'s
  Module from the same initial parameters.
- A tied 2-layer LSTM word LM (``tests/test_torch_bucketing.py``'s) takes
  a sequence of bucket steps through ``BucketingModule``: one fused graph
  a bucket over the shared parameters; outputs and parameters after every
  step bitwise the eager walk's, within 1e-5 of ``mxnet_tpu``'s.
- An MLP with a Dropout trains through the fused program, bitwise the
  eager walk from one ``mx.random`` seed, a fresh mask each run.
- A BucketingModule's buckets capture into one graph memory pool.
- ``grad_req='add'``, outputs read before ``backward`` (a BatchNorm's
  moving statistics move as ``mxnet_tpu``'s do), the monitor's eager
  walk, and a feed of a new shape captured again with its reason.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE", raising=False)
    capture.reset_stats()
    capture.clear_retrace_log()
    with mt.cpu():
        yield
    capture.reset_stats()
    capture.clear_retrace_log()


def _kill_switch(monkeypatch, on):
    if on:
        monkeypatch.setenv("MXNET_TPU_TORCH_CAPTURE", "0")
    else:
        monkeypatch.delenv("MXNET_TPU_TORCH_CAPTURE", raising=False)


def _close(got, want, what="", whole=False):
    """Each array within 1e-5 of its own max|want|, or with ``whole`` of
    the largest over the dict (gradients that are zero up to rounding,
    as a bias's before a BatchNorm)."""
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = top if whole else np.abs(want[k]).max()
        np.testing.assert_allclose(
            got[k], want[k], rtol=0, atol=TOL * max(scale, 1e-12),
            err_msg=f"{what} {k}")


def _same(a, b, what=""):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


# --------------------------------------------------------- the Module fit
def _data(n=512, dim=48, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(classes, dim).astype(np.float32)
    y = rng.randint(0, classes, n)
    x = centers[y] + rng.randn(n, dim).astype(np.float32) * 0.15
    return x, y.astype(np.float32)


def _mlp(lib, hidden=(32, 16)):
    """``examples/train_mnist.py``'s graph at a small width."""
    sym = lib.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden[0],
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=hidden[1], name="fc2")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _initial(sym_of, shapes):
    with mx.cpu():
        m = mx.mod.Module(sym_of(mx), context=mx.cpu())
        m.bind(*shapes)
        mx.random.seed(0)
        m.init_params(mx.initializer.Xavier())
        arg, aux = m.get_params()
        return ({k: v.asnumpy() for k, v in arg.items()},
                {k: v.asnumpy() for k, v in aux.items()})


def _fit(lib, x, y, arg, aux, epochs=2, batch=64):
    with lib.cpu():
        train = lib.io.NDArrayIter(x, y, batch, shuffle=False)
        mod = lib.mod.Module(_mlp(lib), context=lib.cpu())
        per_epoch = []
        mod.fit(train, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params={k: lib.nd.array(v) for k, v in arg.items()},
                aux_params={k: lib.nd.array(v) for k, v in aux.items()},
                epoch_end_callback=lambda e, s, a, x_: per_epoch.append(
                    {k: v.asnumpy().copy() for k, v in a.items()}))
        return mod, per_epoch


def test_module_fit_captured_against_eager_and_mxnet_tpu(monkeypatch):
    x, y = _data()
    arg, aux = _initial(_mlp, ([("data", (64, 48))],
                               [("softmax_label", (64,))]))
    cmod, cep = _fit(mt, x, y, arg, aux)
    st = capture.stats()
    batches = 2 * len(x) // 64
    assert st["capture_fallback_eager"] == 0
    assert st["capture_misses"] == 1                # one fused graph
    assert st["capture_hits"] == batches - 1
    ex = cmod._execs[0]._exec
    assert [k[-5] for k in ex._cap.compiled_signatures] == ["backward"]
    _kill_switch(monkeypatch, True)
    emod, eep = _fit(mt, x, y, arg, aux)
    assert capture.stats()["capture_fallback_eager"] == batches
    _kill_switch(monkeypatch, False)
    _, jep = _fit(mx, x, y, arg, aux)
    for e in range(2):
        _same(cep[e], eep[e], f"epoch {e}")
        _close(cep[e], jep[e], f"epoch {e}")
    with mt.cpu():
        score = cmod.score(mt.io.NDArrayIter(x, y, 64), "acc")
    assert score[0][1] > 0.9


def _dropout_steps(steps=4, batch=64):
    """``steps`` SGD steps of a ``simple_bind`` executor over an MLP with
    a Dropout (its ``rng_key`` shape given, as binding one needs): the
    parameters after each step, and the outputs of two training forwards
    of one batch after them."""
    sym = mt.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=32,
                             name="fc1")
    net = sym.Dropout(sym.Activation(net, act_type="relu"), p=0.3,
                      name="drop")
    net = sym.FullyConnected(net, num_hidden=10, name="fc2")
    net = sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                            name="softmax")
    x, y = _data()
    rng = np.random.RandomState(4)
    with mt.cpu():
        ex = net.simple_bind(mt.cpu(), grad_req="write", data=(batch, 48),
                             softmax_label=(batch,), drop_rng_key=(2,))
        for k in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
            shape = ex.arg_dict[k].shape
            ex.arg_dict[k][:] = rng.randn(*shape).astype(np.float32) * 0.1
        params = []
        for s in range(steps):
            rows = slice(s * batch, (s + 1) * batch)
            ex.forward(is_train=True, data=mt.nd.array(x[rows]),
                       softmax_label=mt.nd.array(y[rows]))
            ex.backward()
            for k in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
                ex.arg_dict[k][:] = ex.arg_dict[k] - 0.1 * ex.grad_dict[k]
            params.append({k: v.asnumpy().copy()
                           for k, v in ex.arg_dict.items()})
        twice = []
        for _ in range(2):
            ex.forward(is_train=True, data=mt.nd.array(x[:batch]),
                       softmax_label=mt.nd.array(y[:batch]))
            twice.append(ex.outputs[0].asnumpy().copy())
    return params, twice


def test_dropout_in_training_captured_against_eager(monkeypatch):
    """A Dropout in training draws from mx.random's generator inside the
    fused program, a fresh mask each run: from one seed, every parameter
    after each step is bitwise the eager walk's (the packages' draws
    differ, so mxnet_tpu is no oracle here)."""
    runs = []
    for kill in (False, True):
        _kill_switch(monkeypatch, kill)
        mt.random.seed(3)
        capture.reset_stats()
        runs.append(_dropout_steps() + (capture.stats(),))
    _kill_switch(monkeypatch, False)
    (cap, ctwice, cst), (eag, etwice, est) = runs
    assert cst["capture_fallback_eager"] == 0
    assert cst["capture_misses"] == 2     # the fused program, the forward
    assert est["capture_fallback_eager"] == 6
    for k, (c, e) in enumerate(zip(cap, eag)):
        _same(c, e, f"step {k}")
    for a, b in zip(ctwice, etwice):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(*ctwice)    # a fresh mask each run


# ------------------------------------------------------ BucketingModule
VOCAB, B = 8, 4
BUCKETS = (4, 6)
SEQUENCE = (6, 4, 4, 6, 4, 6)


def _tied_lstm_sym_gen(lib, units=12, layers=2):
    sym = lib.sym

    def gen(seq_len):
        data, label = sym.Variable("data"), sym.Variable("softmax_label")
        weight = sym.Variable("embed_weight")
        emb = sym.Embedding(data, weight=weight, input_dim=VOCAB,
                            output_dim=units, name="embed")
        rnn = sym.RNN(sym.transpose(emb, axes=(1, 0, 2)), state_size=units,
                      num_layers=layers, mode="lstm", name="lstm")
        out = sym.transpose(rnn, axes=(1, 0, 2)).reshape((-1, units))
        logits = sym.FullyConnected(out, weight=weight, num_hidden=VOCAB,
                                    name="pred")
        return (sym.SoftmaxOutput(logits, sym.reshape(label, shape=(-1,)),
                                  name="softmax"),
                ("data",), ("softmax_label",))
    return gen


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for T in SEQUENCE:
        seq = [rng.randint(0, VOCAB, size=(B, 1))]
        for _ in range(T):
            seq.append((3 * seq[-1] + 7) % VOCAB)
        seq = np.concatenate(seq, axis=1)
        out.append((T, seq[:, :-1].astype(np.float32),
                    seq[:, 1:].astype(np.float32)))
    return out


def _bucketing(lib, arg=None):
    with lib.cpu():
        mod = lib.mod.BucketingModule(_tied_lstm_sym_gen(lib),
                                      default_bucket_key=max(BUCKETS),
                                      context=lib.cpu())
        mod.bind([lib.io.DataDesc("data", (B, max(BUCKETS)))],
                 [lib.io.DataDesc("softmax_label", (B, max(BUCKETS)))])
        if arg is None:
            mx.random.seed(0)
            mod.init_params(mx.initializer.Xavier())
        else:
            mod.init_params(arg_params={k: lib.nd.array(v)
                                        for k, v in arg.items()},
                            aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.5, "momentum": 0.9})
    return mod


def _bucket_steps(lib, mod):
    """Each step's outputs (read after the backward) and parameters."""
    out = []
    for T, x, y in _batches():
        with lib.cpu():
            batch = lib.io.DataBatch(
                data=[lib.nd.array(x)], label=[lib.nd.array(y)],
                bucket_key=T,
                provide_data=[lib.io.DataDesc("data", (B, T))],
                provide_label=[lib.io.DataDesc("softmax_label", (B, T))])
            mod.forward_backward(batch)
            mod.update()
            o = mod.get_outputs()[0].asnumpy()
            out.append((o, {k: v.asnumpy().copy()
                            for k, v in mod.get_params()[0].items()}))
    return out


def test_bucketing_module_captured_against_eager_and_mxnet_tpu(
        monkeypatch):
    jmod = _bucketing(mx)
    init = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    cap = _bucket_steps(mt, cmod := _bucketing(mt, init))
    st = capture.stats()
    assert st["capture_fallback_eager"] == 0
    assert st["capture_misses"] == len(BUCKETS)     # a fused graph a bucket
    for T in BUCKETS:
        sigs = cmod._buckets[T]._execs[0]._exec._cap.compiled_signatures
        assert len(sigs) == 1 and sigs[0][-5] == "backward"
    shared = cmod._buckets[4]._execs[0].arg_dict["embed_weight"]._data
    assert shared is cmod._buckets[6]._execs[0].arg_dict[
        "embed_weight"]._data
    _kill_switch(monkeypatch, True)
    eag = _bucket_steps(mt, _bucketing(mt, init))
    _kill_switch(monkeypatch, False)
    ref = _bucket_steps(mx, jmod)
    for k, ((co, cp), (eo, ep), (jo, jp)) in enumerate(zip(cap, eag, ref)):
        np.testing.assert_array_equal(co, eo)
        _same(cp, ep, f"step {k}")
        _close({"out": co}, {"out": jo}, f"step {k}")
        _close(cp, jp, f"step {k}")


def test_bucket_graphs_share_one_memory_pool(monkeypatch):
    """Each bucket's executor captures into the default bucket's graph
    pool (the buckets never run at once), so the pool holds about the
    largest bucket's temporaries, not the sum over buckets; also when
    another bucket runs before the default one."""
    monkeypatch.setattr(sys.modules[__name__], "SEQUENCE", (4, 6, 4))
    init = {k: v.asnumpy() for k, v in _bucketing(mx).get_params()[0].items()}
    mod = _bucketing(mt, init)
    _bucket_steps(mt, mod)
    pools = [m._execs[0]._exec._cap._pool for m in mod._buckets.values()]
    assert len(pools) == len(BUCKETS)
    assert all(p is pools[0] for p in pools)
    assert pools[0].users == len(BUCKETS)


# ------------------------------------------------------ executor details
def _bn_net(lib):
    sym = lib.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=6, name="fc")
    net = sym.BatchNorm(net, name="bn", fix_gamma=False)
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def _bind_bn(lib, arg, aux, grad_req="write"):
    with lib.cpu():
        ex = _bn_net(lib).simple_bind(
            lib.cpu(), grad_req=grad_req, data=(4, 5), softmax_label=(4,))
        for k, v in arg.items():
            ex.arg_dict[k][:] = v
        for k, v in aux.items():
            ex.aux_dict[k][:] = v
        if grad_req != "write":
            for k in ("data", "softmax_label"):
                if k in ex.grad_dict:
                    ex.grad_dict[k][:] = 0
    return ex


def _bn_batches(n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 5).astype(np.float32),
             rng.randint(0, 6, 4).astype(np.float32)) for _ in range(n)]


def _bn_initial():
    return _initial(_bn_net, ([("data", (4, 5))], [("softmax_label", (4,))]))


def _run_bn(lib, ex, read_first):
    """forward(is_train) + backward over the batches, reading the outputs
    before each backward when ``read_first``; the outputs, the gradients
    and the aux after each."""
    out = []
    for x, y in _bn_batches():
        with lib.cpu():
            ex.forward(is_train=True, data=lib.nd.array(x),
                       softmax_label=lib.nd.array(y))
            first = ex.outputs[0].asnumpy().copy() if read_first else None
            ex.backward()
            out.append((first, ex.outputs[0].asnumpy().copy(),
                        {k: v.asnumpy().copy()
                         for k, v in ex.grad_dict.items()},
                        {k: v.asnumpy().copy()
                         for k, v in ex.aux_dict.items()}))
    return out


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_against_eager_and_mxnet_tpu(monkeypatch, grad_req):
    """Gradients accumulate over three forward + backward pairs under
    'add' (and are overwritten under 'write'): bitwise the eager walk,
    within 1e-5 of mxnet_tpu; BatchNorm's moving statistics too."""
    arg, aux = _bn_initial()
    arg = {k: v for k, v in arg.items()}
    cap = _run_bn(mt, _bind_bn(mt, arg, aux, grad_req), False)
    _kill_switch(monkeypatch, True)
    eag = _run_bn(mt, _bind_bn(mt, arg, aux, grad_req), False)
    _kill_switch(monkeypatch, False)
    ref = _run_bn(mx, _bind_bn(mx, arg, aux, grad_req), False)
    for k, (c, e, j) in enumerate(zip(cap, eag, ref)):
        np.testing.assert_array_equal(c[1], e[1])
        _same(c[2], e[2], f"grads {k}")
        _same(c[3], e[3], f"aux {k}")
        _close({"out": c[1]}, {"out": j[1]}, f"out {k}")
        _close(c[2], j[2], f"grads {k}", whole=True)
        _close(c[3], j[3], f"aux {k}")


def test_outputs_read_before_backward_move_the_statistics_as_mxnet_tpu(
        monkeypatch):
    """Outputs read before ``backward`` run the training forward, then the
    fused program runs it again: the moving statistics move twice a step,
    as mxnet_tpu's do; outputs and gradients are those of the fused
    program, within 1e-5 of mxnet_tpu's."""
    arg, aux = _bn_initial()
    cap = _run_bn(mt, _bind_bn(mt, arg, aux), True)
    ref = _run_bn(mx, _bind_bn(mx, arg, aux), True)
    once = _run_bn(mt, _bind_bn(mt, arg, aux), False)
    for k, (c, j, o) in enumerate(zip(cap, ref, once)):
        _close({"first": c[0]}, {"first": j[0]}, f"first {k}")
        _close({"out": c[1]}, {"out": j[1]}, f"out {k}")
        _close(c[2], j[2], f"grads {k}", whole=True)
        _close(c[3], j[3], f"aux {k}")
    assert not np.array_equal(cap[0][3]["bn_moving_mean"],
                              once[0][3]["bn_moving_mean"])
    sigs = _bind_bn(mt, arg, aux)
    sigs.forward(is_train=True, data=mt.nd.array(_bn_batches()[0][0]),
                 softmax_label=mt.nd.array(_bn_batches()[0][1]))
    assert len(sigs.outputs) == 1
    assert [k[-5:-3] for k in sigs._exec._cap.compiled_signatures] == [
        ("forward", True)]


def test_monitor_keeps_the_eager_walk():
    """With a monitor callback the forward walks eagerly, node by node,
    counted as an eager run; its outputs are the captured forward's."""
    arg, aux = _bn_initial()
    ex = _bind_bn(mt, arg, aux)
    x, y = _bn_batches()[0]
    want = ex.forward(is_train=False, data=mt.nd.array(x),
                      softmax_label=mt.nd.array(y))[0].asnumpy().copy()
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    got = ex.forward(is_train=False, data=mt.nd.array(x),
                     softmax_label=mt.nd.array(y))[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    assert "fc_output" in seen and "bn_output" in seen
    assert capture.stats()["capture_fallback_eager"] == 1
    assert capture.stats()["capture_misses"] == 1


def test_a_feed_of_a_new_shape_is_captured_again_with_its_reason():
    """A batch of 8 rows where 4 were bound: the argument is bound in its
    place and the program captured again, the reason in retrace_log; the
    result equals a fresh executor bound at 8 rows."""
    arg, aux = _bn_initial()
    ex = _bind_bn(mt, arg, aux)
    x4, y4 = _bn_batches()[0]
    ex.forward(is_train=False, data=mt.nd.array(x4),
               softmax_label=mt.nd.array(y4))
    rng = np.random.RandomState(3)
    x8 = rng.randn(8, 5).astype(np.float32)
    y8 = rng.randint(0, 6, 8).astype(np.float32)
    got = ex.forward(is_train=False, data=mt.nd.array(x8),
                     softmax_label=mt.nd.array(y8))[0].asnumpy()
    assert got.shape == (8, 6)
    log = capture.retrace_log()
    assert len(log) == 1 and log[0]["label"].startswith("executor:")
    assert "changed" in log[0]["reason"] and "(8, 5)" in log[0]["reason"]
    with mt.cpu():
        fresh = _bn_net(mt).simple_bind(mt.cpu(), grad_req="write",
                                        data=(8, 5), softmax_label=(8,))
        for k, v in arg.items():
            if k not in ("data", "softmax_label"):
                fresh.arg_dict[k][:] = v
        for k, v in aux.items():
            fresh.aux_dict[k][:] = v
        want = fresh.forward(is_train=False, data=mt.nd.array(x8),
                             softmax_label=mt.nd.array(y8))[0].asnumpy()
    np.testing.assert_array_equal(got, want)
