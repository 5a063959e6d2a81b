"""The word-LM slice as a whole against ``mxnet_tpu``: ``BucketingModule``
over ``tests/test_control_flow_bucketing.py``'s ``_lm_sym_gen`` net (GRU)
and over a tied 2-layer LSTM (the decoder's weight is the embedding's
Variable) at a small width, and ``SequentialModule`` with a
``PythonLossModule`` head.

Both packages start from one set of parameters (``mxnet_tpu``'s
``get_params``, fed to the port's ``set_params``) and run one fixed
sequence of buckets with Adam: after every step the outputs and every
parameter stay within 1e-4 of their max. The port binds each bucket over
the default bucket's arrays, so a switch shares the parameter tensors;
``mxnet_tpu`` copies them on every switch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

VOCAB, B = 8, 4
BUCKETS = (4, 6)
SEQUENCE = (6, 4, 4, 6, 4, 6)          # the buckets of the steps, in order
TOL = 1e-4


def _gru_sym_gen(lib):
    """``tests/test_control_flow_bucketing.py:_lm_sym_gen``'s net."""
    sym = lib.sym

    def gen(seq_len):
        data, label = sym.Variable("data"), sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=VOCAB, output_dim=16,
                              name="embed")
        rnn = sym.RNN(sym.transpose(embed, axes=(1, 0, 2)), state_size=32,
                      num_layers=1, mode="gru", name="gru")
        out = sym.transpose(rnn, axes=(1, 0, 2)).reshape((-1, 32))
        logits = sym.FullyConnected(out, num_hidden=VOCAB, name="pred")
        pred = sym.SoftmaxOutput(logits, sym.reshape(label, shape=(-1,)),
                                 name="softmax")
        return pred, ("data",), ("softmax_label",)
    return gen


def _tied_lstm_sym_gen(lib, units=12, layers=2):
    """``examples/rnn/word_lm.py``'s net with MXNet's tied word LM: two
    LSTM layers of the embedding's width, the decoder's weight the
    embedding's Variable."""
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
    """x[t+1] = (3 x[t] + 7) mod VOCAB from a random start a row."""
    rng = np.random.RandomState(seed)
    out = []
    for T in SEQUENCE:
        start = rng.randint(0, VOCAB, size=(B, 1))
        seq = [start]
        for _ in range(T):
            seq.append((3 * seq[-1] + 7) % VOCAB)
        seq = np.concatenate(seq, axis=1)
        out.append((T, seq[:, :-1].astype(np.float32),
                    seq[:, 1:].astype(np.float32)))
    return out


def _module(lib, make_gen, arg=None):
    with lib.cpu():
        mod = lib.mod.BucketingModule(make_gen(lib),
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
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
    return mod


def _step(lib, mod, T, x, y):
    with lib.cpu():
        batch = lib.io.DataBatch(
            data=[lib.nd.array(x)], label=[lib.nd.array(y)], bucket_key=T,
            provide_data=[lib.io.DataDesc("data", (B, T))],
            provide_label=[lib.io.DataDesc("softmax_label", (B, T))])
        mod.forward(batch, is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
    return out


def _params(mod):
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= TOL, f"{what} {k}: {err:.3e}"


@pytest.mark.parametrize("make_gen", [_gru_sym_gen, _tied_lstm_sym_gen],
                         ids=["gru", "tied_lstm"])
def test_bucketing_module_matches_mxnet_tpu_every_step(make_gen):
    jmod = _module(mx, make_gen)
    init = _params(jmod)
    tmod = _module(mt, make_gen, init)
    _close(_params(tmod), init, "initial")
    for step, (T, x, y) in enumerate(_batches()):
        j_out, t_out = _step(mx, jmod, T, x, y), _step(mt, tmod, T, x, y)
        assert t_out.shape == (B * T, VOCAB)
        _close({"out": t_out}, {"out": j_out}, f"step {step}")
        _close(_params(tmod), _params(jmod), f"step {step}")
    assert sorted(tmod._buckets) == sorted(jmod._buckets) == list(BUCKETS)


def test_tied_weight_is_one_argument_with_both_gradients():
    gen = _tied_lstm_sym_gen(mt)
    s = gen(4)[0]
    assert s.list_arguments().count("embed_weight") == 1
    assert "pred_weight" not in s.list_arguments()
    args, _, _ = s.infer_shape(data=(B, 4), softmax_label=(B, 4))
    shapes = dict(zip(s.list_arguments(), args))
    assert shapes["embed_weight"] == (VOCAB, 12)
    assert shapes["lstm_state"] == shapes["lstm_state_cell"] == (2, B, 12)


def test_bucket_switch_shares_the_parameter_tensors():
    jmod = _module(mx, _tied_lstm_sym_gen)
    tmod = _module(mt, _tied_lstm_sym_gen, _params(jmod))
    for T, x, y in _batches()[:3]:
        _step(mt, tmod, T, x, y)
    mods = [tmod._buckets[k] for k in BUCKETS]
    names = mods[0]._param_names
    for n in names:
        ptrs = {m._execs[0].arg_dict[n]._data.data_ptr() for m in mods}
        grads = {m._execs[0].grad_dict[n]._data.data_ptr() for m in mods}
        assert len(ptrs) == 1 and len(grads) == 1, n
    assert mods[1]._arg_params is mods[0]._arg_params
    assert mods[1]._updater is mods[0]._updater


def _extra_param_sym_gen(lib):
    """The GRU net, with a FullyConnected of its own in bucket 4 only: a
    parameter the default bucket (6) does not have."""
    base = _gru_sym_gen(lib)

    def gen(seq_len):
        pred, data_names, label_names = base(seq_len)
        if seq_len == max(BUCKETS):
            return pred, data_names, label_names
        sym = lib.sym
        data, label = sym.Variable("data"), sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=VOCAB, output_dim=16,
                              name="embed")
        extra = sym.FullyConnected(embed.reshape((-1, 16)), num_hidden=16,
                                   name="extra").reshape((B, seq_len, 16))
        rnn = sym.RNN(sym.transpose(extra, axes=(1, 0, 2)), state_size=32,
                      num_layers=1, mode="gru", name="gru")
        out = sym.transpose(rnn, axes=(1, 0, 2)).reshape((-1, 32))
        logits = sym.FullyConnected(out, num_hidden=VOCAB, name="pred")
        return (sym.SoftmaxOutput(logits, sym.reshape(label, shape=(-1,)),
                                  name="softmax"),
                data_names, label_names)
    return gen


def test_bucket_with_a_parameter_the_default_lacks_raises():
    """A bucket's parameters must all be the default bucket's: MXNet raises
    (``simple_bind`` reads ``shared_exec.arg_dict[name]``), and so does the
    port, rather than train an array that no other bucket sees and that
    ``get_params`` drops. ``mxnet_tpu`` instead fills such a parameter from
    its default ``Uniform(0.01)`` at every switch into the bucket (ROADMAP
    Queue 3, reference defects)."""
    jmod = _module(mx, _extra_param_sym_gen)
    tmod = _module(mt, _extra_param_sym_gen, _params(jmod))
    assert "extra_weight" in _extra_param_sym_gen(mt)(4)[0].list_arguments()
    T, x, y = next(b for b in _batches() if b[0] == 4)
    _step(mx, jmod, T, x, y)
    with pytest.raises(MXNetError, match="extra_weight"):
        _step(mt, tmod, T, x, y)


def _sequential(lib):
    sym = lib.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=4, name="fc")
    body = lib.mod.Module(net, data_names=("data",), label_names=None,
                          context=lib.cpu())
    smod = lib.mod.SequentialModule()
    smod.add(body).add(lib.mod.PythonLossModule(data_names=("fc_output",)),
                       take_labels=True)
    smod.bind(data_shapes=[lib.io.DataDesc("data", (6, 8))],
              label_shapes=[lib.io.DataDesc("softmax_label", (6,))])
    return smod


def test_sequential_module_with_python_loss_matches():
    """``tests/test_control_flow_bucketing.py:182``'s net and steps."""
    with mx.cpu():
        jmod = _sequential(mx)
        mx.random.seed(0)
        jmod.init_params(mx.initializer.Xavier())
        jmod.init_optimizer(optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5})
    init = _params(jmod)
    with mt.cpu():
        tmod = _sequential(mt)
        tmod.init_params(arg_params={k: mt.nd.array(v)
                                     for k, v in init.items()})
        tmod.init_optimizer(optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5})
    rng = np.random.RandomState(0)
    for step in range(6):
        x = rng.rand(6, 8).astype(np.float32)
        y = x[:, :4].argmax(1).astype(np.float32)
        outs = []
        for lib, mod in ((mx, jmod), (mt, tmod)):
            with lib.cpu():
                batch = lib.io.DataBatch(
                    data=[lib.nd.array(x)], label=[lib.nd.array(y)],
                    provide_data=[lib.io.DataDesc("data", (6, 8))],
                    provide_label=[lib.io.DataDesc("softmax_label", (6,))])
                mod.forward(batch, is_train=True)
                outs.append(mod.get_outputs()[0].asnumpy())
                mod.backward()
                mod.update()
        _close({"out": outs[1]}, {"out": outs[0]}, f"step {step}")
        _close(_params(tmod), _params(jmod), f"step {step}")
    assert tmod.output_shapes == [("pyloss_output", (6, 4))]
