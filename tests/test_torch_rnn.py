"""The fused ``RNN`` op, ``gluon.rnn`` and ``gluon.utils`` against
``mxnet_tpu``.

The op over the four modes x {1, 2} layers x {uni, bi} at T=5, N=3, I=4,
H=6: outputs and final states within 1e-5, and the gradients of the data,
the flat parameter vector and the states through ``bind`` / ``backward``
within 1e-4 of their max. The three places where the port follows MXNet
1.6 and ``mxnet_tpu`` does not (dropout between layers, the per-step cell
clip, the raise for ``projection_size`` / ``use_sequence_length``) are
held to their own references. The Gluon layers and cells take
``mxnet_tpu``'s parameters by name (``Block.load_numpy_params``) and
mirror ``tests/test_gluon_rnn.py``'s cases; the inputs are numpy draws
from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import block as jblock  # noqa: E402
from mxnet_tpu.gluon import rnn as jrnn  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon import rnn as trnn  # noqa: E402
from mxnet_tpu_torch.gluon import utils as tutils  # noqa: E402
from mxnet_tpu_torch.ops import rnn as trnn_op  # noqa: E402

T, N, I, H = 5, 3, 4, 6
MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _op_inputs(mode, layers, bi, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = trnn_op.rnn_param_size(I, H, layers, bi, mode)
    ins = {"data": rs.randn(T, N, I).astype(np.float32),
           "parameters": (rs.randn(n) * 0.3).astype(np.float32),
           "state": rs.randn(layers * d, N, H).astype(np.float32)}
    if mode == "lstm":
        ins["state_cell"] = rs.randn(layers * d, N, H).astype(np.float32)
    return ins


def _rnn_sym(lib, mode, layers, bi, **kw):
    sym = lib.sym
    args = [sym.Variable(n) for n in ("data", "parameters", "state")]
    if mode == "lstm":
        args.append(sym.Variable("state_cell"))
    return sym.RNN(*args, state_size=H, num_layers=layers, bidirectional=bi,
                   mode=mode, state_outputs=True, name="rnn", **kw)


def _run(lib, mode, layers, bi, ins, heads):
    """Outputs and gradients of the RNN graph bound by ``lib``."""
    with lib.cpu():
        s = _rnn_sym(lib, mode, layers, bi)
        args = {k: lib.nd.array(v) for k, v in ins.items()}
        grads = {k: lib.nd.zeros(v.shape) for k, v in ins.items()}
        ex = s.bind(lib.cpu(), args, args_grad=grads, grad_req="write")
        outs = ex.forward(is_train=True)
        ex.backward([lib.nd.array(h) for h in heads])
        return ([o.asnumpy() for o in outs],
                {k: g.asnumpy() for k, g in grads.items()})


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_forward_and_gradients_match(mode, layers, bi):
    ins = _op_inputs(mode, layers, bi)
    d = 2 if bi else 1
    rs = np.random.RandomState(1)
    heads = [rs.randn(T, N, d * H).astype(np.float32)] + [
        rs.randn(layers * d, N, H).astype(np.float32)
        for _ in range(2 if mode == "lstm" else 1)]
    j_outs, j_grads = _run(mx, mode, layers, bi, ins, heads)
    t_outs, t_grads = _run(mt, mode, layers, bi, ins, heads)
    assert len(t_outs) == len(j_outs) == (3 if mode == "lstm" else 2)
    for k, (t, j) in enumerate(zip(t_outs, j_outs)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0,
                                   err_msg=f"output {k}")
    for k in ins:
        assert _rel(t_grads[k], j_grads[k]) <= 1e-4, k


def test_rnn_op_without_state_outputs_and_through_nd():
    ins = _op_inputs("gru", 2, True)
    with mt.cpu():
        out = mt.nd.RNN(*(mt.nd.array(ins[k]) for k in
                          ("data", "parameters", "state")),
                        state_size=H, num_layers=2, bidirectional=True,
                        mode="gru")
    with mx.cpu():
        want = mx.nd.RNN(*(mx.nd.array(ins[k]) for k in
                           ("data", "parameters", "state")),
                         state_size=H, num_layers=2, bidirectional=True,
                         mode="gru")
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), atol=1e-5,
                               rtol=0)


def test_rnn_symbol_creates_mxnet_tpus_variables_and_shapes():
    for lib in (mx, mt):
        x = lib.sym.Variable("data")
        s = lib.sym.RNN(x, state_size=H, num_layers=2, mode="lstm",
                        name="lstm")
        assert s.list_arguments() == ["data", "lstm_parameters",
                                      "lstm_state", "lstm_state_cell"]
        g = lib.sym.RNN(x, state_size=H, num_layers=2, mode="gru",
                        name="gru")
        assert g.list_arguments() == ["data", "gru_parameters", "gru_state"]
    shapes = {lib: lib.sym.RNN(
        lib.sym.Variable("data"), state_size=H, num_layers=2,
        bidirectional=True, mode="lstm", name="r").infer_shape(
            data=(T, N, I)) for lib in (mx, mt)}
    assert shapes[mt] == shapes[mx]
    assert shapes[mt][0][1] == (trnn_op.rnn_param_size(I, H, 2, True,
                                                       "lstm"),)


def test_rnn_dropout_between_layers_follows_mxnet():
    """p drops each layer's output but the last's, in training only, kept
    with probability 1 - p and scaled by 1 / (1 - p), from mx.random
    (mxnet_tpu never applies p)."""
    p, t, n, h = 0.3, 40, 50, 32
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.rand(t, n, h).astype(np.float32) + 1.0)
    params = torch.zeros(trnn_op.rnn_param_size(h, h, 2, False, "rnn_relu"))
    # layer 0 copies its input (identity i2h, zero h2h, relu of positives);
    # layer 1 is the identity too, so the output is layer 0's, dropped
    ws = trnn_op._unpack(params, h, h, 2, 1, "rnn_relu")
    for layer in range(2):
        ws[layer][0][0].copy_(torch.eye(h))
    state = torch.zeros(2, n, h)
    call = lambda train: trnn_op._rnn(  # noqa: E731
        x, params, state, state_size=h, num_layers=2, mode="rnn_relu", p=p,
        _train=train, generator=mt.random.generator("cpu"))
    mt.random.seed(3)
    out = call(True)
    kept = (out != 0)
    rate = kept.float().mean().item()
    se = np.sqrt(p * (1 - p) / kept.numel())
    assert abs(rate - (1 - p)) <= 5 * se, (rate, se)
    np.testing.assert_allclose(out[kept].numpy(),
                               (x[kept] / (1 - p)).numpy(), rtol=1e-6)
    mt.random.seed(3)
    assert torch.equal(call(True), out)
    assert torch.equal(call(False), x)
    one_layer = trnn_op._rnn(x, params[:trnn_op.rnn_param_size(
        h, h, 1, False, "rnn_relu")].clone(), state[:1], state_size=h,
        num_layers=1, mode="rnn_relu", p=p, _train=True)
    assert torch.count_nonzero(one_layer) == one_layer.numel()


def _lstm_clipped_reference(x, w, h0, c0, lo, hi):
    """One-layer LSTM in numpy with c clipped at every step."""
    g4 = 4 * H
    w_i2h = w[:g4 * I].reshape(g4, I)
    w_h2h = w[g4 * I:g4 * (I + H)].reshape(g4, H)
    b = w[g4 * (I + H):g4 * (I + H + 1)] + w[g4 * (I + H + 1):]
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    h, c, outs = h0[0], c0[0], []
    for t in range(x.shape[0]):
        z = x[t] @ w_i2h.T + h @ w_h2h.T + b
        i, f, g, o = np.split(z, 4, axis=1)
        c = np.clip(sig(f) * c + sig(i) * np.tanh(g), lo, hi)
        h = sig(o) * np.tanh(c)
        outs.append(h)
    return np.stack(outs), h, c


def test_lstm_state_clip_at_every_step_follows_mxnet():
    ins = _op_inputs("lstm", 1, False)
    ins["parameters"] *= 4        # cells grow past the clip
    lo, hi = -0.5, 0.5
    out, hF, cF = trnn_op._rnn(*(torch.tensor(ins[k]) for k in (
        "data", "parameters", "state", "state_cell")), state_size=H,
        mode="lstm", state_outputs=True, lstm_state_clip_min=lo,
        lstm_state_clip_max=hi)
    want = _lstm_clipped_reference(ins["data"], ins["parameters"],
                                   ins["state"], ins["state_cell"], lo, hi)
    for got, w in zip((out, hF[0], cF[0]), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0)
    unclipped = _lstm_clipped_reference(
        ins["data"], ins["parameters"], ins["state"], ins["state_cell"],
        -np.inf, np.inf)
    assert np.abs(unclipped[0] - want[0]).max() > 1e-3   # the clip bites
    nan_cell = torch.full((1, N, H), float("nan"))
    _, _, c_nan = trnn_op._rnn(*(torch.tensor(ins[k]) for k in (
        "data", "parameters", "state")), nan_cell, state_size=H,
        mode="lstm", state_outputs=True, lstm_state_clip_min=lo,
        lstm_state_clip_max=hi, lstm_state_clip_nan=True)
    assert torch.isfinite(c_nan).all()


@pytest.mark.parametrize("kw", [{"projection_size": 4},
                                {"use_sequence_length": True}])
def test_rnn_options_not_ported_raise_naming_the_item(kw):
    ins = _op_inputs("lstm", 1, False)
    with pytest.raises(mt.MXNetError, match="item 11"):
        trnn_op._rnn(*(torch.tensor(ins[k]) for k in (
            "data", "parameters", "state", "state_cell")), state_size=H,
            mode="lstm", **kw)


def test_initializer_sends_rnn_parameters_to_the_uniform_rule():
    gen = torch.Generator().manual_seed(0)
    flat, state = torch.empty(5000), torch.empty(2, 3, 4)
    mt.init.Xavier()("lstm_parameters", flat, generator=gen)
    assert flat.abs().max() <= 0.07 and flat.std() > 0.03
    mt.init.Zero()("lstm_parameters", flat, generator=gen)
    assert flat.abs().max() > 0        # not the initializer's own rule
    mt.init.Zero()("lstm_state", state, generator=gen)
    assert not state.any()             # the default rule: as a weight


# ----------------------------------------------------------------- gluon
def _reset_names():
    jblock._BlockScope._global_counter = {}
    tblock._BlockScope._global_counter = {}


def _pair(make):
    """The same layer or cell built by both packages, the port's holding
    mxnet_tpu's initial parameters."""
    _reset_names()
    j = make(jrnn)
    j.initialize(mx.init.Xavier())
    _reset_names()
    t = make(trnn)
    t.initialize(ctx=mt.cpu())
    t.load_numpy_params({k: v.data().asnumpy().copy()
                         for k, v in j.collect_params().items()})
    return j, t


def _x(shape=(T, N, I), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _out(v):
    if isinstance(v, (list, tuple)):
        return [_out(e) for e in v]
    return v.asnumpy() if hasattr(v, "asnumpy") else v.detach().numpy()


def _assert_nested(got, want, tol):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_nested(g, w, tol)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("make,layout", [
    (lambda r: r.RNN(7, input_size=I), "TNC"),
    (lambda r: r.RNN(7, activation="tanh", input_size=I), "TNC"),
    (lambda r: r.LSTM(7, input_size=I), "TNC"),
    (lambda r: r.GRU(7, input_size=I), "TNC"),
    (lambda r: r.LSTM(8, num_layers=2, bidirectional=True, input_size=I),
     "TNC"),
    (lambda r: r.GRU(5, num_layers=2, layout="NTC", input_size=I), "NTC"),
    (lambda r: r.LSTM(6, layout="NTC", input_size=I), "NTC")],
    ids=["rnn_relu", "rnn_tanh", "lstm", "gru", "lstm_2_bi", "gru_2_ntc",
         "lstm_ntc"])
def test_fused_layers_match_with_and_without_states(make, layout):
    j, t = _pair(make)
    x = _x((T, N, I) if layout == "TNC" else (N, T, I))
    with mx.cpu():
        j_plain = _out(j(mx.nd.array(x)))
        j_out, j_states = j(mx.nd.array(x), j.begin_state(N))
    t_plain = _out(t(torch.tensor(x)))
    t_out, t_states = t(torch.tensor(x), t.begin_state(N))
    _assert_nested(t_plain, j_plain, 1e-5)
    _assert_nested(_out(t_out), _out(j_out), 1e-5)
    _assert_nested(_out(t_states), _out(j_states), 1e-5)
    # NDArrays in, NDArrays out
    with mt.cpu():
        nd_out, nd_states = t(mt.nd.array(x), [mt.nd.array(s.numpy())
                                               for s in t.begin_state(N)])
    assert isinstance(nd_out, mt.nd.NDArray)
    assert all(isinstance(s, mt.nd.NDArray) for s in nd_states)
    _assert_nested(nd_out.asnumpy(), _out(j_out), 1e-5)


def test_lstm_layer_gradients_match():
    j, t = _pair(lambda r: r.LSTM(8, num_layers=2, input_size=I))
    x = _x()
    with mx.cpu():
        with mx.autograd.record():
            out = j(mx.nd.array(x))
            loss = (out * out).sum()
        loss.backward()
    with mt.autograd.record():
        tout = t(torch.tensor(x))
        (tout * tout).sum().backward()
    for name, p in j.collect_params().items():
        got = t._param_objects()[name].grad().numpy()
        assert _rel(got, p.grad().asnumpy()) <= 1e-4, name


def test_layer_without_input_size_raises_naming_item_8():
    with pytest.raises(mt.MXNetError, match="item 8"):
        trnn.LSTM(8)
    with pytest.raises(mt.MXNetError, match="item 8"):
        trnn.LSTMCell(8)


CELLS = [
    (lambda r: r.RNNCell(8, input_size=I), 1),
    (lambda r: r.LSTMCell(8, input_size=I), 2),
    (lambda r: r.GRUCell(8, input_size=I), 1)]


def _rows(unroll, x_tnc, vl):
    """What ``valid_length`` gives, row by row: row i unrolled alone over
    its first l_i steps, its outputs padded with zero rows to T, its
    final states. mxnet_tpu's own ``unroll(valid_length=...)`` raises
    (ROADMAP Queue 3), so its cells are run this way."""
    outs, states = [], []
    for i, length in enumerate(vl.astype(int)):
        o, st = unroll(length, x_tnc[:length, i:i + 1])
        outs.append(np.concatenate(
            [o, np.zeros((T - length,) + o.shape[1:], o.dtype)]))
        states.append(st)
    return (np.concatenate(outs, axis=1),
            [np.concatenate(k, axis=0) for k in zip(*states)])


def _jax_unroll(cell):
    def unroll(length, x):
        with mx.cpu():
            o, st = cell.unroll(length, mx.nd.array(x), layout="TNC",
                                merge_outputs=True)
        return o.asnumpy(), [v.asnumpy() for v in st]
    return unroll


@pytest.mark.parametrize("valid", [False, True], ids=["full", "valid_len"])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("make,n_states", CELLS,
                         ids=["rnn", "lstm", "gru"])
def test_cells_unroll_match(make, n_states, layout, valid):
    j, t = _pair(make)
    x_tnc = _x()
    x = x_tnc if layout == "TNC" else x_tnc.transpose(1, 0, 2).copy()
    vl = np.array([5, 2, 4], np.float32) if valid else None
    if valid:
        want_out, want_states = _rows(_jax_unroll(j), x_tnc, vl)
        if layout == "NTC":
            want_out = want_out.transpose(1, 0, 2)
    else:
        with mx.cpu():
            j_out, j_states = j.unroll(T, mx.nd.array(x), layout=layout,
                                       merge_outputs=True)
        want_out, want_states = _out(j_out), _out(j_states)
    t_out, t_states = t.unroll(
        T, torch.tensor(x), layout=layout, merge_outputs=True,
        valid_length=None if vl is None else torch.tensor(vl))
    assert len(t_states) == n_states
    _assert_nested(_out(t_out), want_out, 1e-5)
    _assert_nested(_out(t_states), want_states, 1e-5)
    # unmerged outputs: one (N, H) tensor a step
    steps, _ = t.unroll(T, torch.tensor(x), layout=layout)
    assert len(steps) == T and tuple(steps[0].shape) == (N, 8)


def test_cell_vs_fused_lstm():
    _reset_names()
    fl = trnn.LSTM(8, input_size=I)
    fl.initialize(mt.init.Xavier(), ctx=mt.cpu())
    cell = trnn.LSTMCell(8, input_size=I)
    cell.initialize(ctx=mt.cpu())
    for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        cell._reg_params[k].set_data(getattr(fl, "l0_" + k))
    x = torch.tensor(_x())
    outs, _ = cell.unroll(T, x, layout="TNC", merge_outputs=True)
    np.testing.assert_allclose(outs.numpy(), fl(x).numpy(), atol=1e-5)


def test_gru_cell_one_step_matches():
    j, t = _pair(lambda r: r.GRUCell(3, input_size=2))
    rs = np.random.RandomState(0)
    x, h0 = rs.rand(1, 2).astype(np.float32), rs.rand(1, 3).astype(np.float32)
    with mx.cpu():
        j_out, _ = j(mx.nd.array(x), [mx.nd.array(h0)])
    t_out, _ = t(torch.tensor(x), [torch.tensor(h0)])
    np.testing.assert_allclose(t_out.numpy(), j_out.asnumpy(), atol=1e-6)


def test_cell_gradients_through_unroll_match():
    j, t = _pair(lambda r: r.GRUCell(8, input_size=I))
    x = _x()
    with mx.cpu():
        with mx.autograd.record():
            out, _ = j.unroll(T, mx.nd.array(x), layout="TNC",
                              merge_outputs=True)
            (out * out).sum().backward()
    with mt.autograd.record():
        tout, _ = t.unroll(T, torch.tensor(x), layout="TNC",
                           merge_outputs=True)
        (tout * tout).sum().backward()
    for name, p in j.collect_params().items():
        assert _rel(t._param_objects()[name].grad().numpy(),
                    p.grad().asnumpy()) <= 1e-4, name


def _stack_pair(lib):
    seq = lib.SequentialRNNCell()
    seq.add(lib.LSTMCell(8, input_size=I))
    seq.add(lib.GRUCell(6, input_size=8))
    return seq


@pytest.mark.parametrize("make,n_states,width", [
    (_stack_pair, 3, 6),
    (lambda r: r.ResidualCell(r.GRUCell(I, input_size=I)), 1, I),
    (lambda r: r.BidirectionalCell(r.LSTMCell(6, input_size=I),
                                   r.LSTMCell(6, input_size=I)), 4, 12)],
    ids=["sequential", "residual", "bidirectional"])
def test_composite_cells_match(make, n_states, width):
    j, t = _pair(make)
    x = _x()
    with mx.cpu():
        j_out, j_states = j.unroll(T, mx.nd.array(x), layout="TNC",
                                   merge_outputs=True)
    t_out, t_states = t.unroll(T, torch.tensor(x), layout="TNC",
                               merge_outputs=True)
    assert tuple(t_out.shape) == (T, N, width)
    assert len(t_states) == n_states
    _assert_nested(_out(t_out), _out(j_out), 1e-5)
    _assert_nested(_out(t_states), _out(j_states), 1e-5)


def test_bidirectional_cell_valid_length_reverses_within_each_row():
    """MXNet 1.6 reverses each row within its length for the right cell
    (mxnet_tpu reverses the padded sequence): held to mxnet_tpu's two
    cells run row by row, the right one on the row's steps reversed."""
    j, t = _pair(lambda r: r.BidirectionalCell(
        r.LSTMCell(6, input_size=I), r.LSTMCell(6, input_size=I)))
    x, vl = _x(), np.array([5, 2, 4], np.float32)
    t_out, t_states = t.unroll(T, torch.tensor(x), layout="TNC",
                               merge_outputs=True,
                               valid_length=torch.tensor(vl))
    jl, jr = j._children.values()
    left = _jax_unroll(jl)
    right = _jax_unroll(jr)

    def both(length, xr):
        lo, ls = left(length, xr)
        ro, rs = right(length, xr[::-1].copy())
        return np.concatenate([lo, ro[::-1]], axis=2), ls + rs

    want_out, want_states = _rows(both, x, vl)
    np.testing.assert_allclose(t_out.numpy(), want_out, atol=1e-5, rtol=0)
    _assert_nested(_out(t_states), want_states, 1e-5)


def test_dropout_and_zoneout_cells():
    x = torch.tensor(_x((T, N, 8)))
    d = trnn.DropoutCell(0.5)
    outs, _ = d.unroll(T, x, layout="TNC", merge_outputs=True)
    assert torch.equal(outs, x)               # outside training: identity
    with mt.autograd.train_mode():
        mt.random.seed(0)
        outs, _ = d.unroll(T, x, layout="TNC", merge_outputs=True)
    kept = outs != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    np.testing.assert_allclose(outs[kept].numpy(), (x[kept] * 2).numpy(),
                               rtol=1e-6)
    _reset_names()
    base = trnn.GRUCell(8, input_size=8)
    z = trnn.ZoneoutCell(base, zoneout_outputs=0.5, zoneout_states=0.5)
    z.initialize(ctx=mt.cpu())
    plain, _ = z.unroll(T, x, layout="TNC", merge_outputs=True)
    base._modified = False
    want, _ = base.unroll(T, x, layout="TNC", merge_outputs=True)
    assert torch.allclose(plain, want)        # no zoneout outside training


def test_split_and_load_and_clip_global_norm_match():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    with mt.cpu():
        parts = tutils.split_and_load(mt.nd.array(x), [mt.cpu(), mt.cpu()])
    assert [p.shape for p in parts] == [(3, 4), (3, 4)]
    np.testing.assert_array_equal(parts[1].asnumpy(), x[3:])
    uneven = tutils.split_data(torch.tensor(x), 4, even_split=False)
    assert [tuple(p.shape) for p in uneven] == [(1, 4)] * 3 + [(3, 4)]
    with pytest.raises(ValueError):
        tutils.split_data(torch.tensor(x), 4)
    rs = np.random.RandomState(0)
    arrays = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(
        np.float32)]
    with mx.cpu():
        j = [mx.nd.array(a) for a in arrays]
        j_norm = mx.gluon.utils.clip_global_norm(j, 1.0)
    t = [torch.tensor(a) for a in arrays]
    t_norm = tutils.clip_global_norm(t, 1.0)
    assert abs(t_norm - j_norm) <= 1e-5 * j_norm
    for got, want in zip(t, j):
        np.testing.assert_allclose(got.numpy(), want.asnumpy(), atol=1e-6)
    with pytest.raises(mt.MXNetError, match="network"):
        tutils.download("http://example.invalid/x")
