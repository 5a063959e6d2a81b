"""Control flow against ``mxnet_tpu``: the eager ``mx.nd.contrib`` and the
symbolic ``mx.sym.contrib`` ``foreach`` / ``while_loop`` / ``cond``,
forward and gradients, mirroring ``tests/test_control_flow_bucketing.py``
(``TestEagerControlFlow``, ``TestSymbolicControlFlow``,
``TestSubgraphCutting``). Inputs are numpy draws from a seed; outputs
within 1e-6 of max|ref|, gradients within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture  # noqa: E402
from mxnet_tpu_torch.serving import predictor as tpred  # noqa: E402

LIBS = (mx, mt)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _both(fn):
    """fn(lib) for both packages on the CPU."""
    out = []
    for lib in LIBS:
        with lib.cpu():
            out.append(fn(lib))
    return out


# ------------------------------------------------------------------ eager
def test_eager_foreach_forward_and_gradients():
    data, w0 = _rand(4, 2, 3), _rand(3, 3, seed=1)

    def run(lib):
        x, w = lib.nd.array(data), lib.nd.array(w0)
        w.attach_grad()
        with lib.autograd.record():
            outs, fin = lib.nd.contrib.foreach(
                lambda d, s: (lib.nd.dot(d, w) + s,
                              lib.nd.tanh(s + lib.nd.dot(d, w))),
                x, lib.nd.zeros((2, 3)))
            loss = (outs * outs).sum() + fin.sum()
        loss.backward()
        return outs.asnumpy(), fin.asnumpy(), w.grad.asnumpy()

    for got, want in zip(*_both(run)):
        _close(got, want, 1e-5)


def test_eager_while_loop_pads_and_cond_branches():
    def run(lib):
        outs, (i_f, s_f) = lib.nd.contrib.while_loop(
            lambda i, s: i < 3, lambda i, s: (s, (i + 1, s + 2)),
            (lib.nd.zeros((1,)), lib.nd.ones((1,))), max_iterations=5)
        none, _ = lib.nd.contrib.while_loop(
            lambda i: i < 0, lambda i: (i * 2, i + 1), lib.nd.ones((2,)),
            max_iterations=3)
        picks = [lib.nd.contrib.cond(lib.nd.array([p]),
                                     lambda: lib.nd.ones((2,)),
                                     lambda: lib.nd.zeros((2,))).asnumpy()
                 for p in (1.0, 0.0)]
        return [outs.asnumpy(), i_f.asnumpy(), s_f.asnumpy(),
                none.asnumpy()] + picks

    got, want = _both(run)
    np.testing.assert_array_equal(got[0].ravel(), [1, 3, 5, 0, 0])
    assert got[3].shape == (3, 2) and not got[3].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_nd_contrib_short_names():
    assert mt.nd.contrib.quantize_v2 is not None
    with mt.cpu():
        x = mt.nd.array(_rand(2, 3))
        out = mt.nd.contrib.BilinearResize2D(
            x.reshape((1, 1, 2, 3)), height=4, width=6)
    assert out.shape == (1, 1, 4, 6)


# --------------------------------------------------------------- symbolic
def _bind_run(lib, s, args, grad_names=(), heads=None):
    """Outputs and gradients of ``s`` bound on the CPU."""
    with lib.cpu():
        arrays = {k: lib.nd.array(v) for k, v in args.items()}
        grads = {k: lib.nd.zeros(args[k].shape) for k in grad_names}
        ex = s.bind(lib.cpu(), arrays, args_grad=grads or None,
                    grad_req="write" if grads else "null")
        outs = ex.forward(is_train=bool(grads))
        if grads:
            ex.backward(None if heads is None else
                        [lib.nd.array(h) for h in heads])
        return ([o.asnumpy() for o in outs],
                {k: g.asnumpy() for k, g in grads.items()})


def test_symbolic_foreach_forward_and_grad():
    seq, w0 = _rand(5, 2, 3), _rand(4, 3, seed=1)

    def graph(lib):
        sym = lib.sym
        w = sym.Variable("w")

        def body(x, s):
            h = sym.FullyConnected(x, w, num_hidden=4, no_bias=True)
            return h, s + h

        outs, fin = sym.contrib.foreach(body, sym.Variable("seq"),
                                        sym.Variable("init"))
        return sym.Group([outs, fin])

    args = {"seq": seq, "init": np.zeros((2, 4), np.float32), "w": w0}
    heads = [_rand(5, 2, 4, seed=2), _rand(2, 4, seed=3)]
    (j_outs, j_g), (t_outs, t_g) = (_bind_run(lib, graph(lib), args,
                                              ("w", "seq"), heads)
                                    for lib in LIBS)
    for t, j in zip(t_outs, j_outs):
        _close(t, j, 1e-6)
    for k in j_g:
        _close(t_g[k], j_g[k], 1e-5)
    # sum(fin)'s gradient alone is the sum of the inputs over steps and rows
    _, only_fin = _bind_run(mt, graph(mt), args, ("w",),
                            [np.zeros((5, 2, 4), np.float32),
                             np.ones((2, 4), np.float32)])
    _close(only_fin["w"], np.tile(seq.sum((0, 1)), (4, 1)), 1e-6)


def test_symbolic_foreach_matches_eager():
    data, s0 = _rand(4, 3, seed=2), np.array([1.0], np.float32)

    def body(x, s):
        return x * 2 + 1, s * 0.5 + x.sum()

    sym = mt.sym
    outs, fin = sym.contrib.foreach(body, sym.Variable("d"),
                                    sym.Variable("s0"))
    sym_out, _ = _bind_run(mt, sym.Group([outs, fin]),
                           {"d": data, "s0": s0})
    with mt.cpu():
        nd_out, nd_fin = mt.nd.contrib.foreach(body, mt.nd.array(data),
                                               mt.nd.array(s0))
    _close(sym_out[0], nd_out.asnumpy(), 1e-6)
    _close(sym_out[1], nd_fin.asnumpy(), 1e-6)


def test_symbolic_while_loop_pads_and_grads():
    """Outputs against mxnet_tpu; gradients against the same loop written
    in torch, since mxnet_tpu's lax.while_loop has no reverse-mode
    gradient (ROADMAP Queue 3)."""
    w0 = _rand(1, seed=3) + 0.5

    def graph(lib):
        sym = lib.sym
        w = sym.Variable("w")
        outs, (fi, fs) = sym.contrib.while_loop(
            lambda i, s: i < 3.0,
            lambda i, s: (s * w, (i + 1.0, s * w + 1.0)),
            (sym.Variable("i0"), sym.Variable("s0")), max_iterations=5)
        return sym.Group([outs, fi, fs])

    args = {"i0": np.zeros((1,), np.float32),
            "s0": np.ones((1,), np.float32), "w": w0}
    heads = [_rand(5, 1, seed=4), np.zeros((1,), np.float32),
             np.ones((1,), np.float32)]
    j_outs, _ = _bind_run(mx, graph(mx), args)
    t_outs, t_g = _bind_run(mt, graph(mt), args, ("w", "s0"), heads)
    assert t_outs[0].shape == (5, 1) and not t_outs[0][3:].any()
    for t, j in zip(t_outs, j_outs):
        _close(t, j, 1e-6)
    w, s = (torch.tensor(args[k], requires_grad=True) for k in ("w", "s0"))
    s_i, outs = s, []
    for _ in range(3):
        outs.append(s_i * w)
        s_i = s_i * w + 1.0
    loss = (torch.stack(outs) * torch.tensor(heads[0][:3])).sum() + s_i.sum()
    want = torch.autograd.grad(loss, [w, s])
    _close(t_g["w"], want[0].numpy(), 1e-6)
    _close(t_g["s0"], want[1].numpy(), 1e-6)
    shapes = [graph(lib).infer_shape(i0=(1,), s0=(1,), w=(1,))
              for lib in LIBS]
    assert shapes[0] == shapes[1]


def test_symbolic_cond_both_branches_and_grads():
    def graph(lib):
        sym = lib.sym
        a, b = sym.Variable("a"), sym.Variable("b")
        return sym.contrib.cond(sym.sum(sym.Variable("p")),
                                lambda: a * a * 2, lambda: b * 3)

    for pval in (1.0, 0.0):
        args = {"p": np.array([pval], np.float32), "a": _rand(2, seed=5),
                "b": _rand(2, seed=6)}
        (j_outs, j_g), (t_outs, t_g) = (_bind_run(lib, graph(lib), args,
                                                  ("a", "b"))
                                        for lib in LIBS)
        _close(t_outs[0], j_outs[0], 1e-6)
        want = args["a"] ** 2 * 2 if pval else args["b"] * 3
        _close(t_outs[0], want, 1e-6)
        for k in j_g:
            _close(t_g[k], j_g[k], 1e-6)


def test_weight_used_inside_and_outside_a_loop_sums_its_gradients():
    """The tied-weight case: one Variable read by a node outside the loop
    and by the loop's body gets both gradients, as mxnet_tpu."""
    seq, w0 = _rand(3, 2, 4), _rand(4, 4, seed=1)

    def graph(lib):
        sym = lib.sym
        w = sym.Variable("w")
        outside = sym.FullyConnected(sym.Variable("x"), w, num_hidden=4,
                                     no_bias=True)
        outs, fin = sym.contrib.foreach(
            lambda d, s: (sym.FullyConnected(d, w, num_hidden=4,
                                             no_bias=True) + s, s),
            sym.Variable("seq"), outside)
        return sym.sum(outs) + sym.sum(fin * fin)

    args = {"seq": seq, "x": _rand(2, 4, seed=2), "w": w0}
    (_, j_g), (_, t_g) = (_bind_run(lib, graph(lib), args, ("w",))
                          for lib in LIBS)
    _close(t_g["w"], j_g["w"], 1e-5)


def test_foreach_over_an_lstm_cell_body_matches_the_fused_op():
    """A foreach whose body is an LSTM step (the i2h / h2h products and
    gates, written with sym ops) against sym.RNN on the same flat
    parameters: outputs and every gradient."""
    T, N, I, H = 4, 3, 5, 6
    rs = np.random.RandomState(0)
    n = 4 * H * (I + H) + 8 * H
    args = {"data": rs.randn(T, N, I).astype(np.float32),
            "params": (rs.randn(n) * 0.3).astype(np.float32),
            "h0": rs.randn(1, N, H).astype(np.float32),
            "c0": rs.randn(1, N, H).astype(np.float32)}
    sym = mt.sym
    data, flat = sym.Variable("data"), sym.Variable("params")
    h0, c0 = sym.Variable("h0"), sym.Variable("c0")
    fused = sym.RNN(data, flat, h0, c0, state_size=H, mode="lstm",
                    state_outputs=True, name="fused")
    g4 = 4 * H
    w_i2h = sym.slice_axis(flat, axis=0, begin=0,
                           end=g4 * I).reshape((g4, I))
    w_h2h = sym.slice_axis(flat, axis=0, begin=g4 * I,
                           end=g4 * (I + H)).reshape((g4, H))
    b = sym.slice_axis(flat, axis=0, begin=g4 * (I + H),
                       end=g4 * (I + H) + g4) + \
        sym.slice_axis(flat, axis=0, begin=g4 * (I + H) + g4, end=n)

    def step(x, states):
        h, c = states
        z = sym.FullyConnected(x, w_i2h, b, num_hidden=g4) + \
            sym.FullyConnected(h, w_h2h, num_hidden=g4, no_bias=True)
        i, f, g, o = sym.SliceChannel(z, num_outputs=4)
        c = sym.sigmoid(f) * c + sym.sigmoid(i) * sym.tanh(g)
        h = sym.sigmoid(o) * sym.tanh(c)
        return h, [h, c]

    outs, (hT, cT) = sym.contrib.foreach(
        step, data, [sym.reshape(h0, shape=(N, H)),
                     sym.reshape(c0, shape=(N, H))])
    heads = [rs.randn(T, N, H).astype(np.float32),
             rs.randn(N, H).astype(np.float32),
             rs.randn(N, H).astype(np.float32)]
    loop_out, loop_g = _bind_run(mt, sym.Group([outs, hT, cT]), args,
                                 tuple(args), heads)
    fused_out, fused_g = _bind_run(
        mt, fused, args, tuple(args),
        [heads[0], heads[1][None], heads[2][None]])
    _close(loop_out[0], fused_out[0], 1e-6)
    _close(loop_out[1], fused_out[1][0], 1e-6)
    _close(loop_out[2], fused_out[2][0], 1e-6)
    for k in args:
        _close(loop_g[k], fused_g[k], 1e-5)


# --------------------------------------------------------- subgraph cuts
def test_captured_outer_computation_is_cut_and_fed_in():
    """A value computed outside the loop (through BatchNorm, which has
    auxiliary state) is cut at the boundary, computed once, and fed in."""
    rs = np.random.RandomState(0)
    args = {"x": rs.rand(2, 4).astype(np.float32),
            "seq": np.zeros((5, 2, 3), np.float32),
            "s0": np.zeros((1,), np.float32),
            "fc_weight": np.ones((3, 4), np.float32),
            "fc_bias": np.zeros((3,), np.float32),
            "bn_gamma": np.ones((3,), np.float32),
            "bn_beta": np.zeros((3,), np.float32)}
    aux = {"bn_moving_mean": np.zeros(3, np.float32),
           "bn_moving_var": np.ones(3, np.float32)}
    outs = []
    for lib in LIBS:
        sym = lib.sym
        h = sym.BatchNorm(sym.FullyConnected(sym.Variable("x"), num_hidden=3,
                                             name="fc"), name="bn")
        out, _ = sym.contrib.foreach(lambda xs, s: (xs + h, s),
                                     sym.Variable("seq"), sym.Variable("s0"))
        assert "_foreach" in [n.op for n in out._topo_nodes()]
        with lib.cpu():
            ex = out.bind(lib.cpu(), {k: lib.nd.array(v)
                                      for k, v in args.items()},
                          aux_states={k: lib.nd.array(v)
                                      for k, v in aux.items()})
            outs.append(ex.forward()[0].asnumpy())
    assert outs[1].shape == (5, 2, 3)
    np.testing.assert_allclose(outs[1][0], outs[1][4], rtol=1e-6)
    _close(outs[1], outs[0], 1e-6)


def test_cond_predicate_computed_outside():
    for aval, expect in ((0.5, 1.5), (0.0, -1.0)):
        got = []
        for lib in LIBS:
            a = lib.sym.Variable("a")
            out = lib.sym.contrib.cond(lib.sym.sum(a * 2), lambda: a + 1,
                                       lambda: a - 1)
            got.append(_bind_run(lib, out, {"a": np.array(
                [aval], np.float32)})[0][0])
        np.testing.assert_allclose(got[1], [expect], rtol=1e-6)
        np.testing.assert_array_equal(got[1], got[0])


def test_loop_body_with_auxiliary_state_raises():
    sym = mt.sym
    with pytest.raises(mt.MXNetError, match="auxiliary state"):
        sym.contrib.foreach(
            lambda x, s: (sym.BatchNorm(x, name="bn_in"), s),
            sym.Variable("seq"), sym.Variable("s0"))


def test_predictor_refuses_to_capture_host_control_flow():
    """_while_loop and _cond read their predicate on the host: a graph
    holding one is refused for capture; _foreach is capturable."""
    sym = mt.sym
    loop, _ = sym.contrib.while_loop(
        lambda i: i < 3.0, lambda i: (i * 2, i + 1.0), sym.Variable("data"),
        max_iterations=4)
    scan, _ = sym.contrib.foreach(lambda x, s: (x * 2, s),
                                  sym.Variable("data"), sym.Variable("s0"))
    args = {"data": np.zeros((2, 3), np.float32),
            "s0": np.zeros((1,), np.float32)}
    with mt.cpu():
        loop_ex = loop.bind(mt.cpu(), {"data": mt.nd.array(args["data"])})
        scan_ex = scan.bind(mt.cpu(), {k: mt.nd.array(v)
                                       for k, v in args.items()})
    assert capture.enabled()
    with pytest.raises(capture.CaptureError, match="_while_loop"):
        tpred._check_capturable(loop_ex._exec, torch.device("cuda"))
    tpred._check_capturable(scan_ex._exec, torch.device("cuda"))
