"""gluon.contrib of the PyTorch port against mxnet_tpu's, on the CPU:
Concurrent, HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm,
MultiHeadAttention with cross_attention, VariationalDropoutCell, and the
RNN layers and cells with their input width deferred.

Weights are made with numpy and carried with ``load_numpy_params``;
outputs and gradients agree within 1e-5 of scale (f32 sums reordered).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon import contrib as jcontrib  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import contrib as tcontrib  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn, rnn as trnn  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _carry(jblk, tblk, *inputs, seed=0):
    """mxnet_tpu's deferred shapes resolved by a forward on ``inputs``,
    random numpy values set in it, carried into the port."""
    jblk.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jblk(*[mx.nd.array(x) for x in inputs])
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jblk.collect_params().items():
        values[name] = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        if name.endswith("var"):
            values[name] = np.abs(values[name]) + 0.5
        p.set_data(mx.nd.array(values[name]))
    tblk.initialize(ctx=mt.cpu())
    tblk.load_numpy_params(values)
    assert list(tblk.collect_params()) == list(values)
    return values


def _predict(jblk, tblk, *inputs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jblk(*[mx.nd.array(x) for x in inputs]).asnumpy()
    with torch.inference_mode():
        got = tblk(*[torch.from_numpy(x) for x in inputs]).numpy()
    return got, want


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _branches(nn, klass, axis, prefix):
    blk = klass(axis=axis, prefix=prefix)
    with blk.name_scope():
        blk.add(nn.Dense(4), nn.Dense(3), contrib(nn).Identity())
    return blk


def contrib(nn):
    return jcontrib.nn if nn is jgluon.nn else tcontrib.nn


@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent"])
def test_concurrent_concatenates_branches(kind):
    make = {"j": lambda: _branches(jgluon.nn, getattr(jcontrib.nn, kind),
                                   -1, "cc_"),
            "t": lambda: _branches(tnn, getattr(tcontrib.nn, kind), -1,
                                   "cc_")}
    jb, tb = make["j"](), make["t"]()
    x = _x(2, 5)
    _carry(jb, tb, x)
    got, want = _predict(jb, tb, x)
    assert got.shape == (2, 12)
    _close(got, want)


def test_hybrid_concurrent_on_axis_1_and_on_a_symbol():
    blk = tcontrib.nn.HybridConcurrent(axis=1, prefix="hc_")
    with blk.name_scope():
        blk.add(tnn.Conv2D(2, 1, in_channels=3),
                tnn.Conv2D(5, 3, padding=1, in_channels=3))
    blk.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(1, 3, 4, 4))
    with torch.inference_mode():
        out = blk(x)
    assert out.shape == (1, 7, 4, 4)
    sym = blk(mt.symbol.var("data"))
    with mt.cpu():
        args = {k: mt.nd.NDArray(v) for k, v in dict(
            blk.collect_params(), data=x).items()}
        got = sym.bind(mt.cpu(), args).forward()[0].asnumpy()
    np.testing.assert_allclose(got, out.numpy(), rtol=0, atol=1e-6)


def test_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(tcontrib.nn.Identity()(x), x)


def test_sparse_embedding_is_a_dense_embedding():
    with pytest.warns(UserWarning, match="dense"):
        tb = tcontrib.nn.SparseEmbedding(10, 4, prefix="se_")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = jcontrib.nn.SparseEmbedding(10, 4, prefix="se_")
    ids = np.array([[1, 3], [9, 0]], np.float32)
    _carry(jb, tb, ids)
    got, want = _predict(jb, tb, ids)
    _close(got, want, 0)
    idt = torch.tensor([[1, 1, 2]])
    with mt.autograd.record():
        tb(idt).sum().backward()
    g = tb._param_objects()["se_embedding0_weight"].grad()
    assert g.layout == torch.strided and g[1].sum() == 8 and g[2].sum() == 4


def test_sync_batch_norm_is_batch_norm():
    jb = jcontrib.nn.SyncBatchNorm(num_devices=4, prefix="sbn_")
    tb = tcontrib.nn.SyncBatchNorm(num_devices=4, prefix="sbn_")
    assert isinstance(tb, tnn.BatchNorm)
    x = _x(4, 3, 2, 2)
    _carry(jb, tb, x)
    with mx.autograd.record():
        want = jb(mx.nd.array(x)).asnumpy()
    with mt.autograd.record():
        got = tb(torch.from_numpy(x)).detach().numpy()
    _close(got, want, 1e-4)
    for name in ("sbn_running_mean", "sbn_running_var"):
        _close(tb.collect_params()[name].numpy(),
               jb.collect_params()[name].data().asnumpy())


# ---------------------------------------------------- cross-attention
def _mha(lib, impl="dense", causal=False, prefix="x_"):
    mod = jcontrib if lib is mx else tcontrib.nn
    return mod.MultiHeadAttention(16, 4, impl=impl, causal=causal,
                                  cross_attention=True, prefix=prefix)


@pytest.mark.parametrize("s_len,causal", [(7, False), (5, False),
                                          (5, True), (9, True)])
def test_cross_attention_dense_matches(s_len, causal):
    """Forward, the input gradients of x and key_value and every
    parameter gradient; names (q_proj, an interleaved kv_proj) and the
    k / v split equal mxnet_tpu's."""
    jb, tb = _mha(mx, causal=causal), _mha(mt, causal=causal)
    x, kv = _x(2, 5, 16), _x(2, s_len, 16, seed=2)
    values = _carry(jb, tb, x, kv)
    assert set(values) == {"x_q_weight", "x_q_bias", "x_kv_weight",
                           "x_kv_bias", "x_out_weight", "x_out_bias"}
    assert values["x_kv_weight"].shape == (32, 16)
    head = _x(2, 5, 16, seed=3)
    xj, kvj = mx.nd.array(x), mx.nd.array(kv)
    xj.attach_grad()
    kvj.attach_grad()
    with mx.autograd.record():
        (jb(xj, kvj) * mx.nd.array(head)).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    kvt = torch.from_numpy(kv).requires_grad_()
    with mt.autograd.record():
        out = tb(xt, kvt)
        (out * torch.from_numpy(head)).sum().backward()
    want = jb(mx.nd.array(x), mx.nd.array(kv)).asnumpy()
    _close(out.detach().numpy(), want)
    _close(xt.grad.numpy(), xj.grad.asnumpy())
    _close(kvt.grad.numpy(), kvj.grad.asnumpy())
    tp = tb._param_objects()
    for name, p in jb.collect_params().items():
        _close(tp[name].grad().numpy(), p.grad().asnumpy())


def test_cross_attention_kv_split_order():
    """k is the first ``units`` channels of kv_proj's output and v the
    next: with v's rows zero, the attention output (before out_proj) is
    zero whatever k."""
    tb = _mha(mt)
    tb.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tb.kv_proj.weight[16:] = 0
        tb.kv_proj.bias[16:] = 0
    with torch.inference_mode():
        out = tb(torch.from_numpy(_x(1, 3, 16)), torch.from_numpy(
            _x(1, 4, 16)))
    expect = tb.out_proj.bias.detach().expand(1, 3, 16)
    assert torch.allclose(out, expect)


def test_cross_attention_flash_equals_dense_at_equal_lengths():
    """impl='flash' at S = L takes the flash Function (its plain version on
    the CPU) on the q and kv views: equal to impl='dense', gradients too."""
    fb, db = _mha(mt, "flash", prefix="f_"), _mha(mt, "dense", prefix="f_")
    for b in (fb, db):
        b.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(1))
    x, kv = (torch.from_numpy(_x(2, 6, 16)),
             torch.from_numpy(_x(2, 6, 16, seed=2)))
    grads = []
    for blk in (fb, db):
        with mt.autograd.record():
            out = blk(x, kv)
            out.square().sum().backward()
        grads.append((out.detach(), {k: p.grad().clone() for k, p in
                                     blk._param_objects().items()}))
    _close(grads[0][0].numpy(), grads[1][0].numpy())
    for k in grads[0][1]:
        _close(grads[0][1][k].numpy(), grads[1][1][k].numpy())


def test_cross_attention_flash_refuses_unequal_lengths():
    """mxnet_tpu warns and computes the dense composition; the port raises
    naming the kernels' self-attention gate (ROADMAP Queue 3)."""
    tb = _mha(mt, "flash")
    tb.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="self-attention shapes only"):
        tb(torch.zeros(1, 4, 16), torch.zeros(1, 5, 16))
    with pytest.raises(ValueError, match="pass key_value"):
        tb(torch.zeros(1, 4, 16))
    self_attn = tcontrib.nn.MultiHeadAttention(16, 4)
    self_attn.initialize(ctx=mt.cpu())
    with pytest.raises(ValueError, match="cross_attention=True"):
        self_attn(torch.zeros(1, 4, 16), torch.zeros(1, 4, 16))
    assert self_attn._tp_layers() and not tb._tp_layers()


# ------------------------------------------------- VariationalDropoutCell
def _vardrop(p_in=0.5, p_state=0.5, p_out=0.5):
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    cell = trnn.LSTMCell(6, input_size=5, prefix="l_")
    return crnn.VariationalDropoutCell(cell, drop_inputs=p_in,
                                       drop_states=p_state,
                                       drop_outputs=p_out)


def test_variational_dropout_one_mask_a_sequence():
    """Each mask is drawn once at the first step of a sequence and reused
    at every step; the next unroll draws new ones."""
    cell = _vardrop()
    cell.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    x = torch.ones(3, 7, 5)
    mt.random.seed(11)
    with mt.autograd.train_mode():
        cell.unroll(7, x, layout="NTC")
        masks = [cell.drop_inputs_mask, cell.drop_states_mask,
                 cell.drop_outputs_mask]
        shapes = [m.shape for m in masks]
        assert shapes == [(3, 5), (3, 6), (3, 6)]
        for m in masks:
            assert set(m.unique().tolist()) <= {0.0, 2.0}
        # the masks of one sequence stay: stepping on does not redraw
        cell(x[:, 0], cell.begin_state(batch_size=3))
        assert all(a is b for a, b in zip(masks, [
            cell.drop_inputs_mask, cell.drop_states_mask,
            cell.drop_outputs_mask]))
        outs, _ = cell.unroll(7, x, layout="NTC", merge_outputs=True)
    assert not all(torch.equal(a, b) for a, b in zip(masks, [
        cell.drop_inputs_mask, cell.drop_states_mask,
        cell.drop_outputs_mask]))
    # an output unit dropped at one step is dropped at every step
    dropped = cell.drop_outputs_mask == 0
    assert (outs.permute(1, 0, 2)[:, dropped] == 0).all()


def test_variational_dropout_predict_mode_is_the_base_cell():
    cell = _vardrop()
    cell.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    base = trnn.LSTMCell(6, input_size=5, prefix="l_")
    base.initialize(ctx=mt.cpu())
    base.load_numpy_params({k: v.detach().numpy() for k, v in
                            cell.collect_params().items()})
    x = torch.from_numpy(_x(2, 4, 5))
    a, _ = cell.unroll(4, x, layout="NTC", merge_outputs=True)
    b, _ = base.unroll(4, x, layout="NTC", merge_outputs=True)
    assert torch.allclose(a, b)
    assert "VariationalDropoutCell" in repr(cell)


def test_variational_dropout_masks_match_mxnet_tpu_when_kept():
    """With every probability 0 (no mask drawn) the wrapped LSTM's unroll
    equals mxnet_tpu's, names included."""
    from mxnet_tpu.gluon.contrib import rnn as jrnn_c

    jcell = jrnn_c.VariationalDropoutCell(
        jgluon.rnn.LSTMCell(6, input_size=5, prefix="l_"))
    tcell = _vardrop(0.0, 0.0, 0.0)
    x = _x(2, 4, 5)
    jcell.initialize()
    values = {k: (np.random.RandomState(0).randn(*p.shape) * 0.3).astype(
        np.float32) for k, p in jcell.collect_params().items()}
    for k, p in jcell.collect_params().items():
        p.set_data(mx.nd.array(values[k]))
    tcell.initialize(ctx=mt.cpu())
    tcell.load_numpy_params(values)
    want, _ = jcell.unroll(4, mx.nd.array(x), layout="NTC",
                           merge_outputs=True)
    got, _ = tcell.unroll(4, torch.from_numpy(x), layout="NTC",
                          merge_outputs=True)
    _close(got.detach().numpy(), want.asnumpy())


# ------------------------------------------- RNN widths deferred
@pytest.mark.parametrize("make", [
    lambda r: r.LSTM(6, num_layers=2, bidirectional=True, prefix="rl_"),
    lambda r: r.GRU(5, layout="NTC", prefix="rl_"),
    lambda r: r.RNN(4, prefix="rl_")], ids=["lstm_bi", "gru_ntc", "rnn"])
def test_rnn_layer_input_width_deferred(make):
    """Without input_size the first layer's i2h weights take the input's
    width at the first forward: the same name -> shape map and output as
    mxnet_tpu's."""
    jb, tb = make(jgluon.rnn), make(trnn)
    x = _x(4, 3, 7)
    _carry(jb, tb, x)
    tb2 = make(trnn)
    tb2.initialize(ctx=mt.cpu())
    with torch.inference_mode():
        tb2(torch.from_numpy(x))
    assert {k: tuple(v.shape) for k, v in tb2.collect_params().items()} == \
        {k: tuple(p.shape) for k, p in jb.collect_params().items()}
    got, want = _predict(jb, tb, x)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("kind", ["RNNCell", "LSTMCell", "GRUCell"])
def test_rnn_cell_input_width_deferred(kind):
    """A cell without input_size takes the first step's width: the
    name -> shape map of mxnet_tpu's cell built with it (whose own deferred
    unroll raises), and its unroll's outputs once its weights are carried
    in."""
    jc = getattr(jgluon.rnn, kind)(6, input_size=3, prefix="c_")
    tc = getattr(trnn, kind)(6, prefix="c_")
    x = _x(2, 5, 3)
    jc.initialize()
    tc.initialize(ctx=mt.cpu())
    with torch.inference_mode():
        tc.unroll(5, torch.from_numpy(x), layout="NTC")
    values = {k: (np.random.RandomState(0).randn(*p.shape) * 0.3).astype(
        np.float32) for k, p in jc.collect_params().items()}
    assert {k: tuple(v.shape) for k, v in tc.collect_params().items()} == \
        {k: v.shape for k, v in values.items()}
    for k, p in jc.collect_params().items():
        p.set_data(mx.nd.array(values[k]))
    tc.load_numpy_params(values)
    want, _ = jc.unroll(5, mx.nd.array(x), layout="NTC", merge_outputs=True)
    with torch.inference_mode():
        got, _ = tc.unroll(5, torch.from_numpy(x), layout="NTC",
                           merge_outputs=True)
    _close(got.numpy(), want.asnumpy())
