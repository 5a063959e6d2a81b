"""INT8 serving in the PyTorch port against mxnet_tpu, on the CPU.

The Symbol-fed Predictor (a Symbol, its JSON or a ``-symbol.json`` path;
params as a dict or a ``.params`` path with ``arg:`` / ``aux:`` prefixes),
``quantize="int8"`` with calibration data or a shipped table, the errors of
``mxnet_tpu/serving/predictor.py:284-330`` (``tests/test_int8_serving.py
:153-160, 281``), recalibration from the fp32 graph with one recorded
retrace, and the NaN poison through a served graph. Outputs are held to
the offline flow bitwise, and to mxnet_tpu's Predictor given the same
table. Inputs come from numpy seeds; a CPU context runs each bucket's
program directly (the CUDA graphs are the card's).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu.symbol as jsym  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
import mxnet_tpu_torch.symbol as tsym  # noqa: E402
from mxnet_tpu_torch import capture, serving  # noqa: E402
from mxnet_tpu_torch.contrib import quantization as tq  # noqa: E402
from mxnet_tpu_torch.gluon import block as tblock  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402

TAIL = (3, 8, 8)


def _convnet(sym, prefix="q"):
    """mxnet_tpu's serving-test net: conv, relu, max pool, FC, with stable
    names (``tests/test_int8_serving.py:28``)."""
    data = sym.Variable("data")
    c = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=8,
                        name=f"{prefix}_c1")
    r = sym.Activation(c, act_type="relu", name=f"{prefix}_r1")
    p = sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name=f"{prefix}_p1")
    return sym.FullyConnected(p, num_hidden=10, name=f"{prefix}_fc1")


def _params(prefix="q", seed=0):
    rng = np.random.RandomState(seed)
    feat = 8 * (TAIL[1] // 2) * (TAIL[2] // 2)
    return {f"{prefix}_c1_weight": (rng.randn(8, 3, 3, 3) * 0.2)
            .astype(np.float32),
            f"{prefix}_c1_bias": (rng.randn(8) * 0.05).astype(np.float32),
            f"{prefix}_fc1_weight": (rng.randn(10, feat) * 0.1)
            .astype(np.float32),
            f"{prefix}_fc1_bias": np.zeros((10,), np.float32)}


def _calib(n=16, seed=3):
    return np.random.RandomState(seed).rand(n, *TAIL).astype(np.float32)


def _pred(s=None, params=None, **kw):
    kw.setdefault("batch_sizes", (8,))
    return serving.Predictor(s if s is not None else _convnet(tsym),
                             params if params is not None else _params(),
                             ctx=mt.cpu(), input_shapes={"data": TAIL}, **kw)


def _int8(calib_mode="naive", **kw):
    return _pred(quantize="int8", calib_mode=calib_mode,
                 calib_data=mt.io.NDArrayIter(_calib(), batch_size=8), **kw)


@pytest.mark.parametrize("calib_mode", ["naive", "entropy"])
def test_predictor_int8_matches_offline_flow_bitwise(calib_mode):
    pred = _int8(calib_mode)
    assert pred.quantization["calib_mode"] == calib_mode
    x = _calib(8, seed=4)
    out = pred.predict(x)[0]
    s = _convnet(tsym)
    args = {k: torch.from_numpy(v) for k, v in _params().items()}
    qsym, qargs, qaux = tq.quantize_model(
        s, args, {}, calib_table=pred.calibration_table,
        quantize_mode="full")
    ex = qsym.bind(mt.cpu(), {**qargs, "data": torch.from_numpy(x)},
                   aux_states=qaux)
    assert torch.equal(out, ex.forward()[0])


def test_predictor_int8_matches_mxnet_tpu_given_its_table():
    """mxnet_tpu's Predictor calibrates; the port serves from that table
    (carried as JSON): the same graph, and logits within a few int8
    levels of mxnet_tpu's."""
    jparams = {k: mx.nd.array(v) for k, v in _params().items()}
    x = _calib(8, seed=5)
    jpred = jserving.Predictor(
        _convnet(jsym), jparams, input_shapes={"data": TAIL},
        batch_sizes=(8,), quantize="int8", calib_mode="naive",
        calib_data=mx.io.NDArrayIter(_calib(), batch_size=8))
    table = tq.CalibrationTable.from_json(jpred.calibration_table.to_json())
    pred = _pred(quantize="int8", calib_table=table)
    assert json.loads(pred._symbol.tojson()) == \
        json.loads(jpred._symbol.tojson())
    want = jpred.predict(x)[0].asnumpy()
    got = pred.predict(x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.02 * np.abs(want).max())


def test_symbol_sources_json_path_and_params_file(tmp_path):
    """A Symbol, its JSON and a -symbol.json path; params as a dict or a
    .params file written by mxnet_tpu with arg: prefixes: one answer."""
    x = _calib(4, seed=6)
    s = _convnet(tsym)
    path = str(tmp_path / "net-symbol.json")
    s.save(path)
    ppath = str(tmp_path / "net-0000.params")
    mx.nd.save(ppath, {f"arg:{k}": mx.nd.array(v)
                       for k, v in _params().items()})
    outs = [_pred(src, par).predict(x)[0]
            for src, par in ((s, None), (s.tojson(), None), (path, ppath))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    jex = _convnet(jsym).bind(
        mx.cpu(), {**{k: mx.nd.array(v) for k, v in _params().items()},
                   "data": mx.nd.array(x)}, grad_req="null")
    np.testing.assert_allclose(outs[0].numpy(),
                               jex.forward()[0].asnumpy(), rtol=0,
                               atol=1e-5)


def test_exported_resnet_serves_like_the_block(tmp_path):
    tblock._BlockScope._global_counter.clear()
    tsym.reset_name_counters()
    net = tvision.resnet18_v1(thumbnail=True, classes=10)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(0))
    sf, pf = net.export(str(tmp_path / "r18"))
    x = _calib(4, seed=7).repeat(2, axis=2).repeat(2, axis=3)
    pred = serving.Predictor(sf, pf, ctx=mt.cpu(),
                             input_shapes={"data": (3, 16, 16)},
                             batch_sizes=(4,))
    with torch.no_grad():
        want = net(torch.from_numpy(x))
    got = pred.predict(x)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert pred.output_names == ["fullyconnected0_output"]


def test_predictor_errors_match_mxnet_tpu():
    with pytest.raises(mt.MXNetError, match="calibration source"):
        _pred(quantize="int8")
    table = tq.calibrate(_convnet(tsym), {k: torch.from_numpy(v)
                                          for k, v in _params().items()},
                         {}, mt.io.NDArrayIter(_calib(), batch_size=8),
                         calib_mode="naive")
    with pytest.raises(mt.MXNetError, match="not both"):
        _pred(quantize="int8", calib_table=table,
              calib_data=mt.io.NDArrayIter(_calib(), batch_size=8))
    with pytest.raises(mt.MXNetError, match="int8 kernels only"):
        _pred(quantize="uint8", calib_table=table)
    other = _convnet(tsym, "b")
    with pytest.raises(tq.CalibrationMismatchError) as ei:
        _pred(other, _params("b"), quantize="int8", calib_table=table)
    assert ei.value.missing
    drifted = _params()
    drifted["q_c1_weight"] = drifted["q_c1_weight"] * 100.0
    with pytest.raises(tq.CalibrationMismatchError) as ei:
        _pred(params=drifted, quantize="int8", calib_table=table)
    assert ei.value.drifted
    with pytest.raises(mt.MXNetError, match="not arguments"):
        _pred(params={**_params(), "stray": np.zeros(2, np.float32)})
    with pytest.raises(mt.MXNetError, match="missing from params"):
        _pred(params={k: v for k, v in _params().items()
                      if k != "q_fc1_bias"})


def test_table_file_quantizes_without_data(tmp_path):
    src = _int8()
    path = str(tmp_path / "t.json")
    src.calibration_table.save(path)
    dst = _pred(quantize="int8", calib_table=path)
    x = _calib(8, seed=8)
    assert torch.equal(src.predict(x)[0], dst.predict(x)[0])
    assert dst.calibration_table.digest() == src.calibration_table.digest()


def test_recalibration_starts_from_fp32_and_records_one_retrace():
    pred = _int8()
    first = [(n.op, n.name) for n in pred._symbol._topo_nodes()]
    x = _calib(8, seed=9)
    pred.predict(x)
    assert pred._exec.compiled_signatures
    capture.clear_retrace_log()
    pred.quantize(calib_data=mt.io.NDArrayIter(_calib(seed=11),
                                               batch_size=8),
                  calib_mode="naive")
    # rebuilt from the fp32 graph: the same nodes, not a requantized one
    assert [(n.op, n.name) for n in pred._symbol._topo_nodes()] == first
    assert pred._exec.compiled_signatures == []
    log = capture.retrace_log()
    assert len(log) == 1 and "recalibration" in log[0]["reason"]
    assert np.isfinite(pred.predict(x)[0].numpy()).all()


def test_excluded_nodes_stay_fp32():
    pred = _int8(excluded_sym_names=("q_fc1",))
    ops = [n.op for n in pred._symbol._topo_nodes() if not n.is_var]
    assert "FullyConnected" in ops and "_contrib_quantized_conv" in ops
    assert pred.quantization["excluded"] == ("q_fc1",)
    assert np.isfinite(pred.predict(_calib(4))[0].numpy()).all()


def test_pad_rows_do_not_perturb_real_rows():
    """Calibrated thresholds are constants here (no residual add), so a
    3-row batch through the bucket-8 program equals those rows of a full
    batch bitwise, as in mxnet_tpu."""
    pred = _int8()
    x = _calib(8, seed=10)
    full = pred.predict(x)[0]
    part = pred.predict(x[:3])[0]
    assert part.shape[0] == 3 and torch.equal(part, full[:3])


def test_nan_input_reaches_the_outputs(monkeypatch):
    pred = _int8()
    x = _calib(4, seed=12)
    assert np.isfinite(pred.predict(x)[0].numpy()).all()
    x[0, 0, 0, 0] = np.nan
    assert not np.isfinite(pred.predict(x)[0].numpy()).all()
    monkeypatch.setenv("MXNET_TPU_INT8_NAN_POISON", "0")
    assert np.isfinite(pred.predict(x)[0].numpy()).all()


def test_block_predictor_is_unchanged_and_refuses_quantize():
    net = tvision.resnet18_v1(thumbnail=True, classes=4)
    net.initialize(ctx=mt.cpu())
    pred = serving.Predictor.from_block(net, input_shapes={"data": (3, 8,
                                                                    8)},
                                        ctx=mt.cpu(), batch_sizes=(2,))
    assert pred.predict(np.zeros((1, 3, 8, 8), np.float32))[0].shape == \
        (1, 4)
    with pytest.raises(mt.MXNetError, match="Symbol source"):
        serving.Predictor(net, ctx=mt.cpu(), quantize="int8")
    assert pred.quantization is None


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_like_mxnet_tpu(handle):
    """The calibration source: the same batches, pads and epoch ends as
    mxnet_tpu's NDArrayIter over two epochs."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    its = (mx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle),
           mt.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle))
    for _ in range(2):
        got = [[(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in its[1]]]
        want = [[(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                 for b in its[0]]]
        assert len(got[0]) == len(want[0])
        for (gd, gl, gp), (wd, wl, wp) in zip(got[0], want[0]):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        for it in its:
            it.reset()


@pytest.mark.cuda
def test_int8_predictor_on_the_card_runs_k5():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from mxnet_tpu_torch.ops import quantization as q

    s = _convnet(tsym)
    pred = serving.Predictor(s, _params(), ctx=mt.gpu(0),
                             input_shapes={"data": TAIL}, batch_sizes=(8,),
                             quantize="int8", calib_mode="naive",
                             calib_data=mt.io.NDArrayIter(_calib(),
                                                          batch_size=8))
    before = q.s8_conv.launches
    cpu = _int8()
    x = _calib(8, seed=13)
    got = pred.predict(x)[0].cpu()
    assert torch.equal(got, cpu.predict(x)[0])
    assert q.s8_conv.launches == before
