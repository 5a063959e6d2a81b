"""The detection ops (``mxnet_tpu_torch/ops/detection.py``), the hybrid
path of a user's HybridBlock on ``mx.nd`` arrays and Symbols, deferred
initialization, and the SSD training step, against ``mxnet_tpu`` on the
CPU (after ``tests/test_detection.py``).

Tolerances: anchors, class targets, masks, kept sets and class ids are
exact; ``loc_target`` (a float32 ``log`` whose ulp may differ between XLA
and torch), decoded boxes (``exp``), IoUs, ``box_encode`` /
``box_decode`` and ``ROIAlign`` (a mean over samples, in another order)
within 1e-5 relative and 1e-6 absolute; the SSD blocks' outputs within
1e-5 of max|out|; three SSD training steps within 1e-5 of max|w| and
1e-6 relative on the loss.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from _torch_parity import assert_close, run_both  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _boxes(rng, n):
    """n corner boxes in [0, 1]."""
    a = np.sort(rng.rand(n, 2, 2), axis=1)
    return np.stack([a[:, 0, 0], a[:, 0, 1], a[:, 1, 0], a[:, 1, 1]],
                    -1).astype(np.float32)


def _labels(rng, b, m, n_cls=3):
    lab = np.full((b, m, 5), -1, np.float32)
    for i in range(b):
        for j in range(rng.randint(1, m + 1)):
            lab[i, j] = [rng.randint(0, n_cls), *_boxes(rng, 1)[0]]
    return lab


def _prior_case(rng):
    return [rng.rand(2, 8, 4, 6).astype(np.float32)], \
        {"sizes": (0.4, 0.2), "ratios": (1, 2, 0.5), "clip": True}, 0, 0


def _target_case(rng):
    n = 60
    anc = _boxes(rng, n)[None]
    return [anc, _labels(rng, 3, 4), rng.rand(3, 4, n).astype(np.float32)], \
        {"negative_mining_ratio": 3.0, "minimum_negative_samples": 2}, \
        RTOL, ATOL


def _detection_case(rng):
    n = 60
    return [rng.rand(3, 4, n).astype(np.float32),
            (rng.randn(3, n * 4) * 0.2).astype(np.float32),
            _boxes(rng, n)[None]], {"nms_topk": 30, "threshold": 0.2}, \
        RTOL, ATOL


def _nms_case(rng):
    rows = np.concatenate([rng.randint(0, 3, (2, 12, 1)),
                           rng.rand(2, 12, 1), _boxes(rng, 24).reshape(
                               2, 12, 4)], -1).astype(np.float32)
    return [rows], {"overlap_thresh": 0.3, "id_index": 0, "topk": 8,
                    "valid_thresh": 0.1}, 0, 0


def _roi_case(rng):
    rois = np.array([[0, 1, 1, 6, 6], [1, 0.5, 2, 7.5, 5],
                     [0, -2, -2, 3, 9]], np.float32)
    return [rng.rand(2, 3, 8, 8).astype(np.float32), rois], \
        {"pooled_size": (3, 2), "spatial_scale": 1.0}, RTOL, ATOL


def _iou_case(rng):
    return [_boxes(rng, 6).reshape(2, 3, 4), _boxes(rng, 5)], {}, 0, 0


def _matching_case(rng):
    return [rng.rand(2, 5, 4).astype(np.float32)], {"threshold": 0.3}, 0, 0


def _encode_case(rng):
    return [rng.choice([-1.0, 0.0, 1.0], (2, 6)).astype(np.float32),
            rng.randint(0, 3, (2, 6)).astype(np.float32),
            _boxes(rng, 12).reshape(2, 6, 4),
            _boxes(rng, 6).reshape(2, 3, 4),
            np.zeros(4, np.float32),
            np.array([0.1, 0.1, 0.2, 0.2], np.float32)], {}, RTOL, ATOL


def _decode_case(rng):
    return [(rng.randn(2, 6, 4) * 0.3).astype(np.float32),
            _boxes(rng, 6)[None]], \
        {"std0": 0.1, "std1": 0.1, "std2": 0.2, "std3": 0.2, "clip": 0.5,
         "format": "corner"}, RTOL, ATOL


CASES = {
    "_contrib_MultiBoxPrior": _prior_case,
    "_contrib_MultiBoxTarget": _target_case,
    "_contrib_MultiBoxDetection": _detection_case,
    "_contrib_box_nms": _nms_case,
    "_contrib_ROIAlign": _roi_case,
    "_contrib_box_iou": _iou_case,
    "_contrib_bipartite_matching": _matching_case,
    "_contrib_box_encode": _encode_case,
    "_contrib_box_decode": _decode_case,
}
ALIASES = {n[len("_contrib_"):]: n for n in CASES}
CASE_NAMES = set(CASES) | set(ALIASES)


@pytest.mark.parametrize("name", sorted(CASE_NAMES))
def test_op_against_mxnet_tpu(name):
    """Each op and alias through both ``mx.nd``s on seeded inputs;
    MultiBoxTarget's class targets and mask and MultiBoxDetection's class
    ids and kept rows exactly."""
    canon = ALIASES.get(name, name)
    inputs, params, rtol, atol = CASES[canon](np.random.RandomState(7))
    j, t, jg, tg = run_both(name, inputs, params,
                            grad=canon == "_contrib_ROIAlign")
    assert_close(t, j, rtol, atol, name)
    if canon == "_contrib_MultiBoxTarget":
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[2], j[2])
    if canon == "_contrib_MultiBoxDetection":
        np.testing.assert_array_equal(t[0][..., 0], j[0][..., 0])
    if canon == "_contrib_ROIAlign":
        assert_close(tg, jg, rtol, atol, f"{name} gradient")
        assert np.abs(tg[0]).sum() > 0


def test_shared_best_anchor_takes_the_higher_gt():
    """Two ground truths whose best anchor is the same: mxnet_tpu's scatter
    keeps the later gt, and so does the port."""
    anc = np.array([[[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
                     [0.0, 0.6, 0.2, 0.9]]], np.float32)
    lab = np.array([[[1, 0.05, 0.05, 0.45, 0.45],
                     [2, 0.0, 0.0, 0.4, 0.5],
                     [-1, 0, 0, 0, 0]]], np.float32)
    j, t, _, _ = run_both("_contrib_MultiBoxTarget",
                          [anc, lab, np.zeros((1, 3, 3), np.float32)],
                          {"overlap_threshold": 0.95})
    assert j[2][0, 0] == 3.0                 # gt 1 (class 2) wins anchor 0
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_tied_nms_scores_keep_the_lower_index():
    """Equal scores: the sort is stable (lax.top_k's and argsort's order),
    so the lower anchor index survives NMS, in both packages."""
    anc = np.array([[[0.1, 0.1, 0.5, 0.5], [0.11, 0.11, 0.51, 0.51],
                     [0.6, 0.6, 0.9, 0.9], [0.12, 0.1, 0.5, 0.52]]],
                   np.float32)
    cp = np.zeros((1, 2, 4), np.float32)
    cp[0, 1] = [0.7, 0.7, 0.7, 0.7]
    j, t, _, _ = run_both("_contrib_MultiBoxDetection",
                          [cp, np.zeros((1, 16), np.float32), anc],
                          {"nms_threshold": 0.5, "nms_topk": 4})
    np.testing.assert_array_equal(t[0], j[0])
    kept = t[0][0][t[0][0][:, 0] >= 0]
    assert len(kept) == 2
    np.testing.assert_allclose(kept[0, 2:], anc[0, 0], atol=1e-6)
    rows = np.array([[[0, 0.5, 0.1, 0.1, 0.5, 0.5],
                      [0, 0.5, 0.11, 0.11, 0.51, 0.51],
                      [0, 0.5, 0.12, 0.1, 0.5, 0.52]]], np.float32)
    j, t, _, _ = run_both("_contrib_box_nms", [rows],
                          {"overlap_thresh": 0.5, "id_index": 0})
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[0][0, 0], rows[0, 0])


def test_tied_hardness_mines_the_lower_index():
    """Equal hardness among the negatives: the ones mined are the lowest
    indices, in both packages."""
    anc = np.concatenate([np.array([[0.0, 0.0, 0.4, 0.4]], np.float32),
                          np.tile(np.array([[0.6, 0.6, 0.9, 0.9]],
                                           np.float32), (7, 1))])[None]
    lab = np.array([[[0, 0.0, 0.0, 0.4, 0.4]]], np.float32)
    cp = np.full((1, 3, 8), 0.25, np.float32)
    j, t, _, _ = run_both("_contrib_MultiBoxTarget", [anc, lab, cp],
                          {"negative_mining_ratio": 2.0})
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[2][0], [1, 0, 0, -1, -1, -1, -1, -1])


def test_nms_sweep_reads_nothing_back():
    """The sweep runs on a device with no host read inside its loop: under
    a meta device (no values at all) it still gives the kept mask's
    shape."""
    from mxnet_tpu_torch.ops import detection

    boxes = torch.empty(2, 50, 4, device="meta")
    ids = torch.empty(2, 50, device="meta")
    keep = torch.empty(2, 50, dtype=torch.bool, device="meta")
    out = detection._nms_sweep(boxes, ids, keep, 0.5, False)
    assert out.shape == (2, 50) and out.device.type == "meta"


# ------------------------------------------------- the example's SSD block
def _ssd_classes(lib):
    """``examples/ssd/train_ssd.py``'s ``SSD`` and ``test_detection.py``'s
    ``TinySSD``, their bodies as written, imports pointed at ``lib``."""
    src = open(os.path.join(REPO, "examples", "ssd", "train_ssd.py")).read()
    ns = {"gluon": lib.gluon, "mx": lib}
    exec(src[src.index("class SSD"):src.index("def main")], ns)
    tsrc = open(os.path.join(REPO, "tests", "test_detection.py")).read()
    body = tsrc[tsrc.index("    class TinySSD"):tsrc.index("    net = TinySSD()")]
    exec("def _tiny(gluon, C_fg):\n" + body + "    return TinySSD\n", ns)
    return ns["SSD"], ns["_tiny"](lib.gluon, 3)


def _reset_names():
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    jblock._BlockScope._global_counter.clear()
    tblock._BlockScope._global_counter.clear()
    mt.sym.reset_name_counters()


@pytest.mark.parametrize("which,size", [("SSD", 64), ("TinySSD", 16)])
def test_user_block_on_ndarray_and_symbol(which, size):
    """R1: the block runs in the port as written, on mx.nd arrays (F =
    mx.nd, MXNet's transpose / reshape codes, F.contrib) and on a Symbol
    (F = mx.sym), with mxnet_tpu's weights carried: the three outputs
    within 1e-5 of max|out|."""
    x = np.random.RandomState(0).rand(2, 3, size, size).astype(np.float32)
    _reset_names()
    jcls = dict(zip(("SSD", "TinySSD"), _ssd_classes(mx)))[which]
    tcls = dict(zip(("SSD", "TinySSD"), _ssd_classes(mt)))[which]
    args = (3,) if which == "SSD" else ()
    with mx.cpu():
        jnet = jcls(*args)
        jnet.initialize(mx.initializer.Xavier())
        want = [o.asnumpy() for o in jnet(mx.nd.array(x))]
        params = {k: v.data().asnumpy()
                  for k, v in jnet.collect_params().items()}
    with mt.cpu():
        tnet = tcls(*args)
        tnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
        assert sorted(tnet.collect_params()) == sorted(params)
        tnet.load_numpy_params(params)
        got = tnet(mt.nd.array(x))
        assert all(isinstance(o, mt.nd.NDArray) for o in got)
        sym = mt.sym.Group(list(tnet(mt.sym.var("data"))))
        feed = {k: mt.nd.array(v) for k, v in params.items()}
        feed["data"] = mt.nd.array(x)
        by_sym = sym.bind(mt.cpu(), feed).forward()
    for w, g, s in zip(want, got, by_sym):
        tol = 1e-5 * max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g.asnumpy(), w, rtol=0, atol=tol)
        np.testing.assert_allclose(s.asnumpy(), w, rtol=0, atol=tol)


def test_tensor_f_reaches_contrib():
    """``F.contrib.<name>`` on tensors (the port's layers' F) is the
    ``_contrib_<name>`` op."""
    from mxnet_tpu_torch.gluon.block import F_TENSOR

    x = torch.zeros(1, 2, 3, 4)
    a = F_TENSOR.contrib.MultiBoxPrior(x, sizes=(0.5,))
    b = F_TENSOR._contrib_MultiBoxPrior(x, sizes=(0.5,))
    assert a.shape == (1, 12, 4) and torch.equal(a, b)


def test_deferred_initialization():
    """Conv2D and Dense without input widths draw their weights at the
    first forward (or take carried weights' shapes); a layer that cannot
    infer its shapes raises naming the ROADMAP item."""
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Conv2D(4, 3, padding=1),
                mt.gluon.nn.Conv2D(6, 3, layout="NHWC"),
                mt.gluon.nn.Dense(5))
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        assert all(t is None for n, t in net.collect_params().items()
                   if n.endswith("weight"))
        out = net(mt.nd.zeros((2, 3, 6, 6)))
        assert out.shape == (2, 5)
        assert [tuple(t.shape) for t in net.collect_params().values()] == \
            [(4, 3, 3, 3), (4,), (6, 3, 3, 6), (6,), (5, 2 * 4 * 6), (5,)]
        conv = mt.gluon.nn.Conv2D(4, 3, padding=1)
        conv.initialize(ctx=mt.cpu())
        out = conv(mt.nd.zeros((2, 3, 5, 5)))
        assert out.shape == (2, 4, 5, 5)
        assert conv.weight.shape == (4, 3, 3, 3)
        dense = mt.gluon.nn.Dense(5, flatten=False)
        dense.initialize(ctx=mt.cpu())
        w_name, b_name = dense.collect_params()
        dense.load_numpy_params({w_name: np.ones((5, 7), np.float32),
                                 b_name: np.zeros(5, np.float32)})
        assert dense(mt.nd.ones((2, 3, 7))).asnumpy().tolist() == \
            [[[7.0] * 5] * 3] * 2

        class Odd(mt.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.w = self.params.get("w", shape=(0, 2))

            def hybrid_forward(self, F, x, w):
                return x

        odd = Odd()
        odd.initialize(ctx=mt.cpu())
        with pytest.raises(mt.MXNetError, match="item 8"):
            odd(torch.zeros(2, 2))


# ------------------------------------------------------ the training step
def _train_steps(lib, x, lab, params, steps=3, zero_ignored=False):
    _reset_names()
    SSD = _ssd_classes(lib)[0]
    with lib.cpu():
        net = SSD(3)
        if lib is mt:
            net.initialize(mt.init.Xavier(), ctx=mt.cpu())
            net.load_numpy_params(params)
        else:
            net.initialize(mx.initializer.Xavier())
            net(mx.nd.array(x[:1]))
            for k, v in net.collect_params().items():
                v.set_data(mx.nd.array(params[k]))
        trainer = lib.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.002})
        cls_loss = lib.gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
        out = []
        for _ in range(steps):
            xb, label = lib.nd.array(x) / 255.0, lib.nd.array(lab)
            with lib.autograd.record():
                anchors, cp, lp = net(xb)
                with lib.autograd.pause():
                    sm = lib.nd.softmax(cp, axis=1)
                    lt, lm, ct = lib.nd.contrib.MultiBoxTarget(
                        anchors, label, sm, negative_mining_ratio=3.0)
                    if zero_ignored:
                        ct = lib.nd.array(np.maximum(ct.asnumpy(), 0))
                loss = (cls_loss(cp, ct).mean() +
                        lib.nd.smooth_l1((lp - lt) * lm, scalar=1.0).mean())
            loss.backward()
            trainer.step(x.shape[0])
            out.append((float(loss.asnumpy()),
                        {k: np.array(v.data().asnumpy() if lib is mx
                                     else v.detach().numpy())
                         for k, v in net.collect_params().items()}))
    return out


def test_ssd_training_steps_match_mxnet_tpu():
    """Three Adam steps of train_ssd.py's net and loss from carried
    weights. mxnet_tpu's pick wraps the ignored label -1 to the last class
    (ROADMAP Queue 3); its targets' -1 entries are set to 0, the class the
    port's pick clips -1 to, as MXNet's does."""
    rng = np.random.RandomState(0)
    x = (rng.rand(8, 3, 64, 64) * 255).astype(np.float32)
    lab = _labels(rng, 8, 2)
    _reset_names()
    with mx.cpu():
        SSD = _ssd_classes(mx)[0]
        jnet = SSD(3)
        jnet.initialize(mx.initializer.Xavier())
        jnet(mx.nd.array(x[:1]))
        params = {k: v.data().asnumpy()
                  for k, v in jnet.collect_params().items()}
    want = _train_steps(mx, x, lab, params, zero_ignored=True)
    got = _train_steps(mt, x, lab, params)
    for (jl, jw), (tl, tw) in zip(want, got):
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        for k in jw:
            np.testing.assert_allclose(
                tw[k], jw[k], rtol=0, atol=1e-5 * np.abs(jw[k]).max(),
                err_msg=k)
    assert got[-1][0] < got[0][0]


def test_loss_at_the_ignore_label_is_the_background_loss():
    """The port's SoftmaxCrossEntropyLoss (its pick clips, as MXNet's) gives
    a target of -1 the loss of class 0."""
    rng = np.random.RandomState(1)
    cp = rng.randn(2, 4, 6).astype(np.float32)
    ct = rng.randint(0, 4, (2, 6)).astype(np.float32)
    ct[:, ::2] = -1
    with mt.cpu():
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
        at_ignored = loss(mt.nd.array(cp), mt.nd.array(ct)).asnumpy()
        at_zero = loss(mt.nd.array(cp),
                       mt.nd.array(np.maximum(ct, 0))).asnumpy()
    np.testing.assert_array_equal(at_ignored, at_zero)
