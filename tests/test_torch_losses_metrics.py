"""The port's gluon losses and metrics against mxnet_tpu's, on the CPU.

Each loss takes the same seeded inputs in both packages: its per-sample
value and the gradient of their sum with respect to the prediction within
1e-5 (rtol and atol; f32 sums in other orders). Each metric, updated with
the same two seeded batches, gives the same ``get()`` within 1e-6.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402

TOL = 1e-5


def _rng(seed):
    return np.random.RandomState(seed)


def _ctc_args(rng):
    pred = rng.randn(2, 6, 5).astype(np.float32)           # NTC
    label = np.array([[1, 2, 3], [2, 2, -1]], np.float32)  # -1: padding
    return pred, [label]


def _ctc_lengths(rng):
    pred = rng.randn(2, 6, 5).astype(np.float32)
    label = np.array([[1, 2, 3], [3, 1, 0]], np.float32)
    return pred, [label, np.array([6, 4], np.float32),
                  np.array([3, 2], np.float32)]


def _args(kind, rng):
    """(pred, [other inputs]) for each loss's case."""
    x = rng.randn(4, 5).astype(np.float32)
    if kind == "regression":
        return x, [rng.randn(4, 5).astype(np.float32),
                   rng.rand(4, 1).astype(np.float32)]
    if kind == "binary":
        return x, [(rng.rand(4, 5) > 0.5).astype(np.float32)]
    if kind == "binary_pos":
        return x, [(rng.rand(4, 5) > 0.5).astype(np.float32), None,
                   (rng.rand(5) + 0.5).astype(np.float32)]
    if kind == "prob":
        return (rng.rand(4, 5) * 0.9 + 0.05).astype(np.float32), [
            (rng.rand(4, 5) > 0.5).astype(np.float32)]
    if kind == "prob_pos":
        return (rng.rand(4, 5) * 0.9 + 0.05).astype(np.float32), [
            (rng.rand(4, 5) > 0.5).astype(np.float32), None,
            (rng.rand(5) + 0.5).astype(np.float32)]
    if kind == "logprob":
        lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
        p = np.exp(rng.randn(4, 5))
        return lp.astype(np.float32), [(p / p.sum(-1, keepdims=True))
                                       .astype(np.float32)]
    if kind == "dist":
        p = np.exp(rng.randn(4, 5))
        return x, [(p / p.sum(-1, keepdims=True)).astype(np.float32)]
    if kind == "signed":
        return x, [np.sign(rng.randn(4, 5)).astype(np.float32)]
    if kind == "triplet":
        return x, [rng.randn(4, 5).astype(np.float32),
                   rng.randn(4, 5).astype(np.float32)]
    if kind == "poisson":
        return x * 0.5, [rng.randint(0, 6, (4, 5)).astype(np.float32)]
    if kind == "poisson_rate":
        return (rng.rand(4, 5) * 3 + 0.1).astype(np.float32), [
            rng.randint(0, 6, (4, 5)).astype(np.float32)]
    if kind == "cosine":
        return x, [rng.randn(4, 5).astype(np.float32),
                   np.array([1, -1, 1, -1], np.float32)]
    if kind == "ctc":
        return _ctc_args(rng)
    if kind == "ctc_lengths":
        return _ctc_lengths(rng)
    raise ValueError(kind)


LOSSES = [
    ("L1Loss", {}, "regression"),
    ("L1Loss", {"weight": 0.5}, "regression"),
    ("L2Loss", {}, "regression"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary_pos"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob_pos"),
    ("KLDivLoss", {}, "logprob"),
    ("KLDivLoss", {"from_logits": False, "weight": 2.0}, "dist"),
    ("CTCLoss", {}, "ctc"),
    ("CTCLoss", {"layout": "NTC"}, "ctc_lengths"),
    ("HuberLoss", {}, "regression"),
    ("HuberLoss", {"rho": 0.5}, "regression"),
    ("HingeLoss", {}, "signed"),
    ("HingeLoss", {"margin": 2}, "signed"),
    ("SquaredHingeLoss", {}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("TripletLoss", {}, "triplet"),
    ("TripletLoss", {"margin": 3}, "triplet"),
    ("PoissonNLLLoss", {}, "poisson"),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "poisson_rate"),
    ("CosineEmbeddingLoss", {}, "cosine"),
    ("CosineEmbeddingLoss", {"margin": 0.2}, "cosine"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist"),
]


def _j(a):
    return None if a is None else mx.nd.array(a)


def _t(a):
    return None if a is None else torch.from_numpy(a.copy())


@pytest.mark.parametrize("name,kw,kind", LOSSES,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss_value_and_input_gradient(name, kw, kind):
    pred, rest = _args(kind, _rng(len(name) + len(kw)))
    jfn = getattr(mx.gluon.loss, name)(**kw)
    tfn = getattr(mt.gluon.loss, name)(**kw)
    jp = mx.nd.array(pred)
    jp.attach_grad()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with mx.autograd.record():
            jl = jfn(jp, *[_j(a) for a in rest])
        jl.backward()
    tp = torch.from_numpy(pred.copy()).requires_grad_(True)
    with mt.autograd.record():
        tl = tfn(tp, *[_t(a) for a in rest])
    mt.autograd.backward(tl)
    np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tp.grad.numpy(), jp.grad.asnumpy(),
                               rtol=TOL, atol=TOL)


def test_every_loss_of_mxnet_tpu_is_ported():
    names = set(mx.gluon.loss.__all__)
    assert names <= set(mt.gluon.loss.__all__), \
        names - set(mt.gluon.loss.__all__)
    assert mt.gluon.loss.SigmoidBCELoss is \
        mt.gluon.loss.SigmoidBinaryCrossEntropyLoss


def test_ctc_op_matches_with_the_blank_first():
    rng = _rng(3)
    data = rng.randn(7, 3, 6).astype(np.float32)           # TNC
    label = np.array([[1, 2, 0], [3, 0, 0], [4, 4, 5]], np.float32)
    from mxnet_tpu.ops import registry as jreg

    want = np.asarray(jreg.get_op("CTCLoss").fn(data, label))
    got = mt.ops.registry.get_op("CTCLoss").fn(torch.from_numpy(data),
                                               torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# -------------------------------------------------------------- metrics
def _batches(kind, seed):
    rng = _rng(seed)
    out = []
    for _ in range(2):
        if kind == "binary":
            p = rng.rand(16, 1)
            out.append(((rng.rand(16) > 0.5).astype(np.float32),
                        np.concatenate([1 - p, p], 1).astype(np.float32)))
        elif kind == "binary1d":
            out.append(((rng.rand(16) > 0.5).astype(np.float32),
                        rng.rand(16).astype(np.float32)))
        elif kind == "probs":
            p = np.exp(rng.randn(16, 6))
            out.append((rng.randint(0, 6, 16).astype(np.float32),
                        (p / p.sum(1, keepdims=True)).astype(np.float32)))
        elif kind == "seq_probs":
            p = np.exp(rng.randn(2, 8, 6))
            out.append((rng.randint(0, 6, (2, 8)).astype(np.float32),
                        (p / p.sum(-1, keepdims=True)).astype(np.float32)))
        elif kind == "regression":
            out.append((rng.randn(16).astype(np.float32),
                        rng.randn(16).astype(np.float32)))
        elif kind == "regression2d":
            out.append((rng.randn(16, 3).astype(np.float32),
                        rng.randn(16, 3).astype(np.float32)))
        elif kind == "losses":
            out.append((None, rng.rand(16).astype(np.float32)))
    return out


METRICS = [
    ("f1", {}, "binary"), ("f1", {}, "binary1d"), ("mcc", {}, "binary"),
    ("perplexity", {}, "probs"), ("perplexity", {"ignore_label": 2},
                                  "seq_probs"),
    ("mae", {}, "regression"), ("mse", {}, "regression2d"),
    ("rmse", {}, "regression"), ("ce", {}, "probs"),
    ("nll_loss", {}, "probs"), ("negativeloglikelihood", {}, "probs"),
    ("pearsonr", {}, "regression"), ("pearsoncorrelation", {},
                                     "regression2d"),
    ("loss", {}, "losses"), ("torch", {}, "losses"), ("caffe", {}, "losses"),
    ("acc", {}, "probs"), ("top_k_acc", {"top_k": 2}, "probs"),
]


def _feed(lib, m, kind, seed):
    for label, pred in _batches(kind, seed):
        if lib is mx:
            m.update([None if label is None else mx.nd.array(label)],
                     [mx.nd.array(pred)])
        else:
            m.update([None if label is None else torch.from_numpy(label)],
                     [torch.from_numpy(pred)])
    return m.get()


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(METRICS)])
def test_metric_get_matches(name, kw, kind):
    jn, jv = _feed(mx, mx.metric.create(name, **kw), kind, len(name))
    tn, tv = _feed(mt, mt.metric.create(name, **kw), kind, len(name))
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def _feval(label, pred):
    return float(np.abs(label - pred.ravel()).sum()), label.size


@pytest.mark.parametrize("make", ["create", "np", "class"])
def test_custom_metric_matches(make):
    def build(lib):
        if make == "create":
            return lib.metric.create(_feval)
        if make == "np":
            return lib.metric.np(_feval, name="l1")
        return lib.metric.CustomMetric(lambda l, p: float(p.max()),
                                       name="mx")
    jn, jv = _feed(mx, build(mx), "regression", 4)
    tn, tv = _feed(mt, build(mt), "regression", 4)
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def test_every_metric_of_mxnet_tpu_is_ported():
    jnames = set(mx.metric._METRIC_REGISTRY.keys())
    assert jnames <= set(mt.metric._REGISTRY), \
        jnames - set(mt.metric._REGISTRY)
    assert set(mx.metric.__all__) <= set(mt.metric.__all__) | {
        "register"}
    comp = mt.metric.create(["mae", _feval])
    assert [type(m).__name__ for m in comp.metrics] == ["MAE",
                                                        "CustomMetric"]
