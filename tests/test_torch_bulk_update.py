"""The port's bulked update sweep (``aggregate_num``, the multi-tensor
update ops), on the CPU.

The multi-tensor SGD, SGD-momentum and Adam ops, with their scalars given
as Python floats or as 0-d float32 tensors (the slots a captured step
reads), are held bitwise to the per-parameter arithmetic the port had
before them (``_old_*`` below, the formulas of
``mxnet_tpu/ops/optimizer_ops.py:24-82`` in the weight's dtype), in fp32
and bf16, over groups of one dtype and of mixed dtypes, with one rate per
weight or one shared. ``gluon.Trainer``'s sweep, one multi-tensor op over
every parameter whatever ``aggregate_num`` says, is bitwise the sweep of
one op per parameter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.ops import optimizer_ops as topt  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

SHAPES = [(7, 5), (11,), (3, 2, 4)]
LR, WD, RESCALE = 0.0123456789, 1e-2, 0.37


def _old_sgd(w, g, lr, wd, rs, clip, mom=None, momentum=0.0):
    g = g * rs
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    if mom is None:
        w.sub_(lr * (g + wd * w))
    else:
        mom.copy_(momentum * mom - lr * (g + wd * w))
        w.add_(mom)


def _old_adam(w, g, m, v, lr, wd, rs, clip, b1=0.9, b2=0.999, eps=1e-8):
    g = g * rs
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    g = g + wd * w
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * torch.square(g))
    w.sub_(lr * m / (torch.sqrt(v) + eps))


def _tensors(seed, dtype, positive=False):
    rng = np.random.RandomState(seed)
    out = []
    for s in SHAPES:
        a = rng.rand(*s) if positive else rng.randn(*s)
        out.append(torch.from_numpy(a.astype(np.float32)).to(dtype))
    return out


def _scalar(v, slot):
    return torch.tensor(v, dtype=torch.float32) if slot else v


@pytest.mark.parametrize("slot", [False, True], ids=["floats", "slots"])
@pytest.mark.parametrize("clip", [None, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["sgd", "sgd_mom", "adam"])
def test_multi_op_is_bitwise_the_per_parameter_op(opt, dtype, clip, slot):
    dt = getattr(torch, dtype)
    ws = _tensors(0, dt)
    ref_w, got_w = [w.clone() for w in ws], [w.clone() for w in ws]
    ref_s = [[torch.zeros_like(w) for w in ws] for _ in range(2)]
    got_s = [[torch.zeros_like(w) for w in ws] for _ in range(2)]
    lrs = [LR * (k + 1) for k in range(len(ws))]     # one rate per weight
    for step in range(3):
        gs = _tensors(10 + step, dt)
        for k, (w, g) in enumerate(zip(ref_w, gs)):
            if opt == "adam":
                _old_adam(w, g, ref_s[0][k], ref_s[1][k], lrs[k], WD,
                          RESCALE, clip)
            else:
                _old_sgd(w, g, lrs[k], WD, RESCALE, clip,
                         ref_s[0][k] if opt == "sgd_mom" else None, 0.9)
        sl = [_scalar(v, slot) for v in lrs]
        wd, rs = _scalar(WD, slot), _scalar(RESCALE, slot)
        if opt == "adam":
            topt.multi_adam_update(got_w, gs, got_s[0], got_s[1], sl, wd,
                                   rescale_grad=rs, clip_gradient=clip)
        elif opt == "sgd_mom":
            topt.multi_sgd_mom_update(got_w, gs, got_s[0], sl, wd, 0.9, rs,
                                      clip)
        else:
            topt.multi_sgd_update(got_w, gs, sl, wd, rs, clip)
    for k in range(len(ws)):
        assert torch.equal(got_w[k], ref_w[k]), k
        assert got_w[k].dtype == dt
        for got, ref in zip(got_s, ref_s):
            assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_parameter_ops_take_slots(dtype):
    """sgd_mom_update and adam_update give the same bits with Python
    floats and with 0-d float32 tensors holding the same values."""
    dt = getattr(torch, dtype)
    w0, g = _tensors(1, dt)[0], _tensors(2, dt)[0]
    for op, nstate in ((topt.sgd_mom_update, 1), (topt.adam_update, 2)):
        outs = []
        for slot in (False, True):
            w = w0.clone()
            st = [torch.zeros_like(w) for _ in range(nstate)]
            op(w, g, *st, lr=_scalar(LR, slot), wd=_scalar(WD, slot),
               rescale_grad=_scalar(RESCALE, slot))
            outs.append([w] + st)
        for a, b in zip(*outs):
            assert torch.equal(a, b), op.__name__


@pytest.mark.parametrize("opt", ["sgd", "sgd_mom", "adam"])
def test_mixed_dtype_group_is_bitwise_the_per_parameter_op(opt):
    """One group holding fp32 and bf16 weights: foreach over the fp32 ones,
    per-tensor ops over the bf16 ones, each bitwise its per-parameter op."""
    dts = [torch.float32, torch.bfloat16, torch.float32]
    ws = [w.to(dt) for w, dt in zip(_tensors(0, torch.float32), dts)]
    ref_w, got_w = [w.clone() for w in ws], [w.clone() for w in ws]
    ref_s = [[torch.zeros_like(w) for w in ws] for _ in range(2)]
    got_s = [[torch.zeros_like(w) for w in ws] for _ in range(2)]
    lrs = [_scalar(LR * (k + 1), True) for k in range(len(ws))]
    wd, rs = _scalar(WD, True), _scalar(RESCALE, True)
    for step in range(2):
        gs = [g.to(dt) for g, dt in zip(_tensors(10 + step, torch.float32),
                                        dts)]
        for k, (w, g) in enumerate(zip(ref_w, gs)):
            if opt == "adam":
                topt.adam_update(w, g, ref_s[0][k], ref_s[1][k], lr=lrs[k],
                                 wd=wd, rescale_grad=rs)
            elif opt == "sgd_mom":
                topt.sgd_mom_update(w, g, ref_s[0][k], lrs[k], 0.9, wd, rs)
            else:
                topt.sgd_update(w, g, lrs[k], wd, rs)
        if opt == "adam":
            topt.multi_adam_update(got_w, gs, got_s[0], got_s[1], lrs, wd,
                                   rescale_grad=rs)
        elif opt == "sgd_mom":
            topt.multi_sgd_mom_update(got_w, gs, got_s[0], lrs, wd, 0.9, rs)
        else:
            topt.multi_sgd_update(got_w, gs, lrs, wd, rs)
    for k, dt in enumerate(dts):
        assert got_w[k].dtype == dt
        assert torch.equal(got_w[k], ref_w[k]), k
        for got, ref in zip(got_s, ref_s):
            assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["sgd_mom", "adam"])
def test_one_shared_slot_is_bitwise_one_float(opt, dtype):
    """``lr`` and ``wd`` given once for the whole group (as
    ``parallel.ShardedTrainer`` gives them): a shared 0-d slot, a list of
    it, and the Python float give the same bits."""
    dt = getattr(torch, dtype)
    outs = []
    for how in ("float", "slot", "slot_list"):
        ws = _tensors(0, dt)
        st = [[torch.zeros_like(w) for w in ws] for _ in range(2)]
        lr, wd = (LR, WD) if how == "float" else (_scalar(LR, True),
                                                   _scalar(WD, True))
        if how == "slot_list":
            lr, wd = [lr] * len(ws), [wd] * len(ws)
        for step in range(2):
            gs = _tensors(10 + step, dt)
            if opt == "adam":
                topt.multi_adam_update(ws, gs, st[0], st[1], lr, wd,
                                       rescale_grad=RESCALE)
            else:
                topt.multi_sgd_mom_update(ws, gs, st[0], lr, wd, 0.9,
                                          RESCALE)
        outs.append(ws + st[0] + st[1])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)


def _net(dtype):
    net = mt.gluon.nn.HybridSequential(prefix="bulk_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(16, in_units=8, activation="relu"))
        net.add(mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(0))
    net.cast(dtype)
    return net


def _train(dtype, opt, opt_params, steps=3, per_parameter=False):
    """Three steps; ``per_parameter``: the update runs one op per
    parameter through the Updater, as the Trainer did before its sweep
    became one multi-tensor op."""
    net = _net(dtype)
    trainer = mt.gluon.Trainer(net.collect_params(), opt, dict(opt_params))
    rng = np.random.RandomState(3)
    for _ in range(steps):
        x = torch.from_numpy(rng.rand(6, 8).astype(np.float32)).to(
            getattr(torch, dtype))
        with mt.autograd.record():
            loss = ((net(x) - 1.0) ** 2).sum()
        loss.backward()
        if not per_parameter:
            trainer.step(6)
            continue
        trainer.optimizer.rescale_grad = trainer._scale / 6
        for i, p in enumerate(trainer._params):
            if p.grad_req != "null":
                trainer._updater(i, p.grad(), p.data())
    return net, trainer


def _state_tensors(trainer):
    out = []
    for i in sorted(trainer._updater.states):
        s = trainer._updater.states[i]
        out += [s] if isinstance(s, torch.Tensor) else list(s)
    return out


@pytest.mark.parametrize("aggregate_num", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
], ids=["sgd", "adam"])
def test_grouped_trainer_is_bitwise_the_per_parameter_sweep(
        opt, opt_params, dtype, aggregate_num):
    ref_net, ref_tr = _train(dtype, opt, opt_params, per_parameter=True)
    net, tr = _train(dtype, opt, dict(opt_params,
                                      aggregate_num=aggregate_num))
    for (name, a), b in zip(ref_net.collect_params().items(),
                            net.collect_params().values()):
        assert torch.equal(a, b), name
    for a, b in zip(_state_tensors(ref_tr), _state_tensors(tr)):
        assert torch.equal(a, b)
    assert tr.optimizer._index_update_count == \
        ref_tr.optimizer._index_update_count


@pytest.mark.parametrize("aggregate_num", [0, 1, 4])
def test_aggregate_num_is_kept_and_the_sweep_is_one_op(aggregate_num,
                                                        monkeypatch):
    net = _net("float32")
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"aggregate_num": aggregate_num, "momentum": 0.9})
    assert tr.optimizer.aggregate_num == aggregate_num
    groups = []
    monkeypatch.setattr(topt, "multi_sgd_mom_update",
                        lambda ws, *a, **k: groups.append(len(ws)))
    with mt.autograd.record():
        loss = net(torch.ones(2, 8)).sum()
    loss.backward()
    tr.step(2)
    assert groups == [4]
    scal = tr._scalars()
    assert len(scal) == 1 + 2 * 4 and scal[0] == 0.5
    with pytest.raises(ValueError, match="scalars for 4"):
        tr._update(scal[:-1])
