"""The port's elastic OOM retry (``mxnet_tpu_torch/resilience/elastic.py``
and ``parallel.ShardedTrainer.step``) and the pad-masked step, on the
CPU.

An out-of-memory step runs again as 2, 4, ... accumulated microbatches,
bitwise an explicit ``step(x, y, microbatches=N)`` (the same program: no
tolerance), and the shrink is sticky. The halving rule is
``mxnet_tpu``'s (``next_microbatches``, compared case by case). The
``length=`` step's loss is sum(loss * mask) / sum(mask), within 1e-6 of
the masked mean computed from the unmasked step's per-token losses (f32
sums in another order).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.resilience import elastic as jelastic  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture, parallel as tpar  # noqa: E402
from mxnet_tpu_torch.resilience import elastic, faults  # noqa: E402

X = np.random.RandomState(0).randint(0, 40, (8, 8))
Y = (5 * X + 3) % 40


def _trainer(seed=1):
    from mxnet_tpu_torch.gluon.model_zoo import transformer

    net = transformer.transformer_lm(vocab=40, units=16, num_heads=2,
                                     num_layers=2, max_len=8, impl="flash",
                                     prefix="tlm_")
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(
        seed))
    return tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adam", {"learning_rate": 0.01},
                               mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    elastic.reset_stats()
    yield
    faults.reset()


@pytest.mark.parametrize("times,n", [(1, 2), (2, 4)])
def test_oom_retry_is_bitwise_explicit_microbatches(times, n):
    """oom_step fails ``times`` attempts: the step runs as ``n``
    microbatches, equal to an explicit microbatches=n step, and stays
    there for the next step (no new OOM)."""
    tr, ref = _trainer(), _trainer()
    with faults.inject("oom_step", times=times), \
            pytest.warns(UserWarning, match="OOM"):
        loss = tr.step(X, Y)
    want = ref.step(X, Y, microbatches=n)
    assert float(loss) == float(want) and tr._elastic_n == n
    for k, v in ref.params.items():
        assert torch.equal(tr.params[k], v)
    st = elastic.stats()
    assert st["elastic_oom_events"] == times
    assert st["elastic_shrinks"] == times
    loss = tr.step(X, Y)
    want = ref.step(X, Y, microbatches=n)
    assert float(loss) == float(want)
    assert elastic.stats()["elastic_oom_events"] == times
    # a short batch that n does not split falls back, keeping the shrink
    tr.step(X[:3], Y[:3])
    assert tr._elastic_n == n


def test_explicit_schedules_and_the_kill_switch_surface_the_oom(
        monkeypatch):
    tr = _trainer()
    with faults.inject("oom_step"), pytest.raises(faults.InjectedOOM):
        tr.step(X, Y, microbatches=1)
    monkeypatch.setenv("MXNET_TPU_TORCH_ELASTIC", "0")
    with faults.inject("oom_step"), pytest.raises(faults.InjectedOOM):
        tr.step(X, Y)
    monkeypatch.delenv("MXNET_TPU_TORCH_ELASTIC")
    # nothing smaller than one row: the OOM surfaces
    with faults.inject("oom_step", times=None), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(faults.InjectedOOM):
            tr.step(X[:1], Y[:1])


def test_real_oom_errors_are_recognized():
    """A torch.OutOfMemoryError, also as the cause of a capture's
    CaptureError (the warm-up or capture ran out of memory), counts; other
    errors do not."""
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert elastic.is_oom_error(oom)
    try:
        try:
            raise oom
        except torch.OutOfMemoryError as e:
            raise capture.CaptureError("sharded_step: capturing failed") \
                from e
    except capture.CaptureError as wrapped:
        assert elastic.is_oom_error(wrapped)
    assert elastic.is_oom_error(faults.InjectedOOM("x"))
    assert not elastic.is_oom_error(ValueError("shape mismatch"))


@pytest.mark.parametrize("n,rows,shards", [
    (1, 8, 1), (2, 8, 1), (4, 8, 1), (8, 8, 1), (1, 12, 1), (2, 12, 1),
    (1, 8, 2), (2, 8, 2), (1, 6, 4), (1, 3, 1)])
def test_next_microbatches_as_mxnet_tpu(n, rows, shards):
    assert elastic.next_microbatches(n, rows, shards) == \
        jelastic.next_microbatches(n, rows, shards)


def test_min_microbatch_knob(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_ELASTIC_MIN_MICROBATCH", "4")
    assert elastic.next_microbatches(1, 8) == 2
    assert elastic.next_microbatches(2, 8) is None


def test_pad_masked_step():
    """length=: the loss is the mean over each row's first length tokens,
    within 1e-6 of the same masked mean of the per-token losses; full
    lengths give the unmasked step's loss bitwise."""
    length = np.array([8, 5, 1, 8, 3, 8, 7, 2], np.int32)
    tr = _trainer()
    out, _ = tr._fwd({k: v for k, v in tr.params.items()}, tr.aux,
                     torch.from_numpy(X))
    per = -torch.log_softmax(out.float(), -1).gather(
        -1, torch.from_numpy(Y)[..., None])[..., 0]
    mask = torch.arange(8)[None, :] < torch.from_numpy(length)[:, None]
    want = float((per * mask).sum() / mask.sum())
    got = float(tr.step(X, Y, length=length))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    a, b = _trainer(), _trainer()
    assert float(a.step(X, Y, length=np.full(8, 8, np.int32))) == \
        float(b.step(X, Y))
    for k, v in a.params.items():
        assert torch.equal(b.params[k], v)
    with pytest.raises(ValueError, match="one microbatch"):
        tr.step(X, Y, microbatches=2, length=length)
