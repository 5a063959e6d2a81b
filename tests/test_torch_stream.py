"""The port's streaming layer (``mxnet_tpu_torch/io/stream.py``) against
``mxnet_tpu/io/stream.py`` on the CPU: ``StreamBatchIter``'s batches and
resume tokens at ``num_parts`` 1 and 4, the mesh-shrink re-partition,
``for_pod``, the corrupt-record policies, a ``data_state`` checkpoint
restored across the two packages, the decoders, and ``DevicePrefetcher``'s
resume rule and row placement.

Tolerance: none; every comparison is bitwise. Both packages read the same
records in the same epoch order (the same seeded ``RandomState``) and
decode them with the same numpy / PIL code; tokens are plain dicts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu.io import stream as jstream  # noqa: E402
from mxnet_tpu.resilience import checkpoint as jckpt  # noqa: E402
from mxnet_tpu.resilience import faults as jfaults  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402
from mxnet_tpu_torch.io import stream as tstream  # noqa: E402
from mxnet_tpu_torch.observability import alerts, metrics, trace  # noqa: E402,E501
from mxnet_tpu_torch.parallel.trainer import BatchPlacement  # noqa: E402
from mxnet_tpu_torch.resilience import CheckpointManager  # noqa: E402
from mxnet_tpu_torch.resilience import faults as tfaults  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

N_RECORDS = 47
FEAT = 4


@pytest.fixture(autouse=True)
def _clean():
    tstream.reset_stats()
    jstream.reset_stats()
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """47 raw-float32 records over 4 uneven shards, written by the port:
    record i's row is i + 0.5 * arange(FEAT), its label i."""
    root = tmp_path_factory.mktemp("streamrec")
    bounds = [0, 9, 21, 30, N_RECORDS]
    paths = []
    for s in range(4):
        prefix = str(root / f"data-{s:05d}")
        w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i in range(bounds[s], bounds[s + 1]):
            row = (i + 0.5 * np.arange(FEAT)).astype(np.float32)
            w.write_idx(i, trec.pack((0, float(i), i, 0), row.tobytes()))
        w.close()
        paths.append(prefix + ".rec")
    return paths


def _iters(paths, **kw):
    kw.setdefault("shuffle", True)
    kw.setdefault("seed", 3)
    kw.setdefault("batch_size", 3)
    kw.setdefault("chunk_records", 5)
    t = tstream.StreamBatchIter(paths, decode=tstream.raw_decoder((FEAT,)),
                                **kw)
    j = jstream.StreamBatchIter(paths, decode=jstream.raw_decoder((FEAT,)),
                                **kw)
    return t, j


def _take(it, n):
    return [next(it) for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data, y.data)
        np.testing.assert_array_equal(x.label, y.label)
        assert x.data.dtype == y.data.dtype
        assert x.state == y.state


@pytest.mark.parametrize("num_parts", [1, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_and_tokens_match_mxnet_tpu(shards, num_parts, shuffle):
    """Every rank's batches and resume tokens, over two and a half epochs
    (reshuffles and the rolled-off tail included), are mxnet_tpu's."""
    for part in range(num_parts):
        t, j = _iters(shards, num_parts=num_parts, part_index=part,
                      shuffle=shuffle)
        assert t.batches_per_epoch == j.batches_per_epoch
        n = int(2.5 * t.batches_per_epoch)
        _same(_take(t, n), _take(j, n))
        assert t.position() == j.position()


def test_resume_tokens_restore_across_packages(shards):
    """A token taken mid-epoch restores the remaining stream bitwise in a
    fresh iterator of either package, across the epoch edge."""
    t, _ = _iters(shards, num_parts=4, part_index=2)
    run = _take(t, 9)
    token = run[3].state
    for lib in (tstream, jstream):
        fresh = lib.StreamBatchIter(shards, batch_size=3, shuffle=True,
                                    seed=3, chunk_records=5, num_parts=4,
                                    part_index=2,
                                    decode=lib.raw_decoder((FEAT,)))
        _same(_take(fresh.restore(token), 5), run[4:])
    with pytest.raises(ValueError, match="seed"):
        tstream.StreamBatchIter(shards, batch_size=3, shuffle=True, seed=4,
                                chunk_records=5,
                                decode=tstream.raw_decoder((FEAT,))
                                ).restore(token)


def test_mesh_shrink_repartitions_like_mxnet_tpu(shards):
    """A 4-rank token restored over 2 ranks: each survivor's batches are
    mxnet_tpu's, and together they take each remaining position of the
    epoch once."""
    t, _ = _iters(shards, num_parts=4, part_index=0)
    token = _take(t, 2)[-1].state
    seen = []
    for part in range(2):
        tt, jj = _iters(shards, num_parts=2, part_index=part)
        tt.restore(token)
        jj.restore(token)
        n = tt._batches_left()
        got = _take(tt, n)
        _same(got, _take(jj, n))
        seen += [int(v) for b in got for v in b.label]
    cursor = token["global_cursor"]
    order = tstream.RecordStream(shards, shuffle=True, seed=3,
                                 chunk_records=5).epoch_order(0)
    want = order[cursor:cursor + len(seen)]
    assert sorted(seen) == sorted(int(g) for g in want)


def test_for_pod_partitions_by_host(shards):
    """``for_pod`` takes the host's part of the stream, as mxnet_tpu's."""
    tp = tpar.mesh.PodTopology(2, 2, this_host=1)
    jp = jpar.mesh.PodTopology(2, 2, this_host=1)
    kw = dict(batch_size=4, shuffle=True, seed=1, epochs=1)
    t = tstream.StreamBatchIter.for_pod(tp, shards,
                                        decode=tstream.raw_decoder((FEAT,)),
                                        **kw)
    j = jstream.StreamBatchIter.for_pod(jp, shards,
                                        decode=jstream.raw_decoder((FEAT,)),
                                        **kw)
    assert (t.stream.part_index, t.stream.num_parts) == (1, 2)
    _same(list(t), list(j))
    with pytest.raises(ValueError, match="for_pod derives"):
        tstream.StreamBatchIter.for_pod(tp, shards, batch_size=2,
                                        decode=tstream.raw_decoder((FEAT,)),
                                        num_parts=4)


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_record_corrupt_policies(shards, policy):
    """An armed ``record_corrupt`` fails one read's CRC: ``raise`` raises
    RecordCorruptError naming the record, ``skip`` substitutes the row and
    counts ``io_records_corrupt``, the batch as mxnet_tpu's."""
    # one decode thread: the fault fires on the same read in both
    t, j = _iters(shards, shuffle=False, batch_size=5,
                  corrupt_policy=policy, decode_threads=1)
    out = []
    for it, faults, rec in ((t, tfaults, trec), (j, jfaults, jrec)):
        with faults.inject("record_corrupt", at_step=2):
            if policy == "raise":
                with pytest.raises(rec.RecordCorruptError) as err:
                    next(it)
                assert err.value.key is not None
                continue
            out.append(next(it))
    if policy == "skip":
        _same(out[:1], out[1:])
        assert tstream.stats()["io_records_corrupt"] == 1
        assert mt.profiler.dispatch_stats()["io_records_corrupt"] == 1
        assert out[0].data[2, 0] == out[0].data[0, 0]


def test_decoders_match(tmp_path):
    """image_decoder (resize, center crop, mean/std) and token_decoder with
    bucket edges give mxnet_tpu's arrays."""
    rng = np.random.RandomState(2)
    prefix = str(tmp_path / "img-00000")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(6):
        img = rng.randint(0, 256, (20 + 3 * i, 30, 3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img((0, float(i), i, 0), img, quality=85))
    w.close()
    kw = dict(batch_size=3, shuffle=False, epochs=1)
    dec = dict(data_shape=(3, 16, 16), resize=18, mean=[120.0, 110, 100],
               std=[50.0, 60, 70])
    _same(list(tstream.StreamBatchIter(
        prefix + ".rec", decode=tstream.image_decoder(**dec), **kw)),
        list(jstream.StreamBatchIter(
            prefix + ".rec", decode=jstream.image_decoder(**dec), **kw)))
    prefix = str(tmp_path / "tok-00000")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(8):
        toks = rng.randint(0, 100, 3 + 2 * i).astype(np.int32)
        w.write_idx(i, trec.pack((0, 0.0, i, 0), toks.tobytes()))
    w.close()
    got = []
    for lib in (tstream, jstream):
        it = lib.StreamBatchIter(prefix + ".rec", decode=lib.token_decoder(),
                                 bucket_edges=[8, 16, 32], **kw)
        got.append([(b.data, b.label, b.length) for b in it])
    for (d1, l1, n1), (d2, l2, n2) in zip(*got):
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(n1, n2)
    assert tstream.resolve_bucket_edges([16, 8, 8]) == (8, 16)


def test_prefetcher_resume_rule(shards):
    """A prefetcher's token is the last batch handed out, not the ring's:
    restoring it makes the rest again; depth 0 and 2 hand out the same
    tensors on the placement's device."""
    plain, _ = _iters(shards)
    run = _take(plain, 8)
    t, _ = _iters(shards)
    with mt.cpu(), tstream.DevicePrefetcher(t, depth=2) as pre:
        got = [next(pre) for _ in range(3)]
        token = pre.state()
    assert token == run[2].state
    for (x, y), b in zip(got, run):
        assert x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), b.data)
    t2, _ = _iters(shards)
    t2.restore(token)
    with mt.cpu():
        pre0 = tstream.DevicePrefetcher(t2, depth=0)
    for b in run[3:]:
        x, y = next(pre0)
        np.testing.assert_array_equal(x.numpy(), b.data)
        np.testing.assert_array_equal(y.numpy(), b.label)
    assert pre0.state() == run[-1].state
    pre0.restore(run[4].state)
    np.testing.assert_array_equal(next(pre0)[0].numpy(), run[5].data)


def test_prefetcher_places_rows_for_the_trainer(shards):
    """for_trainer takes the trainer's BatchPlacement; over more batch
    ranks than stream parts (for_pod) each rank gets its rows of the host
    batch, host-major; a stream of the wrong part raises."""
    net = mt.gluon.nn.Dense(1, in_units=FEAT)
    net.initialize(ctx=mt.cpu())
    tr = tpar.ShardedTrainer(net, mt.gluon.loss.L2Loss(), "sgd",
                             {"learning_rate": 0.1},
                             mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))
    assert tr.batch_sharding == BatchPlacement(torch.device("cpu"), 0, 1)
    t, _ = _iters(shards, batch_size=4)
    x, y = next(tstream.DevicePrefetcher.for_trainer(tr, t, depth=0))
    tr.step(x, y)
    whole = _take(_iters(shards, batch_size=4, num_parts=2,
                         part_index=1)[0], 2)
    for index in (2, 3):
        it, _ = _iters(shards, batch_size=4, num_parts=2, part_index=1)
        pre = tstream.DevicePrefetcher(
            it, sharding=BatchPlacement("cpu", index, 4), depth=2)
        for b in whole:
            x, y = next(pre)
            lo = 2 * (index - 2)
            np.testing.assert_array_equal(x.numpy(), b.data[lo:lo + 2])
            np.testing.assert_array_equal(y.numpy(), b.label[lo:lo + 2])
        pre.close()
    it, _ = _iters(shards, batch_size=4, num_parts=2, part_index=0)
    pre = tstream.DevicePrefetcher(it, sharding=BatchPlacement("cpu", 3, 4),
                                   depth=0)
    with pytest.raises(ValueError, match="does not hold batch rank 3"):
        next(pre)


def _mlp(lib, **init):
    n = lib.gluon.nn.HybridSequential(prefix="m_")
    with n.name_scope():
        n.add(lib.gluon.nn.Dense(3, in_units=FEAT))
    n.initialize(**init)
    return n


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_data_state_checkpoint_across_packages(shards, tmp_path, direction):
    """CheckpointManager.save(data_iter=) writes the stream's token into
    the manifest; the other package's restore_latest(data_iter=) rewinds
    its iterator to the same remaining batches. A checkpoint without a
    token refuses a data_iter before touching the trainer."""
    t, j = _iters(shards, num_parts=2, part_index=1)
    tt = tpar.ShardedTrainer(_mlp(mt, ctx=mt.cpu()),
                             mt.gluon.loss.L2Loss(), "sgd",
                             {"learning_rate": 0.1},
                             mesh=tpar.create_mesh({"dp": 1}, [mt.cpu()]))
    jt = jpar.ShardedTrainer(_mlp(mx), mx.gluon.loss.L2Loss(), "sgd",
                             {"learning_rate": 0.1})
    src, dst = (t, j) if direction == "port_to_ref" else (j, t)
    src_tr = tt if src is t else jt
    dst_tr = jt if src is t else tt
    save = (CheckpointManager if src is t else
            jckpt.CheckpointManager)(str(tmp_path))
    restore = (jckpt.CheckpointManager if src is t else
               CheckpointManager)(str(tmp_path))
    _take(src, 4)
    save.save(4, trainer=src_tr, data_iter=src)
    want = _take(src, 6)
    m = restore.restore_latest(trainer=dst_tr, data_iter=dst)
    assert m["data_state"]["global_cursor"] == want[0].state[
        "global_cursor"] - 2 * 3
    _same(_take(dst, 6), want)
    save.save(5, trainer=src_tr)
    with pytest.raises(ValueError, match="no data_state"):
        restore.restore_latest(trainer=dst_tr, data_iter=dst)


def test_input_stall_evidence_names_stream_positions(shards):
    """The input_stall_high probe's evidence carries the live iterators'
    positions; the stream counters reach dispatch_stats and reset."""
    t, _ = _iters(shards, num_parts=4, part_index=3)
    _take(t, 2)
    value, detail = alerts._probe_input_stall(alerts._EvalContext(
        0.0, None, None, input_stall=0.5))
    assert value == 0.5 and t.position() in detail["stream_positions"]
    stats = mt.profiler.dispatch_stats()
    assert stats["io_batches_streamed"] == 2
    mt.profiler.reset_dispatch_stats()
    assert tstream.stats()["io_batches_streamed"] == 0
    t.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(t)


def test_input_stall_gauge_reads_the_prefetchers_spans(shards):
    """The prefetcher's ``step.data_wait`` spans and the trainer's step
    spans give ``mxnet_tpu_input_stall_fraction``: inline decode (depth
    0) stalls the loop, within (0, 1]."""
    prev = trace.set_enabled(True)
    trace.clear()
    try:
        t, _ = _iters(shards, batch_size=4)
        with mt.cpu():
            pre = tstream.DevicePrefetcher(t, depth=0)
        for _ in range(3):
            x, _y = next(pre)
            with trace.span("train.sharded_step"):
                x.sum()
        waits = [s for s in trace.spans() if s["name"] == "step.data_wait"]
        stall = metrics.update_input_stall()
    finally:
        trace.set_enabled(prev)
        trace.clear()
    assert len(waits) == 3 and 0.0 < stall <= 1.0
