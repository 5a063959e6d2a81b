"""The port's DataLoader with workers (``num_workers > 0``: forked worker
processes over shared memory, or the thread pool) against its own
``num_workers=0`` path and ``mxnet_tpu``'s DataLoader, on the CPU.

Tolerance: none; every comparison is bitwise. The workers run the same
dataset code (PIL decode, the transforms' numpy arithmetic) as the serial
path, and the batches cross shared memory byte for byte. Forks stay few
and small: this process also holds JAX, and a worker runs host code only.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402
from mxnet_tpu_torch.gluon.data import dataloader as tdl  # noqa: E402
from mxnet_tpu_torch.observability import trace  # noqa: E402

N = 23
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """23 JPEGs of 16 x 16 from RandomState(1), labels i % 4."""
    prefix = str(tmp_path_factory.mktemp("dlrec") / "data")
    rng = np.random.RandomState(1)
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(N):
        img = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img((0, float(i % 4), i, 0), img))
    w.close()
    return prefix + ".rec"


def _dataset(lib, path):
    tf = lib.gluon.data.vision.transforms
    return lib.gluon.data.vision.ImageRecordDataset(path).transform_first(
        tf.Compose([tf.ToTensor(), tf.Normalize(MEAN, STD)]))


def _run(lib, ds, seed=3, batch_size=5, **kw):
    np.random.seed(seed)
    with lib.cpu():
        return [tuple(x.asnumpy() for x in b) for b in
                lib.gluon.data.DataLoader(ds, batch_size=batch_size,
                                          shuffle=True, **kw)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype, (u.dtype, v.dtype)
            np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def serial(rec):
    out = _run(mt, _dataset(mt, rec))
    _same(out, _run(mx, _dataset(mx, rec)))
    return out


@pytest.mark.parametrize("mode", [dict(num_workers=2),
                                  dict(num_workers=2, thread_pool=True),
                                  dict(num_workers=3, pin_memory=True)],
                         ids=["processes", "threads", "processes_pin"])
def test_workers_equal_serial_and_mxnet_tpu(rec, serial, mode):
    """Worker processes and the thread pool give the batches of the
    serial path, which are mxnet_tpu's (ImageRecordDataset, ToTensor,
    Normalize, shuffled, a short last batch); ``pin_memory`` on a CPU
    context changes nothing."""
    _same(_run(mt, _dataset(mt, rec), **mode), serial)


def test_record_reads_from_many_threads(rec):
    """A RecordFileDataset read by more threads than cores, the switch
    interval shortened, gives every record's bytes (one file handle a
    thread: no interleaved seek and read)."""
    import sys

    ds = mt.gluon.data.RecordFileDataset(rec)
    want = [ds[i] for i in range(len(ds))]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with mt.cpu():
            for _ in range(8):
                assert list(mt.gluon.data.DataLoader(
                    ds, batch_size=1, num_workers=16, thread_pool=True,
                    batchify_fn=lambda b: b[0], timeout=30)) == want
    finally:
        sys.setswitchinterval(prev)


class _KillOnce:
    """Top-level (forked workers resolve it): a worker that reads index
    ``victim`` the first time SIGKILLs itself mid-batch."""

    def __init__(self, base, victim, marker, parent):
        self.base, self.victim = base, victim
        self.marker, self.parent = marker, parent

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i == self.victim and os.getpid() != self.parent and \
                not os.path.exists(self.marker):
            open(self.marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return self.base[i]


@pytest.mark.parametrize("where", ["in_getitem", "from_outside"])
def test_killed_worker_is_respawned(rec, serial, tmp_path, where):
    """A worker SIGKILLed mid-epoch, inside a sample's read or by another
    process after the first batch (wherever it then was): it is respawned
    and counted, its batches are resubmitted, and every batch arrives
    once, in order, equal to the serial ones. Killed in a read, it leaves
    no shared-memory block behind (what it sent before is taken); killed
    from outside it may die inside an export, whose blocks the resource
    tracker reclaims at exit."""
    import multiprocessing as mp

    tdl.reset_stats()
    if where == "in_getitem":
        ds, bs, want = _KillOnce(_dataset(mt, rec), 12,
                                 str(tmp_path / "killed"),
                                 os.getpid()), 5, serial
    else:   # 12 batches: 8 still to come when the first arrives
        ds, bs = _dataset(mt, rec), 2
        want = _run(mt, ds, batch_size=bs)
    np.random.seed(3)
    got = []
    others = {c.pid for c in mp.active_children()}
    blocks = _shm_names()
    with mt.cpu(), pytest.warns(UserWarning,
                                match="died mid-epoch; respawned"):
        for b in mt.gluon.data.DataLoader(ds, batch_size=bs, shuffle=True,
                                          num_workers=2, prefetch=4):
            got.append(tuple(x.asnumpy() for x in b))
            if where == "from_outside" and len(got) == 1:
                victim = next(c for c in mp.active_children()
                              if c.pid not in others)
                os.kill(victim.pid, signal.SIGKILL)
                victim.join(10)     # dead before the loader looks again
    _same(got, want)
    assert tdl.stats()["dataloader_respawns"] == 1
    if where == "in_getitem":
        assert _shm_names() == blocks


class _AlwaysDies:
    """Every worker dies on its first sample (the parent's probe of
    sample 0 reads it alive)."""

    def __init__(self):
        self.parent = os.getpid()

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if os.getpid() != self.parent:
            os.kill(os.getpid(), signal.SIGKILL)
        return np.float32(i)


def test_respawn_budget_and_worker_errors():
    """Workers that keep dying exhaust the respawn budget and raise; a
    dataset error in a worker raises naming the batch."""
    with mt.cpu(), pytest.raises(RuntimeError, match="respawn budget"):
        with pytest.warns(UserWarning):
            list(mt.gluon.data.DataLoader(_AlwaysDies(), batch_size=2,
                                          num_workers=1,
                                          max_worker_respawns=1))
    with mt.cpu(), pytest.raises(RuntimeError, match="failed on batch 1"):
        list(mt.gluon.data.DataLoader(_Failing(), batch_size=2,
                                      num_workers=2))


class _Failing:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("bad sample 3")
        return np.float32(i)


class _Unexportable:
    def __array__(self, *a, **k):
        raise MemoryError("no room in /dev/shm")


def _shm_names():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def test_partial_export_is_cleaned_up():
    """A batch whose second array fails to export (as /dev/shm running
    out would) leaves no segment behind, and the worker reports the
    error instead of a descriptor (the worker loop run in this process
    over a pipe)."""
    import multiprocessing as mp

    parent, child = mp.Pipe()
    parent.send((0, [0, 1]))
    parent.send(None)
    before = _shm_names()
    threads = torch.get_num_threads()
    try:
        tdl._mp_worker(list(range(4)),
                       lambda s: (np.ones(1024, np.float32), _Unexportable()),
                       child)
    finally:
        torch.set_num_threads(threads)
    j, status, msg = parent.recv()
    assert (j, status) == (0, "error") and "no room" in msg
    assert _shm_names() == before


def test_batch_larger_than_dev_shm_raises(monkeypatch):
    """A batch that does not fit in /dev/shm's free space fails in the
    worker with ENOSPC before any block is written, and the loader raises
    naming it (no SIGBUS, no hang)."""
    monkeypatch.setattr(tdl, "_shm_free", lambda: 100)
    before = _shm_names()
    with mt.cpu(), pytest.raises(RuntimeError,
                                 match="does not fit in /dev/shm"):
        list(mt.gluon.data.DataLoader(
            mt.gluon.data.SimpleDataset(list(range(64))), batch_size=32,
            num_workers=2))
    assert _shm_names() == before


def test_data_wait_spans_and_counters(rec):
    """Each wait is spanned ``step.data_wait``, the one that ends the
    epoch too (as mxnet_tpu's); the counters reach the profiler's
    dispatch_stats."""
    prev = trace.set_enabled(True)
    trace.clear()
    tdl.reset_stats()
    try:
        with mt.cpu():
            n = len(list(mt.gluon.data.DataLoader(
                _dataset(mt, rec), batch_size=6, num_workers=2)))
        waits = [s for s in trace.spans() if s["name"] == "step.data_wait"]
    finally:
        trace.set_enabled(prev)
        trace.clear()
    assert n == 4 and len(waits) == 5
    assert mt.profiler.dispatch_stats()["dataloader_batches"] == 4


class _OnCard:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return mt.nd.array([float(i)], ctx=mt.gpu(0))


@pytest.mark.cuda
def test_dataset_on_the_card_goes_to_threads():
    """A dataset yielding arrays on the card cannot cross a fork: the
    loader warns and batches on the thread pool, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dataset's arrays live there")
    with mt.gpu(0):
        loader = mt.gluon.data.DataLoader(_OnCard(), batch_size=2,
                                          num_workers=2)
        with pytest.warns(UserWarning, match="cannot cross a fork"):
            got = [b.asnumpy() for b in loader]
    np.testing.assert_array_equal(np.concatenate(got).ravel(),
                                  np.arange(6, dtype=np.float32))
