"""``gluon.data`` (``mxnet_tpu_torch/gluon/data/``) against ``mxnet_tpu`` on
the CPU, after ``tests/test_gluon_data.py``: datasets, samplers, the
``num_workers=0`` DataLoader (the workers: ``test_torch_dataloader_workers.py``),
the vision datasets' synthetic sets and the transforms. Every comparison is
bitwise under one ``np.random`` seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402


def _host(x):
    if isinstance(x, (tuple, list)):
        return tuple(_host(v) for v in x)
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _equal(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _both(fn, seed=0):
    out = {}
    for lib in (mx, mt):
        np.random.seed(seed)
        with lib.cpu():
            out[lib] = fn(lib)
    return out[mt], out[mx]


def test_array_and_simple_datasets():
    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    y = np.arange(10)

    def run(lib):
        ds = lib.gluon.data.ArrayDataset(lib.nd.array(x), y)
        simple = lib.gluon.data.SimpleDataset(list(range(10)))
        return ([ds[i] for i in range(10)]
                + [simple.transform(lambda v: v * 2)[3],
                   len(simple.filter(lambda v: v % 2)),
                   [simple.shard(3, k)[0] for k in range(3)],
                   len(simple.take(4)),
                   lib.gluon.data.ArrayDataset(
                       lib.nd.array(np.arange(5.0)))[2]])
    a, b = _both(run)
    for u, v in zip(a, b):
        if isinstance(u, (int, list)):
            assert u == v
        else:
            _equal(u, v)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers(last_batch):
    def run(lib):
        s = lib.gluon.data.BatchSampler(
            lib.gluon.data.RandomSampler(10), 3, last_batch)
        return [list(s), list(s), len(s),
                list(lib.gluon.data.SequentialSampler(4, start=2))]
    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches(shuffle):
    """Batches of (array, label) samples, tuples stacked field by field;
    the port's batches land on the loader's context and are counted."""
    x = np.random.RandomState(1).rand(13, 2, 3).astype(np.float32)
    y = np.arange(13, dtype=np.int32)

    def run(lib):
        ds = lib.gluon.data.ArrayDataset(lib.nd.array(x), y)
        loader = lib.gluon.data.DataLoader(ds, batch_size=4, shuffle=shuffle)
        assert len(loader) == 4
        return [b for _ in range(2) for b in loader]
    mt.gluon.data.dataloader.reset_stats()
    a, b = _both(run)
    assert len(a) == len(b) == 8
    for u, v in zip(a, b):
        _equal(u, v)
    st = mt.gluon.data.dataloader.stats()
    assert st["dataloader_batches"] == 8
    assert st["dataloader_h2d_copies"] == 0      # the loader's ctx is cpu


@pytest.mark.parametrize("cls,train", [("MNIST", True), ("FashionMNIST", False),
                                       ("CIFAR10", True), ("CIFAR100", False)])
def test_synthetic_vision_datasets(cls, train, tmp_path):
    """The synthetic sets of both packages, drawn from the same seeds."""
    def run(lib):
        ds = getattr(lib.gluon.data.vision, cls)(root=str(tmp_path),
                                                 train=train)
        return [len(ds)] + [ds[i] for i in (0, 5, len(ds) - 1)]
    a, b = _both(run)
    assert a[0] == b[0]
    for u, v in zip(a[1:], b[1:]):
        _equal(u, v)


def test_synthetic_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_SYNTH_DATA", "0")
    with pytest.raises(RuntimeError, match="MXNET_TPU_TORCH_SYNTH_DATA"):
        mt.gluon.data.vision.MNIST(root=str(tmp_path))


def _transform_lists(T):
    return [
        [T.ToTensor()],
        [T.ToTensor(), T.Normalize((0.5, 0.4, 0.3), (0.2, 0.2, 0.25))],
        [T.Cast("float32")],
        [T.Resize(24), T.CenterCrop(20), T.ToTensor()],
        [T.RandomFlipLeftRight(), T.RandomFlipTopBottom(),
         T.RandomCrop(28, pad=2), T.RandomResizedCrop(16)],
        [T.RandomBrightness(0.2), T.RandomContrast(0.2),
         T.RandomSaturation(0.2), T.RandomLighting(0.1)],
    ]


@pytest.mark.parametrize("k", range(6))
def test_transforms_bitwise(k, tmp_path):
    def run(lib):
        T = lib.gluon.data.vision.transforms
        ds = lib.gluon.data.vision.CIFAR10(root=str(tmp_path), train=False)
        f = T.Compose(_transform_lists(T)[k])
        return [f(ds[i][0]) for i in range(12)]
    a, b = _both(run, seed=k)
    for u, v in zip(a, b):
        _equal(u, v)


def test_cifar10_dist_pipeline_epoch(tmp_path):
    """cifar10_dist.py's input path for one worker's shard: transform_first
    (ToTensor), a SimpleDataset of the shard, a shuffled DataLoader; one
    epoch, bitwise."""
    def run(lib):
        T = lib.gluon.data.vision.transforms
        ds = lib.gluon.data.vision.CIFAR10(root=str(tmp_path), train=False) \
            .transform_first(T.Compose([T.ToTensor()]))
        shard = lib.gluon.data.SimpleDataset(
            [ds[i] for i in range(1, len(ds), 2)])
        return list(lib.gluon.data.DataLoader(shard, batch_size=32,
                                              shuffle=True))
    a, b = _both(run, seed=3)
    assert len(a) == len(b) == 8
    for u, v in zip(a, b):
        _equal(u, v)
