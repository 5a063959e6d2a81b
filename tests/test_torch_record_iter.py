"""The port's RecordIO image readers against ``mxnet_tpu``'s on the CPU:
``io.ImageRecordIter`` (Python and native backends), ``image.ImageIter``
and ``ImageDetIter`` from a ``.rec``, and ``gluon.data.RecordFileDataset``
/ ``ImageRecordDataset``; and the rest of ``io/io.py``'s iterators
(``ResizeIter``, ``PrefetchingIter``, ``CSVIter``, ``MNISTIter``).

Tolerance: none; every comparison is bitwise. Both sides decode with the
same PIL (the Python backends, ImageIter, the datasets) or run the same
``src/io/record_pipeline.cc`` (the native backends; skipped, with the
reason, where the library does not build here), and draw from the same
seeded ``RandomState`` streams.
"""
import os
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu.io import record_pipeline as jrp  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402
from mxnet_tpu_torch.io import record_pipeline as trp  # noqa: E402

N = 23


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's iterators land batches on the current context."""
    with mt.cpu():
        yield


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """23 JPEGs of 12-40 px sides drawn from RandomState(0), labels
    i % 5, packed by the port's writer (prefix of the .rec/.idx)."""
    prefix = str(tmp_path_factory.mktemp("imgrec") / "data")
    rng = np.random.RandomState(0)
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(N):
        h, wd = rng.randint(12, 41, 2)
        img = rng.randint(0, 256, (h, wd, 3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img((0, float(i % 5), i, 0), img,
                                     quality=90))
    w.close()
    return prefix


CASES = {
    "center": dict(),
    "shuffle_crop_mirror": dict(shuffle=True, rand_crop=True,
                                rand_mirror=True, resize=20, seed=3),
    "resized_crop_norm": dict(shuffle=True, random_resized_crop=True,
                              rand_mirror=True, mean_r=123.68,
                              mean_g=116.28, mean_b=103.53, std_r=58.395,
                              std_g=57.12, std_b=57.375, seed=11),
    "part_1_of_2": dict(num_parts=2, part_index=1, shuffle=True, seed=5),
}


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (d1, l1, p1), (d2, l2, p2) in zip(a, b):
        assert d1.dtype == d2.dtype == np.float32
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(l1, l2)
        assert p1 == p2


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_pipeline_bitwise_mxnet_tpu(rec, case):
    """The port's Python backend: the same batches, labels and pads as
    mxnet_tpu's, two epochs (the reshuffle included), from the .idx."""
    kw = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
              data_shape=(3, 16, 16), batch_size=5, preprocess_threads=3,
              force_python=True, **CASES[case])
    it = trp.ImageRecordIter(**kw)
    assert it.backend == "python" and len(it) == len(jrp.ImageRecordIter(
        **kw))
    _same(_batches(it), _batches(jrp.ImageRecordIter(**kw)))


def test_python_pipeline_scan_matches_index(rec):
    """Without the .idx (a framing scan) the batches are the same."""
    kw = dict(data_shape=(3, 16, 16), batch_size=4, force_python=True,
              shuffle=True, rand_mirror=True, seed=2)
    a = trp.ImageRecordIter(rec + ".rec", **kw)
    b = trp.ImageRecordIter(rec + ".rec", path_imgidx=rec + ".idx", **kw)
    _same(_batches(a, 1), _batches(b, 1))


@pytest.mark.parametrize("case", ["center", "shuffle_crop_mirror"])
def test_native_pipeline_bitwise_mxnet_tpu(rec, case):
    """The port's native backend (its own build of src/io) against
    mxnet_tpu's native backend: bitwise; the backend is named."""
    if not trp.native_available():
        pytest.skip(f"native pipeline does not build here: "
                    f"{trp.build_error()}")
    if not jrp.native_available():
        pytest.skip("mxnet_tpu's native pipeline does not build here")
    kw = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
              data_shape=(3, 16, 16), batch_size=5, preprocess_threads=2,
              **CASES[case])
    it = trp.ImageRecordIter(**kw)
    assert it.backend == "native"
    assert os.path.dirname(trp._lib_path()).endswith(
        os.path.join("mxnet_tpu_torch", "_build"))
    _same(_batches(it), _batches(jrp.ImageRecordIter(**kw)))


def test_alias_and_label_width(rec):
    """``mx.io.ImageRecordIter`` is the port's; label_width 2 gives
    (batch, 2) labels (the second column 0), as mxnet_tpu's."""
    kw = dict(path_imgrec=rec + ".rec", data_shape=(1, 8, 8),
              batch_size=6, label_width=2, force_python=True)
    it = mt.io.ImageRecordIter(**kw)
    assert isinstance(it, trp.ImageRecordIter)
    assert it.provide_label[0].shape == (6, 2)
    _same(_batches(it, 1), _batches(mx.io.ImageRecordIter(**kw), 1))


def _seed(s):
    random.seed(s)
    np.random.seed(s)


@pytest.mark.parametrize("with_idx", [True, False])
def test_image_iter_from_rec(rec, tmp_path, with_idx):
    """``ImageIter(path_imgrec=)`` with shuffle and random crops and
    mirrors: mxnet_tpu's batches under the same seeds, by key through
    the .idx or in file order without it."""
    path = rec + ".rec"
    if not with_idx:
        path = str(tmp_path / "noidx.rec")
        with open(rec + ".rec", "rb") as f, open(path, "wb") as g:
            g.write(f.read())
    kw = dict(batch_size=4, data_shape=(3, 12, 12), path_imgrec=path,
              shuffle=with_idx, rand_crop=True, rand_mirror=True,
              resize=16, mean=True, std=True)
    out = []
    for lib in (mt, mx):
        _seed(7)
        with lib.cpu():
            it = lib.image.ImageIter(**kw)
            got = []
            for _ in range(2):
                for b in it:
                    got.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                                b.pad))
                it.reset()
        out.append(got)
    _same(*out)
    assert len(out[0]) == 2 * ((N + 3) // 4)


def test_image_record_dataset(rec):
    """RecordFileDataset's raw records and ImageRecordDataset's decoded
    (uint8 HWC, on cpu) images and labels are mxnet_tpu's, with and
    without a transform."""
    traw = mt.gluon.data.RecordFileDataset(rec + ".rec")
    jraw = mx.gluon.data.RecordFileDataset(rec + ".rec")
    assert len(traw) == len(jraw) == N
    assert [traw[i] for i in range(N)] == [jraw[i] for i in range(N)]
    t = mt.gluon.data.vision.ImageRecordDataset(rec + ".rec")
    j = mx.gluon.data.vision.ImageRecordDataset(rec + ".rec")
    for i in (0, 7, N - 1):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.context == mt.cpu() and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert tl == jl == float(i % 5)
    tg = mt.gluon.data.vision.ImageRecordDataset(
        rec + ".rec", flag=0, transform=lambda x, y: (x.asnumpy()[::2], y))
    jg = mx.gluon.data.vision.ImageRecordDataset(
        rec + ".rec", flag=0, transform=lambda x, y: (x.asnumpy()[::2], y))
    np.testing.assert_array_equal(tg[3][0], jg[3][0])


def test_image_det_iter_from_rec(tmp_path):
    """``ImageDetIter(path_imgrec=)``: a .rec whose headers carry the det
    label [A, B, (cls x1 y1 x2 y2)*N] gives the batches mxnet_tpu's
    ImageDetIter gives from the same image files listed in a .lst, random
    crops, pads and flips included."""
    from PIL import Image

    rng = np.random.RandomState(4)
    prefix = str(tmp_path / "det")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    lines = []
    for i in range(7):
        img = rng.randint(0, 256, (30 + i, 40, 3)).astype(np.uint8)
        name = f"im{i}.jpg"
        Image.fromarray(img).save(tmp_path / name, quality=92)
        objs = [[i % 3, 0.1, 0.2, 0.6, 0.7]] + \
            ([[1, 0.3, 0.1, 0.9, 0.5]] if i % 2 else [])
        label = [2.0, 5.0] + [v for o in objs for v in o]
        w.write_idx(i, trec.pack((0, label, i, 0),
                                 (tmp_path / name).read_bytes()))
        lines.append("\t".join([str(i)] + [str(v) for v in label] + [name]))
    w.close()
    (tmp_path / "det.lst").write_text("\n".join(lines) + "\n")
    kw = dict(batch_size=3, data_shape=(3, 24, 24), shuffle=True,
              rand_crop=0.5, rand_pad=0.5, rand_mirror=True)
    _seed(9)
    with mt.cpu():
        t = mt.image.ImageDetIter(path_imgrec=prefix + ".rec", **kw)
        tb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in t]
    _seed(9)
    j = mx.image.ImageDetIter(path_imglist=str(tmp_path / "det.lst"),
                              path_root=str(tmp_path), **kw)
    jb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in j]
    assert t.max_objects == j.max_objects == 2
    _same(tb, jb)


def test_io_iterators(rec, tmp_path):
    """ResizeIter over the record iterator, PrefetchingIter, CSVIter and
    MNISTIter (idx files, gzipped) give mxnet_tpu's batches."""
    import gzip
    import struct

    rng = np.random.RandomState(3)
    np.savetxt(tmp_path / "d.csv", rng.rand(10, 6), delimiter=",")
    np.savetxt(tmp_path / "l.csv", rng.randint(0, 3, 10), delimiter=",")
    imgs = rng.randint(0, 256, (9, 4, 5)).astype(np.uint8)
    with gzip.open(tmp_path / "i.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 9, 4, 5) + imgs.tobytes())
    with gzip.open(tmp_path / "l.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 9) + bytes(range(9)))

    def run(lib):
        kw = dict(path_imgrec=rec + ".rec", data_shape=(3, 8, 8),
                  batch_size=5, force_python=True)
        out = [lib.io.ResizeIter(lib.io.ImageRecordIter(**kw), 7),
               lib.io.PrefetchingIter(lib.io.ImageRecordIter(**kw)),
               lib.io.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                              label_csv=str(tmp_path / "l.csv"),
                              batch_size=4),
               lib.io.MNISTIter(str(tmp_path / "i.gz"),
                                str(tmp_path / "l.gz"), batch_size=4,
                                shuffle=False, flat=True)]
        return [[(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                 for b in it] for it in out]

    with mt.cpu():
        got = run(mt)
    for a, b in zip(got, run(mx)):
        _same(a, b)
    assert [len(g) for g in got] == [7, (N + 4) // 5, 3, 3]

