"""``mx.nd.image`` (``mxnet_tpu_torch/ops/image_ops.py``) and ``mx.image``
(``mxnet_tpu_torch/image/``) against ``mxnet_tpu`` on the CPU (after
``tests/test_image_ops.py`` and ``tests/test_detection.py``).

Tolerances: the deterministic image ops within 1e-6 of max|ref| (float)
or 1 (uint8: ``resize``'s float sum rounds once more or less before the
cast); the random ones draw from the port's generator, so they are held to
their contract (which images flip, the factor's range), not to the
reference's bits. The iterators and augmenters are bitwise under one
``random`` / ``np.random`` seed, except ``RandomGrayAug``'s 3x3 product
(XLA's dot sums in another order: 1e-6 of max|ref|).
"""
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from _torch_parity import run_both  # noqa: E402


def _img(h=8, w=10, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, c)) \
        .astype(np.uint8)


def _batch(n=4, **kw):
    return np.stack([_img(seed=i, **kw) for i in range(n)])


DETERMINISTIC = {
    "_image_to_tensor": [([_img()], {}), ([_batch()], {})],
    "_image_normalize": [([np.random.RandomState(0).rand(3, 4, 5)
                           .astype(np.float32)],
                          {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.2)})],
    "_image_flip_left_right": [([_img()], {}), ([_batch()], {})],
    "_image_flip_top_bottom": [([_img()], {}), ([_batch()], {})],
    "_image_crop": [([_img()], {"x": 2, "y": 1, "width": 5, "height": 4}),
                    ([_batch()], {"x": 1, "y": 2, "width": 3, "height": 5})],
    "_image_resize": [([_batch()], {"size": (5, 4)}),
                      ([_batch().astype(np.float32)], {"size": (20, 13)}),
                      ([_batch().astype(np.float32)], {"size": (7, 16)}),
                      ([_img()], {"size": 3, "interp": 0}),
                      ([_img()], {"size": (20, 13), "interp": 0})],
    "_image_adjust_lighting": [([_img().astype(np.float32)],
                                {"alpha": (0.1, -0.2, 0.3)})],
}
RANDOM = ("_image_random_flip_left_right", "_image_random_flip_top_bottom",
          "_image_random_brightness", "_image_random_contrast",
          "_image_random_saturation", "_image_random_lighting")
CANONICAL = tuple(DETERMINISTIC) + RANDOM
CASE_NAMES = set(CANONICAL) | {n[1:] for n in CANONICAL}


@pytest.mark.parametrize("name", sorted(
    n for n in CASE_NAMES if n.lstrip("_") in
    {c.lstrip("_") for c in DETERMINISTIC}))
def test_deterministic_op_against_mxnet_tpu(name):
    canon = name if name.startswith("_") else "_" + name
    for inputs, params in DETERMINISTIC[canon]:
        j, t, _, _ = run_both(name, inputs, params)
        for a, b in zip(t, j):
            assert a.shape == b.shape
            tol = 1.0 if inputs[0].dtype == np.uint8 and \
                canon == "_image_resize" else 1e-6 * max(np.abs(b).max(), 1)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def _short(name):
    return name[len("_image_"):] if name.startswith("_image_") else \
        name[len("image_"):]


@pytest.mark.parametrize("name", sorted(
    n for n in CASE_NAMES if n.lstrip("_") in {c.lstrip("_") for c in RANDOM}))
def test_random_op_contract(name):
    """The random ops on both packages keep their contract: a flip applies
    to whole images, p=0.5 mixes both, the same seed repeats the draw;
    factors stay in [min, max]; lighting is a constant shift an image."""
    xb = _batch(n=16)
    for lib in (mx, mt):
        with lib.cpu():
            fn = getattr(lib.nd, name)
            short = _short(name)
            lib.random.seed(0)
            if "flip" in short:
                out = fn(lib.nd.array(xb, dtype="uint8")).asnumpy()
                axis = 2 if "left_right" in short else 1
                flipped = (out == np.flip(xb, axis)).all(axis=(1, 2, 3))
                same = (out == xb).all(axis=(1, 2, 3))
                assert (flipped | same).all() and flipped.any() and \
                    same.any()
                lib.random.seed(0)
                again = fn(lib.nd.array(xb, dtype="uint8")).asnumpy()
                np.testing.assert_array_equal(again, out)
            elif short == "random_lighting":
                x = xb.astype(np.float32)
                out = fn(lib.nd.array(x), alpha_std=0.1).asnumpy()
                delta = out - x
                assert not np.allclose(out, x)
                np.testing.assert_allclose(
                    delta, np.broadcast_to(delta[:, :1, :1, :], delta.shape),
                    atol=1e-3)
            elif short == "random_brightness":
                x = np.full((4, 4, 3), 100.0, np.float32)
                out = fn(lib.nd.array(x), min_factor=0.8,
                         max_factor=1.2).asnumpy()
                assert 80.0 - 1e-3 <= out.mean() <= 120.0 + 1e-3
            elif short == "random_contrast":
                x = np.random.RandomState(0).rand(6, 6, 3).astype(np.float32)
                out = fn(lib.nd.array(x), min_factor=0.0,
                         max_factor=0.0).asnumpy()
                gray = (x * [0.299, 0.587, 0.114]).sum(-1).mean()
                np.testing.assert_allclose(out, gray, atol=1e-5)
            else:
                gray = np.full((4, 4, 3), 0.5, np.float32)
                out = fn(lib.nd.array(gray), min_factor=0.1,
                         max_factor=1.9).asnumpy()
                np.testing.assert_allclose(out, 0.5, atol=1e-3)


def test_nd_image_namespace():
    with mt.cpu():
        x = mt.nd.array(_img(), dtype="uint8")
        out = mt.nd.image.to_tensor(x)
        assert out.shape == (3, 8, 10) and "to_tensor" in dir(mt.nd.image)


# ---------------------------------------------------------------- mx.image
@pytest.fixture(scope="module")
def det_dataset(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("det")
    entries = []
    rng = np.random.RandomState(3)
    for i in range(10):
        img = np.full((32, 40, 3), 30, np.uint8)
        x0, y0 = rng.randint(2, 12, 2)
        w, h = rng.randint(8, 16, 2)
        img[y0:y0 + h, x0:x0 + w] = 220
        Image.fromarray(img).save(root / f"d{i}.jpg", quality=95)
        rows = [[i % 3, x0 / 40, y0 / 32, (x0 + w) / 40, (y0 + h) / 32]]
        rows += [[1, 0.1, 0.1, 0.3, 0.4]] * (i % 2)
        entries.append((np.array(rows, np.float32), f"d{i}.jpg"))
    return str(root), entries


def _epochs(lib, make, n_epochs=2, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    with lib.cpu():
        it = make(lib)
        out = []
        for _ in range(n_epochs):
            it.reset()
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
    return out


def _same(a, b, atol=0.0):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x[2] == y[2]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_allclose(x[0], y[0], rtol=0,
                                   atol=atol * max(np.abs(y[0]).max(), 1))


def test_image_det_iter_epochs_bitwise(det_dataset):
    """train_ssd.py's iterator (shuffle, rand_mirror) over two epochs: the
    same batches, pads and labels, bit for bit."""
    root, entries = det_dataset

    def make(lib):
        return lib.image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                      imglist=entries, path_root=root,
                                      shuffle=True, rand_mirror=True)
    _same(_epochs(mt, make), _epochs(mx, make))


def test_image_det_iter_every_augmenter(det_dataset):
    """Crop, pad, the color jitters, PCA noise, gray and normalization."""
    root, entries = det_dataset

    def make(lib):
        return lib.image.ImageDetIter(
            batch_size=3, data_shape=(3, 16, 16), imglist=entries,
            path_root=root, shuffle=True, rand_mirror=True, rand_crop=0.5,
            rand_pad=0.5, min_object_covered=0.5, brightness=0.2,
            contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1,
            rand_gray=0.3, mean=True, std=True)
    _same(_epochs(mt, make), _epochs(mx, make), atol=1e-6)


def test_image_det_iter_lst_file_and_label_shape(det_dataset, tmp_path):
    """The det .lst reader and sync_label_shape."""
    root, entries = det_dataset
    lst = tmp_path / "train.lst"
    with open(lst, "w") as f:
        for i, (lab, path) in enumerate(entries):
            vals = "\t".join(f"{v:.6f}" for v in lab.ravel())
            f.write(f"{i}\t2\t5\t{vals}\t{path}\n")

    def make(lib):
        it = lib.image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                    path_imglist=str(lst), path_root=root,
                                    last_batch_handle="discard")
        other = lib.image.ImageDetIter(batch_size=2, data_shape=(3, 8, 8),
                                       imglist=[(np.zeros((3, 6)), "d0.jpg")],
                                       path_root=root)
        it.sync_label_shape(other)
        assert it.provide_label[0].shape == (4, 3, 6)
        return it
    _same(_epochs(mt, make, 1), _epochs(mx, make, 1))


def test_image_iter_bitwise(det_dataset):
    root, entries = det_dataset
    imglist = [(e[0][0, 0], e[1]) for e in entries]
    for kw, atol in ((dict(rand_crop=True, rand_mirror=True), 0.0),
                     (dict(resize=20, rand_crop=True, rand_resize=True,
                           brightness=0.3, contrast=0.3, saturation=0.3,
                           hue=0.2, pca_noise=0.1, rand_gray=0.5, mean=True,
                           std=True), 1e-6)):
        def make(lib):
            return lib.image.ImageIter(batch_size=3, data_shape=(3, 16, 16),
                                       imglist=imglist, path_root=root,
                                       shuffle=True, **kw)
        _same(_epochs(mt, make, 1), _epochs(mx, make, 1), atol=atol)


def test_det_augmenters_bitwise():
    """DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug on one image
    and label under one seed."""
    img = np.random.RandomState(0).rand(40, 40, 3).astype(np.float32)
    label = np.array([[0, 0.3, 0.3, 0.7, 0.7], [1, 0.1, 0.5, 0.4, 0.9],
                      [-1, 0, 0, 0, 0]], np.float32)
    outs = {}
    for lib in (mx, mt):
        np.random.seed(1)
        augs = [lib.image.DetHorizontalFlipAug(p=0.5),
                lib.image.DetRandomCropAug(min_object_covered=0.5,
                                           area_range=(0.3, 1.0)),
                lib.image.DetRandomPadAug(area_range=(1.5, 3.0))]
        res = []
        for _ in range(6):
            for aug in augs:
                im, lab = aug(img, label)
                res.append((np.asarray(im), lab))
        outs[lib] = res
    for (ai, al), (bi, bl) in zip(outs[mt], outs[mx]):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(al, bl)


def test_image_functions_bitwise():
    """imdecode, imresize, resize_short, the crops and color_normalize on
    the same draws."""
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(_img(20, 30)).save(buf, format="PNG")
    raw = buf.getvalue()
    res = {}
    for lib in (mx, mt):
        random.seed(2)
        with lib.cpu():
            img = lib.image.imdecode(raw)
            outs = [img, lib.image.imresize(img, 13, 7),
                    lib.image.resize_short(img, 12),
                    lib.image.fixed_crop(img, 2, 3, 10, 8, size=(5, 4)),
                    lib.image.random_crop(img, (9, 9))[0],
                    lib.image.center_crop(img, (12, 6))[0],
                    lib.image.random_size_crop(img, (8, 8), 0.3,
                                               (0.75, 1.33))[0],
                    lib.image.color_normalize(
                        img, lib.nd.array(np.array([1.0, 2.0, 3.0])),
                        lib.nd.array(np.array([2.0, 4.0, 8.0])))]
            res[lib] = [(o.asnumpy(), str(o.dtype)) for o in outs]
    for (a, adt), (b, bdt) in zip(res[mt], res[mx]):
        assert adt == bdt
        np.testing.assert_array_equal(a, b)


def test_imread_without_pil_raises(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(mt.MXNetError, match="PIL"):
        mt.image.imread(str(tmp_path / "none.jpg"))


def test_decode_is_the_only_file_read(det_dataset):
    """ImageDetIter.decode replaced by arrays in hand: the augmenters and
    batching run on them, as on decoded files."""
    root, entries = det_dataset
    arrays = {}
    for lab, path in entries:
        from PIL import Image

        arrays[path] = np.asarray(Image.open(os.path.join(root, path))
                                  .convert("RGB"), np.float32)

    def make(lib, from_arrays):
        it = lib.image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                    imglist=entries, path_root=root,
                                    shuffle=True, rand_mirror=True)
        if from_arrays:
            it.decode = lambda i: (arrays[it._entries[it._order[i]][1]],
                                   it._entries[it._order[i]][0])
        return it
    _same(_epochs(mt, lambda lib: make(lib, True)),
          _epochs(mt, lambda lib: make(lib, False)))
