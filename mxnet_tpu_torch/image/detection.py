"""Detection-aware image augmentation and the detection iterator (port of
``mxnet_tpu/image/detection.py``; parity: python/mxnet/image/detection.py:
the DetAugmenter hierarchy, CreateDetAugmenter, ImageDetIter -- the input
stack of example/ssd). Host-side numpy and PIL; boxes ride along with every
geometric transform, and the same ``np.random`` draws are taken in the
same order as ``mxnet_tpu``'s.

:meth:`ImageDetIter.decode` is the one place an image file is read:
everything after it (augmenters, label padding, batching) runs on the
decoded array, so a caller with arrays in hand may replace it.
:class:`ImageDetIter`'s batches land on the context current when it was
made (``gpu(0)`` unless told otherwise): one host-to-device copy for the
data and one for the label a batch.

Label convention (same as the reference): per image an (N, 5+) float array,
rows [class_id, xmin, ymin, xmax, ymax, ...] with coordinates normalized to
[0, 1]; class_id < 0 marks padding rows. Batched labels are padded with -1
to the widest image in the dataset.
"""
from __future__ import annotations

import os

import numpy as np

from ..base import MXNetError
from ..context import current_context
from . import image as _img

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Base class (detection.py:DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


def _to_np(img, dtype=np.float32):
    """Pixel augmenters speak NDArray (reference API); the det chain works
    in numpy — normalize at the seams."""
    if hasattr(img, "asnumpy"):
        img = img.asnumpy()
    return np.asarray(img, dtype=dtype)


class DetBorrowAug(DetAugmenter):
    """Lift a pixel-only Augmenter into the det chain (labels untouched)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        out = self.augmenter(_img.host_array(src))
        return _to_np(out), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter from a list (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or np.random.random() < self.skip_prob:
            return src, label
        i = np.random.randint(len(self.aug_list))
        return self.aug_list[i](src, label)


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if np.random.random() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


def _box_coverage(boxes, crop):
    """Fraction of each box's area inside crop (both normalized corner)."""
    ix = np.maximum(
        np.minimum(boxes[:, 3], crop[2]) - np.maximum(boxes[:, 1], crop[0]),
        0)
    iy = np.maximum(
        np.minimum(boxes[:, 4], crop[3]) - np.maximum(boxes[:, 2], crop[1]),
        0)
    inter = ix * iy
    area = np.maximum((boxes[:, 3] - boxes[:, 1]) *
                      (boxes[:, 4] - boxes[:, 2]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained by object coverage (detection.py
    DetRandomCropAug). Objects whose coverage falls below
    `min_eject_coverage` are dropped; surviving boxes are clipped and
    re-normalized to the crop."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        valid = label[label[:, 0] >= 0]
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ar = np.random.uniform(*self.aspect_ratio_range)
            w = min(np.sqrt(area * ar), 1.0)
            h = min(np.sqrt(area / ar), 1.0)
            x0 = np.random.uniform(0, 1 - w)
            y0 = np.random.uniform(0, 1 - h)
            crop = (x0, y0, x0 + w, y0 + h)
            if valid.size == 0:
                return crop
            cov = _box_coverage(valid, crop)
            if (cov >= self.min_object_covered).any():
                return crop
        return None

    def __call__(self, src, label):
        crop = self._sample_crop(label)
        if crop is None:
            return src, label
        h, w = src.shape[:2]
        x0, y0, x1, y1 = crop
        px0, py0 = int(x0 * w), int(y0 * h)
        px1, py1 = max(int(x1 * w), px0 + 1), max(int(y1 * h), py0 + 1)
        cw, ch = (px1 - px0) / w, (py1 - py0) / h
        nx0, ny0 = px0 / w, py0 / h
        # filter/clip boxes against the crop BEFORE touching pixels so an
        # all-ejected crop can be abandoned cleanly
        out = np.full_like(label, -1.0)
        k = 0
        for row in label:
            if row[0] < 0:
                continue
            cov = _box_coverage(row[None, :], (nx0, ny0, nx0 + cw, ny0 + ch))[0]
            if cov < self.min_eject_coverage:
                continue
            bx0 = (max(row[1], nx0) - nx0) / cw
            by0 = (max(row[2], ny0) - ny0) / ch
            bx1 = (min(row[3], nx0 + cw) - nx0) / cw
            by1 = (min(row[4], ny0 + ch) - ny0) / ch
            if bx1 <= bx0 or by1 <= by0:
                continue
            out[k] = row
            out[k, 1:5] = (bx0, by0, bx1, by1)
            k += 1
        if k == 0:
            return src, label
        return src[py0:py1, px0:px1], out


class DetRandomPadAug(DetAugmenter):
    """Place the image on a larger canvas (zoom-out) and rescale boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ar = np.random.uniform(*self.aspect_ratio_range)
            nw = int(w * np.sqrt(area * ar))
            nh = int(h * np.sqrt(area / ar))
            if nw < w or nh < h:
                continue
            x0 = np.random.randint(0, nw - w + 1)
            y0 = np.random.randint(0, nh - h + 1)
            canvas = np.empty((nh, nw, src.shape[2]), dtype=src.dtype)
            canvas[:] = np.asarray(self.pad_val, dtype=src.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = src
            out = label.copy()
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * w + x0) / nw
            out[valid, 3] = (out[valid, 3] * w + x0) / nw
            out[valid, 2] = (out[valid, 2] * h + y0) / nh
            out[valid, 4] = (out[valid, 4] * h + y0) / nh
            return canvas, out
        return src, label


class _DetForceResize(DetAugmenter):
    def __init__(self, size):  # size = (w, h)
        super().__init__(size=size)
        self.size = size

    def __call__(self, src, label):
        return _to_np(_img.imresize(src, self.size[0], self.size[1])), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pca_noise=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Build the standard SSD augmentation chain (detection.py:
    CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0),
                                 min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(_DetForceResize((data_shape[2], data_shape[1])))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(_img.ColorJitterAug(
            brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(_img.HueJitterAug(hue)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(_img.LightingAug(
            pca_noise,
            np.array([55.46, 4.794, 1.148]),
            np.array([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.814],
                      [-0.5836, -0.6948, 0.4203]]))))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_img.RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.asarray(mean).any():
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter:
    """Detection iterator (detection.py:ImageDetIter). Sources: in-memory
    ``imglist`` [(label, path), ...] or ``path_imglist`` in the reference's
    det .lst format (idx\\tA\\tB\\t[extras]\\t(cls x1 y1 x2 y2)*N\\tpath,
    A = header width incl. A and B, B = object width).

    Yields DataBatch: data (B,C,H,W) float32, label (B, max_obj, obj_width)
    padded with -1.
    """

    def __init__(self, batch_size, data_shape, path_imglist=None,
                 path_root="", imglist=None, shuffle=False, aug_list=None,
                 data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        from ..io import DataDesc

        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.path_root = path_root
        self.shuffle = shuffle
        self._ctx = current_context()
        entries = []
        if path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    header_w = int(float(parts[1]))
                    obj_w = int(float(parts[2]))
                    vals = [float(x) for x in parts[1:-1]]
                    objs = np.asarray(vals[header_w:], dtype=np.float32)
                    objs = objs.reshape(-1, obj_w)
                    entries.append((objs, parts[-1]))
        elif imglist is not None:
            for label, path in imglist:
                arr = np.asarray(label, dtype=np.float32)
                if arr.ndim == 1:
                    arr = arr.reshape(-1, 5)
                entries.append((arr, path))
        else:
            raise MXNetError("need path_imglist or imglist")
        if not entries:
            raise MXNetError("empty detection image list")
        self._entries = entries
        self.obj_width = max(e[0].shape[1] for e in entries)
        self.max_objects = max(e[0].shape[0] for e in entries)
        if aug_list is None:
            aug_list = CreateDetAugmenter(self.data_shape, **kwargs)
        self.auglist = aug_list
        if last_batch_handle == "roll_over":
            import warnings

            warnings.warn("ImageDetIter: last_batch_handle='roll_over' is "
                          "not supported; using 'pad'")
            last_batch_handle = "pad"
        self.last_batch_handle = last_batch_handle
        self._data_name, self._label_name = data_name, label_name
        self.provide_data = [DataDesc(
            data_name, (batch_size,) + self.data_shape, np.float32)]
        self._refresh_label_desc()
        self._order = np.arange(len(entries))
        self.cur = 0
        self.reset()

    def _refresh_label_desc(self):
        from ..io import DataDesc

        self.provide_label = [DataDesc(
            self._label_name,
            (self.batch_size, self.max_objects, self.obj_width),
            np.float32)]

    def __iter__(self):
        return self

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cur = 0

    def decode(self, i):
        """The image of entry ``i`` (in the current order) as an (H, W, C)
        float32 numpy array, and its label rows."""
        label, path = self._entries[self._order[i]]
        return _to_np(_img.imread(os.path.join(self.path_root, path))), label

    def _read(self, i):
        img, label = self.decode(i)
        lab = np.full((self.max_objects, self.obj_width), -1.0, np.float32)
        lab[:label.shape[0], :label.shape[1]] = label
        for aug in self.auglist:
            img, lab = aug(img, lab)
        c, h, w = self.data_shape
        if img.shape[:2] != (h, w):
            img = _to_np(_img.imresize(img, w, h))
        if img.ndim == 2:
            img = img[:, :, None]
        return np.transpose(img, (2, 0, 1)), lab

    def next(self):
        from ..io import DataBatch
        from ..ndarray import ndarray as _nd

        n = len(self._entries)
        if self.cur >= n:
            raise StopIteration
        if self.last_batch_handle == "discard" and \
                self.cur + self.batch_size > n:
            raise StopIteration
        bsz = self.batch_size
        c, h, w = self.data_shape
        data = np.zeros((bsz, c, h, w), np.float32)
        label = np.full((bsz, self.max_objects, self.obj_width), -1.0,
                        np.float32)
        pad = 0
        for j in range(bsz):
            idx = self.cur + j
            if idx >= n:
                idx %= n
                pad += 1
            data[j], label[j] = self._read(idx)
        self.cur += bsz
        return DataBatch(data=[_nd.array(data, ctx=self._ctx)],
                         label=[_nd.array(label, ctx=self._ctx)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def sync_label_shape(self, it, verbose=False):
        """Align label widths between train/val iterators (reference API)."""
        shape = (max(self.max_objects, it.max_objects),
                 max(self.obj_width, it.obj_width))
        self.max_objects = it.max_objects = shape[0]
        self.obj_width = it.obj_width = shape[1]
        self._refresh_label_desc()
        it._refresh_label_desc()
        return it
