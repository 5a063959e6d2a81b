"""``mx.image``: host-side image loading and augmentation (port of
``mxnet_tpu/image/image.py``; parity: python/mxnet/image/image.py and
src/io/image_aug_default.cc).

PIL decodes and resizes, numpy does the arithmetic, and the same global
``random`` / ``np.random`` draws as ``mxnet_tpu``'s are taken in the same
order, so under one seed the two packages give the same bits. The arrays
an augmenter passes on are NDArrays on ``cpu()``, with ``mxnet_tpu``'s
dtypes (uint8 pixels until a cast; numpy's float64 and int64 arrive as
float32 and int32, as JAX keeps them). :class:`ImageIter`'s batches land
on the context current when it was made (``gpu(0)`` unless told
otherwise), one host-to-device copy for the data and one for the label a
batch. Its source is an ``imglist``, a ``.lst`` file, or a ``.rec`` file
read through ``recordio`` (by key through the ``.idx`` beside it, else in
file order).
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as np

from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray import ndarray as nd

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "random_size_crop",
           "CreateAugmenter", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "ImageIter"]


def host_array(a):
    """``a`` (numpy) as an NDArray on ``cpu()`` in the dtype ``mxnet_tpu``'s
    ``nd.array`` keeps: its own, with float64 -> float32 and int64 ->
    int32."""
    a = np.asarray(a)
    dtype = {np.dtype(np.float64): np.float32,
             np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype)
    return nd.array(np.ascontiguousarray(a, dtype=dtype), ctx=cpu(),
                    dtype=dtype)


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:
        raise MXNetError("mx.image requires PIL in this build") from e


def imread(filename, flag=1, to_rgb=True):
    """Read image from file (image.py:81)."""
    img = _pil().open(filename)
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return host_array(arr.astype(np.uint8))

imdecode_flags = {"color": 1, "grayscale": 0}


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an image from bytes (image.py:144)."""
    from io import BytesIO
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy().tobytes()
    elif isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    img = _pil().open(BytesIO(buf))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return host_array(arr.astype(np.uint8))


def imresize(src, w, h, interp=1):
    """Resize to (w, h) (image.py:303)."""
    a = src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)
    squeeze = a.shape[2] == 1 if a.ndim == 3 else False
    pil_img = _pil().fromarray(a[:, :, 0] if squeeze else a.astype(np.uint8))
    out = np.asarray(pil_img.resize((w, h), _pil().BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return host_array(out.astype(a.dtype if a.dtype != np.float64
                                else np.float32))


def resize_short(src, size, interp=2):
    """Resize shorter edge to size (image.py:400)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop at fixed position (image.py:450)."""
    a = src.asnumpy() if isinstance(src, nd.NDArray) else src
    out = a[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return host_array(out)


def random_crop(src, size, interp=2):
    """Random crop with resize (image.py:477)."""
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop with resize (image.py:518)."""
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop by area fraction + aspect ratio (image.py:585)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std (image.py:563)."""
    if isinstance(src, nd.NDArray) and src.dtype == np.uint8:
        src = src.astype(np.float32)
    out = src - mean
    if std is not None:
        out = out / std
    return out


class Augmenter:
    """Image augmenter base (image.py:640)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return host_array(src.asnumpy()[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = host_array(mean) if mean is not None else None
        self.std = host_array(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        a = src.asnumpy()
        gray = (a * self.coef).sum() * (3.0 * (1.0 - alpha) / a.size)
        return host_array(a * alpha + gray)


class SaturationJitterAug(Augmenter):
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        a = src.asnumpy()
        gray = (a * self.coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return host_array(a * alpha + gray)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return host_array(np.dot(src.asnumpy(), t))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + host_array(rgb)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = host_array(np.array([[0.21, 0.21, 0.21],
                                        [0.72, 0.72, 0.72],
                                        [0.07, 0.07, 0.07]], np.float32))

    def __call__(self, src):
        if pyrandom.random() < self.p:
            src = src.dot(self.mat)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Creates the standard augmenter list (image.py:1129)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and len(np.atleast_1d(mean)) > 0:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image data iterator with augmentation (image.py:1210) over an
    ``imglist``, a ``path_imglist`` or a ``path_imgrec``; yields
    io.DataBatch on the context current at construction."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 dtype="float32", last_batch_handle="pad", **kwargs):
        from ..io import DataDesc
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle
        self.dtype = dtype
        self._ctx = current_context()
        self.imgrec = None
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self.imgrec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = MXRecordIO(path_imgrec, "r")
                self.seq = None
            self.imglist = None
        else:
            entries = {}
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.array(
                            [float(i) for i in parts[1:-1]],
                            dtype=np.float32)
                        entries[int(parts[0])] = (label, parts[-1])
            else:
                for i, rec in enumerate(imglist):
                    label = np.array(
                        rec[0] if isinstance(rec[0], (list, tuple))
                        else [rec[0]], dtype=np.float32)
                    entries[i] = (label, rec[1])
            self.imglist = entries
            self.seq = list(self.imglist.keys())
        if num_parts > 1 and self.seq is not None:
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast", "saturation",
                         "hue", "pca_noise", "rand_gray", "inter_method")})
        else:
            self.auglist = aug_list
        self.provide_data = [DataDesc(data_name, (batch_size,) + self.data_shape,
                                      dtype)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width) if
                                       label_width > 1 else (batch_size,),
                                       dtype)]
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(label, encoded image bytes) of the next sample."""
        from ..recordio import unpack
        if self.seq is None:
            s = self.imgrec.read()
            if s is None:
                raise StopIteration
            header, img = unpack(s)
            return header.label, img
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            header, img = unpack(self.imgrec.read_idx(idx))
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            img = f.read()
        return label, img

    def next(self):
        from ..io import DataBatch
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              dtype=self.dtype)
        shape = (self.batch_size, self.label_width) if self.label_width > 1 \
            else (self.batch_size,)
        batch_label = np.zeros(shape, dtype=self.dtype)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                data = imdecode(s)
                for aug in self.auglist:
                    data = aug(data)
                arr = data.asnumpy() if isinstance(data, nd.NDArray) else data
                batch_data[i] = arr.transpose(2, 0, 1)
                label = np.atleast_1d(np.asarray(label, np.float32))
                batch_label[i] = label if self.label_width > 1 else label[0]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        return DataBatch(data=[nd.array(batch_data, ctx=self._ctx)],
                         label=[nd.array(batch_label, ctx=self._ctx)],
                         pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
