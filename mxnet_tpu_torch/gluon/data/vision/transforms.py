"""Vision transforms (port of ``mxnet_tpu/gluon/data/vision/
transforms.py``; parity: python/mxnet/gluon/data/vision/transforms.py:
Compose, ToTensor, Normalize, Resize, the crops, flips and color jitter).

They are Blocks run on the host, on the sample's tensor: numpy does the
arithmetic and draws from the global ``np.random`` in ``mxnet_tpu``'s
order, so under one seed both packages give the same bits.
"""
from __future__ import annotations

import numpy as np

from ...block import Block, HybridBlock
from ...nn import Sequential
from ....image.image import host_array, imresize

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomLighting"]


_INV_255 = float(np.float32(1.0 / 255.0))


class Compose(Sequential):
    """Sequentially composes multiple transforms
    (vision/transforms.py:34)."""

    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            for t in transforms:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1) (vision/transforms.py:89)."""

    def hybrid_forward(self, F, x):
        if len(x.shape) == 4:
            out = F.transpose(x, axes=(0, 3, 1, 2))
        else:
            out = F.transpose(x, axes=(2, 0, 1))
        # mxnet_tpu's compiled x / 255.0: XLA folds the division by a
        # constant into a product with float32(1 / 255)
        return F.Cast(out, dtype="float32") * _INV_255


class Normalize(HybridBlock):
    """Channel-wise (x - mean) / std on CHW float input
    (vision/transforms.py:131)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (x - x.new_tensor(self._mean)) / x.new_tensor(self._std)


def _to_np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


class Resize(Block):
    """Resize to a given size with bilinear interpolation
    (vision/transforms.py:183)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._keep = keep_ratio

    def forward(self, x):
        return imresize(x, self._size[0], self._size[1])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        a = _to_np(x)
        h, w = a.shape[:2]
        cw, ch = self._size
        y0 = max(0, (h - ch) // 2)
        x0 = max(0, (w - cw) // 2)
        return host_array(a[y0:y0 + ch, x0:x0 + cw])


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        a = _to_np(x)
        if self._pad:
            p = self._pad
            a = np.pad(a, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = a.shape[:2]
        cw, ch = self._size
        y0 = np.random.randint(0, max(1, h - ch + 1))
        x0 = np.random.randint(0, max(1, w - cw + 1))
        return host_array(a[y0:y0 + ch, x0:x0 + cw])


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _to_np(x)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            ar = np.exp(np.random.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if cw <= w and ch <= h:
                x0 = np.random.randint(0, w - cw + 1)
                y0 = np.random.randint(0, h - ch + 1)
                crop = a[y0:y0 + ch, x0:x0 + cw]
                return imresize(crop, self._size[0], self._size[1])
        return imresize(a, self._size[0], self._size[1])


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return host_array(_to_np(x)[:, ::-1].copy())
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return host_array(_to_np(x)[::-1].copy())
        return x


class _RandomColorJitterBase(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def _alpha(self):
        return 1.0 + np.random.uniform(-self._b, self._b)


class RandomBrightness(_RandomColorJitterBase):
    def forward(self, x):
        a = _to_np(x).astype(np.float32) * self._alpha()
        return host_array(a)


class RandomContrast(_RandomColorJitterBase):
    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        coef = np.array([0.299, 0.587, 0.114], dtype=np.float32)
        alpha = self._alpha()
        gray = (a * coef).sum() * (1.0 - alpha) / a[..., :1].size
        return host_array(a * alpha + gray)


class RandomSaturation(_RandomColorJitterBase):
    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        coef = np.array([0.299, 0.587, 0.114], dtype=np.float32)
        alpha = self._alpha()
        gray = (a * coef).sum(axis=-1, keepdims=True) * (1.0 - alpha)
        return host_array(a * alpha + gray)


class RandomLighting(Block):
    """AlexNet-style PCA noise (vision/transforms.py:580)."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _to_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return host_array(a + rgb)
