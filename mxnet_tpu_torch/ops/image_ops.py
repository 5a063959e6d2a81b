"""Image operators on (H, W, C) or (N, H, W, C) tensors, ``mx.nd.image.*``
(port of ``mxnet_tpu/ops/image_ops.py``; parity: src/operator/image/
image_random.cc, resize.cc, crop.cc).

They run on whatever device holds the batch. The random ones draw from
the device's ``mx.random`` generator (``generator``), one draw an image
for a batch, where ``mxnet_tpu`` splits its key cell: the draws follow
the same distributions, not the same bits (ROADMAP Queue 3, "SGLD's noise
stream" is the same case). ``_image_resize``'s "linear" method is
``jax.image.resize``'s: a triangle kernel widened by the scale when
downsampling (antialiased), as a weight matrix a spatial axis.
"""
from __future__ import annotations

import torch

from .registry import register

_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.814),
           (-0.5836, -0.6948, 0.4203))
_GRAY = (0.299, 0.587, 0.114)
_INV_255 = 1.0 / 255.0


def _batched(x):
    return x.dim() == 4


@register("_image_to_tensor", aliases=("image_to_tensor",))
def to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1] (image_random.cc ToTensor), as
    ``mxnet_tpu``'s compiled ``x / 255.0``: XLA folds the division by a
    constant into a product with float32(1 / 255)."""
    x = data.to(torch.float32) * _INV_255
    return x.permute(0, 3, 1, 2) if _batched(data) else x.permute(2, 0, 1)


@register("_image_normalize", aliases=("image_normalize",))
def normalize(data, mean=(0.0,), std=(1.0,)):
    """Channel-wise (x - mean) / std on CHW / NCHW float input."""
    mean = torch.tensor(mean, dtype=torch.float32,
                        device=data.device).reshape(-1, 1, 1)
    std = torch.tensor(std, dtype=torch.float32,
                       device=data.device).reshape(-1, 1, 1)
    return (data - mean) / std


@register("_image_flip_left_right", aliases=("image_flip_left_right",))
def flip_left_right(data):
    return torch.flip(data, dims=(-2,))


@register("_image_flip_top_bottom", aliases=("image_flip_top_bottom",))
def flip_top_bottom(data):
    return torch.flip(data, dims=(-3,))


def _rand_apply(data, fn, p, generator):
    """``fn(data)`` for each image with probability ``p``."""
    n = data.shape[0] if _batched(data) else 1
    hit = torch.rand(n, generator=generator, device=data.device) < p
    if _batched(data):
        return torch.where(hit[:, None, None, None], fn(data), data)
    return torch.where(hit[0], fn(data), data)


@register("_image_random_flip_left_right", no_grad=True,
          aliases=("image_random_flip_left_right",))
def random_flip_left_right(data, p=0.5, generator=None):
    return _rand_apply(data, flip_left_right, p, generator)


@register("_image_random_flip_top_bottom", no_grad=True,
          aliases=("image_random_flip_top_bottom",))
def random_flip_top_bottom(data, p=0.5, generator=None):
    return _rand_apply(data, flip_top_bottom, p, generator)


@register("_image_crop", aliases=("image_crop",))
def crop(data, x=0, y=0, width=1, height=1):
    """Fixed-position crop (crop.cc): x / y are the top-left corner."""
    if _batched(data):
        return data[:, y:y + height, x:x + width, :]
    return data[y:y + height, x:x + width, :]


def _linear_weights(n_in, n_out, device):
    """``jax.image.resize``'s (n_in, n_out) weight matrix of one axis for
    the antialiased triangle kernel, in float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                          device=device)[:, None]).abs() \
        / kernel_scale
    w = (1 - x.abs()).clamp_min(0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920928955078125e-07,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(n_in, n_out, device):
    offsets = (torch.arange(n_out, dtype=torch.float32, device=device)
               + 0.5) * n_in / n_out
    return torch.floor(offsets).to(torch.long)


@register("_image_resize", aliases=("image_resize",))
def resize(data, size=(0, 0), keep_ratio=False, interp=1):
    """Bilinear (antialiased when shrinking) or nearest (``interp=0``)
    resize to ``size`` = (w, h) or an int (resize.cc)."""
    if isinstance(size, int):
        w = h = size
    else:
        w, h = size if len(size) == 2 else (size[0], size[0])
    hd, wd = (1, 2) if _batched(data) else (0, 1)
    n_h, n_w = data.shape[hd], data.shape[wd]
    x = data
    if interp == 0:
        if n_h != h:
            x = x.index_select(hd, _nearest_index(n_h, h, x.device))
        if n_w != w:
            x = x.index_select(wd, _nearest_index(n_w, w, x.device))
        return x
    x = x.to(torch.float32)
    if n_h != h:
        x = torch.movedim(torch.tensordot(
            x, _linear_weights(n_h, h, x.device), dims=([hd], [0])), -1, hd)
    if n_w != w:
        x = torch.movedim(torch.tensordot(
            x, _linear_weights(n_w, w, x.device), dims=([wd], [0])), -1, wd)
    return x.to(data.dtype)


def _blend(a, b, ratio):
    return a * ratio + b * (1.0 - ratio)


def _gray(data):
    coef = torch.tensor(_GRAY, dtype=data.dtype, device=data.device)
    return (data * coef).sum(dim=-1, keepdim=True)


def _adjust_brightness(data, factor):
    return data * factor


def _adjust_contrast(data, factor):
    # blend against the BT.601 luminance mean (image_random-inl.h:697-705)
    return _blend(data, _gray(data).mean(dim=(-3, -2, -1), keepdim=True),
                  factor)


def _adjust_saturation(data, factor):
    return _blend(data, _gray(data), factor)


def _random_adjust(name, adjust):
    @register(f"_image_random_{name}", no_grad=True,
              aliases=(f"image_random_{name}",))
    def fn(data, min_factor=1.0, max_factor=1.0, generator=None):
        # the factor is drawn uniformly in [min_factor, max_factor]
        # (image_random-inl.h:675-677), one an image
        shape = (data.shape[0], 1, 1, 1) if _batched(data) else ()
        f = torch.rand(shape, generator=generator, device=data.device) * \
            (max_factor - min_factor) + min_factor
        return adjust(data.to(torch.float32), f)

    fn.__name__ = f"random_{name}"
    fn.__doc__ = f"``{name}`` by a factor drawn in [min_factor, max_factor]."
    return fn


random_brightness = _random_adjust("brightness", _adjust_brightness)
random_contrast = _random_adjust("contrast", _adjust_contrast)
random_saturation = _random_adjust("saturation", _adjust_saturation)


def _pca(device):
    return (torch.tensor(_EIGVAL, dtype=torch.float32, device=device),
            torch.tensor(_EIGVEC, dtype=torch.float32, device=device))


@register("_image_adjust_lighting", aliases=("image_adjust_lighting",))
def adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet-style PCA lighting with a fixed ``alpha``."""
    eigval, eigvec = _pca(data.device)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=data.device)
    return data + (eigvec * alpha * eigval).sum(dim=1)


@register("_image_random_lighting", no_grad=True,
          aliases=("image_random_lighting",))
def random_lighting(data, alpha_std=0.05, generator=None):
    """PCA lighting with alpha ~ N(0, alpha_std), one an image."""
    eigval, eigvec = _pca(data.device)
    n = data.shape[0] if _batched(data) else 1
    alpha = torch.randn(n, 3, generator=generator,
                        device=data.device) * alpha_std
    delta = torch.einsum("nc,rc->nr", alpha * eigval, eigvec)
    if _batched(data):
        return data + delta[:, None, None, :]
    return data + delta[0]
