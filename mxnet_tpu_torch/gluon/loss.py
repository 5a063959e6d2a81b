"""Gluon losses (subset of ``mxnet_tpu/gluon/loss.py``; parity:
python/mxnet/gluon/loss.py).

Each loss is a Block composed of the port's ops; it returns one value per
sample: the loss averaged over every axis but ``batch_axis``. Ported:
``L2Loss`` and ``SoftmaxCrossEntropyLoss``; the other losses wait in
ROADMAP Queue 1.
"""
from __future__ import annotations

from .block import HybridBlock
from ..ops import math as _math
from ..ops import nn as _nn

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss * sample_weight`` (broadcast), then ``* weight`` (a number)
    (``mxnet_tpu/gluon/loss.py:20-27``)."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise TypeError(f"weight must be a number, got "
                            f"{type(weight).__name__}")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base class of the losses (``mxnet_tpu/gluon/loss.py:34``)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _per_sample(self, loss):
        return _math.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (``mxnet_tpu/gluon/loss.py:60``)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred) ** 2
        return self._per_sample(
            _apply_weighting(loss, self._weight / 2, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy (``mxnet_tpu/gluon/loss.py:121``):
    ``-log_softmax(pred)`` picked at the label along ``axis``
    (``sparse_label``; labels are indices, clipped into range as MXNet's
    ``pick`` does) or summed against a dense label distribution;
    ``from_logits`` takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _nn.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_math.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -_math.sum(pred * label.reshape(pred.shape),
                              axis=self._axis, keepdims=True)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
