"""Gluon losses (subset of ``mxnet_tpu/gluon/loss.py``; parity:
python/mxnet/gluon/loss.py).

Each loss is a Block composed of the port's ops; it returns one value per
sample: the loss averaged over every axis but ``batch_axis`` (TripletLoss
sums there, CTCLoss gives each sequence's, PoissonNLLLoss one mean). Every
loss of ``mxnet_tpu/gluon/loss.py`` is ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .block import HybridBlock
from ..ops import math as _math
from ..ops import nn as _nn

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


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


def _softrelu_neg_abs(x):
    """``log(1 + exp(-|x|))``, the stable part of the logistic losses."""
    return F.softplus(-torch.abs(x))


class L1Loss(Loss):
    """``|pred - label|`` (``mxnet_tpu/gluon/loss.py:73``)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy (``mxnet_tpu/gluon/loss.py:86``): on logits
    through the stable ``relu(x) - x * z + log(1 + exp(-|x|))``, or with
    ``from_sigmoid`` on probabilities (eps 1e-12 inside the logs);
    ``pos_weight`` weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + F.relu(-pred))
        else:
            eps = 1e-12
            pos = _math.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + _math.log(1. - pred + eps) * (1. - label))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (after a log-softmax over ``axis`` unless ``from_logits``)
    (``mxnet_tpu/gluon/loss.py:143``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _nn.log_softmax(pred, axis=self._axis)
        loss = label * (_math.log(label + 1e-12) - pred)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification (``mxnet_tpu/gluon/loss.py:
    160``): ``pred`` in ``layout`` "NTC" or "TNC", ``label`` in "NT" or
    "TN" padded with -1, the blank the last class; one loss a sequence."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("Only 'NTC' and 'TNC' layouts for pred are "
                             f"supported. Got: {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError("Only 'NT' and 'TN' layouts for label are "
                             f"supported. Got: {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _nn.ctc_loss(pred, label, pred_lengths, label_lengths,
                            use_data_lengths=pred_lengths is not None,
                            use_label_lengths=label_lengths is not None,
                            blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1: ``|d| - rho / 2`` where ``|d| > rho``, else
    ``d^2 / (2 rho)`` (``mxnet_tpu/gluon/loss.py:189``)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * _math.square(loss))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    """``relu(margin - pred * label)`` (``mxnet_tpu/gluon/loss.py:206``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * label.reshape(pred.shape))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2`` (``mxnet_tpu/gluon/loss.py:220``).
    """

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = _math.square(
            F.relu(self._margin - pred * label.reshape(pred.shape)))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """Logistic loss on logits, labels in {-1, 1} ("signed") or {0, 1}
    ("binary") (``mxnet_tpu/gluon/loss.py:234``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             f"recieved {label_format}.")

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class TripletLoss(Loss):
    """``relu(sum(|pos - pred|^2 - |neg - pred|^2) + margin)``, summed over
    every axis but ``batch_axis`` (``mxnet_tpu/gluon/loss.py:256``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = _math.sum(_math.square(positive - pred)
                         - _math.square(negative - pred),
                         axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, one mean over everything
    (``mxnet_tpu/gluon/loss.py:273``): ``exp(pred) - target * pred`` on
    log-rates (``from_logits``), else ``pred - target * log(pred + eps)``;
    ``compute_full`` adds Stirling's term where ``target > 1``."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = _math.exp(pred) - target * pred
        else:
            loss = pred - target * _math.log(pred + epsilon)
        if self._compute_full:
            stirling = target * _math.log(target) - target + \
                0.5 * _math.log(2 * target * math.pi)
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(stirling))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _math.mean(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(x1, x2)`` for label 1, ``relu(cos - margin)`` otherwise
    (``mxnet_tpu/gluon/loss.py:294``); cos over the last axis with the
    product of the norms clipped at 1e-12."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        x_norm = _math.norm(input1, axis=-1).reshape(-1, 1)
        y_norm = _math.norm(input2, axis=-1).reshape(-1, 1)
        dot = _math.sum(input1 * input2, axis=-1).reshape(-1, 1)
        cos = dot / torch.clamp_min(x_norm * y_norm, 1e-12)
        label = label.reshape(-1, 1)
        loss = torch.where(label == 1, 1.0 - cos,
                           F.relu(cos - self._margin))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))
