"""Evaluation metrics (a subset of ``mxnet_tpu/metric.py``; parity:
python/mxnet/metric.py).

Ported: ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy`` and ``Loss``, with ``register`` and
``create`` and the aliases "acc", "top_k_acc", "top_k_accuracy", "ce" and
"composite": what an image classifier's top-1 and loss read. The other
metrics and ``CustomMetric`` are queued (ROADMAP Queue 1 item 5).

Labels and predictions are tensors on any device, or numpy arrays, alone
or in lists. A metric reads them to the host in ``update`` only, where it
sums on the host in numpy as ``mxnet_tpu`` does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Loss", "register", "create"]

_REGISTRY = {}


def register(klass, name=None):
    """Register a metric class under ``name`` (default: its lower-cased
    class name)."""
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a registered name, an EvalMetric (returned as it is)
    or a list of either (a CompositeEvalMetric)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if callable(metric):
        raise NotImplementedError("metric.create: custom metrics from a "
                                  "callable are not ported yet (ROADMAP "
                                  "Queue 1 item 5)")
    try:
        klass = _REGISTRY[metric.lower()]
    except KeyError:
        raise MXNetError(f"metric '{metric}' is not registered. Known: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(*args, **kwargs)


def _as_numpy(x):
    """A tensor (any device, any float dtype) or array -> numpy, on the
    host."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def _listify(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric: sums a value and an instance count, locally (since
    ``reset_local``) and globally (since ``reset``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = {"metric": self.__class__.__name__, "name": self.name,
                  "output_names": self.output_names,
                  "label_names": self.label_names}
        config.update(self._kwargs)
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError(f"labels({len(labels)}) vs preds({len(preds)}) "
                         f"shape mismatch")


class Accuracy(EvalMetric):
    """The share of predictions equal to the label; class scores are
    reduced by argmax over ``axis``."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _listify(labels), _listify(preds)
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            # class scores iff the shapes differ and pred has the axis
            if pred.shape != label.shape and pred.ndim > self.axis:
                pred = pred.argmax(axis=self.axis)
            ok = (pred.astype(_np.int64).ravel() ==
                  label.astype(_np.int64).ravel()).sum()
            self._update(float(ok), label.size)


class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _listify(labels), _listify(preds)
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int64)
            pred = _as_numpy(pred)
            idx = _np.argsort(pred, axis=1)[:, -self.top_k:]
            ok = (idx == label.reshape(-1, 1)).any(axis=1).sum()
            self._update(float(ok), label.shape[0])


class CrossEntropy(EvalMetric):
    """Mean of ``-log(p[label] + eps)`` over predicted probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _listify(labels), _listify(preds)
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype(_np.int64)
            pred = _as_numpy(pred)
            prob = pred[_np.arange(label.size), label]
            self._update(float((-_np.log(prob + self.eps)).sum()),
                         label.size)


class Loss(EvalMetric):
    """Mean of the given per-sample losses (labels are ignored)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _listify(preds):
            pred = _as_numpy(pred)
            self._update(float(pred.sum()), pred.size)


for _klass in (CompositeEvalMetric, Accuracy, TopKAccuracy, CrossEntropy,
               Loss):
    register(_klass)
for _alias, _klass in (("acc", Accuracy), ("top_k_accuracy", TopKAccuracy),
                       ("top_k_acc", TopKAccuracy), ("ce", CrossEntropy),
                       ("composite", CompositeEvalMetric)):
    register(_klass, _alias)
