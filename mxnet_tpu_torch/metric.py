"""Evaluation metrics (port of ``mxnet_tpu/metric.py``; parity:
python/mxnet/metric.py).

Every metric of ``mxnet_tpu``: ``Accuracy``, ``TopKAccuracy``, ``F1``,
``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss``, ``Torch``,
``Caffe``, ``CompositeEvalMetric`` and ``CustomMetric`` (also from
:func:`np`), with ``register`` and ``create`` (a name, an alias, a metric,
a list, or a callable ``feval(label, pred)``, which becomes a
``CustomMetric``).

Labels and predictions are tensors on any device, NDArrays or numpy
arrays, alone or in lists. A metric reads them to the host in ``update`` only, where it
sums on the host in numpy as ``mxnet_tpu`` does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "register", "create"]

_REGISTRY = {}


def register(klass, name=None):
    """Register a metric class under ``name`` (default: its lower-cased
    class name)."""
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a registered name, an EvalMetric (returned as it is),
    a callable ``feval(label, pred)`` (a :class:`CustomMetric`) or a list
    of them (a CompositeEvalMetric)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    try:
        klass = _REGISTRY[metric.lower()]
    except KeyError:
        raise MXNetError(f"metric '{metric}' is not registered. Known: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(*args, **kwargs)


def _as_numpy(x):
    """A tensor (any device, any float dtype), an NDArray or an array ->
    numpy, on the host."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
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


def _binary(label, pred):
    """(labels, predicted labels) as int vectors: class 1 where its
    probability (column 1, or the one column) exceeds 0.5."""
    label = _as_numpy(label).ravel().astype(int)
    pred = _as_numpy(pred)
    pl = (pred[:, 1] > 0.5).astype(int) if pred.ndim > 1 \
        else (pred > 0.5).astype(int).ravel()
    return label, pl


class _Confusion(EvalMetric):
    """A binary confusion count over every update; the metric is a
    function of the totals, not a mean of batch values."""

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pl = _binary(label, pred)
            self._tp += float(((pl == 1) & (label == 1)).sum())
            self._fp += float(((pl == 1) & (label == 0)).sum())
            self._fn += float(((pl == 0) & (label == 1)).sum())
            self._tn += float(((pl == 0) & (label == 0)).sum())
            value = self._value()
            self.sum_metric = self.global_sum_metric = value
            self.num_inst = self.global_num_inst = 1


class F1(_Confusion):
    """F1 of the positive class over every update so far."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average

    def _value(self):
        tp, fp, fn = self._tp, self._fp, self._fn
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        return 2 * prec * rec / (prec + rec) if prec + rec else 0.0


class MCC(_Confusion):
    """Matthews correlation coefficient over every update so far."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _value(self):
        tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
        denom = _np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / denom if denom else 0.0


class Perplexity(EvalMetric):
    """``exp`` of the mean negative log-probability of the labels
    (probabilities floored at 1e-10); ``ignore_label`` is left out."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).astype(_np.int64).ravel()
            pred = _as_numpy(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.size
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


def _as_columns(label, pred):
    label, pred = _as_numpy(label), _as_numpy(pred)
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


class MAE(EvalMetric):
    """Mean absolute error, one batch mean a batch."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_columns(label, pred)
            self._update(float(_np.abs(label - pred).mean()), 1)


class MSE(EvalMetric):
    """Mean squared error, one batch mean a batch."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_columns(label, pred)
            self._update(float(((label - pred) ** 2).mean()), 1)


class RMSE(MSE):
    """The square root of :class:`MSE`'s mean."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.sqrt(self.sum_metric / self.num_inst)))


class NegativeLogLikelihood(CrossEntropy):
    """:class:`CrossEntropy` under the name "nll-loss"."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names, eps=eps)
        self.eps = eps


class PearsonCorrelation(EvalMetric):
    """Pearson's r of predictions and labels, one value a batch."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            r = _np.corrcoef(_as_numpy(pred).ravel(),
                             _as_numpy(label).ravel())[0, 1]
            self._update(float(r), 1)


class Torch(Loss):
    """:class:`Loss` under the name "torch"."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)


class Caffe(Loss):
    """:class:`Loss` under the name "caffe"."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, a value or a ``(sum,
    count)`` pair, summed over the batches."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                self._update(*reval)
            else:
                self._update(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` of a function on numpy arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


for _klass in (CompositeEvalMetric, Accuracy, TopKAccuracy, F1, MCC,
               Perplexity, MAE, MSE, RMSE, CrossEntropy,
               NegativeLogLikelihood, PearsonCorrelation, Loss, Torch,
               Caffe):
    register(_klass)
for _alias, _klass in (("acc", Accuracy), ("top_k_accuracy", TopKAccuracy),
                       ("top_k_acc", TopKAccuracy), ("ce", CrossEntropy),
                       ("nll_loss", NegativeLogLikelihood),
                       ("pearsonr", PearsonCorrelation),
                       ("composite", CompositeEvalMetric)):
    register(_klass, _alias)
