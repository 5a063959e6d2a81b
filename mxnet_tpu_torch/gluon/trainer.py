"""Gluon Trainer: applies an Optimizer to a set of Parameters (subset of
``mxnet_tpu/gluon/trainer.py``; parity: python/mxnet/gluon/trainer.py).

One process, one device: ``kvstore='device'`` (the default) has nothing
to reduce, so :meth:`Trainer.step` is :meth:`Trainer.update` with
``rescale_grad = scale / batch_size``. ``ignore_stale_grad`` is accepted
and, as in ``mxnet_tpu``, changes nothing: every parameter whose
``grad_req`` is not "null" is updated from its gradient buffer (zeros if
no backward wrote it). Multi-device kvstores, optimizer state save/load,
and ``mxnet_tpu``'s step watchdog, health sentinel, fault hooks and trace
spans (``mxnet_tpu/gluon/trainer.py:111-200``) wait for the sharding,
resilience and observability slices (ROADMAP Queue 1).

The update sweep (``mxnet_tpu/gluon/trainer.py:202-244``) is one
multi-tensor op over every trainable parameter (``ops/optimizer_ops.py``),
as ``parallel.ShardedTrainer``'s is. ``aggregate_num`` is accepted for
parity and changes nothing: every grouping gives the same bits. Its
scalars are computed first, on the host (:meth:`Trainer._scalars`), and
the sweep takes them as Python floats or, in a captured step
(:func:`mxnet_tpu_torch.capture.capture`), as device slots holding them.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]


def _param_list(params):
    """``params`` -> [Parameter]: a ``collect_params()`` result (tensors,
    with their Parameters in ``param_objects``), a dict of Parameters, or
    a list of them."""
    if hasattr(params, "param_objects"):
        params = params.param_objects
    if hasattr(params, "values"):
        params = list(params.values())
    if not isinstance(params, (list, tuple)) or not all(
            isinstance(p, Parameter) for p in params):
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, or Block.collect_params(), got "
                         f"{type(params).__name__}.")
    return list(params)


class Trainer:
    """Applies ``optimizer`` (a name for :func:`optimizer.create`, or an
    Optimizer) to ``params`` (``mxnet_tpu/gluon/trainer.py:27``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = _param_list(params)
        if (kvstore not in (None, "device", "local") or update_on_kvstore
                or compression_params is not None):
            raise MXNetError(f"Trainer: kvstore={kvstore!r}, "
                             f"update_on_kvstore={update_on_kvstore!r} and "
                             "gradient compression are not ported yet: one "
                             "process has nothing to reduce (kvstore "
                             "'device', 'local' or None)")
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every trainable parameter, with gradients scaled
        by ``1 / batch_size`` (``mxnet_tpu/gluon/trainer.py:103``)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter whose ``grad_req`` is not
        "null" (``mxnet_tpu/gluon/trainer.py:161``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(self._scalars())

    def _active(self):
        return [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _scalars(self):
        """This step's scalars as Python floats: ``rescale_grad``, then
        ``lr`` and ``wd`` of each trainable parameter in sweep order. Each
        parameter's update count advances, as its eager update does."""
        optim = self._optimizer
        out = [optim.rescale_grad]
        for i in self._active():
            out += optim._scalars(i)
        return out

    def _update(self, scal):
        """The update sweep with the scalars ``scal`` of :meth:`_scalars`:
        those floats, or device slots holding them."""
        active = self._active()
        if len(scal) != 1 + 2 * len(active):
            raise ValueError(f"{len(scal)} scalars for {len(active)} "
                             "trainable parameters")
        weights = [self._params[i].data() for i in active]
        grads = [self._params[i].grad() for i in active]
        states = [self._updater.state(i, w) for i, w in zip(active, weights)]
        self._optimizer.update_group(weights, grads, states, list(scal[1::2]),
                                     list(scal[2::2]), scal[0])
