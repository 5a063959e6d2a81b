"""PythonModule and PythonLossModule: Modules written in Python (port of
``mxnet_tpu/module/python_module.py``; parity:
python/mxnet/module/python_module.py).

``PythonModule`` wires the Module life cycle for a computation with no
Symbol and no parameters; a subclass writes ``forward``, ``backward`` and
``_compute_output_shapes``. ``PythonLossModule`` is a loss head: its
forward keeps the scores, its backward gives their gradient, from
``grad_func(scores, labels)`` or softmax cross-entropy's ``softmax(scores)
- one_hot(labels)``, on the scores' context. It goes last in a
``SequentialModule``.
"""
from __future__ import annotations

import logging

from ..ndarray import ndarray as _nd
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and write ``forward``, ``backward``, ``get_outputs``
    (``python_module.py:35``)."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else None
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss head (``python_module.py:PythonLossModule``): the output is
    the scores; the backward gives d(loss)/d(scores)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, (name + "_output",),
                         logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "the loss module is the graph's head"
        if self._grad_func is not None:
            g = self._grad_func(self._scores, self._labels)
            if not isinstance(g, _nd.NDArray):
                g = _nd.array(g, ctx=self._scores.context)
            self._scores_grad = g
        else:
            p = _nd.imperative_invoke("softmax", self._scores)[0]
            y = _nd.imperative_invoke(
                "one_hot", self._labels.as_in_context(p.context),
                depth=p.shape[-1])[0]
            self._scores_grad = p - y

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
