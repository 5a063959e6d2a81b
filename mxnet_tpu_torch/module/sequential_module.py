"""SequentialModule: Modules chained head to tail (port of
``mxnet_tpu/module/sequential_module.py``; parity:
python/mxnet/module/sequential_module.py).

Each Module takes the previous one's outputs as its data, under its own
``data_names``; ``add(module, take_labels=True)`` also hands it the
batch's labels. The backward runs the chain in reverse, each Module's
input gradients the head gradients of the one before it, so every Module
after the first is bound with ``inputs_need_grad``. A body Module with a
``PythonLossModule`` head is the usual use.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append ``module`` (``take_labels=True``: it gets the labels);
        returns self, so calls chain."""
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _takes_labels(self, i):
        return self._metas[i].get(self.META_TAKE_LABELS, False)

    @property
    def data_names(self):
        return self._modules[0].data_names

    @property
    def output_names(self):
        return self._modules[-1].output_names

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule is empty; call add() first")
        self._label_shapes = label_shapes
        shapes = data_shapes
        for i, m in enumerate(self._modules):
            m.bind(shapes, label_shapes if self._takes_labels(i) else None,
                   for_training=for_training,
                   inputs_need_grad=inputs_need_grad or i > 0,
                   force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 < len(self._modules):
                # the next Module's data are these outputs, under its names
                shapes = [DataDesc(name, shape) for name, (_, shape) in
                          zip(self._modules[i + 1].data_names,
                              m.output_shapes)]
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, m in enumerate(self._modules):
            m.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            take = self._takes_labels(i + 1)
            outs = m.get_outputs()
            batch = DataBatch(
                data=outs, label=data_batch.label if take else None,
                pad=data_batch.pad,
                provide_data=[DataDesc(n, o.shape) for n, o in zip(
                    self._modules[i + 1].data_names, outs)],
                provide_label=data_batch.provide_label if take else None)

    def backward(self, out_grads=None):
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(out_grads=grads)
            if i > 0:
                grads = self._modules[i].get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for i, m in enumerate(self._modules):
            if self._takes_labels(i):
                m.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for m in self._modules:
            m.install_monitor(mon)
