"""BucketingModule: training over inputs of several shapes, one Module a
bucket (port of ``mxnet_tpu/module/bucketing_module.py:21-212``; parity:
python/mxnet/module/bucketing_module.py).

``sym_gen(bucket_key)`` gives each bucket's (symbol, data_names,
label_names). The default bucket is bound first; every other bucket is
bound on first use with the default bucket's Module as its
``shared_module``, so all buckets read and update the same parameter,
gradient and auxiliary arrays, and one updater (its states keyed by
name) follows them across buckets. Switching buckets moves no bytes.
``mxnet_tpu`` copies the live parameters into the target bucket on every
switch instead (``bucketing_module.py:110-118``); the values are the
same. Each bucket's executor captures its own fused forward + backward
graph over the shared tensors (``executor.py``): one graph a bucket key,
as ``mxnet_tpu`` compiles one program a bucket. The buckets' graphs share
one memory pool (``capture.GraphPool``), so their temporaries take about
the largest bucket's memory, not the sum over buckets.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        if work_load_list is not None or group2ctxs is not None:
            raise MXNetError("BucketingModule: work_load_list and group2ctxs "
                             "are not ported (ROADMAP Queue 1 item 11)")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = "write"

    def _gen_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names=data_names,
                      label_names=label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        return self._curr_module.symbol

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket with these shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module is not supported for "
                             "BucketingModule")
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its Module over the default
        bucket's arrays on first use."""
        if not self.binded:
            raise MXNetError("call bind before switching buckets")
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, shared_module=default,
                        grad_req=self._grad_req)
            if default.optimizer_initialized:
                module.borrow_optimizer(default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def get_params(self):
        """(arg_params, aux_params) on ``cpu()``, read from the shared
        arrays when an update ran since the last read."""
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """One optimizer and updater, the current bucket's, borrowed by
        every other bucket."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        if self._compression_params and self._curr_module._kvstore:
            self._curr_module._kvstore.set_gradient_compression(
                self._compression_params)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Switch to the batch's ``bucket_key`` (the default bucket when it
        has none) and run its forward."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before forward")
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_optimizer_states(self, fname):
        self._curr_module.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self._curr_module.load_optimizer_states(fname)
