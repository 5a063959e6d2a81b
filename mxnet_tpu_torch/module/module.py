"""Module: symbolic training over one or more device contexts (port of
``mxnet_tpu/module/module.py``; parity: python/mxnet/module/module.py and
executor_group.py).

``bind`` makes one executor per context (``simple_bind``), each over an
equal slice of the batch (``module.py:122-180``; DataParallelExecutorGroup).
The parameters live on ``cpu()`` in ``_arg_params`` / ``_aux_params`` and
are copied to every executor. ``init_optimizer`` rescales the gradients by
1 / batch, reads the lr / wd multipliers from the symbol's attributes
(``__lr_mult__`` / ``__wd_mult__``, e.g. from ``AttrScope`` or
``Variable(lr_mult=)``), and updates on a kvstore (several contexts) or
with a local updater (``module.py:240-288``). ``bind(shared_module=m)``
binds over ``m``'s parameter, gradient and auxiliary arrays, as MXNet
does (``BucketingModule`` binds every bucket so). ``Module(context=None)``
runs on ``gpu(0)``, the port's default context, where MXNet's default is
the CPU. The initializer draws from ``mx.random``'s CPU generator, so
``mx.random.seed`` fixes the initial weights.
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from ..ndarray import ndarray as nd
from ..ndarray.ndarray import NDArray, to_tensor
from .base_module import BaseModule

__all__ = ["Module"]


def _desc(desc):
    """(name, shape) of a DataDesc or a (name, shape) pair."""
    if isinstance(desc, (tuple, list)) and not hasattr(desc, "shape"):
        return desc[0], tuple(desc[1])
    return desc.name, tuple(desc.shape)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        context = context or current_context()
        self._context = [context] if isinstance(context, Context) \
            else list(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        inputs = set(self._data_names + self._label_names
                     + self._state_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._execs = []
        self._data_shapes = None
        self._label_shapes = None
        self._slices = None
        self._preload_opt_states = None

    # ------------------------------------------------------------ factories
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over the checkpoint ``prefix``, ``epoch``, its
        parameters set (bind it before use)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        from ..model import save_checkpoint

        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """The whole batch's output shapes (not one context's slice)."""
        assert self.binded
        shapes = dict(_desc(d) for d in list(self._data_shapes)
                      + list(self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # ----------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._execs = []
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else []
        ndev = len(self._context)
        total = _desc(self._data_shapes[0])[1][0]
        if total % ndev:
            raise MXNetError(f"batch size {total} not divisible by number "
                             f"of contexts {ndev}")
        step = total // ndev
        self._slices = [slice(i * step, (i + 1) * step) for i in range(ndev)]
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names or name in self._label_names or \
                    name in self._fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        if inputs_need_grad:
            for name in self._data_names:
                req[name] = "write"
        shapes = {}
        for desc in self._data_shapes + self._label_shapes:
            name, s = _desc(desc)
            shapes[name] = (step,) + s[1:]
        self._execs = [self._symbol.simple_bind(ctx, grad_req=req, **shapes)
                       for ctx in self._context]
        self.binded = True
        if shared_module is not None:
            self._share(shared_module)
        elif self.params_initialized:
            # a Module made by load(): its parameters go to the executors
            for ex in self._execs:
                ex.copy_params_from(self._arg_params, self._aux_params,
                                    allow_extra_params=True)

    def _share(self, shared):
        """Take ``shared``'s parameter, gradient and auxiliary arrays into
        this Module's executors, and its host copies, as MXNet's
        ``shared_module`` does: the two Modules then read and update the
        same memory, and switching between them moves no bytes."""
        if not (shared.binded and shared.params_initialized):
            raise MXNetError("bind: shared_module must be bound and its "
                             "parameters initialized")
        if len(shared._execs) != len(self._execs):
            raise MXNetError("bind: shared_module runs on "
                             f"{len(shared._execs)} contexts, this Module on "
                             f"{len(self._execs)}")
        for ex, other in zip(self._execs, shared._execs):
            for kind, names in (("arg_dict", self._param_names),
                                ("grad_dict", self._param_names),
                                ("aux_dict", self._aux_names)):
                mine, theirs = getattr(ex, kind), getattr(other, kind)
                for n in names:
                    if kind == "grad_dict" and n not in mine:
                        continue        # grad_req 'null' here
                    if n not in theirs:
                        raise MXNetError(f"bind: shared_module has no {n} "
                                         f"in its {kind}")
                    if mine[n].shape != theirs[n].shape:
                        raise MXNetError(
                            f"bind: {n} is {mine[n].shape} here and "
                            f"{theirs[n].shape} in shared_module")
                    mine[n] = theirs[n]
            ex._sync()
        self._arg_params = shared._arg_params
        self._aux_params = shared._aux_params
        self.params_initialized = True

    # --------------------------------------------------------------- params
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters from ``arg_params`` / ``aux_params``
        (NDArrays, tensors or numpy arrays), the rest with
        ``initializer``."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        from .. import random as _random

        ex0 = self._execs[0]
        if self._arg_params is None:
            self._arg_params = {n: nd.zeros(ex0.arg_dict[n].shape, cpu(),
                                            ex0.arg_dict[n]._data.dtype)
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: nd.zeros(ex0.aux_dict[n].shape, cpu(),
                                            ex0.aux_dict[n]._data.dtype)
                                for n in self._aux_names}
        gen = _random.generator("cpu")

        def fill(name, arr, given):
            if given is not None and name in given:
                if given[name] is not arr:
                    arr._set_data(given[name])
            elif initializer is not None:
                initializer(name, arr._data, generator=gen)
            elif not allow_missing:
                raise MXNetError(f"{name} is not presented")

        for name, arr in sorted(self._arg_params.items()):
            fill(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            fill(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        for ex in self._execs:
            ex.copy_params_from(self._arg_params, self._aux_params,
                                allow_extra_params=True)

    def get_params(self):
        """(arg_params, aux_params): NDArrays on ``cpu()``."""
        assert self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _sync_params_from_devices(self):
        if not self._execs:
            return
        ex0 = self._execs[0]
        for n in self._param_names:
            self._arg_params[n]._set_data(ex0.arg_dict[n]._data.cpu())
        for n in self._aux_names:
            self._aux_params[n]._set_data(ex0.aux_dict[n]._data.cpu())
        self._params_dirty = False

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = sum(s.stop - s.start for s in self._slices)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
            attrs = self.symbol.attr_dict()
            lr_mult = {n: float(a["__lr_mult__"])
                       for n, a in attrs.items() if "__lr_mult__" in a}
            wd_mult = {n: float(a["__wd_mult__"])
                       for n, a in attrs.items() if "__wd_mult__" in a}
            if lr_mult:
                optimizer.set_lr_mult(lr_mult)
            if wd_mult:
                optimizer.set_wd_mult({**optimizer.wd_mult, **wd_mult})
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            _initialize_kvstore(
                kvstore=kvstore,
                param_arrays=[[ex.arg_dict[n] for ex in self._execs]
                              for n in self._param_names],
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = opt.get_updater(self._optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # ------------------------------------------------------------ execution
    def forward(self, data_batch, is_train=None):
        """Feed each context its slice of the batch and run its executor."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        several = len(self._execs) > 1
        names = self._data_names + self._label_names
        arrays = list(data_batch.data) + list(data_batch.label or [])
        for ex, sl in zip(self._execs, self._slices):
            feeds = {}
            for name, arr in zip(names, arrays):
                if isinstance(arr, NDArray):
                    arr = arr[sl] if several else arr
                else:
                    arr = to_tensor(arr)[sl] if several else arr
                feeds[name] = arr
            ex.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for ex in self._execs:
            ex.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step from the executors' gradients."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        params = [[ex.arg_dict[n] for ex in self._execs]
                  for n in self._param_names]
        grads = [[ex.grad_dict.get(n) for ex in self._execs]
                 for n in self._param_names]
        if self._update_on_kvstore:
            _update_params_on_kvstore(params, grads, self._kvstore,
                                      self._param_names)
        else:
            _update_params(params, grads, updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = [ex.outputs for ex in self._execs]
        if merge_multi_context and len(outs) > 1:
            return [nd.concatenate([o[i] for o in outs], axis=0)
                    for i in range(len(outs[0]))]
        return outs[0] if merge_multi_context else outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        grads = [[ex.grad_dict.get(n) for n in self._data_names]
                 for ex in self._execs]
        if merge_multi_context and len(grads) > 1:
            return [nd.concatenate([g[i] for g in grads], axis=0)
                    for i in range(len(grads[0]))]
        return grads[0] if merge_multi_context else grads

    def get_states(self, merge_multi_context=True):
        return []

    def set_states(self, states=None, value=None):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self.get_outputs())))

    def install_monitor(self, mon):
        for ex in self._execs:
            mon.install(ex)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, keeping the parameters."""
        assert self.binded
        if self._params_dirty:
            self._sync_params_from_devices()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        for ex in self._execs:
            ex.copy_params_from(self._arg_params, self._aux_params,
                                allow_extra_params=True)
