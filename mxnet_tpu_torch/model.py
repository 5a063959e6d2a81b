"""Checkpoints and the kvstore plumbing Module shares (port of
``mxnet_tpu/model.py``; parity: python/mxnet/model.py).

A checkpoint is ``mxnet_tpu``'s: ``<prefix>-symbol.json`` (the Symbol's
JSON) and ``<prefix>-<epoch:04d>.params`` (an npz of ``arg:<name>`` and
``aux:<name>`` arrays, ``ndarray.save``'s format), so a checkpoint written
by either package loads in the other.
"""
from __future__ import annotations

import os
from collections import namedtuple

from .ndarray import ndarray as _nd

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

# 'local' keeps the update on the store below this many elements a weight
# (mxnet_tpu/model.py:33-37)
_LOCAL_UPDATE_LIMIT = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """(store or None, update_on_kvstore): no store for one device unless
    it is a distributed one (model.py _create_kvstore)."""
    from . import kvstore as kvs

    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local" and max(
                    p.size for p in arg_params.values()) > \
                    _LOCAL_UPDATE_LIMIT:
                update_on_kvstore = False
    else:
        kv = kvstore
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each weight's gradients (summed on the store, which updates
    the weight) and pull the weight back to every device."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum the gradients on the store (when there is one), then update each
    device's weights with ``updater``, keyed by name on one device and by
    ``index * num_device + device`` on several (model.py:73-99)."""
    updates = [[] for _ in range(num_device)]
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            key = param_names[index] if param_names is not None and \
                num_device == 1 else index * num_device + k
            updates[k].append((key, g, w))
    for dev_updates in updates:
        for upd in dev_updates:
            updater(*upd)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """``<prefix>-symbol.json`` and ``<prefix>-<epoch:04d>.params``
    (model.py:407)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch):
    """(arg_params, aux_params) of ``<prefix>-<epoch:04d>.params`` as
    NDArrays on ``cpu()``."""
    save_dict = _nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) (model.py:456); the symbol is None
    when there is no ``-symbol.json``."""
    from . import symbol as sym

    symbol = None
    if os.path.exists(f"{prefix}-symbol.json"):
        symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
