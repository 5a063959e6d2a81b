"""Executor: a bound Symbol run as a walk of its nodes (port of
``mxnet_tpu/executor.py:27-270``, inference subset; parity:
include/mxnet/executor.h).

``mxnet_tpu`` jits the walk into one XLA executable; the port calls each
node's registered op on tensors in topological order. The walk reads
nothing back to the host (calibrated constants are device fills), so a
forward can be captured whole as one CUDA graph: the serving Predictor
does that per bucket through :class:`~mxnet_tpu_torch.capture.
CapturedExec`, with :meth:`Executor.run` as the captured function. A
monitor callback (``set_monitor_callback``) sees every node output under
``mxnet_tpu``'s names ``<node>_output`` / ``<node>_output<i>``; with one
installed the walk runs eagerly, as calibration does. Nodes that no output
depends on are not in the walk. Gradients (``backward``, ``grad_req``
other than "null") are not ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import Context, as_device
from .ops import registry as _registry

__all__ = ["Executor"]


def _device(ctx):
    if isinstance(ctx, torch.device):
        return ctx
    return as_device(ctx if isinstance(ctx, Context) or ctx is None
                     else None)


def _tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(_np.ascontiguousarray(v)).to(device)


class Executor:
    """An inference executor over one Symbol. ``arg_dict`` and
    ``aux_dict`` hold the bound tensors by name; ``forward(**feeds)`` copies
    the feeds in and walks the graph; ``outputs`` are the results."""

    def __init__(self, symbol, device, arg_dict, aux_dict):
        self._symbol = symbol
        self._device = device
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._nodes = symbol._topo_nodes()
        self._ops = []
        for n in self._nodes:
            if n.is_var:
                continue
            op = _registry.get_op(n.op)
            params = op.normalize(n.params)
            self._ops.append((n, op, params, op.takes_train))
        self._outputs = None
        self.monitor_callback = None

    @property
    def outputs(self):
        return self._outputs or []

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install ``callback(name, tensor)``, called with every node output
        of each forward (``mxnet_tpu/executor.py:225``; ``monitor_all`` is
        accepted, as there, and changes nothing)."""
        self.monitor_callback = callback

    def run(self, arg_vals, aux_vals, is_train=False, tap=None):
        """The graph on tensors: ``arg_vals`` / ``aux_vals`` in
        ``list_arguments()`` / ``list_auxiliary_states()`` order. Returns
        (outputs, new aux values). ``tap(node, index, tensor)`` sees
        each node output."""
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        aux_pos = {n: i for i, n in enumerate(self._aux_names)}
        env, aux_out = {}, list(aux_vals)
        for n in self._nodes:
            if n.is_var:
                env[(id(n), 0)] = (aux_out[aux_pos[n.name]] if n.aux_mark
                                   else arg_vals[arg_pos[n.name]])
        for n, op, params, has_train in self._ops:
            ins = [env[(id(i), s)] for i, s in n.inputs]
            p = dict(params, _train=is_train) if has_train else params
            raw = op.closed(p)(*ins)
            raw = raw if isinstance(raw, tuple) else (raw,)
            n_primary = op.num_outputs
            for i in range(n_primary):
                env[(id(n), i)] = raw[i]
                if tap is not None:
                    tap(n, i, raw[i])
            for slot, val in zip(op.mutate, raw[n_primary:]):
                tgt, tgt_slot = n.inputs[slot]
                env[(id(tgt), tgt_slot)] = val
                if tgt.is_var and tgt.aux_mark:
                    aux_out[aux_pos[tgt.name]] = val
        return [env[(id(n), i)] for n, i in self._symbol._outputs], aux_out

    def forward(self, is_train=False, **kwargs):
        """Copy the named feeds into the bound arguments and run the graph;
        returns the output tensors. With ``is_train`` a BatchNorm uses the
        batch's statistics and its moving statistics are written back."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                v = _tensor(v, self._device)
                tgt = self.arg_dict[k]
                if tuple(tgt.shape) == tuple(v.shape):
                    tgt.copy_(v)        # in the bound tensor's dtype
                else:
                    self.arg_dict[k] = v
        tap = None
        if self.monitor_callback is not None:
            cb = self.monitor_callback

            def tap(node, i, t):
                cb(f"{node.name}_output" if i == 0
                   else f"{node.name}_output{i}", t)

        with torch.no_grad():
            outs, new_aux = self.run(self.arg_arrays, self.aux_arrays,
                                     bool(is_train), tap)
            for n, v in zip(self._aux_names, new_aux):
                if v is not self.aux_dict[n]:
                    self.aux_dict[n].copy_(v)
        self._outputs = outs
        return outs

    @staticmethod
    def _bind(symbol, ctx, args, args_grad=None, grad_req="null",
              aux_states=None):
        if args_grad is not None or grad_req != "null":
            raise MXNetError("bind: gradients are not ported (pass "
                             "grad_req='null'; ROADMAP Queue 1 item 11)")
        device = _device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        missing = [n for n in arg_names if n not in args]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux_states = dict(aux_states or {})
        missing = [n for n in aux_names if n not in aux_states]
        if missing:
            raise MXNetError(f"bind: missing auxiliary states {missing}")
        arg_dict = {n: _tensor(args[n], device) for n in arg_names}
        aux_dict = {n: _tensor(aux_states[n], device) for n in aux_names}
        return Executor(symbol, device, arg_dict, aux_dict)
