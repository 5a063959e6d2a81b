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

The plan. At bind time the executor finds each chain
``_contrib_quantized_conv`` -> [``_contrib_quantized_act`` relu] ->
``_contrib_requantize`` whose intermediate outputs have no other consumer
and are not graph outputs, and whose conv takes route "wgmma" by
``ops.quantization._s8_route`` (2-D, one group): the walk runs it as one
:func:`~mxnet_tpu_torch.ops.quantization.quantized_conv_requantize`, the
conv's fused epilogue (a calibrated requantize in it, or the int32 and its
batch range), bitwise the three ops in turn. This is the port's
counterpart of XLA fusing the requantize into the conv's output fusion on
the TPU. A monitor or a ``tap`` walks the unfused nodes, so every node
output is seen.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import Context, as_device
from .ops import quantization as _quant
from .ops import registry as _registry

__all__ = ["Executor"]


def _device(ctx):
    if isinstance(ctx, torch.device):
        return ctx
    return as_device(ctx if isinstance(ctx, Context) or ctx is None
                     else None)


_CONV, _ACT, _RQ = ("_contrib_quantized_conv", "_contrib_quantized_act",
                    "_contrib_requantize")
# a fused chain's step in the walk
_FUSED = _registry.OpDef("_fused_quantized_conv_requantize",
                         _quant.quantized_conv_requantize, num_outputs=3)


def _fused_chains(ops, outputs):
    """The conv -> [relu] -> requantize chains the walk may fuse, as
    {id(requantize node): (conv node, act node or None, requantize node)},
    from ``ops`` (the walk's (node, op, params, has_train) in order) and
    the graph's ``outputs``."""
    uses = {}
    for n, *_ in ops:
        for i, s in n.inputs:
            uses.setdefault(id(i), []).append((n, s))
    for n, i in outputs:
        uses.setdefault(id(n), []).append((None, i))
    canon = {id(n): op.name for n, op, *_ in ops}
    params = {id(n): p for n, _, p, _ in ops}

    def sole_consumer(node):
        """The one node that reads ``node``'s three outputs, in order, and
        nothing else reads them; else None."""
        users = uses.get(id(node), [])
        nxt = users[0][0] if users else None
        if nxt is None or any(u is not nxt for u, _ in users) or \
                [(id(i), s) for i, s in nxt.inputs] != \
                [(id(node), k) for k in range(3)]:
            return None
        return nxt

    chains = {}
    for conv, *_ in ops:
        if canon[id(conv)] != _CONV:
            continue
        p = params[id(conv)]
        kernel = p.get("kernel")
        kernel = tuple(kernel) if isinstance(kernel, (tuple, list)) \
            else kernel
        if not isinstance(kernel, tuple) or len(kernel) != 2 or \
                int(p.get("num_group", 1)) != 1:
            continue
        if _quant._s8_route(
                "conv", kernel=kernel,
                stride=_quant._pairs(p.get("stride") or 1, 2),
                pad=_quant._pairs(p.get("pad") or 0, 2),
                dilate=_quant._pairs(p.get("dilate") or 1, 2)) != "wgmma":
            continue
        act = sole_consumer(conv)
        if act is not None and canon.get(id(act)) == _ACT and \
                params[id(act)].get("act_type", "relu") == "relu":
            rq = sole_consumer(act)
        else:
            act, rq = None, act
        if rq is not None and canon.get(id(rq)) == _RQ:
            chains[id(rq)] = (conv, act, rq)
    return chains


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
        self._plan_fusions()
        self._outputs = None
        self.monitor_callback = None

    def _plan_fusions(self):
        """The fused walk: ``self._fused_ops``, ``self._ops`` with each
        chain of :func:`_fused_chains` one step at its requantize's place
        (its conv and relu left out); ``self.fused_chains`` lists them as
        (conv node, relu node or None, requantize node, "requant" or
        "range"), in walk order."""
        chains = _fused_chains(self._ops, self._symbol._outputs)
        inner = {id(n) for conv, act, _ in chains.values()
                 for n in (conv, act) if n is not None}
        self._fused_ops, self.fused_chains = [], []
        by_id = {id(n): (n, op, p, t) for n, op, p, t in self._ops}
        for n, op, params, has_train in self._ops:
            if id(n) in inner:
                continue
            if id(n) not in chains:
                self._fused_ops.append((n, op, params, has_train))
                continue
            conv, act, rq = chains[id(n)]
            p = dict(by_id[id(conv)][2], relu=act is not None)
            for k in ("min_calib_range", "max_calib_range"):
                if k in params:
                    p[k] = params[k]
            self._fused_ops.append((rq, _FUSED, p, False, conv))
            calibrated = "min_calib_range" in params and \
                "max_calib_range" in params
            self.fused_chains.append(
                (conv, act, rq, "requant" if calibrated else "range"))

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
        each node output; with a tap the walk takes the unfused nodes (the
        plan's chains one node at a time)."""
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        aux_pos = {n: i for i, n in enumerate(self._aux_names)}
        env, aux_out = {}, list(aux_vals)
        for n in self._nodes:
            if n.is_var:
                env[(id(n), 0)] = (aux_out[aux_pos[n.name]] if n.aux_mark
                                   else arg_vals[arg_pos[n.name]])
        walk = self._fused_ops if tap is None else self._ops
        for n, op, params, has_train, *src in walk:
            # a fused chain reads its conv's inputs (src: the conv node)
            ins = [env[(id(i), s)] for i, s in (src[0] if src else n).inputs]
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
