"""Executor: a bound Symbol run as a walk of its nodes (port of
``mxnet_tpu/executor.py:27-420``; parity: include/mxnet/executor.h).

``mxnet_tpu`` jits the walk into one XLA executable; the port calls each
node's registered op on tensors in topological order. The walk reads
nothing back to the host (calibrated constants are device fills), so a
forward can be captured whole as one CUDA graph: the serving Predictor
does that per bucket through :class:`~mxnet_tpu_torch.capture.
CapturedExec`, with :meth:`Executor.run` as the captured function. A
monitor callback (``set_monitor_callback``) sees every node output under
``mxnet_tpu``'s names ``<node>_output`` / ``<node>_output<i>``; with one
installed the walk runs eagerly, as calibration does. Nodes that no output
depends on are not in the walk.

Training. ``forward(is_train=True)`` walks the graph under
``torch.enable_grad()`` with every argument whose ``grad_req`` is not
"null" as a leaf of the tape (its tensor detached, memory shared), and
keeps the graph; ``backward(out_grads)`` takes the gradients of the
outputs (``out_grads`` as their head gradients, ones when None; the
output heads such as ``SoftmaxOutput`` ignore them) into ``grad_dict``:
'write' overwrites, 'add' accumulates across backward calls. The graph is
freed by the backward unless an argument's ``grad_req`` is 'add' (which
may call backward again), and dropped by the next forward. BatchNorm's
moving statistics, the mutated auxiliary slots, are written back in
training, detached, outside the graph. The inference walk
(``is_train=False``), the fused int8 plan and :meth:`Executor.run`, which
the Predictor captures, see none of this.

The executor holds and returns tensors. :class:`NDArrayExecutor`, which
``simple_bind`` and ``bind`` with NDArrays give, is the same executor with
its dicts, outputs and monitor values as NDArrays over those tensors.

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
from .ndarray.ndarray import NDArray, to_tensor
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
    from ``ops`` (the walk's (node, op, params) in order) and
    the graph's ``outputs``."""
    uses = {}
    for n, *_ in ops:
        for i, s in n.inputs:
            uses.setdefault(id(i), []).append((n, s))
    for n, i in outputs:
        uses.setdefault(id(n), []).append((None, i))
    canon = {id(n): op.name for n, op, *_ in ops}
    params = {id(n): p for n, _, p in ops}

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


_REQS = ("write", "add", "null")


def _grad_reqs(grad_req, names):
    """``grad_req`` (one for all, a list in ``names``' order or a dict)
    -> {name: req}."""
    if isinstance(grad_req, str):
        req = {n: grad_req for n in names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(names, grad_req))
    else:
        req = {n: grad_req.get(n, "null") for n in names}
    bad = {r for r in req.values() if r not in _REQS}
    if bad:
        raise MXNetError(f"bind: grad_req {sorted(bad)} for gradients must "
                         "be write, add or null")
    return req


def _named(arrays, names):
    """A dict of ``arrays`` given as a dict, or as a list in ``names``'
    order."""
    if isinstance(arrays, (list, tuple)):
        return dict(zip(names, arrays))
    return dict(arrays or {})


class Executor:
    """An executor over one Symbol. ``arg_dict`` / ``aux_dict`` /
    ``grad_dict`` hold the bound tensors by name; ``forward(**feeds)``
    copies the feeds in and walks the graph; ``outputs`` are the results;
    ``backward`` fills ``grad_dict`` by ``grad_req``."""

    def __init__(self, symbol, device, arg_dict, aux_dict, grad_dict=None,
                 grad_req="null"):
        self._symbol = symbol
        self._device = device
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self.grad_dict = dict(grad_dict or {})
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.grad_req = _grad_reqs(grad_req, self._arg_names)
        self._nodes = symbol._topo_nodes()
        self._ops = [(n, op, op.normalize(n.params)) for n, op in
                     ((n, _registry.get_op(n.op)) for n in self._nodes
                      if not n.is_var)]
        self._plan_fusions()
        self._outputs = None
        self._graph = None
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
        by_id = {id(n): (n, op, p) for n, op, p in self._ops}
        for n, op, params in self._ops:
            if id(n) in inner:
                continue
            if id(n) not in chains:
                self._fused_ops.append((n, op, params))
                continue
            conv, act, rq = chains[id(n)]
            p = dict(by_id[id(conv)][2], relu=act is not None)
            for k in ("min_calib_range", "max_calib_range"):
                if k in params:
                    p[k] = params[k]
            self._fused_ops.append((rq, _FUSED, p, conv))
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
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install ``callback(name, tensor)``, called with every node output
        of each forward (``mxnet_tpu/executor.py:225``; ``monitor_all`` is
        accepted, as there, and changes nothing)."""
        self.monitor_callback = callback

    def run(self, arg_vals, aux_vals, is_train=False, tap=None,
            device=None):
        """The graph on tensors: ``arg_vals`` / ``aux_vals`` in
        ``list_arguments()`` / ``list_auxiliary_states()`` order. Returns
        (outputs, new aux values). ``tap(node, index, tensor)`` sees
        each node output; with a tap the walk takes the unfused nodes (the
        plan's chains one node at a time). ``device`` (the bound one when
        None) is the device the ops are told, as a control-flow op tells
        the subgraph it runs."""
        device = device or self._device
        arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        aux_pos = {n: i for i, n in enumerate(self._aux_names)}
        env, aux_out = {}, list(aux_vals)
        for n in self._nodes:
            if n.is_var:
                env[(id(n), 0)] = (aux_out[aux_pos[n.name]] if n.aux_mark
                                   else arg_vals[arg_pos[n.name]])
        walk = self._fused_ops if tap is None else self._ops
        for n, op, params, *src in walk:
            # a fused chain reads its conv's inputs (src: the conv node)
            ins = [env[(id(i), s)] for i, s in (src[0] if src else n).inputs]
            raw = op.call(ins, params, device, is_train)
            raw = raw if isinstance(raw, tuple) else (raw,)
            n_primary = op.n_out(params)
            for i in range(n_primary):
                env[(id(n), i)] = raw[i]
                if tap is not None:
                    tap(n, i, raw[i])
            for slot, val in zip(op.mutate_slots(params), raw[n_primary:]):
                tgt, tgt_slot = n.inputs[slot]
                env[(id(tgt), tgt_slot)] = val
                if tgt.is_var and tgt.aux_mark:
                    aux_out[aux_pos[tgt.name]] = val
        return [env[(id(n), i)] for n, i in self._symbol._outputs], aux_out

    def forward(self, is_train=False, **kwargs):
        """Copy the named feeds into the bound arguments (in their dtype;
        a feed of another shape is bound in its place) and run the graph;
        returns the output tensors. With ``is_train`` a BatchNorm uses the
        batch's statistics and its moving statistics are written back, and
        when any argument takes a gradient the walk is recorded for
        :meth:`backward`."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                v = _tensor(v, self._device)
                tgt = self.arg_dict[k]
                if tuple(tgt.shape) == tuple(v.shape):
                    with torch.no_grad():
                        tgt.copy_(v)
                else:
                    self.arg_dict[k] = v
        tap = None
        if self.monitor_callback is not None:
            cb = self.monitor_callback

            def tap(node, i, t):
                cb(f"{node.name}_output" if i == 0
                   else f"{node.name}_output{i}", t.detach())

        self._graph = None
        args, leaves = self.arg_arrays, {}
        if is_train:
            for i, n in enumerate(self._arg_names):
                if self.grad_req[n] != "null" and n in self.grad_dict:
                    args[i] = leaves[n] = args[i].detach().requires_grad_()
        with torch.set_grad_enabled(bool(leaves)):
            outs, new_aux = self.run(args, self.aux_arrays, bool(is_train),
                                     tap)
        with torch.no_grad():
            for n, v in zip(self._aux_names, new_aux):
                if v is not self.aux_dict[n]:
                    self.aux_dict[n].copy_(v)
        if leaves:
            self._graph = (outs, leaves)
        self._outputs = [o.detach() for o in outs]
        return self._outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs into
        ``grad_dict``: ``out_grads`` (one tensor per output) are the head
        gradients, ones when None. The graph is kept for another backward
        when an argument's ``grad_req`` is 'add'; else it is freed here."""
        if self._graph is None:
            if any(self.grad_req[n] != "null" for n in self.grad_dict):
                raise MXNetError("backward: run forward(is_train=True) "
                                 "first")
            return
        outs, leaves = self._graph
        if out_grads is not None and not isinstance(out_grads, (list,
                                                                tuple)):
            out_grads = [out_grads]
        heads, grads = [], []
        for i, o in enumerate(outs):
            if o.requires_grad:
                g = torch.ones_like(o) if out_grads is None \
                    else out_grads[i].to(o.device, o.dtype)
                heads.append(o)
                grads.append(g)
        names = list(leaves)
        keep = any(self.grad_req[n] == "add" for n in names)
        got = torch.autograd.grad(heads, [leaves[n] for n in names], grads,
                                  retain_graph=keep, allow_unused=True) \
            if heads else [None] * len(names)
        if not keep:
            self._graph = None
        with torch.no_grad():
            for n, g in zip(names, got):
                buf = self.grad_dict[n]
                if self.grad_req[n] == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values (tensors or numpy arrays) into the bound
        arguments and auxiliary states."""
        for k, v in arg_params.items():
            if k in self.arg_dict:
                with torch.no_grad():
                    self.arg_dict[k].copy_(_tensor(v, self._device))
            elif not allow_extra_params:
                raise MXNetError(f"copy_params_from: unknown argument {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                with torch.no_grad():
                    self.aux_dict[k].copy_(_tensor(v, self._device))

    @staticmethod
    def _bind(symbol, ctx, args, args_grad=None, grad_req="null",
              aux_states=None):
        device = _device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        args = _named(args, arg_names)
        missing = [n for n in arg_names if n not in args]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        aux_states = _named(aux_states, aux_names)
        missing = [n for n in aux_names if n not in aux_states]
        if missing:
            raise MXNetError(f"bind: missing auxiliary states {missing}")
        arg_dict = {n: _tensor(args[n], device) for n in arg_names}
        aux_dict = {n: _tensor(aux_states[n], device) for n in aux_names}
        req = _grad_reqs(grad_req, arg_names)
        args_grad = _named(args_grad, arg_names)
        grad_dict = {n: _tensor(args_grad[n], device) if n in args_grad
                     else torch.zeros_like(arg_dict[n])
                     for n in arg_names if req[n] != "null"}
        return Executor(symbol, device, arg_dict, aux_dict, grad_dict, req)

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                     **shapes):
        """Zeros for every argument (``type_dict``'s dtype, float32 by
        default), auxiliary state and gradient, shapes inferred from
        ``shapes``; an auxiliary state whose shape does not follow (a
        Dropout's ``rng_key``) gets (2,)."""
        from .base import torch_dtype

        device = _device(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        arg_names = symbol.list_arguments()
        types = dict(type_dict or {})

        def zeros(n, s):
            return torch.zeros(tuple(s), device=device, dtype=torch_dtype(
                types.get(n, "float32")))

        arg_dict = {n: zeros(n, s) for n, s in zip(arg_names, arg_shapes)}
        aux_dict = {n: zeros(n, s if s is not None else (2,))
                    for n, s in zip(symbol.list_auxiliary_states(),
                                    aux_shapes)}
        req = _grad_reqs(grad_req, arg_names)
        grad_dict = {n: zeros(n, arg_dict[n].shape) for n in arg_names
                     if req[n] != "null"}
        return Executor(symbol, device, arg_dict, aux_dict, grad_dict, req)


class NDArrayExecutor:
    """An :class:`Executor` with NDArrays for its user: ``arg_dict``,
    ``aux_dict``, ``grad_dict`` and ``outputs`` are NDArrays over the
    executor's tensors, feeds and head gradients may be NDArrays, and the
    monitor sees NDArrays. Each forward and backward reads the tensor every
    array holds then, so an array given another tensor (a feed of another
    shape) is what the walk reads. Everything else is the executor's."""

    def __init__(self, executor, arg_dict=None, aux_dict=None,
                 grad_dict=None):
        self._exec = executor

        def boxed(tensors, given):
            """NDArrays over ``tensors``; a given array holding the tensor
            stays itself."""
            given = given or {}
            return {n: given[n] if isinstance(given.get(n), NDArray)
                    and given[n]._data is t else NDArray(t)
                    for n, t in tensors.items()}

        self.arg_dict = boxed(executor.arg_dict, arg_dict)
        self.aux_dict = boxed(executor.aux_dict, aux_dict)
        self.grad_dict = boxed(executor.grad_dict, grad_dict)
        self.outputs = []

    def __getattr__(self, name):
        if name == "_exec":
            raise AttributeError(name)
        return getattr(self._exec, name)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def _sync(self):
        ex = self._exec
        for tensors, arrays in ((ex.arg_dict, self.arg_dict),
                                (ex.aux_dict, self.aux_dict),
                                (ex.grad_dict, self.grad_dict)):
            for n, a in arrays.items():
                tensors[n] = a._data

    def set_monitor_callback(self, callback, monitor_all=False):
        self._exec.set_monitor_callback(
            lambda name, t: callback(name, NDArray(t)), monitor_all)

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(v)
        self._sync()
        self.outputs = [NDArray(o) for o in self._exec.forward(is_train)]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        if out_grads is not None:
            out_grads = [to_tensor(g) for g in out_grads]
        self._sync()
        self._exec.backward(out_grads, is_train)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values (NDArrays, tensors or numpy arrays) into
        the bound arguments and auxiliary states."""
        self._sync()
        self._exec.copy_params_from(
            {k: to_tensor(v) for k, v in arg_params.items()},
            {k: to_tensor(v) for k, v in (aux_params or {}).items()},
            allow_extra_params)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad=None, grad_req="null",
              aux_states=None):
        """:meth:`Executor._bind` on the tensors of NDArrays; the given
        arrays on the executor's device are its dicts' entries."""
        arg_names = symbol.list_arguments()
        args = _named(args, arg_names)
        args_grad = _named(args_grad, arg_names)
        aux_states = _named(aux_states, symbol.list_auxiliary_states())

        def unboxed(d):
            return {k: to_tensor(v) for k, v in d.items()}

        ex = Executor._bind(symbol, ctx, unboxed(args), unboxed(args_grad),
                            grad_req, unboxed(aux_states))
        return NDArrayExecutor(ex, args, aux_states, args_grad)
