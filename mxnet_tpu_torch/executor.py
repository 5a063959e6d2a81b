"""Executor: a bound Symbol run as a walk of its nodes (port of
``mxnet_tpu/executor.py:27-420``; parity: include/mxnet/executor.h).

The walk calls each node's registered op on tensors in topological order
(:meth:`Executor.run`). It reads nothing back to the host (calibrated
constants are device fills), so it can be captured whole as one CUDA
graph: the serving Predictor does that per bucket, with :meth:`Executor.
run` as the captured function. Nodes that no output depends on are not in
the walk.

Capture, the counterpart of ``mxnet_tpu``'s ``_jit_fwd`` / ``_jit_fwd_bwd``
(``mxnet_tpu/executor.py:146-175``). :meth:`Executor.forward` and
:meth:`Executor.backward` run two programs through one
:class:`~mxnet_tpu_torch.capture.CapturedExec` (one CUDA graph per
signature on the card; the same program run directly on the CPU):

- the forward (``is_train`` False, or True with nothing to differentiate),
  which writes the outputs and, in training, BatchNorm's moving
  statistics (the mutated auxiliary slots) in place;
- the forward and backward fused: ``forward(is_train=True)`` with an
  argument whose ``grad_req`` is not "null" is deferred, as in
  ``mxnet_tpu``, and ``backward(out_grads)`` runs the fused program, which
  writes the outputs, the gradients into ``grad_dict`` ('write'
  overwrites, 'add' accumulates; ``out_grads`` are the head gradients,
  ones when None, and the output heads such as ``SoftmaxOutput`` ignore
  them) and the mutated aux. Outputs read before the ``backward`` run the
  training forward first, as ``mxnet_tpu``'s ``_LazyOutputs`` does, so its
  moving statistics move twice that step, as ``mxnet_tpu``'s do.

A signature's key holds every argument's and aux slot's shape and dtype,
the ``grad_req``, whether ``out_grads`` are given, and ``is_train``; the
graph reads and writes the bound tensors in place, so their addresses are
its state: a feed of a new shape (bound in place of the old argument) or
a rebound array is captured again, with its reason in
``capture.retrace_log()``. A Dropout or a sampler in the graph draws from
``mx.random``'s generator in the graph, a fresh draw each replay, as the
eager walk draws. Executors bound over a ``shared_module`` (a
BucketingModule's buckets) capture into one graph memory pool
(:meth:`share_graph_pool`). A capture that fails on the card raises
``CaptureError``. A monitor callback (``set_monitor_callback``) sees every
node output under ``mxnet_tpu``'s names ``<node>_output`` /
``<node>_output<i>``; with one installed, and under the kill switch
``MXNET_TPU_TORCH_CAPTURE=0``, the walk runs eagerly, and so does a
graph holding an op that reads its operands on the host (``host=True`` in
``ops/registry.py``: ``_while_loop``, ``_cond``, ``boolean_mask``; listed
in ``Executor.host_ops``), which a CUDA graph cannot replay; each such
forward is counted in ``capture.stats()["capture_fallback_eager"]``: ``forward(is_train=True)``
walks the graph under ``torch.enable_grad()`` with every differentiated
argument a leaf of the tape (its tensor detached, memory shared) and
``backward`` takes ``torch.autograd.grad`` of that tape, kept for another
backward when an argument's ``grad_req`` is 'add'. The inference walk of
a monitor, the fused int8 plan and :meth:`Executor.run` see none of this.

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
        self._cap = None            # the CapturedExec, made at first use
        self._graph_pool = None     # its graphs' memory pool
        # ops that read their operands on the host (the registry's
        # host=True: _while_loop, _cond, boolean_mask ...) cannot be held
        # in a CUDA graph: a graph with one walks eagerly
        self.host_ops = sorted({op.name for _, op, _ in self._ops
                                if op.host})
        self._fed_train = False     # a deferred training forward was fed
        self._pending_train = False  # ... and has not run yet
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
        if self._outputs is None and self._pending_train:
            self._outputs = self._replay("forward", True)
            self._pending_train = False
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
        a feed of another shape is bound in its place) and run the
        forward; returns the output tensors. With ``is_train`` a BatchNorm
        uses the batch's statistics and its moving statistics are written
        back; when an argument takes a gradient the training forward is
        deferred to :meth:`backward`'s fused program (the returned list
        runs it when read first)."""
        from . import capture as _capture

        for k, v in kwargs.items():
            if k in self.arg_dict:
                v = _tensor(v, self._device)
                tgt = self.arg_dict[k]
                if tuple(tgt.shape) == tuple(v.shape):
                    with torch.no_grad():
                        tgt.copy_(v)
                else:
                    self.arg_dict[k] = v
        self._graph = None
        self._fed_train = self._pending_train = False
        if self.monitor_callback is not None or self.host_ops or \
                not _capture.enabled():
            _capture._STATS["capture_fallback_eager"] += 1
            return self._forward_eager(is_train)
        if is_train and self._diff_names():
            self._fed_train = self._pending_train = True
            self._outputs = None
            return _LazyOutputs(self)
        self._outputs = self._replay("forward", bool(is_train))
        return self._outputs

    def _diff_names(self):
        return [n for n in self._arg_names
                if self.grad_req[n] != "null" and n in self.grad_dict]

    def _forward_eager(self, is_train):
        """The eager walk: a monitor's, and the kill switch's."""
        tap = None
        if self.monitor_callback is not None:
            cb = self.monitor_callback

            def tap(node, i, t):
                cb(f"{node.name}_output" if i == 0
                   else f"{node.name}_output{i}", t.detach())

        args, leaves = self.arg_arrays, {}
        if is_train:
            for i, n in enumerate(self._arg_names):
                if self.grad_req[n] != "null" and n in self.grad_dict:
                    args[i] = leaves[n] = args[i].detach().requires_grad_()
        with torch.set_grad_enabled(bool(leaves)):
            outs, new_aux = self.run(args, self.aux_arrays, bool(is_train),
                                     tap)
        self._write_aux(new_aux)
        if leaves:
            self._graph = (outs, leaves)
        self._outputs = [o.detach() for o in outs]
        return self._outputs

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for n, v in zip(self._aux_names, new_aux):
                if v is not self.aux_dict[n]:
                    self.aux_dict[n].copy_(v)

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs into
        ``grad_dict``: ``out_grads`` (one tensor per output) are the head
        gradients, ones when None. After a captured forward this runs the
        fused forward + backward program (again at each call, as
        ``mxnet_tpu``'s does); after an eager one it takes the tape's
        gradients, the tape kept for another backward when an argument's
        ``grad_req`` is 'add', else freed here."""
        if out_grads is not None and not isinstance(out_grads, (list,
                                                                tuple)):
            out_grads = [out_grads]
        if self._graph is None:
            if self._fed_train:
                self._outputs = self._replay("backward", True, out_grads)
                self._pending_train = False
                return
            if self._diff_names():
                raise MXNetError("backward: run forward(is_train=True) "
                                 "first")
            return
        outs, leaves = self._graph
        names = list(leaves)
        keep = any(self.grad_req[n] == "add" for n in names)
        got = self._grads_of(outs, leaves, out_grads, keep)
        if not keep:
            self._graph = None
        self._write_grads(names, got)

    def _grads_of(self, outs, leaves, out_grads, keep):
        heads, grads = [], []
        for i, o in enumerate(outs):
            if o.requires_grad:
                g = torch.ones_like(o) if out_grads is None \
                    else out_grads[i].to(o.device, o.dtype)
                heads.append(o)
                grads.append(g)
        names = list(leaves)
        return torch.autograd.grad(heads, [leaves[n] for n in names], grads,
                                   retain_graph=keep, allow_unused=True) \
            if heads else [None] * len(names)

    def _write_grads(self, names, got):
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

    # ------------------------------------------------------------ capture
    def _state(self):
        """The tensors the programs read or write in place."""
        return self.arg_arrays + self.aux_arrays + \
            [self.grad_dict[n] for n in self._arg_names
             if n in self.grad_dict]

    def _mutated(self):
        return self.aux_arrays + [self.grad_dict[n] for n in
                                  self._arg_names if n in self.grad_dict]

    def _warmup_guard(self):
        from .capture import _restored

        return _restored(self._mutated())

    def share_graph_pool(self, other):
        """Capture into ``other``'s graph memory pool (a BucketingModule's
        buckets, which never run at once): the pool then holds about the
        largest bucket's temporaries, not their sum."""
        from . import capture as _capture

        other = getattr(other, "_exec", other)    # an NDArrayExecutor's
        if other._graph_pool is None:
            other._graph_pool = _capture.GraphPool()
        self._graph_pool = other._graph_pool

    def _replay(self, kind, is_train, out_grads=None):
        """Run ``kind`` ("forward" or "backward", the fused program)
        through the CapturedExec; returns the outputs."""
        from . import capture as _capture

        if self._cap is None:
            if self._graph_pool is None:
                self._graph_pool = _capture.GraphPool()
            self._cap = _capture.CapturedExec(
                self._program, label="executor:" + ",".join(
                    self._symbol.list_outputs()),
                device=self._device, state=self._state,
                warmup_guard=self._warmup_guard, pool=self._graph_pool)
        shapes = tuple((tuple(t.shape), str(t.dtype))
                       for t in self.arg_arrays + self.aux_arrays)
        req = tuple(self.grad_req[n] for n in self._arg_names)
        heads = [to_tensor(g) for g in out_grads] if out_grads else []
        out = self._cap(*heads, key=(kind, is_train, req, bool(heads),
                                     shapes))
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _program(self, *heads_and_key):
        """The captured programs: the forward, or the forward and backward
        fused. Writes the mutated aux and the gradients in place; returns
        the outputs."""
        heads, (kind, is_train, _req, has_heads, _shapes) = \
            list(heads_and_key[:-5]), heads_and_key[-5:]
        if kind == "forward":
            with torch.no_grad():
                outs, new_aux = self.run(self.arg_arrays, self.aux_arrays,
                                         is_train)
            self._write_aux(new_aux)
            return [o.detach() for o in outs]
        args, leaves = self.arg_arrays, {}
        for i, n in enumerate(self._arg_names):
            if self.grad_req[n] != "null" and n in self.grad_dict:
                args[i] = leaves[n] = args[i].detach().requires_grad_()
        with torch.enable_grad():
            outs, new_aux = self.run(args, self.aux_arrays, True)
        self._write_aux(new_aux)
        got = self._grads_of(outs, leaves, heads if has_heads else None,
                             False)
        self._write_grads(list(leaves), got)
        return [o.detach() for o in outs]

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


class _LazyOutputs(list):
    """What a deferred ``forward(is_train=True)`` returns: a list that
    runs the training forward when first read (``mxnet_tpu/executor.py``
    ``_LazyOutputs``)."""

    def __init__(self, owner):
        super().__init__()
        self._owner = owner

    def _mat(self):
        return self._owner.outputs

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return len(self._mat())


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
        self._boxed = (None, [])

    @property
    def outputs(self):
        """The executor's outputs as NDArrays (a deferred training forward
        runs here when read before ``backward``)."""
        outs = self._exec.outputs
        if self._boxed[0] is not outs:
            self._boxed = (outs, [NDArray(o) for o in outs])
        return self._boxed[1]

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
        outs = self._exec.forward(is_train)
        return _LazyOutputs(self) if isinstance(outs, _LazyOutputs) \
            else self.outputs

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
