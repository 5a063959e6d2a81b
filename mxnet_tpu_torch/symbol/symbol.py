"""Symbol: declarative graphs of registered ops (port of
``mxnet_tpu/symbol/symbol.py``; parity: python/mxnet/symbol/symbol.py).

A Symbol is a handle to output entries ``(node, index)`` of a DAG of
:class:`_Node`; a node is a variable or an application of an op from
:mod:`mxnet_tpu_torch.ops.registry`. Names, parameters, JSON and the
argument / auxiliary-state split are ``mxnet_tpu``'s letter for letter
(``_auto_name`` counters included), so a graph, a ``*-symbol.json`` or a
calibration table keyed by node names carries across the two packages.
:meth:`Symbol.bind` gives an :class:`~mxnet_tpu_torch.executor.Executor`,
which walks the node list and calls each op on tensors. Shape inference
runs each op on ``meta`` tensors where ``mxnet_tpu`` uses
``jax.eval_shape``, with the same parameter-shape hooks.
"""
from __future__ import annotations

import inspect as _inspect
import itertools as _itertools
import json
import threading

import numpy as _np

from ..attribute import current_attrs as _current_attrs
from ..base import MXNetError
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "make_symbol_creator", "reset_name_counters"]

_NAME_LOCK = threading.Lock()
_NAME_COUNTERS: dict = {}


def _auto_name(kind):
    with _NAME_LOCK:
        i = _NAME_COUNTERS.get(kind, 0)
        _NAME_COUNTERS[kind] = i + 1
    return f"{kind}{i}"


def reset_name_counters():
    """Restart the automatic node names (``activation0``, ...)."""
    with _NAME_LOCK:
        _NAME_COUNTERS.clear()


_node_serial = _itertools.count()


def node_serial_watermark():
    """The creation-order watermark: nodes made after this call have a
    ``serial`` at least the value returned (``symbol.contrib`` cuts a
    control-flow body there)."""
    return next(_node_serial)


class _Node:
    """One graph node: a variable (``op`` None) or an op application."""

    __slots__ = ("op", "name", "params", "inputs", "attrs", "aux_mark",
                 "serial")

    def __init__(self, op, name, params=None, inputs=None, attrs=None):
        self.op = op
        self.name = name
        self.params = params or {}
        self.inputs = inputs or []     # [(node, out_index)]
        self.attrs = {**_current_attrs(), **(attrs or {})}
        self.aux_mark = False          # a variable in a mutate slot
        self.serial = next(_node_serial)   # creation order

    @property
    def is_var(self):
        return self.op is None

    def num_outputs(self):
        if self.is_var:
            return 1
        op = _registry.get_op(self.op)
        return op.n_out(op.normalize(self.params))


class Symbol:
    """A handle to one or more output entries of the graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)   # [(node, index)]

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return ", ".join(n.name for n, _ in self._outputs)

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield Symbol([self._outputs[i]])

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index!r}: {names}")
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def _topo_nodes(self):
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for n, _ in self._outputs:
            visit(n)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo_nodes()
                if n.is_var and not n.aux_mark]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo_nodes() if n.is_var and n.aux_mark]

    def list_outputs(self):
        out = []
        for n, i in self._outputs:
            if n.num_outputs() > 1:
                out.append(f"{n.name}_output{i}")
            else:
                out.append(n.name if n.is_var else f"{n.name}_output")
        return out

    def attr(self, key):
        """The attribute ``key`` of this symbol's (first) node."""
        return self._outputs[0][0].attrs.get(key)

    def attr_dict(self):
        """{node name: its attributes} for every node that has some."""
        return {n.name: dict(n.attrs) for n in self._topo_nodes() if n.attrs}

    def get_internals(self):
        return Symbol([(n, i) for n in self._topo_nodes()
                       for i in range(n.num_outputs())])

    def _binary(self, other, opname, reverse=False):
        """``self <op> other`` (``other <op> self`` with ``reverse``): an
        ``elemwise_*`` node, or ``elemwise_*_scalar`` for a number."""
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _create(opname, [lhs, rhs], {})
        return _create(opname + "_scalar", [self],
                       {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):
        return self._binary(o, "elemwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", reverse=True)

    def __neg__(self):
        return _create("negative", [self], {})

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal")

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary(o, "broadcast_equal")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary(o, "broadcast_not_equal")
        return NotImplemented

    def __hash__(self):
        return id(self)

    # mirrors of common ops (``mxnet_tpu/symbol/symbol.py:226-236``)
    def reshape(self, shape=None, **kw):
        return _create("Reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _create("transpose", [self],
                       {"axes": tuple(axes) if axes else None})

    def sum(self, axis=None, keepdims=False):
        return _create("sum", [self], {"axis": axis, "keepdims": keepdims})

    # ------------------------------------------------------------- inference
    def infer_shape(self, **kwargs):
        """(argument, output, auxiliary) shapes from the given ones, by
        fixpoint propagation (``mxnet_tpu/symbol/symbol.py:276``): forward
        through each op on meta tensors once its inputs are known,
        parameter shapes backward through the per-op hooks."""
        known = self._propagate_shapes(kwargs)
        nodes = self._topo_nodes()
        by_name = {n.name: n for n in nodes if n.is_var}
        arg_shapes = []
        for name in self.list_arguments():
            s = known.get((id(by_name[name]), 0))
            if s is None:
                raise MXNetError(f"infer_shape: cannot infer shape of "
                                 f"argument '{name}' — provide it explicitly")
            arg_shapes.append(s)
        out_shapes = [known.get((id(n), i)) for n, i in self._outputs]
        aux_shapes = [known.get((id(by_name[name]), 0))
                      for name in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def _propagate_shapes(self, kwargs):
        known = {}
        nodes = self._topo_nodes()
        for n in nodes:
            if n.is_var and kwargs.get(n.name) is not None:
                known[(id(n), 0)] = tuple(kwargs[n.name])
        changed = True
        while changed:
            changed = False
            for n in nodes:
                if n.is_var:
                    continue
                op = _registry.get_op(n.op)
                params = op.normalize(n.params)
                in_shapes = [known.get((id(i), s)) for i, s in n.inputs]
                hook = _PARAM_SHAPE_HOOKS.get(op.name)
                if hook and any(s is None for s in in_shapes):
                    for idx, shape in (hook(in_shapes, params) or {}).items():
                        src, slot = n.inputs[idx]
                        if shape is not None and \
                                known.get((id(src), slot)) is None:
                            known[(id(src), slot)] = tuple(shape)
                            changed = True
                    in_shapes = [known.get((id(i), s)) for i, s in n.inputs]
                if all(s is not None for s in in_shapes) and \
                        known.get((id(n), 0)) is None:
                    for i, s in enumerate(_eval_out_shapes(n, in_shapes)):
                        known[(id(n), i)] = s
                    changed = True
        return known

    # --------------------------------------------------------------- binding
    def bind(self, ctx, args, args_grad=None, grad_req="null",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over ``args`` (dict or list, in ``list_arguments()``
        order) and ``aux_states``, with gradient buffers ``args_grad``
        (made for every argument whose ``grad_req`` -- one for all, a list
        or a dict -- is not "null" when not given). Given tensors, the
        executor's dicts and outputs are tensors; given NDArrays, it is an
        :class:`~mxnet_tpu_torch.executor.NDArrayExecutor` over them."""
        from ..executor import Executor, NDArrayExecutor
        from ..ndarray.ndarray import NDArray

        given = [*(args.values() if isinstance(args, dict) else args),
                 *(args_grad.values() if isinstance(args_grad, dict)
                   else args_grad or ())]
        bind = NDArrayExecutor._bind if any(
            isinstance(v, NDArray) for v in given) else Executor._bind
        return bind(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **shapes):
        """An :class:`~mxnet_tpu_torch.executor.NDArrayExecutor` with
        zero-filled NDArrays for every argument and auxiliary state, their
        shapes inferred from ``shapes``, and gradient buffers by
        ``grad_req`` (``mxnet_tpu/symbol/symbol.py:349``)."""
        from ..executor import Executor, NDArrayExecutor

        return NDArrayExecutor(Executor._simple_bind(
            self, ctx, grad_req=grad_req, type_dict=type_dict, **shapes))

    # ---------------------------------------------------------- (de)serialize
    def tojson(self):
        nodes = self._topo_nodes()
        idx_of = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_var else n.op,
            "name": n.name,
            "attrs": ({k: json.dumps(v) for k, v in n.params.items()}
                      if n.params else {}),
            "inputs": [[idx_of[id(i)], s, 0] for i, s in n.inputs],
            "aux": n.aux_mark,
        } for n in nodes]
        heads = [[idx_of[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _eval_out_shapes(node, in_shapes):
    import torch

    op = _registry.get_op(node.op)
    params = op.normalize(node.params)
    if op.takes_device:
        params["device"] = "meta"
    fn = op.closed(params)
    try:
        out = fn(*[torch.empty(s, device="meta") for s in in_shapes])
    except Exception as e:
        raise MXNetError(f"shape inference failed at node '{node.name}' "
                         f"(op {node.op}, inputs {in_shapes}): {e}") from e
    outs = out if isinstance(out, tuple) else (out,)
    return [tuple(o.shape) for o in outs]


# --- parameter-shape hooks (backward inference of learnable parameters) ----

def _fc_hook(in_shapes, p):
    data = in_shapes[0]
    if data is None:
        return {}
    in_dim = int(_np.prod(data[1:])) if p.get("flatten", True) else data[-1]
    hints = {1: (p["num_hidden"], in_dim)}
    if len(in_shapes) > 2:
        hints[2] = (p["num_hidden"],)
    return hints


def _conv_hook(in_shapes, p):
    data = in_shapes[0]
    if data is None:
        return {}
    k = p.get("kernel") or ()
    k = (k,) if isinstance(k, int) else tuple(k)
    nf, ng = p["num_filter"], p.get("num_group", 1)
    layout = p.get("layout")
    if layout and layout[1] != "C":      # channels-last: OHWI weights
        hints = {1: (nf,) + k + (data[-1] // ng,)}
    else:
        hints = {1: (nf, data[1] // ng) + k}
    if len(in_shapes) > 2:
        hints[2] = (nf,)
    return hints


def _bn_hook(in_shapes, p):
    data = in_shapes[0]
    if data is None:
        return {}
    return {i: (data[p.get("axis", 1)],) for i in range(1, 5)}


def _embedding_hook(in_shapes, p):
    return {1: (p["input_dim"], p["output_dim"])}


def _rnn_hook(in_shapes, p):
    """The flat parameter vector's length and the (L·D, N, H) states
    (``mxnet_tpu/symbol/symbol.py:496-515``)."""
    data = in_shapes[0]
    if data is None:
        return {}
    from ..ops.rnn import rnn_param_size

    _, N, I = data
    H, L = p["state_size"], p.get("num_layers", 1)
    bi = bool(p.get("bidirectional"))
    state = (L * (2 if bi else 1), N, H)
    hints = {1: (rnn_param_size(I, H, L, bi, p.get("mode", "lstm")),),
             2: state}
    if len(in_shapes) > 3:
        hints[3] = state
    return hints


def _softmax_output_hook(in_shapes, p):
    """The label's shape from the data's (softmax_output.cc
    SoftmaxOutputShape; ``mxnet_tpu/symbol/symbol.py:518-531``)."""
    data = in_shapes[0]
    if data is None:
        return {}
    if p.get("multi_output"):
        return {1: (data[0],) + tuple(data[2:])}
    if p.get("preserve_shape"):
        return {1: tuple(data[:-1])}
    return {1: (data[0],)}


_PARAM_SHAPE_HOOKS = {"FullyConnected": _fc_hook, "Convolution": _conv_hook,
                      "BatchNorm": _bn_hook, "Embedding": _embedding_hook,
                      "RNN": _rnn_hook,
                      "SoftmaxOutput": _softmax_output_hook}


# ------------------------------------------------------------- construction

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A graph input named ``name`` (``attr``: its ``__*__`` attributes;
    ``lr_mult`` / ``wd_mult``, ``shape``, ``dtype`` and ``init`` become
    ``__lr_mult__`` ...; ``mxnet_tpu/symbol/symbol.py:567``)."""
    attrs = dict(attr or {})
    for key, val in (("__shape__", None if shape is None else tuple(shape)),
                     ("__lr_mult__", lr_mult), ("__wd_mult__", wd_mult),
                     ("__dtype__", None if dtype is None else str(dtype)),
                     ("__init__", None if init is None else str(init))):
        if val is not None:
            attrs[key] = val
    return Symbol([(_Node(None, name, attrs=attrs), 0)])


var = Variable


def Group(symbols):
    return Symbol([e for s in symbols for e in s._outputs])


def _create(opname, input_syms, params, name=None, attr=None):
    op = _registry.get_op(opname)
    name = name or _auto_name(op.name.lower().replace("_", ""))
    inputs = []
    for s in input_syms:
        if s is None:
            continue
        if len(s._outputs) != 1:
            raise MXNetError(f"{opname}: cannot take a multi-output symbol "
                             f"as a single input")
        inputs.append(s._outputs[0])
    node = _Node(op.name, name, params=dict(params), inputs=inputs,
                 attrs=dict(attr or {}))
    return Symbol([(node, i) for i in range(node.num_outputs())])


# array inputs that have a default (None) in the op functions
_OPTIONAL_ARRAYS = ("bias", "state_cell", "rng_key", "sequence_length",
                    "like")
# ... of which a creator makes no variable when they are not given
_NO_AUTO_VAR = ("sequence_length", "like")


def _array_param_names(op):
    """Leading positional (array) parameter names of the op function."""
    names = []
    for p in _inspect.signature(op.fn).parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            return names, True
        if p.default is p.empty or p.name in _OPTIONAL_ARRAYS:
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY):
                names.append(p.name)
        else:
            break
    return names, False


def make_symbol_creator(opname):
    """``sym.<opname>(*symbols, name=None, **params)``: missing parameter
    inputs become variables ``<name>_<input>`` (auxiliary states in the op's
    mutate slots), as ``mxnet_tpu/symbol/symbol.py:629`` creates them."""
    op = _registry.get_op(opname)
    arr_names, variadic = _array_param_names(op)

    def creator(*args, name=None, attr=None, **kwargs):
        syms = [a for a in args if isinstance(a, Symbol)]
        name = name or _auto_name(op.name.lower().replace("_", ""))
        if variadic:
            params = dict(kwargs)
            params.pop("num_args", None)
            return _create(opname, syms, params, name=name, attr=attr)
        slots, si = {}, 0
        for an in arr_names:
            if isinstance(kwargs.get(an), Symbol):
                slots[an] = kwargs.pop(an)
            elif si < len(syms):
                slots[an] = syms[si]
                si += 1
            else:
                slots[an] = None
        params = dict(kwargs)
        mutate = set(op.mutate_slots(op.normalize(params)))
        inputs = []
        for idx, an in enumerate(arr_names):
            s = slots[an]
            if s is None:
                if (an == "bias" and params.get("no_bias")) or \
                        an in _NO_AUTO_VAR or (an == "state_cell" and
                                               params.get("mode") != "lstm"):
                    continue
                s = Variable(f"{name}_{an}")
                if idx in mutate:
                    s._outputs[0][0].aux_mark = True
            elif idx in mutate and s._outputs[0][0].is_var:
                s._outputs[0][0].aux_mark = True
            inputs.append(s)
        return _create(opname, inputs, params, name=name, attr=attr)

    creator.__name__ = opname
    creator.__doc__ = op.doc
    return creator


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _entry(e):
    return (e[0], e[1] if len(e) > 1 else 0)


def _load_reference_json(data):
    """A reference-saved Symbol JSON ("arg_nodes", string attributes;
    ``mxnet_tpu/symbol/symbol.py:728``). Auxiliary states are the variables
    in the ops' mutate slots."""
    nodes = []
    for jn in data["nodes"]:
        raw = next((jn[k] for k in ("attrs", "attr", "param") if jn.get(k)),
                   {})
        attrs = {k: _registry.parse_param(v) for k, v in raw.items()}
        dunder = {k: v for k, v in attrs.items() if k.startswith("__")}
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attrs=dunder)
        else:
            node = _Node(jn["op"], jn["name"],
                         params={k: v for k, v in attrs.items()
                                 if not k.startswith("__")}, attrs=dunder)
        node.inputs = [(nodes[i], s) for i, s in map(_entry, jn["inputs"])]
        nodes.append(node)
    for n in nodes:
        if n.is_var:
            continue
        op = _registry.get_op(n.op)
        for slot in op.mutate_slots(op.normalize(n.params)):
            if slot < len(n.inputs) and n.inputs[slot][0].is_var:
                n.inputs[slot][0].aux_mark = True
    return Symbol([(nodes[i], s) for i, s in map(_entry, data["heads"])])


def load_json(json_str):
    """A Symbol from ``tojson()``'s format or a reference-saved JSON."""
    data = json.loads(json_str)
    if "arg_nodes" in data or "node_row_ptr" in data:
        return _load_reference_json(data)
    nodes = []
    for jn in data["nodes"]:
        params = {k: json.loads(v) for k, v in jn.get("attrs", {}).items()}
        params = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in params.items()}
        if jn["op"] == "null":
            node = _Node(None, jn["name"])
            node.aux_mark = jn.get("aux", False)
        else:
            node = _Node(jn["op"], jn["name"], params=params)
        node.inputs = [(nodes[i], s) for i, s, _ in jn["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], s) for i, s, _ in data["heads"]])


_registry._SYMBOL_CLS = Symbol
