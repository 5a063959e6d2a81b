"""``mx.sym.contrib``: short names for the ``_contrib_*`` ops, and the
control-flow builders ``foreach``, ``while_loop`` and ``cond`` (port of
``mxnet_tpu/symbol/contrib.py``; parity: python/mxnet/symbol/contrib.py,
foreach :136, while_loop :276, cond :425).

A builder calls the user's body on placeholder variables, cuts the body's
graph where it reaches computed nodes made before the call (those are
evaluated once in the enclosing graph and fed in as inputs), stashes an
executor over the body in :mod:`~mxnet_tpu_torch.ops.control_flow` and
makes one ``_foreach`` / ``_while_loop`` / ``_cond`` node whose inputs are
the loop's data and states and the body's free variables. A variable made
before the call stays one node, so a weight used inside and outside the
loop is one argument and gets the sum of both gradients.
``sym.contrib.quantize_v2`` is the ``_contrib_quantize_v2`` op.
"""
from __future__ import annotations

import sys as _sys

from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]

_MODULE = _sys.modules[__name__]
_PREFIX = "_contrib_"


def _listify(x):
    """(list, whether ``x`` was a list or tuple)."""
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _cut_subgraph(group_sym, boundary, name):
    """Replace every edge from a node of the body (serial >= ``boundary``)
    to a computed node made before it by a new placeholder variable, in
    place (``mxnet_tpu/symbol/contrib.py:23-67``). Variables made before
    stay. Returns {placeholder name: the outer Symbol it stands for}."""
    from .symbol import Symbol, Variable

    cut_map = {}   # (id(node), slot) -> (placeholder node, outer Symbol)

    def cut_edge(inode, islot):
        key = (id(inode), islot)
        if key not in cut_map:
            v = Variable(f"{name}_cut{len(cut_map)}")
            cut_map[key] = (v._outputs[0][0], Symbol([(inode, islot)]))
        return cut_map[key][0]

    group_sym._outputs = [
        (cut_edge(node, slot), 0) if node.serial < boundary and
        not node.is_var else (node, slot)
        for node, slot in group_sym._outputs]
    seen = set()
    stack = [n for n, _ in group_sym._outputs]
    while stack:
        node = stack.pop()
        if id(node) in seen or node.serial < boundary:
            continue
        seen.add(id(node))
        for k, (inode, islot) in enumerate(list(node.inputs)):
            if inode.serial < boundary and not inode.is_var:
                node.inputs[k] = (cut_edge(inode, islot), 0)
            elif inode.serial >= boundary:
                stack.append(inode)
    return {vn.name: ref for vn, ref in cut_map.values()}


def _subgraph_program(group_sym):
    """Stash an executor over ``group_sym``: (table key, its argument
    names, its variable nodes by name)."""
    from ..executor import Executor
    from ..ops.control_flow import stash_subgraph

    aux = group_sym.list_auxiliary_states()
    if aux:
        raise MXNetError(
            "control-flow subgraphs cannot mutate auxiliary state "
            f"(found {aux}); move stateful ops out of the loop body")
    var_nodes = {n.name: n for n in group_sym._topo_nodes() if n.is_var}
    key = stash_subgraph(Executor(group_sym, None, {}, {}))
    return key, group_sym.list_arguments(), var_nodes


def _role_maps(arg_names, placeholder_names):
    """({role: ((argument position, index in the role), ...)}, [(argument
    position, name) of the free variables])."""
    name_to_role = {n: (role, i) for role, names in placeholder_names.items()
                    for i, n in enumerate(names)}
    maps = {role: [] for role in placeholder_names}
    free = []
    for pos, n in enumerate(arg_names):
        if n in name_to_role:
            role, i = name_to_role[n]
            maps[role].append((pos, i))
        else:
            free.append((pos, n))
    return {r: tuple(m) for r, m in maps.items()}, free


def _free_ref(n, var_nodes, cut_refs):
    from .symbol import Symbol

    return cut_refs.get(n) or Symbol([(var_nodes[n], 0)])


def _free_map(free):
    return tuple((pos, k) for k, (pos, _) in enumerate(free))


def _split_outputs(node_sym, n_out, n_state):
    return ([node_sym[i] for i in range(n_out)],
            [node_sym[n_out + i] for i in range(n_state)])


def foreach(body, data, init_states, name="foreach"):
    """Run ``body(data_slice, states) -> (step_outputs, next_states)`` over
    axis 0 of ``data``; (stacked outputs, final states), nested as the
    inputs are."""
    from .symbol import Group, Variable, _create, node_serial_watermark

    boundary = node_serial_watermark()
    data_list, data_is_list = _listify(data)
    state_list, state_is_list = _listify(init_states)
    data_ph = [Variable(f"{name}_data{i}") for i in range(len(data_list))]
    state_ph = [Variable(f"{name}_state{i}") for i in range(len(state_list))]
    outs, out_states = body(
        data_ph if data_is_list else data_ph[0],
        state_ph if state_is_list else (state_ph[0] if state_ph else []))
    out_list, out_is_list = _listify(outs)
    out_state_list, _ = _listify(out_states)
    if len(out_state_list) != len(state_list):
        raise MXNetError("foreach body must return as many states as "
                         "init_states")
    sub = Group(out_list + out_state_list)
    cut_refs = _cut_subgraph(sub, boundary, name)
    key, arg_names, var_nodes = _subgraph_program(sub)
    maps, free = _role_maps(arg_names, {
        "data": [p._outputs[0][0].name for p in data_ph],
        "state": [p._outputs[0][0].name for p in state_ph]})
    params = {"_sub": key, "_n_data": len(data_list),
              "_n_state": len(state_list), "_n_out": len(out_list),
              "_data_map": maps["data"], "_state_map": maps["state"],
              "_free_map": _free_map(free)}
    inputs = (data_list + state_list +
              [_free_ref(n, var_nodes, cut_refs) for _, n in free])
    outs_syms, state_syms = _split_outputs(
        _create("_foreach", inputs, params, name=name), len(out_list),
        len(state_list))
    return (outs_syms if out_is_list else outs_syms[0],
            state_syms if state_is_list else
            (state_syms[0] if state_syms else []))


def while_loop(cond, func, loop_vars, max_iterations, name="while_loop"):
    """While ``cond(*loop_vars)`` holds (at most ``max_iterations`` times),
    ``func(*loop_vars) -> (step_outputs, new_loop_vars)``; (outputs
    stacked into (max_iterations, ...) with zero rows after the last step,
    final loop variables)."""
    from .symbol import Group, Variable, _create, node_serial_watermark

    boundary = node_serial_watermark()
    state_list, state_is_list = _listify(loop_vars)
    ph = [Variable(f"{name}_var{i}") for i in range(len(state_list))]
    args = ph if state_is_list else [ph[0]]
    cond_out = cond(*args)
    outs, new_states = func(*args)
    out_list, out_is_list = _listify(outs)
    new_state_list, _ = _listify(new_states)
    if len(new_state_list) != len(state_list):
        raise MXNetError("while_loop func must return as many loop_vars")
    ph_names = [p._outputs[0][0].name for p in ph]
    body_sub = Group(out_list + new_state_list)
    body_cuts = _cut_subgraph(body_sub, boundary, name + "_body")
    body_key, body_args, body_vars = _subgraph_program(body_sub)
    body_maps, body_free = _role_maps(body_args, {"state": ph_names})
    cond_sub = Group([cond_out])
    cond_cuts = _cut_subgraph(cond_sub, boundary, name + "_cond")
    cond_key, cond_args, cond_vars = _subgraph_program(cond_sub)
    cond_maps, cond_free = _role_maps(cond_args, {"state": ph_names})
    params = {"_cond_sub": cond_key, "_body_sub": body_key,
              "_n_state": len(state_list), "_n_body_free": len(body_free),
              "_n_out": len(out_list),
              "_max_iterations": int(max_iterations),
              "_body_state_map": body_maps["state"],
              "_body_free_map": _free_map(body_free),
              "_cond_state_map": cond_maps["state"],
              "_cond_free_map": _free_map(cond_free)}
    inputs = (state_list +
              [_free_ref(n, body_vars, body_cuts) for _, n in body_free] +
              [_free_ref(n, cond_vars, cond_cuts) for _, n in cond_free])
    outs_syms, state_syms = _split_outputs(
        _create("_while_loop", inputs, params, name=name), len(out_list),
        len(state_list))
    return (outs_syms if out_is_list else outs_syms[0],
            state_syms if state_is_list else state_syms[0])


def cond(pred, then_func, else_func, name="cond"):
    """``then_func()`` where the scalar Symbol ``pred`` is non-zero, else
    ``else_func()``; the two branches give the same outputs."""
    from .symbol import Group, _create, node_serial_watermark

    boundary = node_serial_watermark()
    then_list, then_is_list = _listify(then_func())
    else_list, _ = _listify(else_func())
    if len(then_list) != len(else_list):
        raise MXNetError("cond branches must have the same number of "
                         "outputs")
    inputs, params = [], {"_n_out": len(then_list)}
    for role, outs in (("pred", [pred]), ("then", then_list),
                       ("else", else_list)):
        sub = Group(outs)
        cuts = _cut_subgraph(sub, boundary, f"{name}_{role}")
        key, args, var_nodes = _subgraph_program(sub)
        params[f"_{role}_sub"] = key
        params[f"_{role}_map"] = tuple(
            (pos, len(inputs) + pos) for pos in range(len(args)))
        inputs += [_free_ref(n, var_nodes, cuts) for n in args]
    node_sym = _create("_cond", inputs, params, name=name)
    outs = [node_sym[i] for i in range(len(then_list))]
    return outs if then_is_list else outs[0]


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    from ..ops.registry import get_op
    from .symbol import make_symbol_creator

    for candidate in (_PREFIX + name, name):
        try:
            get_op(candidate)
        except Exception:
            continue
        c = make_symbol_creator(candidate)
        setattr(_MODULE, name, c)
        return c
    raise AttributeError(name)
