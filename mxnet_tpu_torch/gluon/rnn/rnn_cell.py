"""Gluon recurrent cells (port of ``mxnet_tpu/gluon/rnn/rnn_cell.py:19-548``;
parity: python/mxnet/gluon/rnn/rnn_cell.py).

A cell runs one step, ``cell(inputs, states) -> (output, new_states)``, on
tensors; ``unroll`` runs ``length`` steps over a (T, N, C) or (N, T, C)
tensor or a list of (N, C) steps, and with ``valid_length`` masks the
outputs past each row's length and returns each row's states at its last
valid step. ``RNNCell``, ``LSTMCell`` and ``GRUCell`` write their step as
``hybrid_forward`` over the registered ops (``F.FullyConnected``,
``F.SliceChannel``, ...), as MXNet does. NDArrays in give NDArrays out.

``BidirectionalCell`` with ``valid_length`` reverses each row within its
length, for the right cell's inputs and for its outputs
(``SequenceReverse``), as MXNet 1.6 does; ``mxnet_tpu`` reverses the
whole padded sequence (ROADMAP Queue 3, "Reference defects").
"""
from __future__ import annotations

import functools

import torch

from ...context import current_context
from ...ops import math as _math
from ..block import Block, HybridBlock, F_TENSOR, _box, _has_ndarray, \
    _unbox

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _state_device(block, ctx=None):
    """``ctx``'s device, else the device of ``block``'s first initialized
    parameter, else the current context's."""
    if ctx is not None:
        return ctx.torch_device()
    for p in block._param_objects().values():
        t = p._tensor()
        if t is not None:
            return t.device
    return current_context().torch_device()


def _nd_io(unroll):
    """``unroll`` on tensors; NDArrays in give NDArrays out."""
    @functools.wraps(unroll)
    def wrapped(self, length, inputs, begin_state=None, *args, **kwargs):
        boxed = _has_ndarray((inputs, begin_state, kwargs))
        if boxed:
            inputs, begin_state, kwargs = _unbox(
                (inputs, begin_state, kwargs))
        out = unroll(self, length, inputs, begin_state, *args, **kwargs)
        return _box(out) if boxed else out
    return wrapped


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(inputs, layout, merge):
    """(inputs as steps (``merge`` False), one tensor (True) or as given
    (None), the time axis, the batch size)."""
    axis, batch_axis = layout.find("T"), layout.find("N")
    if isinstance(inputs, torch.Tensor):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            inputs = list(torch.unbind(inputs, dim=axis))
    else:
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = torch.stack(list(inputs), dim=axis)
    return inputs, axis, batch_size


def _reverse_sequences(steps, valid_length):
    """The steps in reverse order; with ``valid_length`` each row reversed
    within its length, its padding left in place (MXNet 1.6's
    ``_reverse_sequences``)."""
    if valid_length is None:
        return list(reversed(steps))
    rev = _math._sequence_reverse(torch.stack(list(steps)), valid_length,
                                  use_sequence_length=True)
    return list(torch.unbind(rev))


class RecurrentCell(Block):
    """The cells' base (``rnn_cell.py:78``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix)
        self._modified = False
        self.reset()

    def reset(self):
        """Restart the step counters, of this cell and its children."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children_blocks():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zeros of each state's shape on the parameters' device (``ctx``
        when given), or ``func(name=..., shape=..., **info)``."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            if func is None:
                states.append(torch.zeros(shape, device=_state_device(
                    self, kwargs.get("ctx"))))
            else:
                info.update(kwargs)
                states.append(func(name=f"{self._prefix}begin_state_"
                                        f"{self._init_counter}",
                                   shape=shape, **info))
        return states

    @_nd_io
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """``length`` steps: (outputs, final states) (``rnn_cell.py:160``)."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(inputs, layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size)
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [_math._sequence_last(torch.stack(list(s)),
                                           valid_length,
                                           use_sequence_length=True)
                      for s in zip(*all_states)]
            outputs = _math._sequence_mask(
                torch.stack(outputs, dim=axis), valid_length,
                use_sequence_length=True, axis=axis)
        if merge_outputs and not isinstance(outputs, torch.Tensor):
            outputs = torch.stack(outputs, dim=axis)
        elif not merge_outputs and isinstance(outputs, torch.Tensor):
            outputs = list(torch.unbind(outputs, dim=axis))
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            if activation in ("tanh", "relu", "sigmoid", "softrelu",
                              "softsign"):
                return F.Activation(inputs, act_type=activation, **kwargs)
            return getattr(F, activation)(inputs, **kwargs)
        return activation(inputs, **kwargs)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is ``hybrid_forward(F, inputs, states, **params)``
    (``rnn_cell.py:340``)."""

    def _infer_shapes(self, inputs, *args):
        """A gate cell's ``i2h_weight`` takes the input's width."""
        w = self._reg_params["i2h_weight"]
        return {"i2h_weight": (w.shape[0], inputs.shape[-1])}

    def forward(self, inputs, states):
        self._counter += 1
        if self._pending_init:
            self._finish_deferred_init(inputs)
        params = {name: getattr(self, name) for name in self._reg_params}
        return self.hybrid_forward(F_TENSOR, inputs, states, **params)


def _gate_params(cell, gates, hidden_size, input_size, inits):
    """Register ``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``
    for a cell of ``gates`` gates; without ``input_size`` the i2h weight
    waits for the first step's input width."""
    n = gates * hidden_size
    for name, shape, init in zip(
            ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"),
            ((n, input_size), (n, hidden_size), (n,), (n,)), inits):
        setattr(cell, name, cell.params.get(name, shape=shape, init=init))


class RNNCell(HybridRecurrentCell):
    """Elman cell, ``h' = act(W x + b + R h + b')`` (``rnn_cell.py:364``)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        _gate_params(self, 1, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gates (i, f, g, o) (``rnn_cell.py:463``)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        _gate_params(self, 4, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        n = 4 * self._hidden_size
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=n) + \
            F.FullyConnected(states[0], h2h_weight, h2h_bias, num_hidden=n)
        i, f, g, o = F.SliceChannel(gates, num_outputs=4)
        rec, act = self._recurrent_activation, self._activation
        next_c = self._get_activation(F, f, rec) * states[1] + \
            self._get_activation(F, i, rec) * self._get_activation(F, g, act)
        next_h = self._get_activation(F, o, rec) * \
            self._get_activation(F, next_c, act)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gates (r, z, n), the reset gate on the h2h term
    (``rnn_cell.py:599``)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        _gate_params(self, 3, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        n = 3 * self._hidden_size
        prev_h = states[0]
        i2h_r, i2h_z, i2h = F.SliceChannel(
            F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
            num_outputs=3)
        h2h_r, h2h_z, h2h = F.SliceChannel(
            F.FullyConnected(prev_h, h2h_weight, h2h_bias, num_hidden=n),
            num_outputs=3)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        candidate = F.Activation(i2h + reset * h2h, act_type="tanh")
        next_h = (1.0 - update) * candidate + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input
    (``rnn_cell.py:705``)."""

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children_blocks(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children_blocks(), **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        next_states, p = [], 0
        for cell in self._children_blocks():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states += state
        return inputs, next_states

    @_nd_io
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        _, _, batch_size = _format_sequence(inputs, layout, None)
        cells = self._children_blocks()
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size)
        p, next_states = 0, []
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=begin_state[p:p + n],
                layout=layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs,
                valid_length=valid_length)
            p += n
            next_states += states
        return inputs, next_states

    def __getitem__(self, i):
        return self._children_blocks()[i]

    def __len__(self):
        return len(self._children_blocks())


class DropoutCell(HybridRecurrentCell):
    """Dropout on the inputs (``rnn_cell.py:790``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell that wraps another (``rnn_cell.py:850``); its parameters
    are the wrapped cell's."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            f"Cell {base_cell.name} is already modified. One cell cannot " \
            "be modified twice"
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state element keeps its previous value
    with probability ``zoneout_*`` in training (``rnn_cell.py:910``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_out, p_st = self._zoneout_outputs, self._zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev = self._prev_output
        if prev is None:
            prev = torch.zeros_like(next_output)
        output = F.where(mask(p_out, next_output), next_output, prev) \
            if p_out != 0.0 else next_output
        new_states = [F.where(mask(p_st, new), new, old)
                      for new, old in zip(next_states, states)] \
            if p_st != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The wrapped cell's output plus its input (``rnn_cell.py:975``)."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    @_nd_io
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge = isinstance(outputs, torch.Tensor)
        inputs, _, _ = _format_sequence(inputs, layout, merge)
        if merge:
            return outputs + inputs, states
        return [o + i for o, i in zip(outputs, inputs)], states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence, the second reversed; outputs
    concatenated on the feature axis (``rnn_cell.py:1030``). Unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self._output_prefix = output_prefix
        self.l_cell = l_cell
        self.r_cell = r_cell

    def forward(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children_blocks(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children_blocks(), **kwargs)

    @_nd_io
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(inputs, layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size)
        l_cell, r_cell = self._children_blocks()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=_reverse_sequences(inputs, valid_length),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [torch.cat([lo, ro], dim=1) for lo, ro in zip(
            l_outputs, _reverse_sequences(r_outputs, valid_length))]
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, l_states + r_states

