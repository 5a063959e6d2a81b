"""Fused multi-layer RNN layers: ``RNN``, ``LSTM``, ``GRU`` (port of
``mxnet_tpu/gluon/rnn/rnn_layer.py:20-258``; parity:
python/mxnet/gluon/rnn/rnn_layer.py).

A layer holds MXNet's parameters, ``{l,r}{i}_{i2h,h2h}_{weight,bias}``,
and runs the registered ``RNN`` op (:mod:`mxnet_tpu_torch.ops.rnn`) on
their concatenation in MXNet's flat order (``_flat_params``: every weight,
then every bias), so gradients reach each parameter through the
concatenation. Layouts TNC and NTC; called without states, a layer starts
from zeros and returns the output alone, with states it returns (output,
new states). Without ``input_size`` the first layer's ``i2h_weight`` waits
for the first forward, which reads the input's width. The graph of a layer
on a Symbol is not ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops.rnn import GATES
from ..block import F_TENSOR, HybridBlock, _is_symbol
from .rnn_cell import _state_device

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """The fused layers' base (``mxnet_tpu/gluon/rnn/rnn_layer.py:20``)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"Invalid layout {layout}; must be one of "
                             "['TNC' or 'NTC']")
        if projection_size:
            raise MXNetError("projection_size (LSTMP) is not ported yet "
                             "(ROADMAP Queue 1 item 11)")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng, ni, nh = GATES[mode], input_size, hidden_size
        self._names = []
        for i in range(num_layers):
            for j in "lr"[:self._dir]:
                for kind, shape, init in (
                        ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                        ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                    name = f"{j}{i}_{kind}"
                    setattr(self, name, self.params.get(name, shape=shape,
                                                        init=init))
                    self._names.append(name)
            ni = nh * self._dir

    def __repr__(self):
        s = f"{type(self).__name__}({self._input_size} -> " \
            f"{self._hidden_size}, {self._layout}"
        if self._num_layers != 1:
            s += f", num_layers={self._num_layers}"
        if self._dropout != 0:
            s += f", dropout={self._dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        return s + ")"

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}] * \
            (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zeros of each state's shape, on the parameters' device (``ctx``
        when given), or ``func(name=..., shape=..., **info)``."""
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            info = dict(info)
            shape = info.pop("shape")
            if func is None:
                states.append(torch.zeros(shape, device=_state_device(
                    self, kwargs.get("ctx"))))
            else:
                info.update(kwargs)
                states.append(func(name=f"{self.prefix}h0_{i}", shape=shape,
                                   **info))
        return states

    def _flat_params(self):
        """The parameters in MXNet's flat order (every weight, then every
        bias; ``mxnet_tpu/gluon/rnn/rnn_layer.py:107-119``)."""
        ws = [getattr(self, n).reshape(-1) for n in self._names
              if n.endswith("weight")]
        bs = [getattr(self, n) for n in self._names if n.endswith("bias")]
        return torch.cat(ws + bs)

    def _infer_shapes(self, inputs, *args):
        """The first layer's ``i2h_weight`` (each direction's) takes the
        input's width."""
        return {f"{j}0_i2h_weight": (GATES[self._mode] * self._hidden_size,
                                     inputs.shape[2]) for j in "lr"}

    def forward(self, inputs, states=None):
        if _is_symbol(inputs):
            raise MXNetError(f"{type(self).__name__} on a Symbol is not "
                             "ported yet (ROADMAP Queue 1 item 11)")
        if self._pending_init:
            self._finish_deferred_init(inputs)
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=None)
        if isinstance(states, torch.Tensor):
            states = [states]
        for info, state in zip(self.state_info(batch_size), states):
            if tuple(state.shape) != info["shape"]:
                raise MXNetError(
                    f"Invalid recurrent state shape. Expecting "
                    f"{info['shape']}, got {tuple(state.shape)}.")
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        out = F_TENSOR.RNN(inputs, self._flat_params(), *states,
                           state_size=self._hidden_size,
                           num_layers=self._num_layers,
                           bidirectional=self._dir == 2, mode=self._mode,
                           p=self._dropout, state_outputs=True)
        outputs, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = outputs.transpose(0, 1)
        return outputs if skip_states else (outputs, new_states)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, relu or tanh (rnn_layer.py:307)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (rnn_layer.py:404)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm",
                         projection_size=projection_size, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (rnn_layer.py:535)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
