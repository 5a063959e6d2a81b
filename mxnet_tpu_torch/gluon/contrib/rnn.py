"""``gluon.contrib.rnn``: ``VariationalDropoutCell`` (port of
``mxnet_tpu/gluon/contrib/rnn.py``; parity:
python/mxnet/gluon/contrib/rnn/rnn_cell.py).

Dropout masks drawn once a sequence (Gal & Ghahramani 2016) and reused at
every step, on the wrapped cell's inputs, its hidden state h (an LSTM's c
passes through) and its outputs. A mask is ``Dropout`` of ones, drawn from
``mx.random``'s generator of the device at the first step after
``reset()`` (which ``unroll`` calls); in predict mode every mask is ones.
"""
from __future__ import annotations

from ..rnn.rnn_cell import ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational dropout around ``base_cell``
    (``mxnet_tpu/gluon/contrib/rnn.py:17-67``)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        super().__init__(base_cell)
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _mask(self, F, p, like):
        return F.Dropout(F.ones_like(like), p=p)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = self._mask(F, self.drop_states, states[0])
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = self._mask(F, self.drop_inputs, inputs)
        if self.drop_states:
            states = list(states)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = self._mask(F, self.drop_outputs,
                                                next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(p_in={self.drop_inputs}, "
                f"p_state={self.drop_states}, p_out={self.drop_outputs}, "
                f"base={type(self.base_cell).__name__})")
