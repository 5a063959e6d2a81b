"""Dynamic loss scaling (port of ``mxnet_tpu/amp/loss_scaler.py``; parity:
python/mxnet/contrib/amp/loss_scaler.py).

The loss is scaled up before backward so fp16 gradients do not flush to
zero; :meth:`LossScaler.has_overflow` checks the gradients for inf / nan
with one ``multi_all_finite`` (``ops/optimizer_ops.py``) and one host read,
and :meth:`LossScaler.update_scale` halves the scale on overflow (never
below 1) and doubles it after ``scale_window`` clean steps. bf16 has
fp32's exponent range, so a bf16 run keeps the scale at 1.0.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2. ** 16, scale_factor=2.,
                 scale_window=2000, tolerance=0.):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._noted_finite = None

    def note_finite(self, finite):
        """Captured-step hook: a step that computes the all-finite flag
        inside its own program notes it here, and the next
        :meth:`has_overflow` consumes it instead of reading the gradients
        again. Nothing calls it yet: a captured gluon step with a loss
        scaler raises (ROADMAP Queue 1 item 4)."""
        self._noted_finite = bool(finite)

    def clear_note(self):
        """Drop an unconsumed noted flag: called at the start of an eager
        step (``amp.scale_loss``), whose gradients a flag noted by an
        earlier step does not describe."""
        self._noted_finite = None

    def has_overflow(self, params):
        """True if a gradient of ``params`` (Parameters, or gradient
        tensors) holds inf or nan: one ``multi_all_finite`` over all of
        them and one host read, or the noted flag, consumed once."""
        noted = self._noted_finite
        if noted is not None:
            self._noted_finite = None
            return not noted
        from ..ops import optimizer_ops

        grads = []
        for p in params:
            if isinstance(p, torch.Tensor):
                grads.append(p)
            elif isinstance(p, (list, tuple)):
                grads.extend(p)
            else:
                grads.extend(p.list_grad())
        if not grads:
            return False
        return not bool(optimizer_ops.multi_all_finite(*grads).item())

    def update_scale(self, overflow):
        """Halve on overflow (floor 1), double after ``scale_window``
        clean steps (``loss_scaler.py`` update_scale)."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.)
            self._unskipped = 0
        else:
            self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
