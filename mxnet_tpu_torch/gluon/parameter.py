"""Gluon Parameter / ParameterDict (parity: python/mxnet/gluon/parameter.py).

Counterpart of ``mxnet_tpu/gluon/parameter.py``. A :class:`Parameter`
holds one weight's MXNet name, shape, dtype and initializer; the tensor
itself is an ``nn.Parameter`` attribute of the owning Block, so the Block's
``forward`` reads ``self.weight`` as any PyTorch module does. A shape
with an unknown (0) dimension defers ``initialize``: the draw waits until
the owning layer's first forward supplies the shape
(:meth:`Parameter.finish_deferred_init`; ``Conv2D`` and ``Dense`` infer
their input width), as MXNet's deferred initialization does.

A parameter whose ``grad_req`` is not ``"null"`` is a leaf that requires
grad; its gradient is the tensor's ``.grad``. ``grad_req="write"`` (MXNet's
kWriteTo) overwrites the gradient at each backward, where PyTorch would
accumulate: a hook on the tensor drops the old gradient just before
autograd adds the new one. ``"add"`` accumulates. A parameter that is not
``differentiable`` (BatchNorm's running statistics) has ``grad_req`` "null"
and never requires grad; those auxiliary states are written back in place
with :meth:`Parameter.set_data`.

Under a captured step (:mod:`mxnet_tpu_torch.capture`) the graph owns one
static gradient buffer per parameter, which it hands back to ``.grad``
after every replay, so :meth:`Parameter.grad` reads what the step
computed. :meth:`Parameter.set_data` copies in place, which a captured
program sees at its next replay; ``initialize`` and ``cast`` rebind the
tensor to new memory (``_set``), which changes the captured step's key, so
the step is captured again.
"""
from __future__ import annotations

import warnings
import weakref
from collections import OrderedDict

import numpy as _np
import torch
from torch import nn

from ..base import MXNetError, torch_dtype
from .. import initializer

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """One weight of a Block: name, shape, dtype and initializer."""

    def __init__(self, name, shape, dtype="float32", init=None,
                 grad_req="write", differentiable=True, lr_mult=1.0,
                 wd_mult=1.0):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self.init = init
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._differentiable = differentiable
        self._owner = None
        self._attr = None
        self._hooked = None      # weakref to the tensor with the 'write' hook
        self._var = None
        self._deferred = None    # initialize's arguments, until the shape
        self.grad_req = grad_req

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of write, add, null, but "
                             f"got {req!r}")
        self._grad_req = req if self._differentiable else "null"
        t = self._tensor() if self._owner is not None else None
        if t is not None:
            self._track_grad(t)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    def _bind(self, block, attr):
        self._owner, self._attr = block, attr

    def _tensor(self):
        return self._owner._parameters.get(self._attr)

    def _track_grad(self, t):
        """Make ``t`` require grad unless grad_req is "null", with the
        'write' hook registered once per tensor."""
        t.requires_grad_(self._grad_req != "null")
        if self._grad_req == "null":
            t.grad = None
            return
        if self._hooked is not None and self._hooked() is t:
            return
        ref = weakref.ref(t)

        def overwrite(grad, param=self):
            # runs before autograd adds `grad` into .grad: for 'write',
            # drop the previous gradient so the new one replaces it
            leaf = ref()
            if param._grad_req == "write" and leaf is not None:
                leaf.grad = None

        t.register_hook(overwrite)
        self._hooked = ref

    def _set(self, tensor):
        t = nn.Parameter(tensor, requires_grad=False)
        self._track_grad(t)
        setattr(self._owner, self._attr, t)

    def data(self):
        t = self._tensor()
        if t is None:
            raise MXNetError(f"Parameter '{self.name}' has not been "
                             "initialized")
        return t

    def list_data(self):
        return [self.data()]

    def var(self):
        """The Symbol variable of this parameter (one per Parameter)."""
        if self._var is None:
            from .. import symbol
            self._var = symbol.var(self.name)
        return self._var

    def grad(self):
        """The gradient buffer: zeros until a backward writes it, as
        MXNet's buffer is from initialization on."""
        t = self.data()
        if self._grad_req == "null":
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"'{self.name}' because grad_req='null'")
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient to zero (parameters with grad_req 'null' have
        none)."""
        t = self._tensor() if self._owner is not None else None
        if t is not None and t.grad is not None:
            t.grad.zero_()

    def initialize(self, init=None, device=None, generator=None,
                   default_init=None, force_reinit=False):
        """Draw the value with this parameter's own initializer, else
        ``init``, else ``default_init`` (MXNet's precedence), from
        ``generator`` (a ``torch.Generator``; the global one when None),
        and place it on ``device`` in this parameter's dtype."""
        if self._tensor() is not None and not force_reinit:
            warnings.warn(f"Parameter '{self.name}' is already initialized, "
                          "ignoring. Set force_reinit=True to re-initialize.",
                          stacklevel=2)
            return
        if not self.shape or any(s <= 0 for s in self.shape):
            # MXNet's deferred initialization: drawn at the first forward
            self._deferred = (init, device, generator, default_init)
            self._owner._pending_init = True
            return
        self._deferred = None
        chosen = initializer.create(
            self.init if self.init is not None else
            (init if init is not None else default_init))
        if chosen is None:
            chosen = initializer.Uniform()
        gen_device = generator.device if generator is not None else "cpu"
        buf = torch.empty(self.shape, dtype=torch.float32, device=gen_device)
        chosen(self.name, buf, generator)
        self._set(buf.to(device=device, dtype=self.dtype))

    def finish_deferred_init(self, shape):
        """Give a deferred parameter its ``shape`` and draw it with the
        arguments ``initialize`` was called with."""
        if self._deferred is None:
            raise MXNetError(f"Parameter '{self.name}' is not waiting for "
                             "its shape")
        known = [s for s in self.shape if s > 0]
        if known and tuple(s for s, t in zip(shape, self.shape)
                           if t > 0) != tuple(known):
            raise MXNetError(f"Parameter '{self.name}': shape {tuple(shape)}"
                             f" does not fit {self.shape}")
        self.shape = tuple(int(s) for s in shape)
        self.initialize(*self._deferred)

    def set_data(self, value):
        """Copy ``value`` (numpy array or tensor) into the initialized
        tensor in place, on its device and in its dtype (also inside
        ``torch.inference_mode``)."""
        t = self.data()
        if not isinstance(value, torch.Tensor):
            arr = _np.ascontiguousarray(value)
            if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes bfloat16
                arr = arr.astype(_np.float32)
            value = torch.from_numpy(arr)
        if tuple(value.shape) != self.shape:
            raise MXNetError(f"Parameter '{self.name}': value shape "
                             f"{tuple(value.shape)} != {self.shape}")
        with torch.no_grad():
            t.copy_(value)

    def cast(self, dtype):
        self.dtype = torch_dtype(dtype)
        t = self._tensor()
        if t is not None:
            self._set(t.detach().to(self.dtype))


class ParameterDict:
    """The Parameters a Block creates, named ``prefix + name``."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = OrderedDict()

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, shape, dtype="float32", init=None, grad_req="write",
            differentiable=True):
        """Create (or return) the Parameter named ``prefix + name``."""
        full = self._prefix + name
        param = self._params.get(full)
        if param is None:
            param = self._params[full] = Parameter(
                full, shape, dtype, init, grad_req, differentiable)
        elif tuple(shape) != param.shape:
            raise MXNetError(f"Parameter '{full}' exists with shape "
                             f"{param.shape}, not {tuple(shape)}")
        return param

    def items(self):
        return self._params.items()
