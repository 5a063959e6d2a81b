"""Gluon Block / HybridBlock as PyTorch modules (parity:
python/mxnet/gluon/block.py).

Counterpart of ``mxnet_tpu/gluon/block.py``. A Block is an ``nn.Module``
that also carries MXNet's naming: a prefix from ``prefix=`` or from the
lower-cased class name plus a per-scope counter (``transformerblock0_``),
nested through ``name_scope()``, so ``collect_params()`` gives the same
names, letter for letter, as ``mxnet_tpu``. Subclasses write ``forward``
on tensors. ``hybridize()`` is accepted and does nothing: PyTorch runs
eagerly. As in MXNet, a Block called outside ``autograd.record()`` records
nothing: it runs under ``torch.no_grad()``.

A HybridBlock that defines ``hybrid_forward(F, x, **params)`` is written
once, as in MXNet: on tensors its ``forward`` calls it with ``F`` the
registered ops (:data:`F_TENSOR`, whose ``F.contrib.<name>`` is
``_contrib_<name>``) and its parameters' tensors. A HybridBlock defined
outside the port (a user's model, such as ``examples/ssd``'s ``SSD``)
called on ``mx.nd`` arrays runs its ``hybrid_forward`` as MXNet does:
``F = mx.nd`` and NDArrays in, so MXNet's array methods (``transpose``
with an axes tuple, ``reshape`` with its 0 / -1 codes) work as written;
the port's own layers take their tensor path under it, whatever they are
called on. Called on a
:class:`~mxnet_tpu_torch.symbol.Symbol` (``mxnet_tpu/gluon/block.py:
405-420``) it gets ``F = mx.sym`` and its parameters as variables, and
writes the same nodes, names and parameters as ``mxnet_tpu``'s layer. A
Block without one runs its ``forward`` on the Symbol, whose children build
on it in turn.
:meth:`HybridBlock.export` writes ``-symbol.json`` and ``-%04d.params``
(``mxnet_tpu/gluon/block.py:451``).
"""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..base import MXNetError, torch_dtype
from ..context import as_device, current_context
from .. import autograd, initializer
from ..ops import registry as _registry
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "ParameterTensors", "F_TENSOR"]


class ParameterTensors(OrderedDict):
    """What :meth:`Block.collect_params` returns: MXNet name -> tensor
    (None before ``initialize``), as the serving code reads it, and in
    ``param_objects`` the same names -> :class:`Parameter`, which is what
    ``gluon.Trainer`` needs (``grad_req``, ``lr_mult``, ``wd_mult``)."""

    def __init__(self, params=None):
        params = params if params is not None else OrderedDict()
        super().__init__((name, p._tensor()) for name, p in params.items())
        self.param_objects = params


class _BlockScope:
    """Scope for naming child Blocks (gluon/block.py:34)."""

    _current = None
    _global_counter = {}  # top-level naming (reference: NameManager current)

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, hint):
        current = _BlockScope._current
        if current is None:
            if prefix is None:
                prefix = _name_with_count(_BlockScope._global_counter,
                                          hint) + "_"
            return prefix
        if prefix is None:
            prefix = _name_with_count(current._counter, hint) + "_"
        return current._block.prefix + prefix

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = _BlockScope._current
        _BlockScope._current = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current = self._old_scope


def _name_with_count(counter, hint):
    count = counter.get(hint, 0)
    counter[hint] = count + 1
    return f"{hint}{count}"


class Block(nn.Module):
    """Base class of all layers and models (gluon/block.py:229).

    ``self.weight = self.params.get("weight", shape=...)`` declares a
    parameter; after :meth:`initialize`, ``self.weight`` is its tensor.
    """

    def __init__(self, prefix=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix = _BlockScope.create(prefix, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._params = ParameterDict(self._prefix)
        self._reg_params = OrderedDict()  # attribute -> Parameter
        self._pending_init = False       # a parameter awaits its shape

    def __call__(self, *args, **kwargs):
        if args and _is_symbol(args[0]):
            return self._call_symbolic(*args)
        if _has_ndarray((args, kwargs)):
            if _user_hybrid(self):
                return self._call_ndarray(*args, **kwargs)
            # mx.nd arrays in, mx.nd arrays out; the Block sees tensors
            args, kwargs = _unbox((args, kwargs))
            return _box(self(*args, **kwargs))
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def _call_ndarray(self, *args, **kwargs):
        """``hybrid_forward(mx.nd, *NDArrays, **parameter NDArrays)``,
        recording only inside ``autograd.record()``."""
        from .. import ndarray
        from ..ndarray.ndarray import NDArray

        params = {name: None if t is None else NDArray(t)
                  for name, t in ((name, getattr(self, name))
                                  for name in self._reg_params)}
        if autograd.is_recording():
            return _box(self.hybrid_forward(ndarray, *args, **kwargs,
                                            **params))
        with torch.no_grad():
            return _box(self.hybrid_forward(ndarray, *args, **kwargs,
                                            **params))

    def _call_symbolic(self, *args):
        """The graph of this Block on Symbol inputs."""
        if getattr(type(self), "hybrid_forward", None) is not None:
            from .. import symbol
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(symbol, *args, **params)
        return self.forward(*args)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value._bind(self, name)
            self._reg_params[name] = value
            self.register_parameter(name, None)
            return
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        """This Block's own ParameterDict (children not included)."""
        return self._params

    def name_scope(self):
        """Scope in which child Blocks take this Block's prefix."""
        return self._scope

    def _children_blocks(self):
        return [m for m in self._modules.values() if isinstance(m, Block)]

    def _param_objects(self):
        """Ordered MXNet name -> Parameter, own first, then children in
        registration order (gluon/block.py:504)."""
        out = OrderedDict((p.name, p) for p in self._reg_params.values())
        for child in self._children_blocks():
            out.update(child._param_objects())
        return out

    def collect_params(self):
        """Ordered MXNet name -> tensor (None before ``initialize``), as a
        :class:`ParameterTensors` that also carries the Parameters."""
        return ParameterTensors(self._param_objects())

    def zero_grad(self, set_to_none=False):
        """Set every parameter's gradient to zero (MXNet's
        ``collect_params().zero_grad()``); ``set_to_none`` is accepted for
        ``nn.Module``'s signature and ignored."""
        for p in self._param_objects().values():
            p.zero_grad()

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)``) with ``init`` as the default initializer
        (``Uniform()`` when None), drawing from ``generator``."""
        device = as_device(ctx)
        default = initializer.create(init) or initializer.Uniform()
        for p in self._param_objects().values():
            p.initialize(None, device, generator, default, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; PyTorch runs the module eagerly."""

    def cast(self, dtype):
        """Cast every parameter to ``dtype``: this Block's own, then each
        child's through its ``cast`` (so a layer may keep another dtype,
        as BatchNorm keeps float32 under float16)."""
        torch_dtype(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        for child in self._children_blocks():
            child.cast(dtype)
        return self

    def load_numpy_params(self, params, strict=True):
        """Copy ``{mxnet_name: numpy array}`` (e.g. ``{k: v.data().asnumpy()}``
        of ``mxnet_tpu``'s ``collect_params()``) into the initialized
        tensors, on their device and in their dtype. With ``strict``, any
        missing, unexpected or shape-mismatched name raises and lists the
        names; otherwise only shape mismatches raise."""
        own = self._param_objects()
        for name, p in own.items():      # a deferred shape takes the value's
            if p._deferred is not None and name in params:
                p.finish_deferred_init(tuple(params[name].shape))
        missing = [n for n in own if n not in params]
        unexpected = [n for n in params if n not in own]
        mismatched = [f"{n}: {tuple(params[n].shape)} vs {p.shape}"
                      for n, p in own.items()
                      if n in params and tuple(params[n].shape) != p.shape]
        if mismatched or (strict and (missing or unexpected)):
            raise MXNetError(
                "load_numpy_params: "
                + "; ".join(f"{what} {names}" for what, names in (
                    ("missing", missing), ("unexpected", unexpected),
                    ("shape mismatch", mismatched)) if names))
        for name, p in own.items():
            if name in params:
                p.set_data(params[name])


class HybridBlock(Block):
    """A Block that MXNet could hybridize (gluon/block.py:839). In the port
    it is an ordinary eager ``nn.Module`` that can also build its Symbol
    graph."""

    def forward(self, *args):
        if self._pending_init:
            self._finish_deferred_init(*args)
        params = {name: getattr(self, name) for name in self._reg_params}
        return self.hybrid_forward(F_TENSOR, *args, **params)

    def _infer_shapes(self, *args):
        """{attribute: shape} of the deferred parameters, from the first
        forward's inputs; a layer that can tell overrides this."""
        raise MXNetError(
            f"{type(self).__name__} '{self.name}' cannot infer the shapes "
            "of its deferred parameters: pass its input width (deferred "
            "initialization beyond Conv2D and Dense is ROADMAP Queue 1 "
            "item 8)")

    def _finish_deferred_init(self, *args):
        shapes = self._infer_shapes(*args)
        for attr, p in self._reg_params.items():
            if p._deferred is not None:
                p.finish_deferred_init(shapes[attr])
        self._pending_init = False

    def export(self, path, epoch=0):
        """Write the graph on ``data`` to ``<path>-symbol.json`` and every
        initialized parameter to ``<path>-<epoch:04d>.params``, in
        ``mxnet_tpu``'s formats; returns the two file names."""
        from .. import ndarray, symbol
        out = self(symbol.var("data"))
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        out.save(f"{path}-symbol.json")
        params = {name: t for name, t in self.collect_params().items()
                  if t is not None}
        ndarray.save(f"{path}-{epoch:04d}.params", params)
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


def _has_ndarray(x):
    """Whether ``x`` (nested in lists, tuples and dicts) holds an
    NDArray."""
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_ndarray(v) for v in x)
    if isinstance(x, dict):
        return any(_has_ndarray(v) for v in x.values())
    return False


def _unbox(x):
    """``x`` with every NDArray (nested as :func:`_has_ndarray` looks)
    replaced by its tensor."""
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unbox(v) for v in x)
    if isinstance(x, dict):
        return {k: _unbox(v) for k, v in x.items()}
    return x


def _box(x):
    """``x`` with every tensor (nested in lists and tuples) an NDArray."""
    from ..ndarray.ndarray import NDArray

    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_box(v) for v in x)
    return x


def _is_symbol(x):
    cls = _registry._SYMBOL_CLS     # set once the symbol module is loaded
    return cls is not None and isinstance(x, cls)


def _user_hybrid(block):
    """Whether ``block`` is a HybridBlock written outside the port whose
    ``hybrid_forward`` MXNet would hand NDArrays."""
    cls = type(block)
    return getattr(cls, "hybrid_forward", None) is not None and \
        cls.forward is HybridBlock.forward and \
        not cls.__module__.startswith("mxnet_tpu_torch.")


class _TensorOps:
    """``F`` of a ``hybrid_forward`` on tensors: ``F.<op>(*arrays, name=None,
    **params)`` calls the registered op (``ops/registry.py``) in the
    current training mode, on the first tensor's device (else the current
    context's), with that device's ``mx.random`` generator. An op's mutated
    slots (BatchNorm's running statistics) are written back into the
    tensors given for them, in place, as MXNet's op updates its auxiliary
    states. ``F.contrib.<name>`` is the op ``_contrib_<name>`` (else
    ``<name>``), as ``mx.nd.contrib`` and ``mx.sym.contrib`` resolve it."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, opname):
        if opname.startswith("__"):
            raise AttributeError(opname)
        if opname == "contrib" and not self._prefix:
            return _CONTRIB
        try:
            op = _registry.get_op(self._prefix + opname)
        except MXNetError:
            if not self._prefix:
                raise
            op = _registry.get_op(opname)

        def call(*arrays, name=None, **params):
            params = op.normalize(params)
            device = next((a.device for a in arrays
                           if isinstance(a, torch.Tensor)), None) or \
                current_context().torch_device()
            raw = op.call(arrays, params, device, autograd.is_training())
            if not op.mutate_slots(params):
                return raw
            out = op.write_back(arrays, params, raw)
            return out[0] if len(out) == 1 else out

        return call


F_TENSOR = _TensorOps()
_CONTRIB = _TensorOps("_contrib_")
