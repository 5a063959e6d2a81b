"""NDArray: the imperative array (port of
``mxnet_tpu/ndarray/ndarray.py:43-926``; parity: include/mxnet/ndarray.h,
python/mxnet/ndarray/ndarray.py).

An :class:`NDArray` holds one ``torch.Tensor`` on its context's device.
Every op runs through :func:`imperative_invoke`, which looks the op up in
the registry (``ops/registry.py``), calls its function on the tensors,
writes mutated slots back in place (BatchNorm's running statistics) and
wraps the results. Recording is torch's own tape: inside
``autograd.record()`` an op runs with grad mode on (unless the op has no
gradient), outside it with grad mode off, so nothing outside ``record()``
builds a graph.

Memory follows MXNet. Basic indexing (ints, slices, ``None``,
``Ellipsis``) gives a view that shares the parent's memory: a write
through ``x[1:3]`` changes ``x``. In-place operators (``x += 1``,
``x[:] = v``, ``copyto``, an op's ``out=``) write into the array's own
tensor, so an earlier view of it sees the change; an op's result never
shares memory with its inputs (a result that would alias one is copied),
so writing into it leaves the inputs alone. ``mxnet_tpu`` swaps the
buffer of the array instead (``_set_data``), so there a view taken before
``x += 1`` keeps the old values (ROADMAP "Reference defects"). In-place
writes run outside autograd: a leaf that requires a gradient is written
under ``torch.no_grad()``, never through the tape.

``mx.nd`` places an array on ``ctx`` when given, else on the current
context, which is ``gpu(0)`` unless a ``with mx.cpu():`` scope says
otherwise: without a card that raises ``MXNetError``, as every entry point
of the port does. Parameter files are ``mxnet_tpu``'s npz ``.params``
(:func:`save` / :func:`load`); loaded arrays are on ``cpu()``, as MXNet
restores a file with no device.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context
from ..ops import registry as _reg
from .. import profiler as _profiler

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "concatenate", "stack", "split", "waitall", "save",
           "load", "imperative_invoke", "moveaxis", "broadcast_to", "tile",
           "repeat", "expand_dims", "transpose", "reshape", "squeeze",
           "flip", "zeros_like", "ones_like",
           "context_of", "to_tensor"]

_NUMERIC = (int, float, bool, _np.generic)


def context_of(t):
    """The Context of a tensor's device."""
    if t.device.type == "cuda":
        return Context("gpu", t.device.index or 0)
    return Context("cpu", 0)


def to_tensor(x):
    """An NDArray's tensor; anything else as it is."""
    return x._data if isinstance(x, NDArray) else x


def _numpy_dtype(dt):
    if dt == torch.bfloat16:
        return dt
    return _np.dtype(str(dt).replace("torch.", ""))


class NDArray:
    """An n-dimensional array on a device context, holding one tensor."""

    __slots__ = ("_data", "_ctx", "grad_req", "__weakref__")
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data)
        self.grad_req = "null"

    # ------------------------------------------------------------------ core
    @property
    def data_(self):
        """The tensor this array holds."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """A numpy dtype (``torch.bfloat16`` for bfloat16, which numpy
        lacks)."""
        return _numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element NDArray")
        return bool(self.item())

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self)

    def item(self):
        return self.asnumpy().reshape(())[()]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ----------------------------------------------------------- engine sync
    def wait_to_read(self):
        """Block until the value is computed (ndarray.h WaitToRead)."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy on the host; bfloat16 is read as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar")
        return self.item()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -------------------------------------------------------------- mutation
    def _set_data(self, new):
        """Write ``new`` (a tensor, NDArray, array or number) into this
        array: in place, outside autograd, when its shape is this array's;
        else the array takes ``new``'s tensor."""
        new = to_tensor(new)
        if not isinstance(new, torch.Tensor):
            new = torch.as_tensor(_np.asarray(new), dtype=self._data.dtype)
        if tuple(new.shape) == self.shape:
            with torch.no_grad():
                self._data.copy_(new)
        else:
            self._data = new.to(self._data.device)

    def _inplace(self, out):
        """The in-place operators' write: into this tensor, unless it is a
        recorded non-leaf, which takes the recorded result instead."""
        t = self._data
        if t.requires_grad and t.grad_fn is not None:
            self._data = out._data
        else:
            self._set_data(out._data)
        return self

    # ------------------------------------------------------------- transfers
    def copyto(self, other):
        """A copy on a Context, or written into an NDArray."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device))
            return other
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx):
        return self if ctx == self.context else self.copyto(ctx)

    as_in_ctx = as_in_context

    def copy(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return imperative_invoke("Cast", self, dtype=str(dt)[6:])[0]

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage types need the row-sparse and "
                             "CSR arrays of ROADMAP Queue 1 item 9, which "
                             "are not ported")
        return self

    # -------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a gradient buffer (zeros), filled by a backward
        ('write') or added into ('add'). The array becomes a leaf of the
        tape; its memory stays shared with any array it views."""
        from .. import autograd

        self._data = self._data.detach()
        self.grad_req = grad_req
        autograd.mark_variables(self._data, torch.zeros_like(self._data),
                                grad_req)

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else NDArray(g, self._ctx)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------- indexing
    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            return key._data.to(torch.int64) if not key._data.dtype == \
                torch.bool else key._data
        if isinstance(key, tuple):
            return tuple(NDArray._key(k) if isinstance(k, NDArray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        """Basic indexing: a view sharing this array's memory; advanced
        indexing (arrays of ids): a copy."""
        from .. import autograd

        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[self._key(key)], self._ctx)

    def __setitem__(self, key, value):
        value = to_tensor(value)
        if not isinstance(value, (torch.Tensor,) + _NUMERIC):
            value = torch.as_tensor(_np.asarray(value),
                                    dtype=self._data.dtype)
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device)
        with torch.no_grad():
            self._data[self._key(key)] = value

    def slice_assign(self, rhs, begin, end, step=None):
        idx = tuple(slice(b, e, s) for b, e, s in
                    zip(begin, end, step or [None] * len(begin)))
        self[idx] = rhs
        return self

    # ------------------------------------------------------------ arithmetic
    def _binary(self, other, opname, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return imperative_invoke(opname, lhs, rhs)[0]
        if isinstance(other, _NUMERIC):
            return imperative_invoke(opname + "_scalar", self,
                                     scalar=float(other), reverse=reverse)[0]
        if isinstance(other, (_np.ndarray, torch.Tensor)):
            return self._binary(array(other, ctx=self.context,
                                      dtype=getattr(other, "dtype", None)),
                                opname, reverse)
        raise TypeError(f"unsupported operand type {type(other)} for "
                        f"{opname}")

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

    def __mod__(self, o):
        return self._binary(o, "elemwise_mod")

    def __rmod__(self, o):
        return self._binary(o, "elemwise_mod", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "elemwise_pow")

    def __rpow__(self, o):
        return self._binary(o, "elemwise_pow", reverse=True)

    def __neg__(self):
        return imperative_invoke("negative", self)[0]

    def __abs__(self):
        return imperative_invoke("abs", self)[0]

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal")

    def __hash__(self):
        return id(self)

    def __iadd__(self, o):
        return self._inplace(self._binary(o, "elemwise_add"))

    def __isub__(self, o):
        return self._inplace(self._binary(o, "elemwise_sub"))

    def __imul__(self, o):
        return self._inplace(self._binary(o, "elemwise_mul"))

    def __itruediv__(self, o):
        return self._inplace(self._binary(o, "elemwise_div"))

    # ------------------------------------------------------------- reshaping
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return imperative_invoke("Reshape", self, shape=tuple(shape),
                                 reverse=kwargs.get("reverse", False))[0]

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def flatten(self):
        return self.reshape((self.shape[0], -1)) if self.ndim > 1 else self

    def expand_dims(self, axis):
        return imperative_invoke("expand_dims", self, axis=axis)[0]

    def squeeze(self, axis=None):
        return imperative_invoke("squeeze", self, axis=axis)[0]

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return imperative_invoke("transpose", self,
                                 axes=tuple(axes) if axes else None)[0]

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, a1, a2):
        return imperative_invoke("SwapAxis", self, dim1=a1, dim2=a2)[0]

    def split(self, num_outputs, axis=0):
        return split(self, num_outputs, axis)

    def broadcast_to(self, shape):
        return imperative_invoke("broadcast_to", self, shape=tuple(shape))[0]

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return imperative_invoke("tile", self, reps=tuple(reps) if isinstance(
            reps, (list, tuple)) else reps)[0]

    def repeat(self, repeats, axis=None):
        return imperative_invoke("repeat", self, repeats=repeats,
                                 axis=axis)[0]

    def pad(self, pad_width, mode="constant", constant_value=0):
        return imperative_invoke("pad", self, pad_width=tuple(pad_width),
                                 mode=mode, constant_value=constant_value)[0]

    def flip(self, axis):
        return imperative_invoke("flip", self, axis=axis)[0]

    def diag(self, k=0):
        return imperative_invoke("diag", self, k=k)[0]

    # ------------------------------------------------------------ reductions
    def _reduce(self, opname, axis=None, keepdims=False, **kw):
        axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        return imperative_invoke(opname, self, axis=axis, keepdims=keepdims,
                                 **kw)[0]

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):  # noqa: A002
        return self._reduce("norm", axis, keepdims, ord=ord)

    def argmax(self, axis=None, keepdims=False):
        return imperative_invoke("argmax", self, axis=axis,
                                 keepdims=keepdims)[0]

    def argmin(self, axis=None, keepdims=False):
        return imperative_invoke("argmin", self, axis=axis,
                                 keepdims=keepdims)[0]

    def argsort(self, axis=-1, is_ascend=True):
        return imperative_invoke("argsort", self, axis=axis,
                                 is_ascend=is_ascend)[0]

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        out = imperative_invoke("topk", self, axis=axis, k=k,
                                ret_typ=ret_typ, is_ascend=is_ascend)
        return out if len(out) > 1 else out[0]

    # ---------------------------------------------------------------- math
    def dot(self, other, **kw):
        return imperative_invoke("dot", self, other, **kw)[0]

    def clip(self, a_min=None, a_max=None):
        return imperative_invoke("clip", self, a_min=a_min, a_max=a_max)[0]

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return imperative_invoke("one_hot", self, depth=depth,
                                 on_value=on_value, off_value=off_value)[0]

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke("take", self, indices, axis=axis,
                                 mode=mode)[0]

    def softmax(self, axis=-1):
        return imperative_invoke("softmax", self, axis=axis)[0]

    def log_softmax(self, axis=-1):
        return imperative_invoke("log_softmax", self, axis=axis)[0]


def _unary_method(opname):
    def method(self):
        return imperative_invoke(opname, self)[0]
    method.__name__ = opname
    return method


for _op in ("abs", "sqrt", "square", "exp", "log", "relu", "sigmoid",
            "tanh", "sign", "round", "floor", "ceil"):
    setattr(NDArray, _op, _unary_method(_op))


# ---------------------------------------------------------------------------
# imperative invoke (parity: MXImperativeInvokeEx -> Imperative::Invoke)
# ---------------------------------------------------------------------------

def _as_context(ctx):
    if ctx is None or isinstance(ctx, Context):
        return ctx
    if isinstance(ctx, str):          # "cpu(0)", "gpu(1)" from a graph
        kind, _, rest = ctx.partition("(")
        return Context(kind, int(rest.rstrip(")") or 0))
    raise MXNetError(f"not a context: {ctx!r}")


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def imperative_invoke(opname, *inputs, out=None, **params):
    """Run the registered op ``opname`` on NDArrays; a list of NDArrays.

    The op runs on ``ctx`` when given (creation ops, samplers), else on the
    first input's context, else on the current one. It gets ``_train``
    from ``autograd.is_training()``, ``device`` and the device's
    ``mx.random`` generator when it takes them; inside ``record()`` it is
    on torch's tape unless it has no gradient. NDArray-valued params
    (optional array inputs such as ``mask``) pass as their tensors.
    Mutated slots are written into their input arrays in place; with
    ``out`` the results are written into those arrays, which are
    returned."""
    from .. import autograd
    from ..amp import amp as _amp

    op = _reg.get_op(opname)
    _profiler.record_dispatch(op.name)
    params = op.normalize(params)
    ctx = _as_context(params.pop("ctx", None))
    if ctx is None:
        ctx = inputs[0]._ctx if inputs else current_context()
    tensors = [x._data for x in inputs]
    params = {k: to_tensor(v) for k, v in params.items()}
    device = tensors[0].device if tensors else ctx.torch_device()
    cast = _amp.cast_inputs_for(op.name, tensors) if _amp.amp_active() \
        else tensors
    with torch.set_grad_enabled(autograd.is_recording() and not op.no_grad):
        raw = op.call(cast, params, device, autograd.is_training())
    outs = []
    for r in op.write_back(tensors, params, raw):
        if any(_shares_memory(r, t) for t in tensors):
            r = r.clone()
        outs.append(NDArray(r, ctx))
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for o, r in zip(targets, outs):
            o._set_data(r._data)
        return list(targets)
    return outs


# ---------------------------------------------------------------------------
# creation / free functions
# ---------------------------------------------------------------------------

def _shape_of(shape):
    return (shape,) if isinstance(shape, (int, _np.integer)) else \
        tuple(shape)


def _dtype_name(dtype):
    return None if dtype is None else str(torch_dtype(dtype))[6:]


def array(source, ctx=None, dtype=None):
    """An NDArray from an NDArray, a tensor, a numpy array or a nested
    list, on ``ctx`` (the current context when None). The dtype is
    ``dtype``, else the source's for an NDArray or a tensor, else float32
    (MXNet's ``mx_real_t``)."""
    ctx = ctx or current_context()
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
        dt = torch_dtype(dtype) if dtype is not None else t.dtype
    else:
        dt = torch_dtype(dtype) if dtype is not None else torch.float32
        src = _np.asarray(source)
        if dt == torch.bfloat16:
            t = torch.from_numpy(_np.ascontiguousarray(src, _np.float32))
        else:
            t = torch.from_numpy(_np.ascontiguousarray(
                src, dtype=_numpy_dtype(dt)))
    return NDArray(t.to(device=ctx.torch_device(), dtype=dt, copy=True), ctx)


def zeros(shape, ctx=None, dtype=None, **kw):
    return imperative_invoke("_zeros", shape=_shape_of(shape), ctx=ctx,
                             dtype=_dtype_name(dtype))[0]


def ones(shape, ctx=None, dtype=None, **kw):
    return imperative_invoke("_ones", shape=_shape_of(shape), ctx=ctx,
                             dtype=_dtype_name(dtype))[0]


def full(shape, val, ctx=None, dtype=None):
    return imperative_invoke("_full", shape=_shape_of(shape),
                             value=float(val), ctx=ctx,
                             dtype=_dtype_name(dtype))[0]


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def zeros_like(a):
    return zeros(a.shape, a.context, a._data.dtype)


def ones_like(a):
    return ones(a.shape, a.context, a._data.dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return imperative_invoke("_arange", start=start, stop=stop, step=step,
                             repeat=int(repeat), ctx=ctx,
                             dtype=_dtype_name(dtype))[0]


def concat(*arrays, dim=1, axis=None):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return imperative_invoke("Concat", *arrays,
                             dim=dim if axis is None else axis)[0]


def concatenate(arrays, axis=0):
    return concat(*arrays, dim=axis)


def stack(*arrays, axis=0):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return imperative_invoke("stack", *arrays, axis=axis)[0]


def split(ary, num_outputs, axis=0, squeeze_axis=False):
    out = imperative_invoke("SliceChannel", ary, num_outputs=num_outputs,
                            axis=axis, squeeze_axis=squeeze_axis)
    return out if len(out) > 1 else out[0]


def broadcast_to(a, shape):
    return a.broadcast_to(shape)


def tile(a, reps):
    return a.tile(reps)


def repeat(a, repeats, axis=None):
    return a.repeat(repeats, axis)


def expand_dims(a, axis):
    return a.expand_dims(axis)


def transpose(a, axes=None):
    return a.transpose(axes) if axes is not None else a.transpose()


def reshape(a, shape, reverse=False):
    return a.reshape(shape, reverse=reverse)


def squeeze(a, axis=None):
    return a.squeeze(axis)


def flip(a, axis):
    return a.flip(axis)


def moveaxis(a, source, destination):
    perm = list(range(a.ndim))
    perm.insert(destination % a.ndim, perm.pop(source % a.ndim))
    return a.transpose(perm)


def waitall():
    """Block until every queued device operation is done (Engine
    WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ------------------------------------------------------------------- save/load
# ``mxnet_tpu``'s format: a numpy ``.npz`` whose entry names are the array
# names (``__only__`` for one array, ``__list_<i>__`` for a list), written
# to exactly the given file name. Sparse entries (``<name>::rsp_*`` /
# ``::csr_*``) wait for ROADMAP Queue 1 item 9.

def _host(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return _np.asarray(a)


def save(fname, data):
    """Write an array, a list of arrays or a dict name -> array (NDArrays,
    tensors or numpy arrays) to ``fname``."""
    if isinstance(data, (NDArray, torch.Tensor, _np.ndarray)):
        entries = {"__only__": data}
    elif isinstance(data, (list, tuple)):
        entries = {f"__list_{i}__": a for i, a in enumerate(data)}
    elif isinstance(data, dict):
        entries = dict(data)
    else:
        raise TypeError("save expects an array, a list or a dict")
    entries = {k: _host(v) for k, v in entries.items()}
    tmp = fname if fname.endswith(".npz") else fname + ".npz"
    _np.savez(tmp, **entries)
    if tmp != fname:
        os.replace(tmp, fname)


def load(fname):
    """The arrays of ``fname`` as NDArrays on ``cpu()``: a dict name ->
    array, or a list for a file saved from one array or a list."""
    with _np.load(fname, allow_pickle=False) as f:
        names = list(f.keys())
        if any("::" in n for n in names):
            raise MXNetError(f"{fname}: sparse entries need ROADMAP Queue 1 "
                             "item 9, which is not ported")
        out = {n: NDArray(torch.from_numpy(_np.array(f[n])), cpu())
               for n in names}
    if names == ["__only__"]:
        return [out["__only__"]]
    if names and all(n.startswith("__list_") for n in names):
        return [out[f"__list_{i}__"] for i in range(len(names))]
    return out
