"""Predictor — forward-only model server core (subset of
``mxnet_tpu/serving/predictor.py``; parity: the C predict API).

``mxnet_tpu`` traces a Symbol and compiles one executable per bucketed
batch size through ``capture.CapturedExec`` (``mxnet_tpu/serving/
predictor.py:159, 282, 600``). The port captures the Block's forward,
under ``torch.inference_mode()``, as one CUDA graph per bucket through
:class:`mxnet_tpu_torch.capture.CapturedExec`; the buckets share one
memory pool, calls are serialised and outputs cloned out. A batch is
copied into its bucket's static input with zero rows up to the bucket,
and outputs are sliced back to the true rows (``mxnet_tpu/serving/
predictor.py:468-474, 697-728``). A batch larger than every declared
bucket runs at its own size: a new graph, logged as a retrace. On a CPU
context the forward runs directly. Loading a Symbol JSON is a later slice.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .. import capture
from ..base import MXNetError, torch_dtype
from ..context import as_device
from . import _STATS

__all__ = ["Predictor", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def _declared_buckets(batch_sizes):
    out = tuple(sorted({int(b) for b in (batch_sizes or DEFAULT_BUCKETS)}))
    if out[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints, got {out}")
    return out


class Predictor:
    """Serve an initialized Block.

    Parameters
    ----------
    block : Block — initialized, with every parameter on ``ctx``'s device.
    ctx : Context (default: the current context, ``gpu(0)``).
    input_shapes : dict name -> PER-SAMPLE shape (no batch axis); the
        Block's forward takes the inputs positionally in this order.
    batch_sizes : declared batch buckets (default ``(1, 2, 4, 8, 16)``).
        ``predict`` pads each batch up to the smallest bucket that fits;
        a larger batch runs at its own size.
    warmup : run every declared bucket once at construction (needs
        ``input_shapes``).
    dtype : the dtype float inputs are cast to; integer inputs (token ids)
        pass through.
    """

    def __init__(self, block, ctx=None, input_shapes=None, batch_sizes=None,
                 warmup=True, dtype="float32", input_names=("data",)):
        self._device = as_device(ctx)
        self._block = block
        for name, t in block.collect_params().items():
            if t is None:
                raise MXNetError(f"Predictor: parameter '{name}' is not "
                                 "initialized")
            if t.device != self._device:
                raise MXNetError(
                    f"Predictor: parameter '{name}' lies on {t.device}, "
                    f"not on the predictor's device {self._device}")
        self._buckets = _declared_buckets(batch_sizes)
        self._dtype = torch_dtype(dtype)
        if input_shapes is not None:
            self.input_names = list(input_shapes)
            self._input_tails = {n: tuple(s) for n, s in input_shapes.items()}
        else:
            self.input_names = list(input_names)
            self._input_tails = None
        self._lock = threading.Lock()
        self._seen = set()   # buckets run at least once
        self._param_objs = list(block._param_objects().values())
        self._exec = capture.CapturedExec(
            self._forward, label="predictor", device=self._device,
            state=lambda: [p.data() for p in self._param_objs])
        if warmup and self._input_tails is not None:
            self.warmup()

    @classmethod
    def from_block(cls, block, input_shapes=None, input_names=("data",),
                   ctx=None, **kwargs):
        """Wrap an initialized gluon Block: its forward is the served
        function and its parameters are used in place."""
        return cls(block, ctx=ctx, input_shapes=input_shapes,
                   input_names=input_names, **kwargs)

    @property
    def buckets(self):
        return self._buckets

    @property
    def device(self):
        return self._device

    def bucket_for(self, n):
        """Smallest declared bucket that fits ``n`` rows (``n`` itself
        beyond the largest declared)."""
        for b in self._buckets:
            if b >= n:
                return b
        return n

    def _note_bucket(self, bucket):
        with self._lock:
            hit = bucket in self._seen
            self._seen.add(bucket)
        _STATS["serving_bucket_hits" if hit else "serving_bucket_misses"] += 1
        if bucket not in self._buckets:
            _STATS["serving_unbucketed"] += 1

    def _forward(self, *inputs):
        with torch.inference_mode():
            out = self._block(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _run(self, feeds, bucket, rows=None):
        """The bucket's graph on ``feeds`` (padded to ``bucket`` rows);
        outputs cut to ``rows``."""
        return self._exec(*[feeds[n] for n in self.input_names],
                          batch=bucket, rows=rows)

    def warmup(self, buckets=None, dtype=None):
        """Capture every declared bucket on zeros of ``dtype`` (default the
        predictor's; pass the requests' dtype, e.g. ``"int64"`` for token
        ids, which pass through uncast) (needs ``input_shapes``), so the
        first request pays no first-run costs such as building the CUDA
        kernels or capturing its graph."""
        if self._input_tails is None:
            raise MXNetError("Predictor.warmup needs input_shapes")
        dt = self._dtype if dtype is None else torch_dtype(dtype)
        for b in (buckets or self._buckets):
            self._note_bucket(int(b))
            self._run({n: torch.zeros((int(b),) + tail, dtype=dt,
                                      device=self._device)
                       for n, tail in self._input_tails.items()}, int(b))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    def _coerce_feeds(self, data):
        """data: array | dict name->array -> (dict name->tensor on the
        device, rows)."""
        if not isinstance(data, dict):
            if len(self.input_names) != 1:
                raise MXNetError(
                    f"Predictor has inputs {self.input_names}; pass a dict")
            data = {self.input_names[0]: data}
        feeds, n = {}, None
        for name, a in data.items():
            if name not in self.input_names:
                raise MXNetError(f"unknown input '{name}' "
                                 f"(declared: {self.input_names})")
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(_np.ascontiguousarray(a))
            if a.is_floating_point():
                a = a.to(self._dtype)
            a = a.to(self._device)
            if a.dim() == 0:
                raise MXNetError(f"input '{name}' must have a batch axis")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise MXNetError(f"input '{name}' has {a.shape[0]} rows, "
                                 f"expected {n}")
            feeds[name] = a
        missing = [m for m in self.input_names if m not in feeds]
        if missing:
            raise MXNetError(f"missing inputs {missing}")
        return feeds, n

    def predict_raw(self, data):
        """Run one batch; returns (list of output tensors, n_rows). The
        batch is padded up to its bucket and outputs are sliced back to the
        true row count, so callers see exactly their rows."""
        feeds, n = self._coerce_feeds(data)
        if not n:
            raise MXNetError("Predictor: empty batch")
        _STATS["serving_predict_calls"] += 1
        bucket = self.bucket_for(n)
        self._note_bucket(bucket)
        outs = self._run(feeds, bucket, rows=n)
        _STATS["serving_batch_samples"] += bucket
        _STATS["serving_padded_samples"] += bucket - n
        return outs, n

    def predict(self, data):
        """Functional inference: ``data`` is one batch (array, or dict
        name -> array). Returns the list of output tensors, batch-sliced
        to the input's row count."""
        return self.predict_raw(data)[0]
