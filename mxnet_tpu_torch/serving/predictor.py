"""Predictor — forward-only model server core (subset of
``mxnet_tpu/serving/predictor.py``; parity: the C predict API).

Two sources, as in ``mxnet_tpu``:

- a Symbol, its JSON string or a ``*-symbol.json`` path, with params as a
  dict or a ``*.params`` path (``arg:`` / ``aux:`` prefixes honored;
  ``mxnet_tpu/serving/predictor.py:65, 194``): the served function is the
  :class:`~mxnet_tpu_torch.executor.Executor`'s walk of the graph;
- an initialized Block (``Predictor(block, ...)`` or :meth:`from_block`):
  the served function is the Block's forward, its parameters used in
  place.

``mxnet_tpu`` compiles one executable per bucketed batch size through
``capture.CapturedExec`` (``mxnet_tpu/serving/predictor.py:159, 282,
600``). The port captures the forward, under ``torch.inference_mode()``,
as one CUDA graph per bucket through :class:`mxnet_tpu_torch.capture.
CapturedExec`; the buckets share one memory pool, calls are serialised and
outputs cloned out. A batch is copied into its bucket's static input with
zero rows up to the bucket, and outputs are sliced back to the true rows
(``mxnet_tpu/serving/predictor.py:468-474, 697-728``). A batch larger than
every declared bucket runs at its own size: a new graph, logged as a
retrace. On a CPU context the forward runs directly.

INT8 serving (``quantize="int8"``, Symbol sources; ``mxnet_tpu/serving/
predictor.py:263-360``): BatchNorm is folded, the graph calibrated on
``calib_data`` (naive or entropy) or checked against a shipped
``calib_table``, and rewritten to the full-int8 graph whose convs, FC and
requantize steps are K5's kernels; each bucket is then one CUDA graph of
that graph. Quantizing again starts from the fp32 graph, drops the bucket
graphs and records one retrace (``capture.retrace_log()``).

``swap_params`` replaces parameter VALUES in place (the weight-rollout
primitive of ``serving.operator``): every name, shape and dtype is checked
before the first copy, and the copies run under the lock every bucket's
replay takes, so a request sees all-old or all-new weights and no graph is
captured again. ``predict_raw`` carries the ``nan_serving`` fault hook and
the ``serve.predict`` span.
"""
from __future__ import annotations

import os
import threading

import numpy as _np
import torch

from .. import capture
from ..base import MXNetError, torch_dtype
from ..context import Context, as_device
from ..observability import trace as _obs_trace
from ..resilience import faults as _faults
from . import _STATS

__all__ = ["Predictor", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


def _declared_buckets(batch_sizes):
    out = tuple(sorted({int(b) for b in (batch_sizes or DEFAULT_BUCKETS)}))
    if out[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints, got {out}")
    return out


def _check_capturable(graph, device):
    """Raise :class:`~mxnet_tpu_torch.capture.CaptureError` when ``graph``
    (an Executor) would be captured on ``device`` and holds an op that
    reads its operands on the host (``host=True`` in ``ops/registry.py``:
    its output shape depends on its data), which a CUDA graph cannot
    replay."""
    if device.type != "cuda" or not capture.enabled():
        return
    host = sorted({op.name for _, op, _ in graph._ops if op.host})
    if host:
        raise capture.CaptureError(
            f"Predictor: {host} read their operands on the host (the output "
            "shape depends on the data) and cannot be captured in a CUDA "
            "graph; serve this graph on cpu() or with "
            "MXNET_TPU_TORCH_CAPTURE=0")


class Predictor:
    """Serve a Symbol with its params, or an initialized Block.

    Parameters
    ----------
    symbol : Symbol | JSON string | path to ``*-symbol.json`` | Block
    params : dict name -> array | path to ``*.params`` (Symbol sources).
        ``arg:`` / ``aux:`` prefixes are honored; plain names split by the
        symbol's argument / auxiliary lists. A Context here is taken as
        ``ctx`` (a Block source has no params).
    ctx : Context (default: the current context, ``gpu(0)``).
    input_shapes : dict name -> PER-SAMPLE shape (no batch axis); a
        Block's forward takes the inputs positionally in this order.
    batch_sizes : declared batch buckets (default ``(1, 2, 4, 8, 16)``).
        ``predict`` pads each batch up to the smallest bucket that fits;
        a larger batch runs at its own size.
    warmup : run every declared bucket once at construction (needs
        ``input_shapes``).
    dtype : the dtype float inputs are cast to; integer inputs (token ids)
        pass through.
    quantize : None | "int8" (Symbol sources) — serve the full-int8 graph
        (:meth:`quantize`); needs ``calib_data`` (a DataIter, with
        ``calib_mode`` naive | entropy, default env
        ``MXNET_TPU_INT8_CALIB_MODE`` or entropy) or ``calib_table`` (a
        ``CalibrationTable`` or a path; default env
        ``MXNET_TPU_INT8_TABLE``). ``excluded_sym_names`` (and env
        ``MXNET_TPU_INT8_EXCLUDE``) stay fp32.
    """

    def __init__(self, symbol, params=None, ctx=None, input_shapes=None,
                 batch_sizes=None, warmup=True, dtype="float32",
                 input_names=("data",), quantize=None, calib_data=None,
                 calib_mode=None, calib_table=None, excluded_sym_names=None,
                 num_calib_examples=None):
        from ..gluon.block import Block

        if isinstance(params, Context):
            params, ctx = None, params
        self._device = as_device(ctx)
        self._buckets = _declared_buckets(batch_sizes)
        self._dtype = torch_dtype(dtype)
        self._feed_dtype = self._dtype   # the probes' dtype (warmup's)
        self._lock = threading.Lock()
        self._seen = set()   # buckets run at least once
        self._quant = None
        self._fp32_state = None
        self.calibration_table = None
        if isinstance(symbol, Block):
            if params is not None:
                raise MXNetError("Predictor: a Block source takes no params "
                                 "(its own are served)")
            if quantize:
                raise MXNetError("Predictor: quantize= needs a Symbol source "
                                 "(export the Block first)")
            self._init_block(symbol)
            default_inputs = list(input_names)
        else:
            self._init_symbol(symbol, params)
            default_inputs = [n for n in self._arg_names
                              if n not in self._arg_params]
        if input_shapes is not None:
            self.input_names = list(input_shapes)
            self._input_tails = {n: tuple(s) for n, s in input_shapes.items()}
        else:
            self.input_names = default_inputs
            self._input_tails = None
        if self._block is None:
            self._check_inputs()
        self._exec = self._make_exec()
        if quantize:
            self.quantize(quantized_dtype=quantize if isinstance(
                quantize, str) else "int8", calib_data=calib_data,
                calib_mode=calib_mode, calib_table=calib_table,
                excluded_sym_names=excluded_sym_names,
                num_calib_examples=num_calib_examples)
        if warmup and self._input_tails is not None:
            self.warmup()

    def _init_block(self, block):
        for name, t in block.collect_params().items():
            if t is None:
                raise MXNetError(f"Predictor: parameter '{name}' is not "
                                 "initialized")
            if t.device != self._device:
                raise MXNetError(
                    f"Predictor: parameter '{name}' lies on {t.device}, "
                    f"not on the predictor's device {self._device}")
        self._block = block
        self._param_objs = list(block._param_objects().values())

    def _init_symbol(self, symbol, params):
        from .. import symbol as sym

        self._block = None
        if isinstance(symbol, str):
            symbol = (sym.load_json(symbol) if symbol.lstrip().startswith(
                "{") else sym.load(symbol))
        if not isinstance(symbol, sym.Symbol):
            raise MXNetError(f"Predictor: cannot build a symbol from "
                             f"{type(symbol).__name__}")
        self._set_graph(symbol, *self._split_params(symbol, params))

    def _set_graph(self, symbol, arg_params, aux_params):
        from ..executor import Executor

        self._symbol = symbol
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self._arg_params, self._aux_params = arg_params, aux_params
        self._graph = Executor(symbol, self._device, {}, {})
        _check_capturable(self._graph, self._device)

    def _split_params(self, symbol, params):
        """params (dict or ``.params`` path) -> (arg, aux) dicts of tensors
        on the predictor's device, copies the predictor owns (a swap never
        writes into the caller's tensors or a sibling predictor's)."""
        from .. import ndarray

        if params is None:
            params = {}
        elif isinstance(params, str):
            params = ndarray.load(params)
        arg_set = set(symbol.list_arguments())
        aux_set = set(symbol.list_auxiliary_states())
        args, auxs = {}, {}
        for key, v in params.items():
            kind, _, name = key.partition(":")
            if kind not in ("arg", "aux"):
                kind, name = ("aux" if key in aux_set else "arg"), key
            if name in aux_set:
                kind = "aux"
            v = ndarray.to_tensor(v)
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(_np.ascontiguousarray(v))
            (auxs if kind == "aux" else args)[name] = v.detach().to(
                self._device, copy=True)
        extra = [n for n in args if n not in arg_set]
        extra += [n for n in auxs if n not in aux_set]
        if extra:
            raise MXNetError(f"Predictor: params {extra} are not arguments "
                             "or auxiliary states of the symbol")
        return args, auxs

    def _check_inputs(self):
        unknown = [n for n in self.input_names if n not in self._arg_names]
        if unknown:
            raise MXNetError(f"Predictor: inputs {unknown} are not "
                             f"arguments of the symbol ({self._arg_names})")
        missing = [n for n in self._arg_names
                   if n not in self._arg_params and n not in self.input_names]
        missing += [n for n in self._aux_names if n not in self._aux_params]
        if missing:
            raise MXNetError(f"Predictor: {missing} are missing from params "
                             "and are not declared inputs")

    def _make_exec(self):
        if self._block is not None:
            return capture.CapturedExec(
                self._forward, label="predictor", device=self._device,
                state=lambda: [p.data() for p in self._param_objs])
        return capture.CapturedExec(
            self._graph_forward, label="predictor", device=self._device,
            state=lambda: list(self._arg_params.values())
            + list(self._aux_params.values()))

    @classmethod
    def from_block(cls, block, input_shapes=None, input_names=("data",),
                   ctx=None, **kwargs):
        """Wrap an initialized gluon Block: its forward is the served
        function and its parameters are used in place."""
        return cls(block, ctx=ctx, input_shapes=input_shapes,
                   input_names=input_names, **kwargs)

    # ------------------------------------------------------------ quantization
    @property
    def quantization(self):
        """The served graph's quantization identity (dtype, calibration
        mode, table digest, excluded nodes), or None."""
        return dict(self._quant) if self._quant else None

    def quantize(self, quantized_dtype="int8", calib_data=None,
                 calib_mode=None, calib_table=None, excluded_sym_names=None,
                 num_calib_examples=None):
        """Serve the full-int8 graph (``mxnet_tpu/serving/predictor.py:
        263``): fold BatchNorm, calibrate on ``calib_data`` (eagerly, on
        the predictor's device; the table is kept on
        ``calibration_table``) or validate ``calib_table`` against this
        model, rewrite with ``quantize_model(quantize_mode='full')``, drop
        every bucket graph. Quantizing again starts from the fp32 graph and
        records one retrace when the thresholds changed."""
        from ..contrib import quantization as _q

        if self._block is not None:
            raise MXNetError("Predictor.quantize needs a Symbol source")
        if quantized_dtype != "int8":
            raise MXNetError("Predictor.quantize serves symmetric int8 "
                             f"kernels only, got {quantized_dtype!r}")
        if self._fp32_state is None:
            self._fp32_state = (self._symbol, dict(self._arg_params),
                                dict(self._aux_params))
        sym, args, auxs = _q.fold_batch_norm(*self._fp32_state)
        excluded = list(excluded_sym_names or ())
        env_ex = os.environ.get("MXNET_TPU_INT8_EXCLUDE", "").strip()
        if env_ex:
            excluded += [x.strip() for x in env_ex.split(",") if x.strip()]
        if calib_table is not None and calib_data is not None:
            raise MXNetError(
                "Predictor.quantize: pass calib_table OR calib_data, not "
                "both (a pre-shipped table and a fresh calibration run "
                "cannot both win)")
        if calib_table is None and calib_data is None:
            calib_table = os.environ.get("MXNET_TPU_INT8_TABLE",
                                         "").strip() or None
        if calib_table is not None:
            table = (_q.CalibrationTable.load(calib_table)
                     if isinstance(calib_table, str) else calib_table)
        elif calib_data is not None:
            table = _q.calibrate(
                sym, args, auxs, calib_data,
                calib_mode=(calib_mode
                            or os.environ.get("MXNET_TPU_INT8_CALIB_MODE",
                                              "").strip() or "entropy"),
                data_names=tuple(self.input_names), label_names=(),
                num_calib_examples=num_calib_examples, ctx=self._device)
        else:
            raise MXNetError(
                "Predictor.quantize needs a calibration source: "
                "calib_data, calib_table, or MXNET_TPU_INT8_TABLE")
        qsym, qargs, qaux = _q.quantize_model(
            sym, args, auxs, data_names=tuple(self.input_names),
            label_names=(), excluded_sym_names=excluded,
            quantized_dtype=quantized_dtype, quantize_mode="full",
            calib_table=table)
        prev = self._quant
        quant = {"dtype": quantized_dtype, "mode": "full",
                 "calib_mode": table.calib_mode,
                 "table_digest": table.digest(),
                 "excluded": tuple(sorted(excluded)),
                 "base_digest": _q.symbol_digest(sym)}
        with self._lock:
            self._set_graph(qsym, {k: v.to(self._device)
                                   for k, v in qargs.items()},
                            {k: v.to(self._device) for k, v in qaux.items()})
            self._quant = quant
            self.calibration_table = table
            self._exec = self._make_exec()
            self._seen.clear()
        _STATS["serving_quantized_predictors"] += 1
        if prev is not None and prev["table_digest"] != quant["table_digest"]:
            capture.note_recapture(
                f"serving_quant:{quant['base_digest']}",
                prev["table_digest"], quant["table_digest"],
                reason="int8 recalibration: the bucket graphs are captured "
                       "again from the requantized graph")
        return self

    @property
    def quant_tag(self):
        """Suffix naming the served executable's dtype in health-check
        messages (empty for fp32 / bf16)."""
        q = self._quant
        return f" ({q['dtype']} executable)" if q else ""

    # ------------------------------------------------------------ live swap
    def _bound_cells(self):
        """``{("arg"|"aux", name): tensor}`` of the parameters every bucket
        graph reads."""
        if self._block is not None:
            return {("arg", name): t for name, t in
                    self._block.collect_params().items()}
        cells = {("arg", n): t for n, t in self._arg_params.items()}
        cells.update({("aux", n): t for n, t in self._aux_params.items()})
        return cells

    def swap_params(self, params):
        """Replace bound parameter / aux VALUES in place: ``params`` is
        ``{name | "arg:name" | "aux:name": array}`` or a ``.params`` path.
        Every entry is validated (a bound name, its shape and dtype)
        before the first copy, so a rejected swap leaves the predictor
        untouched; the copies run under the lock the bucket graphs replay
        under, so a concurrent request sees all-old or all-new weights.
        An int8 predictor's bound cells are its quantized graph's (the
        fp32 names it was built from are not bound), as in ``mxnet_tpu``.
        Returns the prior values as ``{"arg:name"/"aux:name": tensor}``
        clones: pass it back to roll back."""
        from .. import ndarray

        if isinstance(params, str):
            params = ndarray.load(params)
        cells = self._bound_cells()
        updates = []
        for key, v in params.items():
            kind, _, name = key.partition(":")
            if kind not in ("arg", "aux"):
                name = key
                kind = "aux" if ("aux", key) in cells else "arg"
            cell = cells.get((kind, name))
            if cell is None:
                raise MXNetError(
                    f"swap_params: '{name}' is not a bound {kind} parameter "
                    "of this predictor (data inputs and unbound names "
                    "cannot be swapped)")
            t = ndarray.to_tensor(v)
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(_np.ascontiguousarray(_np.asarray(t)))
            if tuple(t.shape) != tuple(cell.shape) or t.dtype != cell.dtype:
                raise MXNetError(
                    f"swap_params: {kind} '{name}' is {tuple(t.shape)}/"
                    f"{t.dtype} but the bound cell is {tuple(cell.shape)}/"
                    f"{cell.dtype}; a changed architecture needs a new "
                    "Predictor, not a live swap")
            updates.append((f"{kind}:{name}", cell, t))
        prev = {}
        with self._lock, self._exec._lock, torch.no_grad():
            for key, cell, t in updates:
                prev[key] = cell.detach().clone()
            for key, cell, t in updates:
                cell.copy_(t)
        return prev

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

    def _graph_forward(self, *inputs):
        feeds = dict(zip(self.input_names, inputs))
        args = [feeds[n] if n in feeds else self._arg_params[n]
                for n in self._arg_names]
        auxs = [self._aux_params[n] for n in self._aux_names]
        with torch.inference_mode():
            return self._graph.run(args, auxs)[0]

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
        self._feed_dtype = dt
        for b in (buckets or self._buckets):
            self._note_bucket(int(b))
            self._run({n: torch.zeros((int(b),) + tail, dtype=dt,
                                      device=self._device)
                       for n, tail in self._input_tails.items()}, int(b))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    def _probe_feeds(self):
        """A 1-row zero batch of the warm-up dtype (the fleet's health
        probe), or None without ``input_shapes``."""
        if self._input_tails is None:
            return None
        return {n: torch.zeros((1,) + tail, dtype=self._feed_dtype)
                for n, tail in self._input_tails.items()}

    @staticmethod
    def _sig_of(feeds):
        return tuple(sorted((n, tuple(a.shape[1:]), str(a.dtype))
                            for n, a in feeds.items()))

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
        feeds = _faults.maybe_nan_batch(feeds)
        self._note_bucket(bucket)
        with _obs_trace.span("serve.predict", rows=n, bucket=bucket):
            outs = self._run(feeds, bucket, rows=n)
        _STATS["serving_batch_samples"] += bucket
        _STATS["serving_padded_samples"] += bucket - n
        return outs, n

    def predict(self, data):
        """Functional inference: ``data`` is one batch (array, or dict
        name -> array). Returns the list of output tensors, batch-sliced
        to the input's row count."""
        return self.predict_raw(data)[0]
