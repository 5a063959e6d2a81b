"""INT8 model quantization: graph rewriting and calibration (port of
``mxnet_tpu/contrib/quantization.py``; parity: python/mxnet/contrib/
quantization.py and src/operator/quantization/calibrate.cc).

- :func:`quantize_graph` (``:97``) clones a Symbol with int8 boundaries:
  ``quantize_mode='fake'`` wraps the data and weight inputs of every
  FullyConnected / Convolution in quantize_v2 -> dequantize; ``'full'``
  replaces the node by the real int8 op (K5 underneath, int32
  accumulation) behind a dequantize, with weights and biases quantized
  offline into ``<name>_int8`` / ``_int8_min`` / ``_int8_max`` variables.
- :func:`fold_batch_norm` (``:755``) folds each inference BatchNorm fed by
  a Convolution into that conv's weight and bias.
- ``_int8_grid_propagate`` (``:863``) keeps a full-int8 graph on the
  integer grid through relu, pooling and the residual add, and turns
  quantize(dequantize(int32)) into requantize.
- :func:`calibrate` (``:639``) runs the fp32 graph over calibration
  batches with an executor monitor (eagerly; no capture) and returns a
  :class:`CalibrationTable` of (min, max) per quantized input, by naive
  min / max or by the KL-optimal threshold of |x| histograms ("entropy");
  min / max and histograms are reduced on the device and one small result
  a tensor a batch comes back. The table is JSON, carries a structural
  digest of the graph it was made on, and refuses (``validate_for``) a
  graph it does not belong to with :class:`CalibrationMismatchError`.
- :func:`quantize_model` (``:667``) ties them together.

Names, graph JSON, table JSON and digests are ``mxnet_tpu``'s, so a table
or a quantized graph carries across the two packages. Table keys are node
names: ``mxnet_tpu`` names many layer nodes ``fwd``, so producers of one
name share one range there, and here alike.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["quantize_model", "quantize_graph", "fold_batch_norm",
           "calibrate", "CalibrationTable", "CalibrationMismatchError",
           "symbol_digest", "stats", "reset_stats"]

_STATS = {
    "calib_batches": 0,       # calibration batches fed through the graph
    "calib_tensor_syncs": 0,  # device->host pulls (a pair or a histogram)
    "calib_ms": 0,            # wall-clock ms in the collectors
    "calib_tables_saved": 0,
    "calib_tables_loaded": 0,
    "calib_mismatches": 0,    # stale table/model pairs rejected
}


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


@contextlib.contextmanager
def _calib_timer():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STATS["calib_ms"] += int((time.perf_counter() - t0) * 1e3)


def _calib_bins(num_bins=None):
    if num_bins is not None:
        return int(num_bins)
    v = os.environ.get("MXNET_TPU_INT8_CALIB_BINS", "").strip()
    return int(v) if v else 2048


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _params_device(params):
    """Where the first tensor of ``params`` lies (the CPU if none does)."""
    for v in params.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _tensor_on(a, device):
    return torch.from_numpy(np.array(a)).to(device)


_QUANTIZABLE = ("FullyConnected", "Convolution")
_FULL_OPS = {"FullyConnected": "_contrib_quantized_fully_connected",
             "Convolution": "_contrib_quantized_conv"}
_FULL_PARAMS = {
    "FullyConnected": ("num_hidden", "no_bias", "flatten"),
    "Convolution": ("kernel", "stride", "dilate", "pad", "num_filter",
                    "num_group", "no_bias", "layout"),
}


def quantize_graph(sym, excluded_sym_names=(), quantized_dtype="int8",
                   calib_ranges=None, quantize_mode="fake",
                   offline_params=None, offline_out=None):
    """A clone of ``sym`` with int8 boundaries on every FullyConnected /
    Convolution not in ``excluded_sym_names``. ``calib_ranges``:
    {(producer_name, slot): (min, max)}; a quantize_v2 without a range
    takes the data's min / max. ``offline_params`` {name: array}: in full
    mode these weights and biases are quantized now, their values written
    to ``offline_out``."""
    from ..symbol.symbol import Symbol, Variable, _Node

    if quantize_mode not in ("fake", "full"):
        raise MXNetError(f"quantize_mode must be fake|full, "
                         f"got {quantize_mode!r}")
    excluded = set(excluded_sym_names)
    mapping = {}
    offline_params = offline_params or {}

    def make_quant(name, src, dtype="int8", key=None):
        params = {"out_type": dtype}
        if calib_ranges and key in calib_ranges:
            lo, hi = calib_ranges[key]
            params["min_calib_range"] = float(lo)
            params["max_calib_range"] = float(hi)
        return _Node("_contrib_quantize_v2", name, params=params,
                     inputs=[src])

    def make_offline(var_name, key):
        a = np.asarray(offline_params[var_name], np.float32)
        if calib_ranges and key in calib_ranges:
            lo, hi = calib_ranges[key]
        else:
            lo, hi = float(a.min()), float(a.max())
        real = max(abs(lo), abs(hi), 1e-20)
        q = np.clip(np.round(a * (127.0 / real)), -127, 127).astype(np.int8)
        base = f"{var_name}_int8"
        if offline_out is not None:
            offline_out[base] = q
            offline_out[base + "_min"] = np.float32(-real)
            offline_out[base + "_max"] = np.float32(real)
        return [(Variable(n)._outputs[0][0], 0)
                for n in (base, base + "_min", base + "_max")]

    def cloned(node):
        if id(node) in mapping:
            return mapping[id(node)]
        new = _Node(node.op, node.name, params=dict(node.params),
                    attrs=dict(node.attrs))
        new.aux_mark = node.aux_mark
        mapping[id(node)] = new
        new.inputs = [(cloned(n), s) for n, s in node.inputs]
        if node.op not in _QUANTIZABLE or node.name in excluded:
            return new
        if quantize_mode == "full":
            # range keys name the ORIGINAL producer: a quantizable
            # producer's clone is its '<name>_dequantize'
            qslots = []
            for i, ((src, slot), (orig, orig_slot)) in enumerate(
                    zip(new.inputs[:3], node.inputs[:3])):
                key = (orig.name, orig_slot)
                if orig.is_var and orig.name in offline_params:
                    qslots.append(make_offline(orig.name, key))
                else:
                    q = make_quant(f"{node.name}_in{i}_quantize",
                                   (src, slot), quantized_dtype, key=key)
                    qslots.append([(q, 0), (q, 1), (q, 2)])
            d, w = qslots[0], qslots[1]
            b = qslots[2] if len(qslots) > 2 else qslots[1]
            inputs = [d[0], w[0], b[0], d[1], d[2], w[1], w[2], b[1], b[2]]
            qparams = {k: node.params[k] for k in _FULL_PARAMS[node.op]
                       if k in node.params}
            if len(qslots) <= 2:
                qparams["no_bias"] = True
            qnode = _Node(_FULL_OPS[node.op], f"{node.name}_int8",
                          params=qparams, inputs=inputs)
            dq = _Node("_contrib_dequantize", f"{node.name}_dequantize",
                       inputs=[(qnode, 0), (qnode, 1), (qnode, 2)])
            mapping[id(node)] = dq
            return dq
        for i in range(min(2, len(new.inputs))):
            src, slot = new.inputs[i]
            orig, orig_slot = node.inputs[i]
            q = make_quant(f"{node.name}_in{i}_quantize", (src, slot),
                           quantized_dtype, key=(orig.name, orig_slot))
            dq = _Node("_contrib_dequantize", f"{node.name}_in{i}_dequantize",
                       inputs=[(q, 0), (q, 1), (q, 2)])
            new.inputs[i] = (dq, 0)
        return new

    return Symbol([(cloned(n), s) for n, s in sym._outputs])


def _quant_targets(sym):
    """(producer_name, slot) keys that need ranges: the data, weight and
    bias inputs of every quantizable node."""
    return {(n.name, s) for node in sym._topo_nodes()
            if node.op in _QUANTIZABLE for n, s in node.inputs[:3]}


def _monitor_names(targets):
    """The executor monitor's names "<node>_output[<i>]" -> key."""
    return {(f"{name}_output" if slot == 0 else f"{name}_output{slot}"):
            (name, slot) for name, slot in targets}


def _calibration_forward(sym, arg_params, aux_params, data_names,
                         label_names, calib_data, num_calib_examples, tap,
                         on_batch=None, ctx=None):
    """Bind once with a monitor, feed each calibration batch (labels as
    zeros), stop at the example count. Returns the examples seen."""
    from ..io import DataBatch
    from ..ndarray.ndarray import to_tensor

    seen, ex = 0, None
    calib_data.reset()
    for batch in calib_data:
        batch = DataBatch([to_tensor(d) for d in batch.data])
        if on_batch is not None:
            on_batch(batch)
        feeds = dict(zip(data_names, batch.data))
        if ex is None:
            args = dict(arg_params)
            args.update(feeds)
            for ln in label_names or ():
                if ln in sym.list_arguments() and ln not in args:
                    args[ln] = torch.zeros((batch.data[0].shape[0],))
            device = ctx if ctx is not None else _params_device(arg_params)
            ex = sym.bind(device, args, aux_states=dict(aux_params or {}))
            ex.set_monitor_callback(tap, monitor_all=True)
            ex.forward(is_train=False)
        else:
            ex.forward(is_train=False, **feeds)
        seen += batch.data[0].shape[0]
        _STATS["calib_batches"] += 1
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return seen


def _device_minmax(arr):
    """(min, max) of one tensor, reduced where it lies: one pull of a pair."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.asarray(arr))
    pair = torch.stack([arr.min(), arr.max()]).float().cpu()
    _STATS["calib_tensor_syncs"] += 1
    return float(pair[0]), float(pair[1])


def _device_abs_hist(arr, hi, num_bins):
    """The |x| histogram of one tensor over [0, hi] in ``num_bins`` bins,
    counted where the tensor lies, as ``jnp.histogram`` bins it (float32
    edges ``hi * i / num_bins``; a value is in the last bin whose left edge
    it reaches; ``hi`` itself in the last bin); one pull of the counts."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.asarray(arr))
    a = arr.detach().float().abs().reshape(-1)
    n = num_bins
    step = torch.arange(n, dtype=torch.float32, device=a.device) / n
    edges = torch.cat([torch.full((1,), float(hi), dtype=torch.float32,
                                  device=a.device) * step,
                       torch.full((1,), float(hi), dtype=torch.float32,
                                  device=a.device)])
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], torch.full_like(idx, n), idx)
    counts = torch.bincount(idx, minlength=n + 1)[1:n + 1]
    _STATS["calib_tensor_syncs"] += 1
    return counts.cpu().numpy().astype(np.int64)


def _collect_ranges(sym, arg_params, aux_params, data_names, label_names,
                    calib_data, num_calib_examples, logger=None,
                    seen_out=None, ctx=None):
    """Naive calibration: min / max per target over the calibration set;
    weights' ranges straight from the parameters."""
    targets = _quant_targets(sym)
    name_of = _monitor_names(targets)
    ranges = {}

    def expand(key, pair):
        lo, hi = ranges.get(key, (np.inf, -np.inf))
        ranges[key] = (min(lo, pair[0]), max(hi, pair[1]))

    def tap(mon_name, arr):
        key = name_of.get(mon_name)
        if key is not None:
            expand(key, _device_minmax(arr))

    for name, slot in targets:
        if name in arg_params:
            a = _numpy(arg_params[name])
            ranges[(name, slot)] = (float(a.min()), float(a.max()))

    def on_batch(batch):
        for n, d in zip(data_names, batch.data):
            expand((n, 0), _device_minmax(d))

    with _calib_timer():
        seen = _calibration_forward(sym, arg_params, aux_params, data_names,
                                    label_names, calib_data,
                                    num_calib_examples, tap, on_batch, ctx)
    if seen_out is not None:
        seen_out.append(seen)
    return ranges


def _entropy_threshold(hist, edges, num_quantized_bins=255):
    """KL-divergence-optimal clip threshold over an |x| histogram
    (calibrate.cc ComputeEntropy; numpy, as ``mxnet_tpu/contrib/
    quantization.py:359``)."""
    nbins = len(hist)
    half = (num_quantized_bins + 1) // 2
    if nbins <= half:
        return float(edges[-1])
    hist = hist.astype(np.float64)

    def smooth(d, eps=1e-4):
        is_zero = d == 0
        n_zero = int(is_zero.sum())
        n_nonzero = d.size - n_zero
        if n_nonzero == 0:
            return None
        if n_zero == 0:
            return d
        eps1 = eps * n_zero / n_nonzero
        if eps1 >= 1.0:
            return None
        out = d.copy()
        out[is_zero] = eps
        out[~is_zero] -= eps1
        return out

    best_kl, best_i = np.inf, nbins
    for i in range(half, nbins + 1):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()
        is_nonzero = hist[:i] > 0
        q = np.zeros(i, np.float64)
        group = i / half
        for j in range(half):
            lo = int(np.floor(j * group))
            hi = int(np.floor((j + 1) * group)) if j < half - 1 else i
            seg = slice(lo, max(hi, lo + 1))
            total = hist[seg].sum()
            nz = is_nonzero[seg].sum()
            if nz:
                q[seg] = np.where(is_nonzero[seg], total / nz, 0.0)
        p = smooth(p)
        q = smooth(q)
        if p is None or q is None:
            continue
        p /= p.sum()
        q /= q.sum()
        mask = p > 0
        kl = float(np.sum(p[mask] * np.log(p[mask] / q[mask])))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return float(edges[best_i])


def _collect_entropy_ranges(sym, arg_params, aux_params, data_names,
                            label_names, calib_data, num_calib_examples,
                            num_bins=None, logger=None, seen_out=None,
                            ctx=None):
    """Two passes: max |x| per target (the naive collector), then |x|
    histograms and the KL threshold; parameters keep their min / max."""
    num_bins = _calib_bins(num_bins)
    naive = _collect_ranges(sym, arg_params, aux_params, data_names,
                            label_names, calib_data, num_calib_examples,
                            logger, seen_out=seen_out, ctx=ctx)
    param_keys = {k for k in naive if k[0] in arg_params}
    act_keys = [k for k in naive if k not in param_keys]
    max_abs = {k: max(abs(naive[k][0]), abs(naive[k][1]), 1e-20)
               for k in act_keys}
    hists = {k: np.zeros(num_bins, np.int64) for k in act_keys}
    name_of = _monitor_names(act_keys)

    def add_hist(key, arr):
        hists[key] += _device_abs_hist(arr, max_abs[key], num_bins)

    def tap(mon_name, arr):
        key = name_of.get(mon_name)
        if key is not None:
            add_hist(key, arr)

    def on_batch(batch):
        for n, d in zip(data_names, batch.data):
            if (n, 0) in hists:
                add_hist((n, 0), d)

    with _calib_timer():
        _calibration_forward(sym, arg_params, aux_params, data_names,
                             label_names, calib_data, num_calib_examples,
                             tap, on_batch, ctx)
        ranges = dict(naive)
        for k in act_keys:
            edges = np.linspace(0.0, max_abs[k], num_bins + 1)
            t = _entropy_threshold(hists[k], edges)
            ranges[k] = (-t, t)
            if logger:
                logger.info("entropy calib %s: max|x| %.4f -> threshold "
                            "%.4f", k, max_abs[k], t)
    return ranges


def symbol_digest(sym):
    """Structural digest of a Symbol: its JSON with op-node names replaced
    by their positions, variable names kept (``mxnet_tpu/contrib/
    quantization.py:473``)."""
    graph = json.loads(sym.tojson())
    for i, node in enumerate(graph.get("nodes", ())):
        if node.get("op") != "null":
            node["name"] = f"n{i}"
    return hashlib.sha256(
        json.dumps(graph, sort_keys=True).encode()).hexdigest()[:16]


class CalibrationMismatchError(MXNetError):
    """A CalibrationTable does not belong to the model it is applied to:
    another graph (``model_digest``), targets without thresholds
    (``missing``) or parameters outside their calibrated ranges
    (``drifted``)."""

    def __init__(self, msg, model_digest=None, missing=(), drifted=()):
        super().__init__(msg)
        self.model_digest = model_digest
        self.missing = tuple(missing)
        self.drifted = tuple(drifted)


class CalibrationTable:
    """Per-tensor thresholds ``{(producer_name, slot): (min, max)}`` with
    the calibration mode, example count, dtype and the digest of the graph
    they were calibrated on (``mxnet_tpu/contrib/quantization.py:504``);
    saved as JSON beside the params file."""

    VERSION = 1

    def __init__(self, thresholds, calib_mode, num_examples=0,
                 quantized_dtype="int8", model_digest=None, num_bins=None):
        self.thresholds = {tuple(k): (float(v[0]), float(v[1]))
                           for k, v in thresholds.items()}
        self.calib_mode = calib_mode
        self.num_examples = int(num_examples)
        self.quantized_dtype = quantized_dtype
        self.model_digest = model_digest
        self.num_bins = num_bins

    def digest(self):
        """Digest of the thresholds, mode and dtype."""
        blob = json.dumps({
            "thresholds": sorted((f"{n}:{s}", lo, hi) for (n, s), (lo, hi)
                                 in self.thresholds.items()),
            "calib_mode": self.calib_mode,
            "quantized_dtype": self.quantized_dtype,
        }, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_json(self):
        return json.dumps({
            "version": self.VERSION,
            "calib_mode": self.calib_mode,
            "quantized_dtype": self.quantized_dtype,
            "num_examples": self.num_examples,
            "num_bins": self.num_bins,
            "model_digest": self.model_digest,
            "thresholds": {f"{n}:{s}": [lo, hi] for (n, s), (lo, hi)
                           in sorted(self.thresholds.items())},
        }, sort_keys=True, indent=1)

    def save(self, path):
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        _STATS["calib_tables_saved"] += 1
        return path

    @classmethod
    def from_json(cls, text):
        d = json.loads(text)
        if d.get("version") != cls.VERSION:
            raise MXNetError(
                f"CalibrationTable version {d.get('version')!r} is not "
                f"supported (expected {cls.VERSION})")
        thresholds = {}
        for key, (lo, hi) in d["thresholds"].items():
            name, _, slot = key.rpartition(":")
            thresholds[(name, int(slot))] = (lo, hi)
        return cls(thresholds, d["calib_mode"],
                   num_examples=d.get("num_examples", 0),
                   quantized_dtype=d.get("quantized_dtype", "int8"),
                   model_digest=d.get("model_digest"),
                   num_bins=d.get("num_bins"))

    @classmethod
    def load(cls, path):
        with open(path) as f:
            table = cls.from_json(f.read())
        _STATS["calib_tables_loaded"] += 1
        return table

    def validate_for(self, sym, arg_params=None, model_digest=None):
        """Raise :class:`CalibrationMismatchError` unless this table
        matches ``sym``: the same digest (when the table has one), a
        threshold for every target and, given ``arg_params``, parameter
        ranges inside the table's."""
        digest = model_digest or symbol_digest(sym)
        problems = []
        if self.model_digest is not None and digest != self.model_digest:
            problems.append(f"model digest {digest} != table digest "
                            f"{self.model_digest}")
        targets = _quant_targets(sym)
        missing = sorted(f"{n}[{s}]" for (n, s) in targets
                         if (n, s) not in self.thresholds)
        if missing:
            problems.append(f"no thresholds for targets {missing}")
        drifted = []
        if arg_params is not None:
            for (n, s) in sorted(targets):
                if n not in arg_params or (n, s) not in self.thresholds:
                    continue
                lo, hi = _device_minmax(arg_params[n])
                tlo, thi = self.thresholds[(n, s)]
                span = max(abs(tlo), abs(thi), 1e-20)
                if lo < tlo - 1e-5 * span or hi > thi + 1e-5 * span:
                    drifted.append(f"{n}[{s}] value range ({lo:.6g}, "
                                   f"{hi:.6g}) left calibrated "
                                   f"({tlo:.6g}, {thi:.6g})")
        if drifted:
            problems.append(f"param ranges drifted: {drifted}")
        if problems:
            _STATS["calib_mismatches"] += 1
            raise CalibrationMismatchError(
                "calibration table does not match this model — "
                "re-calibrate instead of serving mis-scaled int8 answers: "
                + "; ".join(problems), model_digest=self.model_digest,
                missing=missing, drifted=drifted)
        return self


def calibrate(sym, arg_params, aux_params, calib_data, calib_mode="entropy",
              data_names=("data",), label_names=("softmax_label",),
              num_calib_examples=None, num_bins=None, logger=None, ctx=None):
    """Calibrate ``sym`` (the graph you deploy: BatchNorm folded if the
    serving flow folds it) over ``calib_data`` and return a
    :class:`CalibrationTable`. ``ctx`` is the device to run on (default:
    where the parameters lie)."""
    if calib_mode not in ("naive", "entropy"):
        raise MXNetError(f"calibrate: calib_mode must be naive|entropy, "
                         f"got {calib_mode!r}")
    collect = (_collect_ranges if calib_mode == "naive"
               else _collect_entropy_ranges)
    kwargs = {} if calib_mode == "naive" else {"num_bins": num_bins}
    seen_out = []
    ranges = collect(sym, arg_params, aux_params, data_names, label_names,
                     calib_data, num_calib_examples, logger=logger,
                     seen_out=seen_out, ctx=ctx, **kwargs)
    return CalibrationTable(ranges, calib_mode,
                            num_examples=seen_out[0] if seen_out else 0,
                            num_bins=_calib_bins(num_bins)
                            if calib_mode == "entropy" else None,
                            model_digest=symbol_digest(sym))


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), excluded_sym_names=(),
                   calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   quantize_mode="fake", calib_table=None, logger=None,
                   ctx=None):
    """Quantize a symbolic model (``mxnet_tpu/contrib/quantization.py:
    667``). Returns (quantized symbol, arg_params, aux_params); in full
    mode the offline int8 weights join arg_params, on the parameters'
    device."""
    if quantized_dtype not in ("int8", "uint8"):
        raise MXNetError("quantized_dtype must be int8 or uint8")
    ranges = None
    if calib_table is not None and calib_data is not None:
        raise MXNetError(
            "quantize_model: pass calib_table OR calib_data, not both "
            "(a pre-shipped table and a fresh calibration run cannot both "
            "win)")
    if calib_table is not None:
        if isinstance(calib_table, str):
            calib_table = CalibrationTable.load(calib_table)
        calib_table.validate_for(sym, arg_params=arg_params)
        ranges = dict(calib_table.thresholds)
    elif calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} requires "
                             "calib_data")
        collect = (_collect_ranges if calib_mode == "naive"
                   else _collect_entropy_ranges)
        ranges = collect(sym, arg_params, aux_params, data_names,
                         label_names, calib_data, num_calib_examples,
                         logger=logger, ctx=ctx)
    elif calib_mode != "none":
        raise MXNetError(f"unsupported calib_mode {calib_mode!r} "
                         "(supported: 'none', 'naive', 'entropy')")
    if quantize_mode == "full" and ranges is None:
        raise MXNetError("quantize_mode='full' requires calibration "
                         "(calib_mode 'naive' or 'entropy')")
    if quantize_mode == "full" and quantized_dtype != "int8":
        raise MXNetError("quantize_mode='full' kernels are symmetric int8; "
                         "use quantized_dtype='int8'")
    if quantize_mode != "full":
        return (quantize_graph(sym, excluded_sym_names, quantized_dtype,
                               ranges, quantize_mode=quantize_mode),
                arg_params, aux_params)
    offline_in = {k: _numpy(v) for k, v in arg_params.items()}
    offline_out = {}
    qsym = quantize_graph(sym, excluded_sym_names, quantized_dtype, ranges,
                          quantize_mode="full", offline_params=offline_in,
                          offline_out=offline_out)
    qsym = _int8_grid_propagate(qsym)
    device = _params_device(arg_params)
    new_args = {k: _tensor_on(v, device) for k, v in offline_out.items()}
    live = set(qsym.list_arguments())
    for k, v in arg_params.items():
        if k in live:        # fp32 params still read (an excluded node)
            new_args[k] = v
    return qsym, new_args, aux_params


# ---------------------------------------------------------------------------
# whole-graph int8: BatchNorm folding and integer-grid propagation
# ---------------------------------------------------------------------------

def fold_batch_norm(sym, arg_params, aux_params, eps_default=1e-3):
    """Fold each inference BatchNorm whose input is a Convolution's output
    into that conv: w' = w * gamma / sqrt(var + eps) per output channel,
    b' = (b - mean) * gamma / sqrt(var + eps) + beta, in float32 numpy as
    ``mxnet_tpu/contrib/quantization.py:755``. Returns (symbol, args, auxs)
    as tensors on the parameters' device. The folded pair is named
    ``<weight>_bnfold`` / ``<weight>_bnfold_bias``, as there; a weight that
    two conv + BatchNorm pairs share gets one pair per fold: the second
    fold and any later one are keyed on the conv node's name
    (``<conv>_bnfold``, with a counter where that is taken too), where
    ``mxnet_tpu`` would overwrite the first fold."""
    from ..symbol.symbol import Symbol, Variable, _Node

    device = _params_device(arg_params)
    args = {k: _numpy(v) for k, v in arg_params.items()}
    auxs = {k: _numpy(v) for k, v in aux_params.items()}
    mapping = {}
    folded_keys = set()

    def fold_key(w_n, conv_name):
        """The base name of a fold's parameters: the weight's, or for a
        weight folded before, the conv node's (made unique)."""
        key, i = w_n, 0
        while key + "_bnfold" in folded_keys or (
                key != w_n and key + "_bnfold" in args):
            key = conv_name if i == 0 else f"{conv_name}{i}"
            i += 1
        folded_keys.add(key + "_bnfold")
        return key

    def var_of(node_inputs, idx):
        n, _ = node_inputs[idx]
        return n.name if n.is_var else None

    def cloned(node):
        if id(node) in mapping:
            return mapping[id(node)]
        new = _Node(node.op, node.name, params=dict(node.params),
                    attrs=dict(node.attrs))
        new.aux_mark = node.aux_mark
        mapping[id(node)] = new
        new.inputs = [(cloned(n), s) for n, s in node.inputs]
        if node.op != "BatchNorm":
            return new
        src, src_slot = node.inputs[0]
        if src.is_var or src.op != "Convolution" or src_slot != 0:
            return new
        gamma_n, beta_n, mean_n, var_n = (var_of(node.inputs, i)
                                          for i in range(1, 5))
        w_n = var_of(src.inputs, 1)
        if None in (gamma_n, beta_n, mean_n, var_n, w_n) or \
                w_n not in args or mean_n not in auxs:
            return new
        eps = float(node.params.get("eps", eps_default))
        fix_gamma = bool(node.params.get("fix_gamma", True))
        gamma = np.ones_like(auxs[mean_n]) if fix_gamma else args[gamma_n]
        beta = args[beta_n]
        mean, var = auxs[mean_n], auxs[var_n]
        scale = gamma / np.sqrt(var + eps)
        w = args[w_n]
        key = fold_key(w_n, src.name)
        args[key + "_bnfold"] = (
            w * scale.reshape((-1,) + (1,) * (w.ndim - 1))).astype(w.dtype)
        b_prev = 0.0
        bias_n = var_of(src.inputs, 2) if len(src.inputs) > 2 else None
        if bias_n is not None and bias_n in args:
            b_prev = args[bias_n]
        args[key + "_bnfold_bias"] = (
            (b_prev - mean) * scale + beta).astype(beta.dtype)
        conv_clone = cloned(src)
        wv = Variable(key + "_bnfold")._outputs[0][0]
        bv = Variable(key + "_bnfold_bias")._outputs[0][0]
        folded = _Node("Convolution", src.name + "_bnfold",
                       params={**src.params, "no_bias": False},
                       inputs=[conv_clone.inputs[0], (wv, 0), (bv, 0)])
        mapping[id(node)] = folded
        return folded

    out_sym = Symbol([(cloned(n), s) for n, s in sym._outputs])
    live_args = set(out_sym.list_arguments())
    live_aux = set(out_sym.list_auxiliary_states())
    new_args = {k: _tensor_on(v, device) for k, v in args.items()
                if k in live_args}
    new_aux = {k: _tensor_on(v, device) for k, v in auxs.items()
               if k in live_aux}
    return out_sym, new_args, new_aux


_I32_PRODUCERS = ("_contrib_quantized_conv",
                  "_contrib_quantized_fully_connected",
                  "_contrib_quantized_elemwise_add",
                  "_contrib_quantized_elemwise_mul")
_I8_PRODUCERS = ("_contrib_quantize_v2", "_contrib_requantize")
_GRID_PASSTHROUGH = ("_contrib_quantized_pooling", "_contrib_quantized_act",
                     "_contrib_quantized_flatten")


def _grid_of(node):
    """'int8' / 'int32' / None: the integer grid a node's output rides."""
    seen = set()
    while True:
        if node.is_var or id(node) in seen:
            return None
        seen.add(id(node))
        if node.op in _I32_PRODUCERS:
            return "int32"
        if node.op in _I8_PRODUCERS:
            return "int8"
        if node.op in _GRID_PASSTHROUGH:
            node = node.inputs[0][0]
            continue
        return None


def _int8_grid_propagate(sym):
    """Peephole pass over a full-int8 graph (``mxnet_tpu/contrib/
    quantization.py:863``): quantize_v2(dequantize(int32)) ->
    requantize; max and avg Pooling, relu and elemwise_add over
    dequantized int8 / int32 triples -> their quantized ops (``mxnet_tpu``
    rewrites every Pooling, and a 'sum' pool then raises). Each rewritten
    node keeps its identity as the boundary dequantize; dead boundaries
    drop out of the executor's walk."""
    from ..symbol.symbol import _Node

    def deq_src(inp):
        n, slot = inp
        if not n.is_var and n.op == "_contrib_dequantize" and slot == 0:
            return n, n.inputs[0][0]
        return None, None

    changed = True
    while changed:
        changed = False
        quant_of = {}
        for n2 in sym._topo_nodes():
            if not n2.is_var and n2.op in _I8_PRODUCERS and n2.inputs:
                quant_of[(id(n2.inputs[0][0]), n2.inputs[0][1])] = n2
        for node in sym._topo_nodes():
            if node.is_var:
                continue
            if node.op == "_contrib_quantize_v2":
                dq, q = deq_src(node.inputs[0])
                if dq is not None and _grid_of(q) == "int32":
                    node.op = "_contrib_requantize"
                    node.inputs = list(dq.inputs)
                    node.params = {k: node.params[k] for k in
                                   ("min_calib_range", "max_calib_range")
                                   if k in node.params}
                    changed = True
            elif node.op == "Pooling" and \
                    node.params.get("pool_type", "max") in ("max", "avg"):
                # quantized_pooling has max and avg only: a 'sum' (or lp)
                # pool stays fp32 behind its dequantize
                dq, q = deq_src(node.inputs[0])
                layout_ok = (node.params.get("layout") or "NCHW")[1] == "C"
                if dq is not None and layout_ok and _grid_of(q) is not None:
                    qp_params = {k: v for k, v in node.params.items()
                                 if k in ("kernel", "stride", "pad",
                                          "pool_type", "global_pool",
                                          "pooling_convention",
                                          "count_include_pad", "layout")}
                    qp = _Node("_contrib_quantized_pooling",
                               node.name + "_int8", params=qp_params,
                               inputs=list(dq.inputs))
                    node.op = "_contrib_dequantize"
                    node.params = {}
                    node.inputs = [(qp, 0), (qp, 1), (qp, 2)]
                    changed = True
            elif node.op == "Activation" and \
                    node.params.get("act_type", "relu") == "relu":
                dq, q = deq_src(node.inputs[0])
                if dq is not None and _grid_of(q) is not None:
                    qa = _Node("_contrib_quantized_act", node.name + "_int8",
                               params={"act_type": "relu"},
                               inputs=list(dq.inputs))
                    node.op = "_contrib_dequantize"
                    node.params = {}
                    node.inputs = [(qa, 0), (qa, 1), (qa, 2)]
                    changed = True
            elif node.op in ("elemwise_add", "broadcast_add", "_plus"):
                def int8_triple(inp):
                    dq, q = deq_src(inp)
                    if dq is not None:
                        g = _grid_of(q)
                        if g == "int8":
                            return list(dq.inputs)
                        if g == "int32":
                            rq = _Node("_contrib_requantize", q.name + "_rq",
                                       inputs=list(dq.inputs))
                            return [(rq, 0), (rq, 1), (rq, 2)]
                    qn = quant_of.get((id(inp[0]), inp[1]))
                    if qn is not None:
                        return [(qn, 0), (qn, 1), (qn, 2)]
                    return None

                ta = int8_triple(node.inputs[0])
                tb = int8_triple(node.inputs[1])
                if ta is not None and tb is not None:
                    qadd = _Node("_contrib_quantized_elemwise_add",
                                 node.name + "_int8",
                                 inputs=[ta[0], tb[0], ta[1], ta[2], tb[1],
                                         tb[2]])
                    node.op = "_contrib_dequantize"
                    node.params = {}
                    node.inputs = [(qadd, 0), (qadd, 1), (qadd, 2)]
                    changed = True
    return sym
