"""Generative decode serving: the paged KV-cache runtime (port of
``mxnet_tpu/serving/decode.py``).

- :class:`PagePool` allocates fixed-size KV pages (``page_size`` tokens
  each) out of ``num_pages`` preallocated ones, so admitting and evicting a
  sequence is integer bookkeeping, never an allocation. Page 0 is the
  scratch page that masked writes land on. ``alloc`` returning None is the
  backpressure signal (``decode_backpressure``).
- :class:`DecodePredictor` runs one ``TransformerLM`` as three executable
  families: ``("prefill", bucket)`` writes a prompt's KV into its pages and
  returns the last token's logits; ``("step",)``, ONE fixed-shape step over
  ``max_seqs`` slots, advances every live sequence a token through K4
  (``ops/decode_attention.py``); ``("full", B, T)`` is the flat forward for
  probes. Each runs through :class:`capture.CapturedExec`, so on the card
  each is one CUDA graph: tokens, positions, active flags and the page
  table are its static inputs, copied in at every call, and the KV pages
  and parameters are its state, used in place. Admitting or evicting a
  sequence never captures again; :meth:`reset_cache` allocates new pages,
  so each graph is captured once more ("rebound state" in
  ``capture.retrace_log()``). The int8 pool (``kv_dtype="int8"``) stores
  symmetric int8 K and V with fp32 scales per (page, slot, head).

Settings default from ``MXNET_TPU_TORCH_DECODE_PAGE_SIZE`` (8),
``_PAGES`` (32, scratch page included), ``_MAX_SEQS`` (4),
``_PREFILL_BUCKETS`` ("8,16,32") and ``_KV_DTYPE`` ("float32" or "int8"),
the port's names for ``mxnet_tpu``'s knobs and their defaults.

``PagePool.alloc`` carries the ``kv_pool_exhaustion`` fault hook; prefill,
step and the probe forward run in ``decode.prefill`` / ``decode.step`` /
``decode.predict`` spans. The fleet's probe surface (``buckets``,
``_input_tails``, ``_coerce_feeds``, ``_probe_feeds``) lets a BatchServer
and the fleet's health probes drive the flat forward.

Not ported: the AOT cache and its fingerprints (ROADMAP Queue 1 item 4)
and loading parameters from a file in ``swap_params``.
"""
from __future__ import annotations

import os
import threading

import numpy as _np
import torch

from .. import capture
from ..base import MXNetError
from ..context import as_device
from ..observability import trace as _obs_trace
from ..resilience import faults as _faults
from . import _STATS

__all__ = ["PagePool", "DecodePredictor", "DEFAULT_PREFILL_BUCKETS"]

DEFAULT_PREFILL_BUCKETS = (8, 16, 32)


def _env_int(name, default):
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else int(default)


def _env_ints(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return tuple(default)
    return tuple(int(x) for x in raw.split(",") if x.strip())


class PagePool:
    """Fixed-capacity KV page allocator. Pages are integers into the
    predictor's page arrays; page 0 is the scratch page, so ``num_pages -
    1`` are allocatable. Thread-safe; the in-use high-water mark goes to
    ``decode_pages_inuse_peak``."""

    def __init__(self, num_pages):
        if int(num_pages) < 2:
            raise MXNetError("PagePool needs >= 2 pages (page 0 is the "
                             f"reserved scratch page), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free = list(range(1, self.num_pages))
        self._allocated = set()
        self._lock = threading.Lock()

    def alloc(self, n):
        """Take ``n`` pages, or None when the pool cannot supply them (the
        admission backpressure signal, counted per refusal)."""
        n = int(n)
        if n <= 0:
            raise MXNetError(f"PagePool.alloc: need a positive count, "
                             f"got {n}")
        with self._lock:
            avail = _faults.maybe_kv_pool_exhaustion(len(self._free))
            if n > avail or n > len(self._free):
                _STATS["decode_backpressure"] += 1
                return None
            pages = self._free[:n]
            del self._free[:n]
            self._allocated.update(pages)
            _STATS["decode_pages_inuse_peak"] = max(
                _STATS["decode_pages_inuse_peak"], len(self._allocated))
            return pages

    def free(self, pages):
        """Return pages to the pool. A double free raises: two sequences
        must never share KV pages."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p not in self._allocated:
                    raise MXNetError(
                        f"PagePool.free: page {p} is not allocated "
                        "(double free, or a page the pool never issued)")
                self._allocated.discard(p)
                self._free.append(p)

    @property
    def free_count(self):
        with self._lock:
            return len(self._free)

    @property
    def in_use(self):
        with self._lock:
            return len(self._allocated)


class DecodePredictor:
    """Stateful decode engine over an initialized ``TransformerLM``.

    Parameters
    ----------
    net : TransformerLM, initialized, every parameter on ``ctx``'s device
        (its tensors are used in place, in their dtype).
    ctx : Context (default: the current context, ``gpu(0)``).
    page_size, num_pages, max_seqs, prefill_buckets, kv_dtype : the paged
        cache's geometry (defaults from the environment, above).
    warmup : run every prefill bucket, the step and the smallest probe once
        at construction, so that on the card every graph is captured before
        the first sequence arrives.
    """

    def __init__(self, net, ctx=None, page_size=None, num_pages=None,
                 max_seqs=None, prefill_buckets=None, kv_dtype=None,
                 warmup=True):
        from ..gluon.model_zoo import transformer as _tf

        self._tf = _tf
        self._spec = _tf.decode_spec(net)
        self._device = as_device(ctx)
        self.page_size = int(page_size if page_size is not None else
                             _env_int("MXNET_TPU_TORCH_DECODE_PAGE_SIZE", 8))
        self.num_pages = int(num_pages if num_pages is not None else
                             _env_int("MXNET_TPU_TORCH_DECODE_PAGES", 32))
        self.max_seqs = int(max_seqs if max_seqs is not None else
                            _env_int("MXNET_TPU_TORCH_DECODE_MAX_SEQS", 4))
        if self.page_size < 1 or self.max_seqs < 1:
            raise MXNetError("DecodePredictor: page_size and max_seqs "
                             "must be positive")
        if self.num_pages < 2:
            raise MXNetError("DecodePredictor: num_pages must be >= 2 "
                             "(page 0 is the scratch page)")
        # a table row addresses a whole max_len context
        self.max_pages = -(-self._spec["max_len"] // self.page_size)
        kv_dtype = (kv_dtype or os.environ.get(
            "MXNET_TPU_TORCH_DECODE_KV_DTYPE", "").strip() or "float32")
        if kv_dtype not in ("float32", "int8"):
            raise MXNetError("DecodePredictor: kv_dtype must be "
                             f"'float32' or 'int8', got {kv_dtype!r}")
        self._kv_dtype = kv_dtype
        buckets = prefill_buckets if prefill_buckets is not None else \
            _env_ints("MXNET_TPU_TORCH_DECODE_PREFILL_BUCKETS",
                      DEFAULT_PREFILL_BUCKETS)
        buckets = tuple(sorted({min(int(b), self._spec["max_len"])
                                for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise MXNetError("DecodePredictor: prefill_buckets must be "
                             f"positive ints, got {buckets}")
        self.prefill_buckets = buckets
        objs = net.collect_params().param_objects
        self._names = _tf.decode_param_names(self._spec, list(objs))
        self._params = [objs[n] for n in self._names]
        for name, p in zip(self._names, self._params):
            t = p.data()
            if t is None or t.device != self._device:
                raise MXNetError(
                    f"DecodePredictor: parameter '{name}' is not "
                    f"initialized on the predictor's device {self._device}")
        self._idx = {n: i for i, n in enumerate(self._names)}
        self._execs = {}          # ("prefill", b) / ("step",) / ("full", B, T)
        self._lock = threading.RLock()   # executions, swaps, the cache
        self.pool = PagePool(self.num_pages)
        self.reset_cache()
        if warmup:
            self.warmup()

    # ------------------------------------------------------------ state
    @property
    def device(self):
        return self._device

    def _cells(self):
        return tuple(p.data() for p in self._params)

    def _state(self):
        """What every graph reads or writes in place: the parameters and
        the four cache tensors."""
        return self._cells() + self._kv

    def reset_cache(self):
        """(Re)allocate the paged KV arrays: K and V pages (L, num_pages,
        page_size, H, D) in the KV dtype, and fp32 scales (L, num_pages,
        page_size, H) for an int8 pool ((L, 1, 1, 1) ones for fp32, unused).
        Drain live sequences first: their pool accounting stays, their
        contents do not. Every graph is captured again at its next call."""
        spec = self._spec
        heads = spec["num_heads"]
        shape = (spec["num_layers"], self.num_pages, self.page_size, heads,
                 spec["units"] // heads)
        int8 = self._kv_dtype == "int8"
        page_dtype = torch.int8 if int8 else torch.float32
        scale_shape = shape[:-1] if int8 else (spec["num_layers"], 1, 1, 1)
        with self._lock:
            self._kv = (
                torch.zeros(shape, dtype=page_dtype, device=self._device),
                torch.zeros(shape, dtype=page_dtype, device=self._device),
                torch.ones(scale_shape, dtype=torch.float32,
                           device=self._device),
                torch.ones(scale_shape, dtype=torch.float32,
                           device=self._device))

    @property
    def kv_hbm_bytes(self):
        """Bytes the KV page and scale arrays occupy."""
        return sum(t.numel() * t.element_size() for t in self._kv)

    @property
    def compiled_keys(self):
        return sorted(self._execs)

    # ------------------------------------------------------- executables
    def _exec_for(self, key):
        with self._lock:
            ex = self._execs.get(key)
            if ex is None:
                ex = self._execs[key] = self._build_exec(key)
            return ex

    def _build_exec(self, key):
        tf, spec = self._tf, self._spec
        if key[0] == "prefill":
            def fn(tokens, true_len, page_row):
                with torch.no_grad():
                    return tf.paged_prefill(self._cells(), spec, tokens,
                                            true_len, self._kv, page_row)
            label = f"decode_prefill{key[1]}"
        elif key[0] == "step":
            def fn(tokens, positions, active, page_table):
                with torch.no_grad():
                    return list(tf.paged_step(
                        self._cells(), spec, tokens, positions, active,
                        self._kv, page_table))
            label = "decode_step"
        elif key[0] == "full":
            def fn(tokens):
                with torch.no_grad():
                    return tf.flat_forward(self._cells(), spec, tokens)
            label = f"decode_full_b{key[1]}x{key[2]}"
        else:
            raise MXNetError(f"DecodePredictor: unknown executable {key}")
        return capture.CapturedExec(fn, label=label, device=self._device,
                                    state=self._state)

    def prefill_bucket_for(self, n):
        """The smallest prefill bucket that holds ``n`` tokens (``n`` itself
        beyond the largest)."""
        for b in self.prefill_buckets:
            if b >= n:
                return b
        return n

    # ------------------------------------------------------------ engine
    def prefill(self, tokens, page_row):
        """Run one prompt (1-D int sequence) through its bucket's prefill,
        writing its KV into the pages ``page_row`` (max_pages,) maps.
        Returns ``(first_token, logits)``: the greedy next token and the
        last position's logits (vocab,) on the device."""
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        if n < 1 or n > self._spec["max_len"]:
            raise MXNetError(f"prefill: prompt length {n} outside [1, "
                             f"{self._spec['max_len']}]")
        bucket = self.prefill_bucket_for(n)
        padded = _np.zeros((1, bucket), _np.int32)
        padded[0, :n] = toks
        row = _np.asarray(page_row, _np.int32).reshape(self.max_pages)
        ex = self._exec_for(("prefill", bucket))
        with self._lock, _obs_trace.span("decode.prefill", tokens=n,
                                         bucket=bucket):
            logits = ex(torch.from_numpy(padded),
                        torch.tensor([n], dtype=torch.int32),
                        torch.from_numpy(row))
            first = int(torch.argmax(logits))
        _STATS["decode_prefills"] += 1
        return first, logits

    def step(self, tokens, positions, active, page_table):
        """ONE fixed-shape decode step over every slot. ``tokens``,
        ``positions``, ``active``: (max_seqs,) ints -- the last token, its
        position and a 0/1 liveness flag per row; ``page_table``
        (max_seqs, max_pages) ints. Returns ``(next_tokens (max_seqs,)
        numpy int32, logits (max_seqs, vocab) on the device)``; inactive
        rows return values the caller must ignore."""
        arrs = [_np.ascontiguousarray(_np.asarray(a, _np.int32).reshape(s))
                for a, s in ((tokens, (self.max_seqs,)),
                             (positions, (self.max_seqs,)),
                             (active, (self.max_seqs,)),
                             (page_table, (self.max_seqs, self.max_pages)))]
        ex = self._exec_for(("step",))
        with self._lock, _obs_trace.span("decode.step",
                                         live=int(arrs[2].sum())):
            nxt, logits = ex(*[torch.from_numpy(a) for a in arrs])
            nxt = nxt.cpu().numpy()
        _STATS["decode_steps"] += 1
        return nxt, logits

    def greedy_decode(self, prompt, max_new_tokens, eos_id=None):
        """Greedy generation of one sequence through the paged path on slot
        0: prefill, then steps until ``max_new_tokens``, ``eos_id`` (emitted)
        or the context window. Its pages come from the shared pool and are
        freed on every exit path. Returns the generated token list."""
        toks = [int(t) for t in prompt]
        if not toks:
            raise MXNetError("greedy_decode: empty prompt")
        total = min(len(toks) + int(max_new_tokens), self._spec["max_len"])
        pages = self.pool.alloc(-(-total // self.page_size))
        if pages is None:
            raise MXNetError(
                "greedy_decode: KV page pool exhausted "
                f"({self.pool.free_count} free) -- backpressure")
        out = []
        try:
            row = _np.zeros((self.max_pages,), _np.int32)
            row[:len(pages)] = pages
            first, _ = self.prefill(toks, row)
            _STATS["decode_sequences"] += 1
            _STATS["decode_tokens"] += 1
            out.append(first)
            pos = len(toks)
            table = _np.zeros((self.max_seqs, self.max_pages), _np.int32)
            table[0] = row
            step_toks = _np.zeros((self.max_seqs,), _np.int32)
            positions = _np.zeros((self.max_seqs,), _np.int32)
            active = _np.zeros((self.max_seqs,), _np.int32)
            active[0] = 1
            while (len(out) < int(max_new_tokens) and pos < total
                   and (eos_id is None or out[-1] != eos_id)):
                step_toks[0] = out[-1]
                positions[0] = pos
                nxt, _ = self.step(step_toks, positions, active, table)
                out.append(int(nxt[0]))
                _STATS["decode_tokens"] += 1
                pos += 1
        finally:
            self.pool.free(pages)
        return out

    # ------------------------------------------------------ probe surface
    def predict_raw(self, data):
        """Stateless full-context forward: ``data`` (B, T) int token ids
        (or a dict with one entry) -> ``([logits (B, T, vocab)], B)``, the
        Predictor's ``predict_raw`` contract."""
        if isinstance(data, dict):
            if len(data) != 1:
                raise MXNetError("DecodePredictor takes one token input, "
                                 f"got {sorted(data)}")
            data = next(iter(data.values()))
        a = data if isinstance(data, torch.Tensor) else \
            torch.from_numpy(_np.ascontiguousarray(_np.asarray(data)))
        if a.dim() == 1:
            a = a[None]
        if a.dim() != 2:
            raise MXNetError("DecodePredictor.predict_raw wants (B, T) "
                             f"token ids, got shape {tuple(a.shape)}")
        a = a.to(torch.int32)
        ex = self._exec_for(("full", int(a.shape[0]), int(a.shape[1])))
        with self._lock, _obs_trace.span("decode.predict",
                                         rows=int(a.shape[0])):
            logits = ex(a)
        return [logits], int(a.shape[0])

    # The fleet's probe surface: a thread Fleet serves the flat forward
    # through a BatchServer, one row at a time, and its health probes
    # send one row of ``prefill_buckets[0]`` token ids, a shape warmup()
    # already captured.
    @property
    def buckets(self):
        return (1,)

    @property
    def _input_tails(self):
        return {"data": (self.prefill_buckets[0],)}

    def _probe_feeds(self):
        return {"data": torch.zeros((1, self.prefill_buckets[0]),
                                    dtype=torch.int32)}

    def _coerce_feeds(self, data):
        if not isinstance(data, dict):
            data = {"data": data}
        if set(data) != {"data"}:
            raise MXNetError("DecodePredictor takes one 'data' input, "
                             f"got {sorted(data)}")
        a = data["data"]
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(_np.ascontiguousarray(_np.asarray(a)))
        if a.dim() != 2:
            raise MXNetError("DecodePredictor wants (B, T) token ids, "
                             f"got shape {tuple(a.shape)}")
        return {"data": a.to(torch.int32)}, int(a.shape[0])

    @staticmethod
    def _sig_of(feeds):
        return tuple(sorted((n, tuple(a.shape[1:]), str(a.dtype))
                            for n, a in feeds.items()))

    # ------------------------------------------------------------ rollout
    def swap_params(self, params):
        """Flip parameter VALUES: ``{name or "arg:name": array}``, every
        entry validated (a known name, the bound shape and dtype) before
        any is written, then copied under the lock into the existing
        parameter storage, so no graph is captured again and in-flight
        sequences continue on the new weights from their next token.
        Returns the prior values as ``{"arg:name": tensor}`` clones, the
        rollback snapshot."""
        if isinstance(params, str):
            raise MXNetError("swap_params: loading parameters from a file "
                             "is not ported; pass {name: array}")
        cells = self._cells()
        updates = {}
        for key, v in params.items():
            kind, _, name = key.partition(":")
            if kind not in ("arg", "aux"):
                name = key
            if name not in self._idx:
                raise MXNetError(f"swap_params: '{name}' is not a "
                                 "parameter of this decode predictor")
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))
            cell = cells[self._idx[name]]
            if tuple(t.shape) != tuple(cell.shape) or t.dtype != cell.dtype:
                raise MXNetError(
                    f"swap_params: '{name}' is {tuple(t.shape)}/{t.dtype} "
                    f"but the bound cell is {tuple(cell.shape)}/"
                    f"{cell.dtype}; a changed architecture needs a new "
                    "DecodePredictor")
            updates[name] = t
        prev = {}
        with self._lock, torch.no_grad():
            for name, t in updates.items():
                cell = cells[self._idx[name]]
                prev[f"arg:{name}"] = cell.detach().clone()
                cell.copy_(t)
        return prev

    def warmup(self):
        """Run every prefill bucket, THE step and the smallest probe shape
        once against the scratch page only, so that every later call
        replays (on the card: every graph captured here)."""
        row = _np.zeros((self.max_pages,), _np.int32)
        for b in self.prefill_buckets:
            self.prefill(_np.zeros((b,), _np.int32), row)
        z = _np.zeros((self.max_seqs,), _np.int32)
        self.step(z, z, z, _np.zeros((self.max_seqs, self.max_pages),
                                     _np.int32))
        self.predict_raw(_np.zeros((1, self.prefill_buckets[0]), _np.int32))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self
