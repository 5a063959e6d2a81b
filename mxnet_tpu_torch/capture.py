"""Whole-step capture on CUDA graphs (port of ``mxnet_tpu/capture.py``).

``mxnet_tpu`` compiles a whole training step (forward, backward, the
optimizer's update sweep) or a serving bucket's forward into one donated
XLA executable. The port records the same work as one CUDA graph
(``torch.cuda.CUDAGraph``) and replays it: after warm-up a step or a
predict is one graph launch, however many kernels it holds.

- :class:`CapturedExec` keeps one graph per signature (input shapes and
  dtypes, plus the caller's key), with static input and output buffers and
  one memory pool for all of an owner's graphs. A call copies its inputs
  into the static buffers, replays, and clones the outputs out before the
  next call may replay: calls are serialised under a lock. Before its
  capture a graph's function runs twice on a side stream, so
  that what happens only on first use (building the kernels, raising a
  kernel's shared-memory limit, creating optimizer states, cuDNN's plans,
  first allocations) never happens inside a capture; a ``warmup_guard``
  puts back the state those runs changed. ``ShardedTrainer.step`` and
  every ``serving.Predictor`` bucket run through it.
- :class:`CapturedTrainerStep` (from :func:`capture` on a gluon
  ``Trainer``) captures forward + backward + update sweep. The sweep's
  scalars (``lr`` with its schedule, Adam's bias correction, ``wd``,
  ``rescale_grad``) are device slots (:class:`SlotTable`): before every
  replay the host computes them exactly as the eager ``Trainer.step``
  does, in Python doubles (``Trainer._scalars``), and writes them into
  the slots; the graph's sweep reads the slots (``Trainer._update``).
  ``ShardedTrainer`` does the same with ``update.scalars(t)``. A schedule, a bias correction or ``set_learning_rate`` never
  re-captures and never goes stale. After a replay every parameter's
  ``.grad`` is the graph's own static buffer, so ``param.grad()`` reads
  what the step computed.
- The key of every entry holds the ``data_ptr`` of each state tensor the
  graph reads or writes in place (parameters, masters, optimizer states,
  aux, accumulated gradients): a graph bakes addresses in, TMA tensor maps
  included, so a tensor that moved is captured again, with the reason
  "rebound state" in :func:`retrace_log`, and never replayed stale.

On a CPU context the same programs run directly with no graph: static
buffers, slots, keys and counters are still exercised. On CUDA a failed
capture raises :class:`CaptureError`; ``mxnet_tpu`` falls back to eager
there, the port does not (ROADMAP Queue 3). The only eager path is the
kill switch ``MXNET_TPU_TORCH_CAPTURE=0``, counted in
``capture_fallback_eager``.

A kernel wrapper's ``launches`` counter (``ops/kernels.py``) ticks when a
launch is enqueued: during warm-up and once in the capture, never at a
replay. The kernels inside a graph are its nodes: every graph keeps its
node list, which :meth:`CapturedExec.debug_dump` writes out.

Each captured graph lands one entry in the perf ledger
(``observability.perf``): its FLOPs (torch's FLOP table over the first
warm-up run, plus what the port's kernels report), its peak device memory
and capture time, and with device timing on its replays' event times.
The step fingerprint (``resilience.integrity``) and the numerics tap
(``observability.numerics``) are outputs of the captured trainer steps:
a signature's key carries whether each is on, so a step with the tap and
one without are two graphs, picked on the host each step, and the tap's
column selection is a slot.

The health gates are in the captured gluon step: a ``HealthSentinel``, an
AMP ``loss_scaler=`` and a halt / skip numerics tap make the graph compute
the finite flag (and the sentinel's norm bound) and hold back the weight
write on it, the loss scale and the sentinel's cadence being slots; the
host reads the flag once a step and applies the policies
(:class:`CapturedTrainerStep`). The Module executor's forward and fused
forward + backward run through :class:`CapturedExec` too
(``executor.py``).

Not ported: the AOT compile cache. A CUDA graph cannot be written to disk,
so ``MXNET_TPU_TORCH_COMPILE_CACHE`` raises ``NotImplementedError``
(ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import threading
import time

import torch

from . import random as _random
from .observability import perf as _perf

__all__ = ["capture", "CapturedTrainerStep", "CapturedShardedStep",
           "CapturedExec", "GraphPool", "CaptureError", "SlotTable", "enabled",
           "cache_dir", "note_recapture", "retrace_log",
           "clear_retrace_log", "stats", "reset_stats", "fingerprint",
           "code_sig", "net_sig"]

_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()   # one capture at a time, GC held off
_DEFERRED = []     # writes that must wait for the running capture's end
_IN_CAPTURE = threading.local()
_WARMUP = 2                        # eager runs before each capture

# Flat counters, named as mxnet_tpu's (the aot_* ones stay 0: no AOT cache)
_STATS = {
    "capture_steps": 0,           # captured trainer-step invocations
    "capture_hits": 0,            # replays of an existing graph
    "capture_misses": 0,          # captures (first per signature, rebinds)
    "capture_retraces": 0,        # captures after an owner's first
    "capture_fallback_eager": 0,  # kill-switch eager runs
    "aot_cache_hits": 0,
    "aot_cache_misses": 0,
    "aot_cache_stale": 0,
    "aot_cache_corrupt": 0,
    "aot_cache_writes": 0,
    "aot_cache_evictions": 0,
}


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


class CaptureError(RuntimeError):
    """A step program could not be captured (or its scalar replay no longer
    matches the captured program). Raised, never answered by an eager
    fall-back."""


def defer_until_captured(fn):
    """Run ``fn()`` once the running capture of a :class:`CapturedExec`
    has ended, before the graph's first replay: a host-to-device write of
    what a kernel in the graph reads (a device table of the capture's own
    addresses), which a capture cannot hold. Raises outside one."""
    if not getattr(_IN_CAPTURE, "on", False):
        raise CaptureError(
            "a deferred device write inside a CUDA graph capture that "
            "CapturedExec does not run: nothing would perform it")
    _DEFERRED.append(fn)


def enabled():
    """The kill switch: ``MXNET_TPU_TORCH_CAPTURE=0`` runs every captured
    path eagerly (the same program, one launch at a time), counted."""
    return os.environ.get("MXNET_TPU_TORCH_CAPTURE", "1").strip().lower() \
        not in ("0", "false", "off")


def cache_dir():
    """``MXNET_TPU_TORCH_COMPILE_CACHE``, or None."""
    return os.environ.get("MXNET_TPU_TORCH_COMPILE_CACHE", "").strip() or None


def _check_cache():
    if cache_dir() is not None:
        raise NotImplementedError(
            "MXNET_TPU_TORCH_COMPILE_CACHE: the AOT compile cache is not "
            "ported (a CUDA graph cannot be written to disk); ROADMAP Queue "
            "1 item 4 queues torch.export artifacts keyed by the same "
            "fingerprint")


# -------------------------------------------------------- retrace forensics
_RETRACE_LOG: list = []
_RETRACE_LOG_CAP = 64


def retrace_log():
    """Structured reasons for every capture after an owner's first:
    ``{"label", "reason", "prev", "new", "t"}`` dicts, oldest first."""
    with _LOCK:
        return [dict(e) for e in _RETRACE_LOG]


def clear_retrace_log():
    with _LOCK:
        del _RETRACE_LOG[:]


def _sig_reason(prev, new):
    if prev is None:
        return "first capture"
    try:
        if len(prev) != len(new):
            return f"operand count changed {len(prev)} -> {len(new)}"
        for i, (p, n) in enumerate(zip(prev, new)):
            if p != n:
                return f"operand {i} changed {p} -> {n}"
    except TypeError:
        pass
    return f"signature changed {prev!r} -> {new!r}"


def _note_retrace(label, prev_sig, new_sig, reason=None):
    reason = reason or _sig_reason(prev_sig, new_sig)
    _STATS["capture_retraces"] += 1
    entry = {"label": label, "reason": reason, "prev": repr(prev_sig),
             "new": repr(new_sig), "t": time.time()}
    with _LOCK:
        _RETRACE_LOG.append(entry)
        if len(_RETRACE_LOG) > _RETRACE_LOG_CAP:
            del _RETRACE_LOG[:-_RETRACE_LOG_CAP]
    return entry


def note_recapture(label, prev, new, reason=None):
    """Record a program that its owner must rebuild, with the reason."""
    return _note_retrace(label, prev, new, reason=reason)


# ------------------------------------------------------------ fingerprints
def fingerprint(parts):
    """A stable 32-hex digest of a structural-identity dict."""
    return hashlib.sha256(json.dumps(
        parts, sort_keys=True, default=repr).encode()).hexdigest()[:32]


def code_sig(fn):
    """Digest of a callable's bytecode and constants, nested code included
    (a callable object: its class's ``forward`` or ``__call__``)."""
    import types

    code = getattr(fn, "__code__", None)
    if code is None:
        for name in ("hybrid_forward", "forward", "__call__"):
            code = getattr(getattr(type(fn), name, None), "__code__", None)
            if code is not None:
                break
    if code is None:
        return repr(fn)
    out, stack = [], [code]
    while stack:
        c = stack.pop()
        out.append(c.co_code.hex())
        for const in c.co_consts:
            if isinstance(const, types.CodeType):
                stack.append(const)
            else:
                out.append(repr(const))
    return hashlib.sha256("|".join(out).encode()).hexdigest()[:16]


def net_sig(net):
    """Digest of a block tree: its repr and every block class's forward."""
    parts, seen = [repr(net)], set()
    for b in net.modules():
        cls = type(b)
        key = f"{cls.__module__}.{cls.__qualname__}"
        if key not in seen:
            seen.add(key)
            parts.append(f"{key}:{code_sig(b.forward)}")
    return hashlib.sha256("|".join(sorted(parts)).encode()).hexdigest()[:16]


# ------------------------------------------------------------------ slots
class SlotTable:
    """A step's scalar operands as float32 slots on ``device``.

    :meth:`write` copies a list of Python floats into the slots on the
    current stream; ``views`` are the slots as 0-d tensors, in the same
    order, for the step program to read. A double becomes float32 by
    round-to-nearest, as a Python float does inside a kernel. On CUDA the
    values pass through two pinned buffers in turn, each reused only after
    its last copy has run.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.views = []
        self._dev = None
        self._host = None
        self._events = [None, None]
        self._turn = 0

    def write(self, values):
        values = [float(v) for v in values]
        n = len(values)
        if self._dev is None:
            self._dev = torch.zeros(n, dtype=torch.float32,
                                    device=self.device)
            self.views = [self._dev[i] for i in range(n)]
            if self.device.type == "cuda":
                self._host = [torch.empty(n, dtype=torch.float32,
                                          pin_memory=True) for _ in range(2)]
        elif n != self._dev.numel():
            raise CaptureError(
                f"scalar replay diverged from the captured program: {n} "
                f"scalars, {self._dev.numel()} slots")
        src = torch.tensor(values, dtype=torch.float64)
        if self._host is None:
            self._dev.copy_(src)
            return
        k = self._turn
        self._turn ^= 1
        if self._events[k] is not None:
            self._events[k].synchronize()
        self._host[k].copy_(src)
        self._dev.copy_(self._host[k], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[k] = ev


# ------------------------------------------------------------ CapturedExec
class GraphPool:
    """One private memory pool for the CUDA graphs of several
    CapturedExecs that never replay at once (a BucketingModule's buckets,
    each its own executor): their temporaries share memory, so the pool
    holds about the largest graph's, not their sum. Made on the first
    capture."""

    def __init__(self):
        self.handle = None
        self.users = 0


class _Entry:
    __slots__ = ("sig", "state", "inputs", "outputs", "as_list", "graph",
                 "capture_s", "extra", "ledger_fp")

    def __init__(self, sig, state, inputs):
        self.sig, self.state, self.inputs = sig, state, inputs
        self.outputs = self.graph = self.extra = self.ledger_fp = None
        self.as_list = False
        self.capture_s = 0.0

    def keep(self, out):
        self.as_list = isinstance(out, (list, tuple))
        self.outputs = list(out) if self.as_list else [out]


def _pad(a, batch):
    n = a.shape[0]
    if n == batch:
        return a
    return torch.cat([a, a.new_zeros((batch - n,) + tuple(a.shape[1:]))])


def _feed(inputs, args):
    """Copy each arg into its static input; rows beyond the arg's are
    zeroed."""
    for s, a in zip(inputs, args):
        n = a.shape[0] if a.dim() else None
        if n is not None and n < s.shape[0]:
            s[:n].copy_(a)
            s[n:].zero_()
        else:
            s.copy_(a)


def _cut(outs, batch, rows, clone):
    """Outputs with their first ``rows`` rows kept (those whose leading
    dimension is ``batch``), cloned when ``clone``."""
    out = []
    for o in outs:
        if rows is not None and o.dim() and o.shape[0] == batch:
            o = o[:rows]
        out.append(o.clone() if clone else o)
    return out


class CapturedExec:
    """One CUDA graph of ``fn`` per signature.

    ``fn(*inputs, *key)`` runs on tensors (its static inputs) and returns a
    tensor or a list of them. ``state()`` gives the tensors the program
    reads or writes in place; their addresses are part of each entry's key.
    ``eager(*inputs, *key)`` (default ``fn``) is the kill switch's path.
    ``warmup_guard()`` is a context manager wrapped around the warm-up
    runs that restores what they changed. ``on_capture(entry)`` runs after
    each capture.

    ``fingerprint(sig)`` gives the program identity its perf-ledger
    entries are keyed by (default: the label and the signature). ``pool``
    (a :class:`GraphPool`) is shared with other CapturedExecs; by default
    the instance's graphs have a pool of their own.

    A program that draws from the port's ``mx.random`` generator (Dropout,
    the samplers) draws on replay as its eager run would: the warm-up
    runs' draws are undone, and each graph registers the generator, so a
    replay advances it by the graph's draws.

    ``exec(*args, key=(), batch=None, rows=None)``: ``batch`` pads every
    arg's leading dimension with zero rows to ``batch`` (into the static
    buffer; on the eager path by concatenation); ``rows`` keeps only the
    first ``rows`` rows of each output whose leading dimension is
    ``batch``. Returns clones of the outputs (a tensor, or a list).
    """

    def __init__(self, fn, *, label, device, state=None, eager=None,
                 warmup_guard=None, on_capture=None, fingerprint=None,
                 pool=None):
        _check_cache()
        self._fingerprint = fingerprint
        self._fn = fn
        self.label = label
        self.device = torch.device(device)
        self._state = state or (lambda: ())
        self._eager = eager or fn
        self._guard = warmup_guard
        self._on_capture = on_capture
        self._entries = {}
        self._last_sig = None
        self._pool = pool if pool is not None else GraphPool()
        self._pool.users += 1
        self._lock = threading.Lock()
        self.last_entry = None

    @property
    def compiled_signatures(self):
        return sorted(self._entries, key=repr)

    def __call__(self, *args, key=(), batch=None, rows=None):
        if not enabled():
            _STATS["capture_fallback_eager"] += 1
            if batch is not None:
                args = [_pad(a.to(self.device), batch) for a in args]
            out = self._eager(*args, *key)
            many = isinstance(out, (list, tuple))
            outs = _cut(list(out) if many else [out], batch, rows, False)
            return outs if many else outs[0]
        sig = tuple((((batch,) + tuple(a.shape[1:])) if batch is not None
                     else tuple(a.shape), str(a.dtype)) for a in args) \
            + tuple(key)
        with self._lock:
            ptrs = tuple(t.data_ptr() for t in self._state())
            entry = self._entries.get(sig)
            if entry is not None and entry.state != ptrs:
                _note_retrace(self.label, sig, sig, reason=(
                    "rebound state: a parameter, master, optimizer state or "
                    "aux tensor of the captured program moved"))
                del self._entries[sig]
                entry = None
            elif entry is None and self._entries:
                _note_retrace(self.label, self._last_sig, sig)
            if entry is None:
                _STATS["capture_misses"] += 1
                entry = _Entry(sig, ptrs, [
                    torch.empty(shape, dtype=a.dtype, device=self.device)
                    for (shape, _), a in zip(sig, args)])
                _feed(entry.inputs, args)
                if self.device.type == "cuda":
                    self._capture(entry, key)
                self._entries[sig], self._last_sig = entry, sig
            else:
                _STATS["capture_hits"] += 1
                _feed(entry.inputs, args)
            if entry.graph is None:     # a CPU context: the program itself
                if entry.outputs is None:
                    self._first_run(entry, key)
                else:
                    entry.keep(self._fn(*entry.inputs, *key))
            else:
                _perf.timed_call(entry.graph.replay, (), self.label,
                                 entry.ledger_fp, self.device)
            self.last_entry = entry
            outs = _cut(entry.outputs, batch, rows, True)
        return outs if entry.as_list else outs[0]

    def _ledger_fp(self, sig):
        if self._fingerprint is not None:
            return self._fingerprint(sig)
        return fingerprint({"label": self.label, "sig": repr(sig)})

    def _note_ledger(self, entry, flops, peak, base, seconds):
        entry.ledger_fp = self._ledger_fp(entry.sig)
        nbytes = sum(t.numel() * t.element_size() for t in entry.inputs)
        out_bytes = sum(t.numel() * t.element_size() for t in entry.outputs
                        if isinstance(t, torch.Tensor))
        _perf.note_compile(self.label, entry.ledger_fp,
                           flops=flops, argument_bytes=nbytes,
                           output_bytes=out_bytes, peak_bytes=peak,
                           temp_bytes=max(0, peak - base), compile_s=seconds,
                           backend=self.device.type)

    def _first_run(self, entry, key):
        """A CPU context's first run of a signature: the program itself,
        its FLOPs counted into the perf ledger."""
        t0 = time.perf_counter()
        with _perf.count_flops() as box:
            out = self._fn(*entry.inputs, *key)
        entry.keep(out)
        self._note_ledger(entry, box["flops"], 0, 0,
                          time.perf_counter() - t0)

    def drop_failed(self):
        """After a failed capture (an out-of-memory step): free what the
        failed warm-up and capture held, and the private memory pool when
        no graph uses it, so a retry starts from a clean allocator."""
        with self._lock:
            if not self._entries and self._pool.users == 1:
                self._pool.handle = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _capture(self, entry, key):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        base = torch.cuda.memory_allocated(self.device)
        graph = None
        rng = _random.made_generator(self.device)
        rng_state = rng.get_state() if rng is not None else None
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                guard = self._guard() if self._guard is not None \
                    else contextlib.nullcontext()
                with guard:
                    for i in range(_WARMUP):
                        if i == 0:
                            with _perf.count_flops() as box:
                                self._fn(*entry.inputs, *key)
                        else:
                            self._fn(*entry.inputs, *key)
            cur.wait_stream(side)
            # the warm-up runs' draws are undone (a generator they made
            # goes back to its seed)
            rng = _random.made_generator(self.device)
            if rng is not None:
                if rng_state is not None:
                    rng.set_state(rng_state)
                else:
                    rng.manual_seed(rng.initial_seed())
            if self._pool.handle is None:
                self._pool.handle = torch.cuda.graph_pool_handle()
            # keep_graph keeps the node list for debug_dump after the graph
            # is instantiated
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            register = getattr(graph, "register_generator_state", None)
            if rng is not None and register is not None:
                register(rng)       # a replay advances it by its draws
            # a graph freed by the garbage collector inside a capture
            # (an owner that died in a reference cycle) would end it:
            # collect first, and not during the capture
            with _CAPTURE_LOCK:
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                del _DEFERRED[:]
                _IN_CAPTURE.on = True
                try:
                    with torch.cuda.graph(graph, pool=self._pool.handle,
                                          capture_error_mode="thread_local"):
                        out = self._fn(*entry.inputs, *key)
                    for fn in _DEFERRED:
                        fn()
                finally:
                    _IN_CAPTURE.on = False
                    del _DEFERRED[:]
                    if collecting:
                        gc.enable()
            graph.instantiate()
        except CaptureError:
            raise
        except Exception as e:  # the capture failed: say so, no fall-back
            del graph
            raise CaptureError(f"{self.label}: capturing {entry.sig} failed: "
                               f"{type(e).__name__}: {e}") from e
        entry.keep(out)
        entry.graph = graph
        entry.capture_s = time.perf_counter() - t0
        self._note_ledger(entry, box["flops"],
                          torch.cuda.max_memory_allocated(self.device), base,
                          entry.capture_s)
        if self._on_capture is not None:
            self._on_capture(entry)

    def debug_dump(self, sig, path):
        """Write ``sig``'s graph as Graphviz DOT."""
        self._entries[sig].graph.debug_dump(path)


def _leaves(state):
    """The tensors of an optimizer state (a tensor, a tuple, None)."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _leaves(s)]
    return []


@contextlib.contextmanager
def _restored(tensors):
    """Put ``tensors``' values back, in place, when the block ends."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


# ------------------------------------------------- gluon Trainer capture
# the step's own slots after the optimizer's: the loss scale, the
# sentinel's cadence gate (1.0 on a check step) and the nan_grad drill's
# factor (NaN on the step it fires, else 1.0)
_GATE_SLOTS = 3


def _health_flags(grads, threshold):
    """The fused health check over ``grads``, as 0-d bool device tensors:
    ``(finite, norm_ok or None)``. ``finite`` is ``multi_all_finite``;
    with a ``threshold``, ``norm_ok`` is ``sqrt(sum(multi_sum_sq)) <=
    threshold``, the norm itself against the threshold (not its square),
    as ``mxnet_tpu``'s captured step compares it."""
    from .ops import optimizer_ops

    finite = optimizer_ops.multi_all_finite(*grads) != 0
    if threshold is None:
        return finite, None
    sq = optimizer_ops.multi_sum_sq(*grads, num_arrays=len(grads))
    return finite, torch.sqrt(torch.stack(sq).sum()) <= threshold


def _passed(finite, norm_ok, gate, scale, sentinel, tap_gates):
    """Whether the update lands, from the flags: device tensors in the
    program, Python bools and floats on the kill switch's path. ``gate``
    is the cadence (nonzero on a sentinel check step, None without a
    sentinel): off cadence an unhealthy batch lands, as the eager
    ``before_update`` never looks at it, except where a loss scaler or a
    halt / skip tap gates on ``finite`` every step. None when nothing
    gates."""
    ok = finite if norm_ok is None else finite & norm_ok
    passed = None
    if sentinel or scale:
        if gate is not None:
            passed = ok | (gate == 0)
            if scale:
                passed = passed & finite   # an AMP overflow always skips
        else:
            passed = ok
    if tap_gates:
        passed = finite if passed is None else passed & finite
    return passed


class CapturedTrainerStep:
    """One gluon training step (forward, backward, the health check, the
    update sweep) as one CUDA graph per signature, with its scalars in
    device slots.

    Bitwise equal to the eager step (``autograd.record()`` around
    ``loss_fn(net(x), y)``, ``backward``, ``Trainer.step``): the update ops
    take their scalars as floats or slots with the same arithmetic
    (``ops/optimizer_ops.py``).

    With a sentinel, a loss scaler or a halt / skip numerics tap the
    program also computes the finite flag (``multi_all_finite``) and, with
    the sentinel's ``grad_norm_threshold``, the norm bound, and holds back
    the update on them: every tensor the sweep writes (parameters,
    optimizer states) takes ``where(passed, new, pre)``, ``pre`` a copy
    made in the graph before the sweep, so a gated step leaves them
    bitwise as they were. The host reads the flag once a step, un-advances
    the optimizer's update counts on a gated step and applies the policies
    as the eager step does (:meth:`_apply_flag`). The tap's statistics see
    the raw update; the step fingerprint is folded after the select.

    Parameters
    ----------
    net : initialized gluon Block
    loss_fn : callable(pred, label) -> tensor (head gradient ones, as
        ``loss.backward()`` eagerly)
    trainer : gluon.Trainer
    batch_size : rescale denominator for ``Trainer.step``; default the
        batch's row count
    sentinel : HealthSentinel; default the one attached to ``trainer``,
        which the step bypasses: its check runs in the graph and its
        policy on the host
    loss_scaler : amp.LossScaler; its scale is a slot: the loss is scaled
        before the backward, the gradients unscaled before the check and
        the update, an overflow skips the step, and the scaler's schedule
        advances from the graph's flag (``note_finite``). Passed
        explicitly, as in ``mxnet_tpu``: a trainer given
        ``amp.init_trainer`` and no ``loss_scaler=`` steps unscaled, with
        ``rescale_grad = trainer._scale / batch_size`` and no overflow
        check, its attached scaler unused (pass
        ``loss_scaler=trainer._amp_loss_scaler`` to scale).
    numerics : observability.numerics.NumericsTap; default armed from
        ``MXNET_TPU_TORCH_NUMERICS``
    """

    def __init__(self, net, loss_fn, trainer, batch_size=None,
                 sentinel=None, loss_scaler=None, numerics=None,
                 label="trainer_step"):
        from .observability import numerics as _numerics

        _no_dist(trainer)
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.label = label
        self._batch_size = batch_size
        self.sentinel = sentinel if sentinel is not None \
            else getattr(trainer, "_sentinel", None)
        self.loss_scaler = loss_scaler
        self.device = trainer._params[0].data().device
        self._slots = SlotTable(self.device)
        self._tap_slots = SlotTable(self.device)
        self.numerics = numerics if numerics is not None \
            else _numerics.default_tap()
        if self.numerics is not None:
            self.numerics.bind(net, trainer)
        self._step_count = 0
        self._last_fp_out = None
        self._exec = CapturedExec(
            self._program, label=label, device=self.device,
            state=self._state_tensors, warmup_guard=self._warmup_guard,
            on_capture=self._keep_grads, fingerprint=self._ledger_fp)

    def _gates(self):
        """(has_scale, has_gate, has_norm, tap_gates): what the program
        gates on, part of every graph's key."""
        s, tap = self.sentinel, self.numerics
        return (self.loss_scaler is not None, s is not None,
                s is not None and s.grad_norm_threshold is not None,
                tap is not None and tap.gates_updates)

    def _ledger_fp(self, sig):
        scale, gate, norm, tap_gates = self._gates()
        return fingerprint({"net": net_sig(self.net),
                            "loss": code_sig(self.loss_fn),
                            "optimizer": type(self.trainer.optimizer)
                            .__name__, "has_scale": scale,
                            "has_gate": gate, "has_norm": norm,
                            "tap_gates": tap_gates, "sig": repr(sig)})

    @property
    def last_fingerprint(self):
        """The uint32 fingerprint of the last step (post-update parameters
        and gradients, ``resilience.integrity``), or None when it is
        off."""
        if self._last_fp_out is None:
            return None
        from .resilience import integrity as _integrity

        return _integrity.as_uint32(self._last_fp_out)

    def _active(self):
        return [(i, self.trainer._params[i]) for i in self.trainer._active()]

    def _grads(self):
        return [p.grad() for _, p in self._active()]

    def _state_tensors(self):
        """Everything the graph reads or writes in place: the net's and the
        trainer's parameters (aux included), the optimizer states and the
        gradients that accumulate (grad_req 'add')."""
        out = [p.data() for p in self.net._param_objects().values()]
        out += [p.data() for p in self.trainer._params]
        states = self.trainer._updater.states
        for i in sorted(states):
            out += _leaves(states[i])
        out += [p.grad() for _, p in self._active() if p.grad_req == "add"]
        return out

    def _swept(self):
        """The tensors the update sweep writes: each trainable parameter,
        then its optimizer state's leaves."""
        active = self._active()
        states = self.trainer._updater.states
        out = [p.data() for _, p in active]
        for i, _ in active:
            out += _leaves(states.get(i))
        return out

    def _warmup_guard(self):
        return _restored(self._state_tensors())

    def _keep_grads(self, entry):
        """After a capture: the gradient buffers the graph writes, one per
        trainable parameter, which each replay hands back to ``.grad``."""
        entry.extra = [(p.data(), p.data().grad) for _, p in self._active()]

    def _tap_stats(self, pre):
        params = [(p.name, p.data()) for _, p in self._active()]
        grads = [(p.name, p.data().grad) for _, p in self._active()
                 if p.data().grad is not None]
        return self.numerics.graph_stats(
            grads, [(n, pre[n]) for n, _ in params], params, [],
            torch.stack(self._tap_slots.views))

    def _fold(self):
        from .resilience import integrity as _integrity

        return _integrity.step_fold(*_integrity.net_named_state(self.net))

    def _pre(self, tap):
        return {p.name: p.data().detach().clone()
                for _, p in self._active()} if tap else None

    def _threshold(self, norm):
        return self.sentinel.grad_norm_threshold if norm else None

    def _program(self, x, y, batch_size, fp=False, tap=False, scale=False,
                 gate=False, norm=False, tap_gates=False, drill=False):
        """[loss, finite?, norm_ok?, fingerprint?, stats?]: the step with
        its scalars in the slots; the flags only when something gates."""
        from . import autograd

        views = self._slots.views
        scale_t, gate_t, drill_t = views[-_GATE_SLOTS:]
        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
            loss_b = loss * scale_t if scale else loss
        autograd.backward(loss_b)
        grads = self._grads()
        if scale:
            torch._foreach_mul_(grads, 1.0 / scale_t)
        if drill:
            grads[0].mul_(drill_t)
        out, flags, swept, saved = [loss], None, [], []
        if scale or gate or tap_gates:
            flags = _health_flags(grads, self._threshold(norm))
            out += [f for f in flags if f is not None]
            swept = self._swept()
            saved = [torch.empty_like(t) for t in swept]
            with torch.no_grad():
                torch._foreach_copy_(saved, swept)
        pre = None
        if tap:      # the copies made for the gate serve the tap as well
            pre = {p.name: s for (_, p), s in zip(self._active(), saved)} \
                if swept else self._pre(True)
        self.trainer._update(views[:-_GATE_SLOTS])
        stats = self._tap_stats(pre) if tap else None
        if flags is not None:
            passed = _passed(flags[0], flags[1], gate_t if gate else None,
                             scale, gate, tap_gates)
            with torch.no_grad():
                for t, s in zip(swept, saved):
                    torch.where(passed, t, s, out=t)
        if fp:
            out.append(self._fold())
        if tap:
            out.append(stats)
        return out

    def _eager_gated(self, x, y, bs, fp, tap, checking):
        """The kill switch's step when something gates: the program's
        semantics eagerly (``mxnet_tpu/capture.py`` ``_eager_step``): the
        loss scaled and the gradients unscaled, the nan_grad /
        nonfinite_grad drills, the fused check read on the host, and the
        update only when it passes. Returns the program's outputs as
        (loss, finite_ok, norm_ok, fingerprint, stats); on a gated step
        the tap's update rows are zero (the update is never computed)."""
        from . import autograd
        from .resilience import faults as _faults

        trainer, scaler = self.trainer, self.loss_scaler
        has_scale, has_gate, norm, tap_gates = self._gates()
        scale_t = None
        if scaler is not None:
            scaler.clear_note()        # an earlier step's flag never
            scale_t = torch.tensor(    # answers this one's has_overflow
                float(scaler.loss_scale), dtype=torch.float32,
                device=self.device)
        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
            loss_b = loss * scale_t if scale_t is not None else loss
        autograd.backward(loss_b)
        grads = self._grads()
        if scale_t is not None:
            torch._foreach_mul_(grads, 1.0 / scale_t)
        _faults.maybe_nan_grads(trainer._params)
        _faults.maybe_nonfinite_grad(trainer._params)
        finite_t, norm_t = _health_flags(grads, self._threshold(norm))
        finite_ok = bool(finite_t.item())
        norm_ok = bool(norm_t.item()) if norm_t is not None else None
        if scaler is not None:
            scaler.note_finite(finite_ok)
        pre = self._pre(tap)
        if _passed(finite_ok, norm_ok, (1.0 if checking else 0.0)
                   if has_gate else None, has_scale, has_gate, tap_gates):
            trainer._optimizer.rescale_grad = trainer._scale / bs
            trainer._update(trainer._scalars())
        return (loss, finite_ok, norm_ok, self._fold() if fp else None,
                self._tap_stats(pre) if tap else None)

    def _eager_step(self, x, y, bs, fp, tap):
        """The kill switch's step when nothing gates: ``Trainer.step``."""
        from . import autograd

        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
        autograd.backward(loss)
        pre = self._pre(tap)
        self.trainer.step(bs)
        return (loss, None, None, self._fold() if fp else None,
                self._tap_stats(pre) if tap else None)

    def _as_tensor(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a)
        return a if a.device == self.device else a.to(self.device)

    def __call__(self, x, y, batch_size=None):
        from .observability import trace as _obs_trace
        from .resilience import faults as _faults
        from .resilience import integrity as _integrity
        from .resilience import watchdog as _watchdog

        _no_dist(self.trainer)
        _STATS["capture_steps"] += 1
        x, y = self._as_tensor(x), self._as_tensor(y)
        bs = batch_size if batch_size is not None else (
            self._batch_size if self._batch_size is not None
            else int(x.shape[0]))
        fp_on = _integrity.fingerprint_enabled()
        tap = self.numerics
        tap_on = tap is not None and tap.tick()
        if tap_on:
            self._tap_slots.write(tap.sel_values().tolist())
        has_scale, has_gate, has_norm, tap_gates = self._gates()
        gating = has_scale or has_gate or tap_gates
        checking = False
        s = self.sentinel
        if s is not None:                 # the eager before_update's cadence
            s._step += 1
            checking = (s._step - 1) % s.check_every == 0
        self._step_count += 1
        _watchdog.note_step(self._step_count)
        attrs = {"step": self._step_count}
        if tap_on:
            attrs["numerics_sampled"] = True
        try:
            with _obs_trace.span("train.captured_step", **attrs), \
                    _watchdog.guard("step", detail="capture.CapturedTrainerStep",
                                    step=self._step_count):
                _faults.maybe_hang("hang_step")
                if not enabled():
                    _STATS["capture_fallback_eager"] += 1
                    out = self._eager_gated(x, y, bs, fp_on, tap_on,
                                            checking) if gating \
                        else self._eager_step(x, y, bs, fp_on, tap_on)
                else:
                    out = self._captured(x, y, bs, fp_on, tap_on, checking,
                                         gating)
        except _watchdog.StallError as e:
            if not self._stall_rollback(e):
                raise
            return None
        loss, finite_ok, norm_ok, fp_out, stats = out
        self._last_fp_out = fp_out
        if fp_on:
            _integrity.note_fingerprint_step()
        if gating:
            self._apply_flag(finite_ok, norm_ok, checking)
        if tap is not None:
            tap.on_step(self._step_count, finite_ok if gating else None,
                        stats.cpu().numpy() if tap_on else None, (x, y))
        return loss

    def _captured(self, x, y, bs, fp_on, tap_on, checking, gating):
        from .resilience import faults as _faults

        trainer, opt = self.trainer, self.trainer.optimizer
        has_scale, has_gate, has_norm, tap_gates = self._gates()
        # the nonfinite_grad drill's captured form poisons the target
        # layer's weight, so the NaN flows through the graph to its
        # activations and gradients (the kill switch poisons the gradient)
        _faults.maybe_nonfinite_grad(trainer._params, where="param")
        for i, p in self._active():       # states exist before the key
            trainer._updater.state(i, p.data())
        drill = _faults.active("nan_grad")
        fire = False
        if drill:
            f = _faults.get("nan_grad")
            fire = f is not None and f.should_fire()
        snap = (opt.num_update, dict(opt._index_update_count),
                opt.rescale_grad, dict(vars(opt.lr_scheduler))
                if opt.lr_scheduler is not None else None)

        def unadvance():
            opt.num_update, count, opt.rescale_grad, sched = snap
            opt._index_update_count = count
            if sched is not None:
                vars(opt.lr_scheduler).update(sched)

        opt.rescale_grad = trainer._scale / bs
        values = trainer._scalars()       # the host scalar replay
        values += [float(self.loss_scaler.loss_scale) if has_scale else 1.0,
                   1.0 if checking else 0.0,
                   float("nan") if fire else 1.0]
        try:
            self._slots.write(values)
            out = self._exec(x, y, key=(
                float(bs), fp_on, tap_on, has_scale, has_gate, has_norm,
                tap_gates, drill))
        except BaseException:
            unadvance()                   # the step never ran
            raise
        entry = self._exec.last_entry
        if entry.graph is not None:
            for leaf, buf in entry.extra:
                if leaf.grad is not buf:
                    leaf.grad = buf
        loss = out.pop(0)
        finite_ok = norm_ok = None
        if gating:                        # the one host read of the step
            finite_ok = bool(out.pop(0).item())
            if has_norm:
                norm_ok = bool(out.pop(0).item())
            if has_scale:
                self.loss_scaler.note_finite(finite_ok)
            if not _passed(finite_ok, norm_ok,
                           (1.0 if checking else 0.0) if has_gate else None,
                           has_scale, has_gate, tap_gates):
                unadvance()               # the gated update never landed
        fp_out = out.pop(0) if fp_on else None
        stats = out.pop(0) if tap_on else None
        return loss, finite_ok, norm_ok, fp_out, stats

    def _apply_flag(self, finite_ok, norm_ok, checking):
        """The host side of the check (``mxnet_tpu/capture.py:1476-1519``),
        the counterpart of ``HealthSentinel.before_update``: the scaler's
        schedule, the sentinel's counters and its policy (the weights were
        already gated). Off cadence the sentinel does nothing, as eager;
        an overflow is counted every step."""
        from .resilience import sentinel as _sentinel

        scaler = self.loss_scaler
        if scaler is not None:
            scaler.update_scale(not finite_ok)
        s = self.sentinel
        if s is None or not checking:
            if scaler is not None and not finite_ok:
                _sentinel.note_skip("amp_overflow")
            return
        ok = finite_ok and norm_ok is not False
        _sentinel.note_check(
            ok, kind="nonfinite" if not finite_ok else "grad_norm")
        if ok:
            return
        s.last_reason = (
            "non-finite gradient (NaN/Inf) (captured step)"
            if not finite_ok else
            f"global grad norm exceeds threshold "
            f"{s.grad_norm_threshold:.3e} (captured step)")
        if s.policy == "raise":
            raise _sentinel.NumericHealthError(
                f"numeric health check failed at captured step "
                f"{self._step_count}: {s.last_reason}")
        if s.policy == "skip_batch" or s.manager is None:
            _sentinel.note_skip("sentinel")
            return
        restored = s.manager.restore_latest(net=s._net or self.net,
                                            trainer=self.trainer)
        if restored is None:
            raise _sentinel.NumericHealthError(
                "rollback requested (captured step) but no valid "
                f"checkpoint exists under {s.manager.directory}")
        _sentinel.note_skip("sentinel")
        _sentinel.note_rollback()

    def _stall_rollback(self, err):
        """A stalled step resumes from the last checkpoint under a
        rollback-policy sentinel with a manager, as ``Trainer.step``'s
        does. True when recovered."""
        from .resilience import watchdog as _watchdog

        s = self.sentinel
        if s is None or s.policy != "rollback" or s.manager is None:
            return False
        manifest = s.manager.restore_latest(net=s._net or self.net,
                                            trainer=self.trainer)
        if manifest is None:
            return False
        _watchdog.note_rollback(err, manifest)
        import warnings

        warnings.warn(
            f"captured step stalled ({err}); rolled back to checkpoint "
            f"step {manifest.get('step')} and skipped the step")
        return True


class CapturedShardedStep:
    """Captured view of a ``parallel.ShardedTrainer``, whose step already
    runs through :class:`CapturedExec`: counts steps and delegates.
    ``numerics`` (default: armed from ``MXNET_TPU_TORCH_NUMERICS``)
    attaches a numerics tap to the trainer."""

    def __init__(self, trainer, label="sharded_step", numerics=None):
        from .observability import numerics as _numerics

        self.trainer = trainer
        self.label = label
        tap = numerics if numerics is not None else _numerics.default_tap()
        if tap is not None:
            trainer.attach_numerics(tap)
        self.numerics = trainer._numerics

    @property
    def last_fingerprint(self):
        return self.trainer.last_fingerprint

    def __call__(self, x, y, microbatches=None, length=None):
        _STATS["capture_steps"] += 1
        return self.trainer.step(x, y, microbatches=microbatches,
                                 length=length)

    @property
    def mesh(self):
        return self.trainer.mesh


def _no_dist(trainer):
    if getattr(trainer, "_dist", None) is not None:
        raise CaptureError(
            "capture: this trainer sums its gradients over a distributed "
            "kvstore; a captured multi-rank step is ROADMAP Queue 1 item 6. "
            "Run the step eagerly (trainer.step)")


def capture(trainer, net=None, loss_fn=None, **kwargs):
    """A captured training step: ``capture(sharded_trainer)`` gives a
    :class:`CapturedShardedStep`, ``capture(trainer, net=net,
    loss_fn=loss)`` (gluon) a :class:`CapturedTrainerStep`. With
    ``MXNET_TPU_TORCH_CAPTURE=0`` either runs the same step eagerly."""
    from .parallel.trainer import ShardedTrainer

    _check_cache()
    if isinstance(trainer, ShardedTrainer):
        return CapturedShardedStep(trainer, **kwargs)
    if net is None or loss_fn is None:
        raise CaptureError(
            "capture(gluon_trainer) needs net= and loss_fn= (the step "
            "program is forward + backward + update, not just the update)")
    return CapturedTrainerStep(net, loss_fn, trainer, **kwargs)
