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

Not ported: the AOT compile cache. A CUDA graph cannot be written to disk,
so ``MXNET_TPU_TORCH_COMPILE_CACHE`` raises ``NotImplementedError``
(ROADMAP Queue 1 item 4). The sentinel, numerics tap and integrity
fingerprint wait for their modules (Queue 1 item 12). The AMP loss scaler
inside a captured step (its all-finite flag computed in the graph and
noted with ``LossScaler.note_finite``) is Queue 1 item 4: a gluon trainer
with a loss scaler attached (``amp.init_trainer``) raises
:class:`CaptureError` rather than run with its scaler ignored.
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

__all__ = ["capture", "CapturedTrainerStep", "CapturedShardedStep",
           "CapturedExec", "CaptureError", "SlotTable", "enabled",
           "cache_dir", "note_recapture", "retrace_log",
           "clear_retrace_log", "stats", "reset_stats", "fingerprint",
           "code_sig", "net_sig"]

_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()   # one capture at a time, GC held off
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
class _Entry:
    __slots__ = ("sig", "state", "inputs", "outputs", "as_list", "graph",
                 "capture_s", "extra")

    def __init__(self, sig, state, inputs):
        self.sig, self.state, self.inputs = sig, state, inputs
        self.outputs = self.graph = self.extra = None
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

    ``exec(*args, key=(), batch=None, rows=None)``: ``batch`` pads every
    arg's leading dimension with zero rows to ``batch`` (into the static
    buffer; on the eager path by concatenation); ``rows`` keeps only the
    first ``rows`` rows of each output whose leading dimension is
    ``batch``. Returns clones of the outputs (a tensor, or a list).
    """

    def __init__(self, fn, *, label, device, state=None, eager=None,
                 warmup_guard=None, on_capture=None):
        _check_cache()
        self._fn = fn
        self.label = label
        self.device = torch.device(device)
        self._state = state or (lambda: ())
        self._eager = eager or fn
        self._guard = warmup_guard
        self._on_capture = on_capture
        self._entries = {}
        self._last_sig = None
        self._pool = None
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
                entry.keep(self._fn(*entry.inputs, *key))
            else:
                entry.graph.replay()
            self.last_entry = entry
            outs = _cut(entry.outputs, batch, rows, True)
        return outs if entry.as_list else outs[0]

    def _capture(self, entry, key):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                guard = self._guard() if self._guard is not None \
                    else contextlib.nullcontext()
                with guard:
                    for _ in range(_WARMUP):
                        self._fn(*entry.inputs, *key)
            cur.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # keep_graph keeps the node list for debug_dump after the graph
            # is instantiated
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # a graph freed by the garbage collector inside a capture
            # (an owner that died in a reference cycle) would end it:
            # collect first, and not during the capture
            with _CAPTURE_LOCK:
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool,
                                          capture_error_mode="thread_local"):
                        out = self._fn(*entry.inputs, *key)
                finally:
                    if collecting:
                        gc.enable()
            graph.instantiate()
        except CaptureError:
            raise
        except Exception as e:  # the capture failed: say so, no fall-back
            raise CaptureError(f"{self.label}: capturing {entry.sig} failed: "
                               f"{type(e).__name__}: {e}") from e
        entry.keep(out)
        entry.graph = graph
        entry.capture_s = time.perf_counter() - t0
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
class CapturedTrainerStep:
    """One gluon training step (forward, backward, the update sweep) as one
    CUDA graph per signature, with its scalars in device slots.

    Bitwise equal to the eager step (``autograd.record()`` around
    ``loss_fn(net(x), y)``, ``backward``, ``Trainer.step``): the update ops
    take their scalars as floats or slots with the same arithmetic
    (``ops/optimizer_ops.py``).

    Parameters
    ----------
    net : initialized gluon Block
    loss_fn : callable(pred, label) -> tensor (head gradient ones, as
        ``loss.backward()`` eagerly)
    trainer : gluon.Trainer
    batch_size : rescale denominator for ``Trainer.step``; default the
        batch's row count
    """

    def __init__(self, net, loss_fn, trainer, batch_size=None,
                 label="trainer_step"):
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.label = label
        self._batch_size = batch_size
        self.device = trainer._params[0].data().device
        self._slots = SlotTable(self.device)
        self._exec = CapturedExec(
            self._program, label=label, device=self.device,
            state=self._state_tensors, warmup_guard=self._warmup_guard,
            on_capture=self._keep_grads)

    def _active(self):
        return [(i, self.trainer._params[i]) for i in self.trainer._active()]

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

    def _warmup_guard(self):
        return _restored(self._state_tensors())

    def _keep_grads(self, entry):
        """After a capture: the gradient buffers the graph writes, one per
        trainable parameter, which each replay hands back to ``.grad``."""
        entry.extra = [(p.data(), p.data().grad) for _, p in self._active()]

    def _program(self, x, y, batch_size):
        from . import autograd

        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
        autograd.backward(loss)
        self.trainer._update(self._slots.views)
        return loss

    def _eager_step(self, x, y, batch_size):
        from . import autograd

        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
        autograd.backward(loss)
        self.trainer.step(batch_size)
        return loss

    def _as_tensor(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a)
        return a if a.device == self.device else a.to(self.device)

    def __call__(self, x, y, batch_size=None):
        _no_loss_scaler(self.trainer)
        _STATS["capture_steps"] += 1
        x, y = self._as_tensor(x), self._as_tensor(y)
        bs = batch_size if batch_size is not None else (
            self._batch_size if self._batch_size is not None
            else int(x.shape[0]))
        trainer, opt = self.trainer, self.trainer.optimizer
        if not enabled():
            _STATS["capture_fallback_eager"] += 1
            return self._eager_step(x, y, bs)
        for i, p in self._active():       # states exist before the key
            trainer._updater.state(i, p.data())
        snap = (opt.num_update, dict(opt._index_update_count),
                opt.rescale_grad, dict(vars(opt.lr_scheduler))
                if opt.lr_scheduler is not None else None)
        opt.rescale_grad = trainer._scale / bs
        values = trainer._scalars()       # the host scalar replay
        try:
            self._slots.write(values)
            loss = self._exec(x, y, key=(float(bs),))
        except BaseException:
            # the step never ran: un-advance the replay's bookkeeping
            opt.num_update, count, opt.rescale_grad, sched = snap
            opt._index_update_count = count
            if sched is not None:
                vars(opt.lr_scheduler).update(sched)
            raise
        entry = self._exec.last_entry
        if entry.graph is not None:
            for leaf, buf in entry.extra:
                if leaf.grad is not buf:
                    leaf.grad = buf
        return loss


class CapturedShardedStep:
    """Captured view of a ``parallel.ShardedTrainer``, whose step already
    runs through :class:`CapturedExec`: counts steps and delegates."""

    def __init__(self, trainer, label="sharded_step"):
        self.trainer = trainer
        self.label = label

    def __call__(self, x, y, microbatches=None, length=None):
        _STATS["capture_steps"] += 1
        return self.trainer.step(x, y, microbatches=microbatches,
                                 length=length)

    @property
    def mesh(self):
        return self.trainer.mesh


def _no_loss_scaler(trainer):
    if getattr(trainer, "_dist", None) is not None:
        raise CaptureError(
            "capture: this trainer sums its gradients over a distributed "
            "kvstore; a captured multi-rank step is ROADMAP Queue 1 item 6. "
            "Run the step eagerly (trainer.step)")
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        raise CaptureError(
            "capture: this trainer has an AMP loss scaler attached "
            "(amp.init_trainer); a captured step that checks the gradients "
            "for overflow in the graph is ROADMAP Queue 1 item 4. Run the "
            "step eagerly (amp.scale_loss, amp.unscale, trainer.step)")


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
    _no_loss_scaler(trainer)
    return CapturedTrainerStep(net, loss_fn, trainer, **kwargs)
