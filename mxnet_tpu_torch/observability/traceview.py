"""Chrome-trace timeline export: span records -> Trace Event Format
(port of ``mxnet_tpu/observability/traceview.py``).

``to_chrome_trace()`` converts collected span records (the
``trace.spans()`` ring, a crash report's exemplar trees, or any list of
span dicts) into the JSON Trace Event Format that loads directly in
Perfetto / ``chrome://tracing``:

- every span becomes one complete (``"ph": "X"``) event with
  microsecond ``ts``/``dur``;
- **pid** comes from the span-id's process prefix (span ids are minted
  as ``<pid-hex>.<counter>``, so records shipped back over the fleet's
  process-replica pipe keep their origin identity) and **tid** from the
  recording thread's name, with ``process_name`` / ``thread_name``
  metadata events so the timeline reads "replica 1" and
  "mxnet-tpu-serving", not bare numbers;
- cross-process clock skew is handled structurally: each foreign
  process's events are shifted so its earliest span whose *parent*
  lives in another process starts just inside that parent
  (``perf_counter_ns`` epochs are per-process and otherwise
  incomparable), keeping the fleet tree visually nested.

Stdlib only, with no package-relative import outside
``to_chrome_trace()``'s default argument: a copy of
``mxnet_tpu/observability/traceview.py``, so the two packages turn the
same span records into the same events.
"""
from __future__ import annotations

import os

__all__ = ["to_chrome_trace", "span_pid"]

# one synthetic nesting margin (ns) when re-basing a foreign process's
# clock inside its cross-process parent span
_ALIGN_MARGIN_NS = 1000


def span_pid(record):
    """The origin-process id of one span record, parsed from the
    span-id's ``<pid-hex>.<counter>`` prefix; 0 when unparsable."""
    sid = str(record.get("span", ""))
    head = sid.split(".", 1)[0]
    try:
        return int(head, 16)
    except ValueError:
        return 0


def _process_offsets(records, by_id):
    """ns offset to add per foreign pid so each process's events sit
    inside their cross-process parent span (clock re-basing)."""
    home = os.getpid()
    offsets = {}
    for rec in records:
        pid = span_pid(rec)
        if pid == home or pid in offsets:
            continue
        parent = by_id.get(rec.get("parent"))
        if parent is None or span_pid(parent) == pid:
            continue
        offsets[pid] = (parent["t0_ns"] + _ALIGN_MARGIN_NS) - rec["t0_ns"]
    return offsets


def to_chrome_trace(records=None):
    """Convert span records to a Trace Event Format dict
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``) —
    ``json.dump`` it and load the file in Perfetto. ``records``
    defaults to the live ``trace.spans()`` ring (which requires the
    package; explicit records keep this module standalone)."""
    if records is None:
        from . import trace as _trace

        records = _trace.spans()
    records = [r for r in records
               if isinstance(r, dict) and "span" in r and "t0_ns" in r]
    by_id = {r["span"]: r for r in records}
    offsets = _process_offsets(records, by_id)

    events = []
    # (pid, thread-name) -> tid; tid 1..N per process, stable by first
    # appearance so re-exports of the same records agree
    tids: dict = {}
    proc_names: dict = {}
    for rec in records:
        pid = span_pid(rec)
        thread = str(rec.get("thread", "?"))
        key = (pid, thread)
        if key not in tids:
            tids[key] = sum(1 for k in tids if k[0] == pid) + 1
        name = str(rec.get("name", "?"))
        attrs = rec.get("attrs") or {}  # tolerate an explicit null in
        if name == "serve.replica" and "replica" in attrs:  # foreign JSON
            proc_names[pid] = f"replica {attrs['replica']}"
        t0 = rec["t0_ns"] + offsets.get(pid, 0)
        args = {"trace": rec.get("trace"), "span": rec["span"]}
        if rec.get("parent") is not None:
            args["parent"] = rec["parent"]
        for k, v in attrs.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                args[k] = v
        events.append({
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": t0 / 1e3,
            "dur": max(0.001, (rec.get("dur_ns") or 0) / 1e3),
            "pid": pid,
            "tid": tids[key],
            "args": args,
        })

    home = os.getpid()
    meta = []
    for pid in sorted({p for p, _ in tids}):
        label = proc_names.get(pid) or (
            "main" if pid == home else f"process {pid:#x}")
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": label}})
    for (pid, thread), tid in sorted(tids.items(),
                                     key=lambda kv: (kv[0][0], kv[1])):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": thread}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
