"""Sharded streaming RecordIO ingestion with device prefetch and
deterministic mid-epoch resume (port of ``mxnet_tpu/io/stream.py``).

- :class:`RecordStream` — range reads over one or many ``.rec`` shards
  through each one's ``.idx`` offset index (no full-file scan), an
  epoch-seeded shard-and-chunk shuffle identical on every rank, and a
  strided rank partition: order position ``p`` belongs to rank
  ``p % num_parts``. Each read is CRC-checked against the index
  (``recordio.read_record_at``); a corrupt record raises
  ``RecordCorruptError`` or, under ``MXNET_TPU_TORCH_DATA_CORRUPT_POLICY=
  skip``, is counted (``io_records_corrupt``) and skipped.
- :class:`StreamBatchIter` — lockstep batches assembled on a decode
  thread pool; every rank produces the same number a epoch, and every
  batch carries the resume token of the stream after it, which restores
  the remaining stream bitwise, at the same ``num_parts`` or re-strided
  over fewer ranks after a mesh shrink. Batches and tokens are
  ``mxnet_tpu``'s under the same seed.
- :class:`DevicePrefetcher` — a daemon worker stages each host batch in
  pinned memory and copies it to the trainer's device on a copy stream of
  its own, ``depth`` batches ahead (``MXNET_TPU_TORCH_DATA_PREFETCH``,
  default 2; 0: inline, no thread). The copy records an event, and the
  consumer's stream waits on it when the batch is handed out, so decode,
  the copy and the step overlap. Its resume token is that of the last
  batch handed to the consumer: ring contents never handed out are
  dropped on restore and made again from the source.

Resume tokens go into the checkpoint manifest
(``CheckpointManager.save(..., data_iter=)`` / ``restore_latest(...,
data_iter=)``), in ``mxnet_tpu``'s format, so either package resumes the
other's stream.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref

import numpy as _np

from ..base import MXNetError
from ..observability import trace as _obs_trace
from .. import recordio as _recordio

__all__ = ["RecordStream", "StreamBatchIter", "StreamBatch",
           "DevicePrefetcher", "raw_decoder", "image_decoder",
           "token_decoder", "resolve_bucket_edges", "live_positions",
           "stats", "reset_stats", "STATE_VERSION"]

# docs/observability.md "streaming ingestion" counters; merged into
# profiler.dispatch_stats() like every subsystem's _STATS.
_STATS = {
    "io_batches_streamed": 0,   # host batches assembled by StreamBatchIter
    "io_records_corrupt": 0,    # CRC-failed records skipped (policy=skip)
    "io_prefetch_depth": 0,     # DevicePrefetcher ring occupancy (last seen)
    "io_stream_resumes": 0,     # iterators restored from a resume token
    "io_bucket_batches": 0,     # batches padded to a token-length bucket
    "io_bucket_pad_rows": 0,    # rows that needed padding to their bucket
}

STATE_VERSION = 1

# live batch iterators, so the input_stall_high alert rule can name the
# streaming iterator position in its evidence (observability/alerts.py)
_LIVE_LOCK = threading.Lock()
_LIVE = weakref.WeakSet()


def stats():
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def live_positions():
    """Positions of every live :class:`StreamBatchIter` — the evidence
    the ``input_stall_high`` alert attaches so an incident names WHERE
    in the epoch the input-bound loop was starving."""
    with _LIVE_LOCK:
        iters = list(_LIVE)
    out = []
    for it in iters:
        try:
            out.append(it.position())
        except Exception:
            continue
    return out


def _corrupt_policy(override=None):
    policy = (override if override is not None else
              os.environ.get("MXNET_TPU_TORCH_DATA_CORRUPT_POLICY", "raise"))
    policy = str(policy).strip().lower()
    if policy not in ("raise", "skip"):
        raise ValueError(
            f"corrupt-record policy must be 'raise' or 'skip', got "
            f"{policy!r} (MXNET_TPU_TORCH_DATA_CORRUPT_POLICY)")
    return policy


def resolve_bucket_edges(override=None):
    """Token-length bucket boundaries: an explicit iterable of ints, or
    the ``MXNET_TPU_TORCH_DATA_BUCKET_EDGES`` env knob ('32,64,128'); None/''
    disables bucketing. Returned sorted ascending and de-duplicated —
    the FIXED set of sequence shapes every padded batch snaps to, so a
    captured step compiles at most ``len(edges)`` signatures no matter
    how batch membership shifts (docs/data.md)."""
    if override is not None:
        raw = list(override)
    else:
        env = os.environ.get("MXNET_TPU_TORCH_DATA_BUCKET_EDGES", "").strip()
        if not env:
            return None
        raw = [p for p in env.split(",") if p.strip()]
    try:
        edges = sorted({int(e) for e in raw})
    except (TypeError, ValueError):
        raise ValueError(
            f"bucket edges must be integers, got {raw!r} "
            "(MXNET_TPU_TORCH_DATA_BUCKET_EDGES)")
    if not edges:
        return None
    if edges[0] < 1:
        raise ValueError(
            f"bucket edges must be positive, got {edges} "
            "(MXNET_TPU_TORCH_DATA_BUCKET_EDGES)")
    return tuple(edges)


# ------------------------------------------------------------------ decoders

def raw_decoder(data_shape, label_width=1, cost_s=0.0):
    """Decoder for records whose payload is raw little-endian float32
    bytes of ``data_shape`` — the synthetic-decode form the tests and
    ``tools/stream_bench.py`` pack. ``cost_s`` sleeps per record to
    emulate a real decoder's latency for overlap benchmarking (sleep,
    not spin, so the emulated cost never steals CPU from the step)."""
    shape = tuple(int(d) for d in data_shape)
    n = 1
    for d in shape:
        n *= d

    def decode(header, payload):
        if cost_s > 0:
            time.sleep(cost_s)
        arr = _np.frombuffer(payload, dtype=_np.float32, count=n)
        arr = arr.reshape(shape)
        lab = _np.atleast_1d(_np.asarray(header.label, _np.float32)).ravel()
        label = _np.zeros(label_width, _np.float32)
        label[:min(label_width, lab.size)] = lab[:label_width]
        return arr, label

    return decode


def token_decoder(lm_shift=True, dtype=_np.float32):
    """Decoder for variable-length text records: the payload is raw
    little-endian int32 token ids (any count — this is the decoder the
    token-length buckets exist for). With ``lm_shift`` (default) each
    record yields the next-token LM pair ``(tokens[:-1], tokens[1:])``
    — both length T-1, padded together to the bucket edge; otherwise
    the full sequence with the record header's label."""

    def decode(header, payload):
        toks = _np.frombuffer(payload, dtype=_np.int32).astype(dtype)
        if lm_shift:
            if toks.size < 2:
                raise ValueError(
                    f"LM records need >= 2 tokens, got {toks.size}")
            return toks[:-1], toks[1:]
        lab = _np.atleast_1d(_np.asarray(header.label, _np.float32))
        return toks, lab.ravel()[:1]

    return decode


def image_decoder(data_shape, resize=0, mean=None, std=None):
    """Deterministic (augmentation-free) image decoder: PIL decode,
    shorter-side resize, center crop to ``(C, H, W)``, float32 NCHW with
    optional per-channel mean/std normalization. Training-time random
    augmentation stays with ``io.ImageRecordIter``; streaming resume is
    bitwise only because this decode has no RNG."""
    channels, height, width = (int(d) for d in data_shape)
    mean_a = _np.asarray(mean if mean is not None else [0.0] * channels,
                         _np.float32)
    std_a = _np.asarray(std if std is not None else [1.0] * channels,
                        _np.float32)

    def decode(header, payload):
        from io import BytesIO

        from PIL import Image

        img = Image.open(BytesIO(payload))
        img = img.convert("L" if channels == 1 else "RGB")
        if resize > 0:
            scale = resize / min(img.size)
            img = img.resize((max(width, round(img.size[0] * scale)),
                              max(height, round(img.size[1] * scale))))
        if img.size != (width, height):
            if img.size[0] < width or img.size[1] < height:
                img = img.resize((width, height))
            else:
                x = (img.size[0] - width) // 2
                y = (img.size[1] - height) // 2
                img = img.crop((x, y, x + width, y + height))
        arr = _np.asarray(img, dtype=_np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = (arr - mean_a) / std_a
        lab = _np.atleast_1d(_np.asarray(header.label, _np.float32)).ravel()
        return arr.transpose(2, 0, 1), lab[:1]

    return decode


# -------------------------------------------------------------- RecordStream

class _Shard:
    """One ``.rec`` file plus its loaded ``.idx`` offset index."""

    __slots__ = ("rec_path", "idx_path", "entries", "name")

    def __init__(self, rec_path, idx_path=None):
        self.rec_path = os.fspath(rec_path)
        base = (self.rec_path[:-4] if self.rec_path.endswith(".rec")
                else self.rec_path)
        self.idx_path = os.fspath(idx_path) if idx_path else base + ".idx"
        if not os.path.isfile(self.idx_path):
            raise MXNetError(
                f"streaming reads need an offset index: {self.idx_path} is "
                "missing (tools/im2rec.py writes one next to every .rec)")
        self.entries = _recordio.load_index(self.idx_path)
        if not self.entries:
            raise MXNetError(f"offset index {self.idx_path} is empty")
        # the index must reach EOF: an index from an earlier, shorter
        # pack of the same data has only valid offsets — trusting it
        # would silently train on a prefix of the dataset
        size = os.path.getsize(self.rec_path)
        last = self.entries[-1]
        ok = 0 <= last.offset < size
        if ok:
            try:
                with open(self.rec_path, "rb") as f:
                    f.seek(last.offset)
                    ok = (_recordio.read_logical_record(f) is not None
                          and f.tell() == size)
            except (OSError, ValueError):
                ok = False
        if not ok:
            raise MXNetError(
                f"offset index {self.idx_path} is stale for "
                f"{self.rec_path}: its last entry does not frame the "
                "file's final record (rebuild with tools/im2rec.py)")
        self.name = os.path.basename(self.rec_path)


class RecordStream:
    """Deterministic sharded streaming reader over indexed RecordIO.

    Parameters
    ----------
    paths : str | [str] — one or many ``.rec`` shards; each needs the
        sibling ``.idx`` index. Shards are ordered by sorted path so
        every rank agrees on the global record numbering.
    part_index, num_parts : this rank's slice. The partition is strided
        over epoch-order POSITIONS (position ``p`` belongs to rank
        ``p % num_parts``), so the union over ranks covers every record
        exactly once per epoch, uneven tail included — and a resume
        token's global cursor re-partitions cleanly onto a different
        ``num_parts`` after a mesh shrink.
    shuffle, seed : epoch-seeded shard-and-chunk shuffle — the chunk
        order across all shards and the record order within each chunk
        are permuted by an RNG seeded from ``(seed, epoch)``, identical
        on every rank, while reads stay range-local.
    chunk_records : shuffle granularity (``MXNET_TPU_TORCH_DATA_CHUNK_RECORDS``,
        default 64 records per chunk).
    corrupt_policy : ``raise`` | ``skip``
        (``MXNET_TPU_TORCH_DATA_CORRUPT_POLICY``).
    """

    def __init__(self, paths, part_index=0, num_parts=1, shuffle=False,
                 seed=0, chunk_records=None, corrupt_policy=None):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.shards = [_Shard(p) for p in
                       sorted(os.fspath(p) for p in paths)]
        num_parts = int(num_parts)
        part_index = int(part_index)
        if num_parts < 1 or not 0 <= part_index < num_parts:
            raise ValueError(
                f"need 0 <= part_index < num_parts, got {part_index}/"
                f"{num_parts}")
        self.part_index = part_index
        self.num_parts = num_parts
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        if chunk_records is None:
            chunk_records = int(os.environ.get(
                "MXNET_TPU_TORCH_DATA_CHUNK_RECORDS", "64"))
        self.chunk_records = max(1, int(chunk_records))
        self._policy = _corrupt_policy(corrupt_policy)
        self._shard_base = []
        self._chunks = []       # [(start_gid, stop_gid)] within one shard
        base = 0
        for shard in self.shards:
            self._shard_base.append(base)
            n = len(shard.entries)
            for lo in range(0, n, self.chunk_records):
                self._chunks.append((base + lo,
                                     base + min(lo + self.chunk_records, n)))
            base += n
        self.num_records = base
        self._tls = threading.local()

    def identity(self):
        """What a resume token must match: the dataset, not the rank."""
        return {"shards": [s.name for s in self.shards],
                "num_records": int(self.num_records)}

    def epoch_order(self, epoch):
        """Global record order (array of record ids) for one epoch —
        identical on every rank. Shuffle permutes whole chunks across
        shards, then records within each chunk, so range reads stay
        local while the sample order decorrelates across epochs."""
        if not self.shuffle:
            return _np.arange(self.num_records, dtype=_np.int64)
        rs = _np.random.RandomState(
            (self.seed * 2654435761 + (int(epoch) + 1) * 40503)
            & 0xFFFFFFFF)
        chunks = list(self._chunks)
        rs.shuffle(chunks)
        out = _np.empty(self.num_records, _np.int64)
        pos = 0
        for lo, hi in chunks:
            ids = _np.arange(lo, hi, dtype=_np.int64)
            rs.shuffle(ids)
            out[pos:pos + len(ids)] = ids
            pos += len(ids)
        return out

    def locate(self, gid):
        """Global record id -> (shard, IndexEntry)."""
        gid = int(gid)
        lo, hi = 0, len(self.shards) - 1
        while lo < hi:  # rightmost shard whose base <= gid
            mid = (lo + hi + 1) // 2
            if self._shard_base[mid] <= gid:
                lo = mid
            else:
                hi = mid - 1
        shard = self.shards[lo]
        return shard, shard.entries[gid - self._shard_base[lo]]

    def _file(self, shard):
        # one handle per (thread, shard): seek/read pairs must not
        # interleave across the decode pool's threads
        files = getattr(self._tls, "files", None)
        if files is None:
            files = self._tls.files = {}
        f = files.get(shard.rec_path)
        if f is None:
            f = files[shard.rec_path] = open(shard.rec_path, "rb")
        return f

    def close(self):
        """Close the CALLING thread's shard file handles. Handles opened
        by decode-pool threads are per-thread-local and close with their
        thread (StreamBatchIter.close shuts the pool down first)."""
        files = getattr(self._tls, "files", None)
        if files:
            for f in files.values():
                try:
                    f.close()
                except OSError:
                    pass
            files.clear()

    def read(self, gid):
        """Verified range-read of one record; returns the payload bytes,
        or None when the record failed verification and the policy is
        ``skip`` (counted in ``io_records_corrupt``)."""
        shard, entry = self.locate(gid)
        try:
            return _recordio.read_record_at(self._file(shard), entry,
                                            path=shard.rec_path)
        except _recordio.RecordCorruptError:
            if self._policy == "raise":
                raise
            _STATS["io_records_corrupt"] += 1
            return None

    def iter_records(self, epoch=0, start=0):
        """Yield ``(position, record_id, payload)`` for THIS rank's slice
        of the epoch: order positions ``p >= start`` with
        ``(p - start) % num_parts == part_index``. Corrupt records under
        policy ``skip`` are omitted (still counted); the partition
        itself covers every record exactly once across ranks."""
        order = self.epoch_order(epoch)
        p = int(start) + self.part_index
        while p < self.num_records:
            gid = int(order[p])
            payload = self.read(gid)
            if payload is not None:
                yield p, gid, payload
            p += self.num_parts


# ------------------------------------------------------------ batch assembly

class StreamBatch:
    """One assembled host batch plus the resume token that re-produces
    every batch AFTER it (``state`` — feed it to
    ``StreamBatchIter.restore`` / ``CheckpointManager.save(data_iter=)``).

    ``length`` is None except on token-length-bucketed text batches
    (``bucket_edges`` / ``MXNET_TPU_TORCH_DATA_BUCKET_EDGES``), where it is
    the (batch,) int32 vector of REAL per-row sequence lengths — the
    mask consumers apply over the pad positions ``data``/``label`` were
    padded to (the bucket edge)."""

    __slots__ = ("data", "label", "state", "length")

    def __init__(self, data, label, state, length=None):
        self.data = data
        self.label = label
        self.state = state
        self.length = length

    def __iter__(self):  # (x, y) unpacking convenience
        return iter((self.data, self.label))


class StreamBatchIter:
    """Lockstep streaming batch iterator with deterministic resume.

    Single consumer (the training loop or a :class:`DevicePrefetcher`
    worker — never both). Every rank running the same configuration
    produces the same number of batches per epoch, and every yielded
    :class:`StreamBatch` carries the resume token of the stream AFTER
    that batch. ``epochs=None`` streams forever (epoch-seeded reshuffle
    at every epoch edge); ``epochs=N`` raises StopIteration after N
    full epochs.

    A corrupt record under policy ``skip`` keeps the batch geometry
    intact: its row is substituted with the batch's first valid row
    (counted in ``io_records_corrupt``), so the position arithmetic —
    and therefore bitwise resume and cross-rank lockstep — never shifts.
    """

    def __init__(self, source, batch_size, decode, part_index=0,
                 num_parts=1, shuffle=False, seed=0, chunk_records=None,
                 corrupt_policy=None, epochs=None, decode_threads=None,
                 batch_cost_s=0.0, bucket_edges=None, bucket_pad=0):
        from concurrent.futures import ThreadPoolExecutor

        if isinstance(source, RecordStream):
            conflicting = [name for name, passed in
                           (("part_index", part_index != 0),
                            ("num_parts", num_parts != 1),
                            ("shuffle", shuffle is not False),
                            ("seed", seed != 0),
                            ("chunk_records", chunk_records is not None),
                            ("corrupt_policy", corrupt_policy is not None))
                           if passed]
            if conflicting:
                raise ValueError(
                    "source is already a RecordStream: its own settings "
                    "govern the order/partition, and the conflicting "
                    f"argument(s) {conflicting} would be silently "
                    "ignored — configure them on the RecordStream")
            self.stream = source
        else:
            self.stream = RecordStream(
                source, part_index=part_index, num_parts=num_parts,
                shuffle=shuffle, seed=seed, chunk_records=chunk_records,
                corrupt_policy=corrupt_policy)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.decode = decode
        self._epochs = None if epochs is None else int(epochs)
        # synthetic per-BATCH decode latency (sleep) for overlap
        # benchmarking (tools/stream_bench.py): one sleep per batch, not
        # per record — on a CPU-starved host every timer wakeup costs a
        # scheduler quantum, so a per-record decoder sleep would serialize
        # with compute instead of overlapping it
        self._batch_cost_s = float(batch_cost_s)
        if decode_threads is None:
            decode_threads = int(os.environ.get(
                "MXNET_TPU_TORCH_DATA_DECODE_THREADS", "4"))
        self._pool_workers = max(1, int(decode_threads))
        self._pool = ThreadPoolExecutor(
            max_workers=self._pool_workers,
            thread_name_prefix="mxnet-torch-data-decode")
        # token-length bucketing (variable-length text rows): pad every
        # batch's sequence dim up to the smallest edge that fits it, so
        # decoded lengths never leak into batch shapes — a captured step
        # compiles at most len(edges) signatures. Deliberately NOT part
        # of the resume token (like the decode fn, bucketing is
        # configuration the resuming iterator must be rebuilt with; the
        # token's order arithmetic is untouched by padding).
        self._bucket_edges = resolve_bucket_edges(bucket_edges)
        self._bucket_pad = bucket_pad
        self._epoch = 0
        self._cursor = 0        # within-epoch global position cursor
        self._epochs_done = 0
        self._order = None
        self._closed = False
        if self.batches_per_epoch == 0:
            raise MXNetError(
                f"{self.stream.num_records} records cannot fill one "
                f"lockstep batch of {self.batch_size} rows per rank over "
                f"{self.stream.num_parts} rank(s)")
        with _LIVE_LOCK:
            _LIVE.add(self)

    @classmethod
    def for_pod(cls, topology, source, batch_size, decode, **kw):
        """Per-host partition of the stream for a pod run: host ``h`` of
        a :class:`~mxnet_tpu_torch.parallel.mesh.PodTopology` reads order
        positions ``p % num_hosts == h`` (the strided partition, so a
        host-count change after a shrink re-strides the same remainder
        instead of re-reading consumed records). ``batch_size`` is the
        host's rows; :meth:`DevicePrefetcher.for_trainer` hands each of the
        host's ranks its rows of them (the trainer's ``batch_sharding``)."""
        for name in ("part_index", "num_parts"):
            if name in kw:
                raise ValueError(
                    f"for_pod derives {name} from the topology "
                    f"(num_hosts={int(topology.num_hosts)}, "
                    f"this_host={int(topology.this_host)}); don't pass it")
        return cls(source, batch_size, decode,
                   part_index=int(topology.this_host),
                   num_parts=int(topology.num_hosts), **kw)

    # ------------------------------------------------------------ geometry

    @property
    def batches_per_epoch(self):
        """Lockstep batches per FULL epoch (cursor 0) — identical on
        every rank by construction."""
        return ((self.stream.num_records // self.stream.num_parts)
                // self.batch_size)

    def _batches_left(self):
        avail = self.stream.num_records - self._cursor
        return max(0, (avail // self.stream.num_parts) // self.batch_size)

    @property
    def epoch(self):
        return self._epoch

    # ----------------------------------------------------------- iteration

    def __iter__(self):
        return self

    def close(self):
        """Release the decode pool's threads and this thread's shard
        file handles (pool threads' per-thread handles close with their
        threads). Without an explicit close these are reclaimed only by
        GC — a job building one iterator per evaluation pass would
        accumulate threads and fds until then."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        self.stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __next__(self):
        if self._closed:
            raise RuntimeError("StreamBatchIter is closed")
        if self._batches_left() == 0:
            self._epochs_done += 1
            if self._epochs is not None \
                    and self._epochs_done >= self._epochs:
                raise StopIteration
            self._epoch += 1
            self._cursor = 0
            self._order = None
        with _obs_trace.span("data.fetch", epoch=self._epoch,
                             cursor=self._cursor):
            batch = self._assemble()
        _STATS["io_batches_streamed"] += 1
        return batch

    def _assemble(self):
        stream = self.stream
        if self._order is None:
            self._order = stream.epoch_order(self._epoch)
        base, bs, P = self._cursor, self.batch_size, stream.num_parts
        gids = [int(self._order[base + stream.part_index + i * P])
                for i in range(bs)]
        if self._batch_cost_s > 0:
            time.sleep(self._batch_cost_s)
        if self._pool_workers == 1:
            # inline serial decode: a 1-worker pool adds one cross-thread
            # handoff per record for zero parallelism — ruinous on a
            # starved host where every wakeup costs a scheduler quantum
            rows = [self._decode_one(g) for g in gids]
        else:
            rows = list(self._pool.map(self._decode_one, gids))
        good = next((r for r in rows if r is not None), None)
        if good is None:
            shard, entry = stream.locate(gids[0])
            raise _recordio.RecordCorruptError(
                f"every record of a {bs}-row batch failed verification "
                f"(first: key {entry.key} in {shard.rec_path}) — the "
                "skip policy substitutes single bad rows, not whole "
                "batches", path=shard.rec_path, key=entry.key,
                offset=entry.offset)
        rows = [r if r is not None else good for r in rows]
        if self._bucket_edges is not None:
            data, label, length = self._bucket_stack(rows)
        else:
            length = None
            data = _np.stack([r[0] for r in rows])
            label = _np.stack([r[1] for r in rows])
        if label.ndim == 2 and label.shape[1] == 1:
            label = label.reshape(bs)
        self._cursor = base + bs * P
        return StreamBatch(data, label, self.state(), length=length)

    def _bucket_stack(self, rows):
        """Pad variable-length rows to the smallest bucket edge that
        fits the batch's longest row and stack. Labels that are
        per-token sequences (row length == data row length) pad along
        with the data; per-example labels stack unchanged. Returns
        (data, label, real_lengths)."""
        lens = [int(_np.shape(r[0])[0]) for r in rows]
        need = max(lens)
        edge = next((e for e in self._bucket_edges if e >= need), None)
        if edge is None:
            raise MXNetError(
                f"a {need}-token row exceeds the largest bucket edge "
                f"{self._bucket_edges[-1]}; extend bucket_edges / "
                "MXNET_TPU_TORCH_DATA_BUCKET_EDGES or truncate at decode "
                "(fixed bucket shapes are the no-retrace contract, "
                "docs/data.md)")

        def pad(a):
            a = _np.asarray(a)
            if a.shape[0] == edge:
                return a
            width = [(0, edge - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return _np.pad(a, width, constant_values=self._bucket_pad)

        seq_labels = all(
            _np.ndim(r[1]) >= 1 and _np.shape(r[1])[0] == n
            for r, n in zip(rows, lens))
        data = _np.stack([pad(r[0]) for r in rows])
        label = (_np.stack([pad(r[1]) for r in rows]) if seq_labels
                 else _np.stack([_np.asarray(r[1]) for r in rows]))
        _STATS["io_bucket_batches"] += 1
        _STATS["io_bucket_pad_rows"] += sum(1 for n in lens if n != edge)
        return data, label, _np.asarray(lens, dtype=_np.int32)

    def _decode_one(self, gid):
        payload = self.stream.read(gid)
        if payload is None:
            return None
        header, content = _recordio.unpack(payload)
        return self.decode(header, content)

    # -------------------------------------------------------------- resume

    def state(self):
        """The resume token: everything needed to re-produce the exact
        remaining batch stream — on this rank, on a freshly-started
        replacement, or re-partitioned over a DIFFERENT ``num_parts``
        after a mesh shrink (``global_cursor`` is rank-agnostic; only
        batches fully handed out are counted). JSON-serializable; lands
        in the checkpoint manifest (docs/resilience.md)."""
        return {"version": STATE_VERSION,
                "epoch": int(self._epoch),
                "global_cursor": int(self._cursor),
                "epochs_done": int(self._epochs_done),
                "batch_size": int(self.batch_size),
                "num_parts": int(self.stream.num_parts),
                "seed": int(self.stream.seed),
                "shuffle": bool(self.stream.shuffle),
                "chunk_records": int(self.stream.chunk_records),
                **self.stream.identity()}

    def restore(self, state):
        """Resume from a token produced by :meth:`state` (possibly under
        a different ``num_parts``). The dataset identity and the order
        parameters (seed / shuffle / chunk size) must match — they
        define the sequence being resumed; a mismatch raises instead of
        silently re-sampling."""
        state = dict(state)
        if state.get("version") != STATE_VERSION:
            raise ValueError(
                f"unsupported stream-state version "
                f"{state.get('version')!r} (this build writes "
                f"{STATE_VERSION})")
        ident = self.stream.identity()
        for key in ("shards", "num_records"):
            if state.get(key) != ident[key]:
                raise ValueError(
                    f"stream state was saved over a different dataset "
                    f"({key}: {state.get(key)!r} != {ident[key]!r})")
        for key, have in (("seed", self.stream.seed),
                          ("shuffle", self.stream.shuffle),
                          ("chunk_records", self.stream.chunk_records),
                          ("batch_size", self.batch_size)):
            if state.get(key) != have:
                raise ValueError(
                    f"stream state {key}={state.get(key)!r} does not "
                    f"match this iterator's {key}={have!r}; the resumed "
                    "sequence would differ from the saved one")
        cursor = int(state["global_cursor"])
        if not 0 <= cursor <= self.stream.num_records:
            raise ValueError(f"stream-state cursor {cursor} out of range")
        self._epoch = int(state["epoch"])
        self._cursor = cursor
        self._epochs_done = int(state.get("epochs_done", 0))
        self._order = None
        _STATS["io_stream_resumes"] += 1
        return self

    def position(self):
        """Lightweight live-position snapshot (alert evidence)."""
        return {"epoch": int(self._epoch),
                "global_cursor": int(self._cursor),
                "num_records": int(self.stream.num_records),
                "part_index": int(self.stream.part_index),
                "num_parts": int(self.stream.num_parts)}


# --------------------------------------------------------- device prefetch

_DONE = object()


class DevicePrefetcher:
    """Double-buffered device prefetch over a :class:`StreamBatchIter`.

    A daemon worker pulls host batches from ``it``, stages each array in
    pinned memory and copies it to ``placement.device`` on a copy stream
    of its own, recording an event behind the copy, into a bounded ring
    of ``depth`` batches (``MXNET_TPU_TORCH_DATA_PREFETCH``, default 2;
    0 = an inline copy on the caller's stream, no thread). ``__next__``
    pops a batch, makes the caller's stream wait on its event and hands
    the tensors over: ``(x, y)``, or ``(x, y, lengths)`` for token-length
    bucketed text, already on the device, so the ``step.data_wait`` span
    is the queue sync.

    ``placement`` is a ``ShardedTrainer.batch_sharding``
    (:class:`~mxnet_tpu_torch.parallel.trainer.BatchPlacement`): its
    device, and this rank's index among ``count`` ranks of the batch axes.
    When the stream is split over fewer parts than that (``for_pod``: a
    host's batch for its ranks), the rank takes its own rows of each host
    batch, host-major, so ``step`` receives this rank's rows already on
    its device and copies nothing. Without a placement the batch goes to
    the current device whole.

    ``state()`` is the resume token of the last batch HANDED TO THE
    CONSUMER: ring contents never handed out are dropped by a restore and
    made again from the source, never replayed.
    """

    def __init__(self, it, sharding=None, depth=None):
        if depth is None:
            depth = int(os.environ.get("MXNET_TPU_TORCH_DATA_PREFETCH", "2"))
        self.depth = max(0, int(depth))
        self._it = it
        self._placement = sharding
        self._device = self._target_device(sharding)
        self._copy_stream = None
        self.last_state = it.state()
        self._finished = False
        self._q = None
        self._stop = None
        self._thread = None
        if self.depth:
            self._start()

    @classmethod
    def for_trainer(cls, trainer, it, depth=None):
        """Prefetch onto ``trainer``'s batch placement (a
        ``ShardedTrainer``'s ``batch_sharding``), so its ``step`` takes
        the batch where it lies."""
        return cls(it, sharding=getattr(trainer, "batch_sharding", None),
                   depth=depth)

    @staticmethod
    def _target_device(placement):
        import torch

        if placement is not None:
            return torch.device(placement.device)
        from ..context import current_context

        return current_context().torch_device()

    # ------------------------------------------------------------- worker

    def _start(self):
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(
            target=self._worker, name="mxnet-torch-data-prefetch",
            daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                item = (*self._put(batch), batch.state)
                if not self._enqueue(item):
                    return
            self._enqueue(_DONE)
        except BaseException as e:  # surfaced on the consumer's next()
            self._enqueue(e)

    def _enqueue(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                _STATS["io_prefetch_depth"] = self._q.qsize()
                return True
            except queue.Full:
                continue
        return False

    def _rows(self, arr):
        """This rank's rows of a host batch (all of them unless the stream
        has fewer parts than the placement's batch ranks)."""
        p = self._placement
        if p is None or int(p.count) <= 1:
            return arr
        parts = int(self._it.stream.num_parts)
        per_part, rem = divmod(int(p.count), parts)
        if rem or int(p.index) // max(per_part, 1) != \
                int(self._it.stream.part_index):
            raise ValueError(
                f"the stream's part {self._it.stream.part_index} of "
                f"{parts} does not hold batch rank {p.index} of {p.count}: "
                "build the iterator with part_index/num_parts from the "
                "trainer's batch_sharding (or StreamBatchIter.for_pod)")
        if per_part == 1:
            return arr
        rows, rem = divmod(int(arr.shape[0]), per_part)
        if rem:
            raise ValueError(
                f"a {arr.shape[0]}-row host batch does not split over the "
                f"{per_part} batch ranks of its part")
        local = int(p.index) % per_part
        return arr[local * rows:(local + 1) * rows]

    def _put(self, batch):
        """((tensors on the device), the event behind their copy or
        None)."""
        import torch

        with _obs_trace.span("data.h2d", rows=len(batch.data)):
            arrs = [batch.data, batch.label]
            if batch.length is not None:  # bucketed text: real lengths
                arrs.append(batch.length)
            host = [torch.from_numpy(_np.ascontiguousarray(self._rows(a)))
                    for a in arrs]
            if self._device.type != "cuda":
                return tuple(t.to(self._device) for t in host), None
            if self.depth == 0:
                return tuple(t.pin_memory().to(self._device,
                                               non_blocking=True)
                             for t in host), None
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self._device)
            with torch.cuda.stream(self._copy_stream):
                out = tuple(t.pin_memory().to(self._device,
                                              non_blocking=True)
                            for t in host)
                ev = torch.cuda.Event()
                ev.record(self._copy_stream)
        return out, ev

    # ----------------------------------------------------------- consumer

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self.depth != 0 and self._q is None:
            raise RuntimeError("DevicePrefetcher is closed")
        # the time the training loop stalls on input, both modes: the
        # ring pop (prefetching — the queue sync) or the whole inline
        # decode + copy (depth 0 — the cost prefetch hides)
        with _obs_trace.span("step.data_wait"):
            if self.depth == 0:
                batch = next(self._it)  # StopIteration ends the stream
                (xy, ev), state = self._put(batch), batch.state
            else:
                item = self._q.get()
                _STATS["io_prefetch_depth"] = self._q.qsize()
                if item is _DONE:
                    self._finished = True
                    raise StopIteration
                if isinstance(item, BaseException):
                    self._finished = True
                    raise item
                xy, ev, state = item
            if ev is not None:
                import torch

                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(ev)
                for t in xy:   # freed only after the consumer's use
                    t.record_stream(consumer)
        self.last_state = state
        return xy

    # ------------------------------------------------------------- resume

    def state(self):
        return dict(self.last_state)

    def restore(self, state):
        """Stop the worker, rewind the source to ``state``, and restart:
        whatever the ring held is dropped and made again from the
        restored position."""
        self.close()
        self._it.restore(state)
        self.last_state = self._it.state()
        self._finished = False
        if self.depth:
            self._start()
        return self

    def position(self):
        return self._it.position()

    def close(self, timeout=5.0):
        """Stop the prefetch worker and drain the ring. Raises if the
        worker did not exit within ``timeout``: a restore must never start
        a second worker while an orphaned one still advances the same
        source iterator; close() can be retried once the stuck decode
        ends."""
        if self._thread is None:
            return
        self._stop.set()
        while True:  # unblock a worker stuck in put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"prefetch worker still running after {timeout}s "
                "(wedged in a slow decode?); retry close() before "
                "restoring or restarting this prefetcher")
        self._thread = None
        self._q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
