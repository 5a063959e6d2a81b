"""RecordIO file format (port of ``mxnet_tpu/recordio.py``; parity:
python/mxnet/recordio.py: MXRecordIO :37, MXIndexedRecordIO :216, IRHeader
pack/unpack :344-387, and the dmlc-core RecordIO writer).

Each record is [kMagic u32][cflag:3 bits | length:29 bits u32][payload]
[pad to 4 bytes], a payload holding the magic word split into cflag
1/2/3 chunks. ``write_idx`` writes the 4-column ``.idx`` (key, offset,
logical length, CRC32) that :func:`read_record_at` verifies against;
:func:`load_index` also reads the legacy 2-column form. The bytes are
``mxnet_tpu``'s, so files written by either package read bitwise in the
other. numpy and PIL only: worker processes import this module.
"""
from __future__ import annotations

import numbers
import os
import struct
import zlib
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "IndexEntry",
           "RecordCorruptError", "load_index", "read_record_at", "pack",
           "unpack", "pack_img", "unpack_img"]

_kMagic = 0xced7230a


def _encode_flag_len(cflag, length):
    return (cflag << 29) | length


def _decode_flag_len(v):
    return v >> 29, v & ((1 << 29) - 1)


def read_logical_record(fileobj):
    """Read one logical record from `fileobj` at its current position.

    Handles split records (cflag kBegin=1/kMiddle=2/kEnd=3, produced when a
    payload contains the magic word): chunks are re-joined with the magic
    word re-inserted at each seam, matching the dmlc-core reader. Returns
    None at EOF. This is THE framing parser — the data pipeline
    (io/record_pipeline.py) delegates here; src/io/record_pipeline.cc
    mirrors the same rules natively.
    """
    chunks = None
    while True:
        hdr = fileobj.read(8)
        if len(hdr) < 8:
            if chunks is not None:
                raise ValueError("truncated split record")
            return None
        magic, fl = struct.unpack("<II", hdr)
        if magic != _kMagic:
            raise ValueError("invalid record magic")
        cflag, length = _decode_flag_len(fl)
        buf = fileobj.read(length)
        pad = (-length) % 4
        if pad:
            fileobj.read(pad)
        if chunks is None:
            if cflag == 0:
                return buf
            if cflag != 1:
                raise ValueError(f"unexpected continuation flag {cflag}")
            chunks = [buf]
        else:
            if cflag not in (2, 3):
                raise ValueError(f"unexpected record flag {cflag}")
            chunks.append(buf)
            if cflag == 3:
                return struct.pack("<I", _kMagic).join(chunks)


class MXRecordIO:
    """Reads/writes sequential RecordIO files (recordio.py:37)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.record = None
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["record"]
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        self.record = None
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in multiple processes")

    def close(self):
        if not self.is_open:
            return
        self.record.close()
        self.is_open = False
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid(allow_reset=False)
        self.record.write(struct.pack("<II", _kMagic,
                                      _encode_flag_len(0, len(buf))))
        self.record.write(buf)
        pad = (-len(buf)) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        """Read one logical record (split records re-joined; see
        read_logical_record)."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        return read_logical_record(self.record)

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with random access by key (recordio.py:216)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        self.fidx = open(self.idx_path, "w") if self.writable else None

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        pos = self.idx[idx]
        self.record.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        # extended index line: offset + logical payload length + CRC32,
        # so streaming consumers (io/stream.py) can range-read and
        # integrity-check each record without scanning the record
        # stream. Legacy readers (this class, the native pipeline)
        # parse the first two columns only, so the format stays
        # backward compatible (docs/data.md).
        self.fidx.write(f"{key}\t{pos}\t{len(buf)}\t"
                        f"{zlib.crc32(buf) & 0xFFFFFFFF}\n")
        self.idx[key] = pos
        self.keys.append(key)


# ------------------------------------------------------------ offset index

IndexEntry = namedtuple("IndexEntry", ["key", "offset", "length", "crc32"])
IndexEntry.__doc__ = """One parsed line of a ``.idx`` offset index.

``length`` (logical payload bytes) and ``crc32`` (payload checksum) come
from the extended 4-column form ``tools/im2rec.py`` / ``write_idx``
emit; both are None for legacy 2-column indexes."""


class RecordCorruptError(ValueError):
    """A record failed its integrity check on read (CRC32/length recorded
    in the offset index, or an unreadable frame at the indexed offset).
    Structured: ``path`` / ``key`` / ``offset`` name the damaged record so
    recovery tooling and the ``io_records_corrupt`` skip policy
    (io/stream.py, docs/data.md) can report precisely what was lost."""

    def __init__(self, message, path=None, key=None, offset=None):
        super().__init__(message)
        self.path = path
        self.key = key
        self.offset = offset


def load_index(path, key_type=int):
    """Parse a RecordIO offset index into ``[IndexEntry]`` (file order).

    Accepts both the legacy 2-column ``key\\toffset`` form and the
    extended 4-column ``key\\toffset\\tlength\\tcrc32`` form the repo's
    writers emit; extra columns beyond the first are ignored by the
    legacy readers, so one file serves both."""
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 2:
                continue
            entries.append(IndexEntry(
                key_type(parts[0]), int(parts[1]),
                int(parts[2]) if len(parts) > 2 else None,
                int(parts[3]) if len(parts) > 3 else None))
    return entries


def read_record_at(fileobj, entry, path=None, verify=True):
    """Range-read the logical record indexed by ``entry`` and verify its
    payload against the index's recorded length and CRC32 (when
    present). This is THE verified-read primitive the streaming
    ingestion layer (io/stream.py) is built on: no full-file scan, and
    a damaged record surfaces as a structured :class:`RecordCorruptError`
    — never as garbage bytes silently decoded into a batch.

    The ``record_corrupt`` fault kind (resilience.faults) injects a bit
    flip here, between the read and the verification, so the drill
    exercises the real detection path."""
    fileobj.seek(entry.offset)
    try:
        buf = read_logical_record(fileobj)
    except ValueError as e:
        raise RecordCorruptError(
            f"unreadable record frame at offset {entry.offset} of {path} "
            f"({e})", path=path, key=entry.key, offset=entry.offset) from e
    if buf is None:
        raise RecordCorruptError(
            f"no record at offset {entry.offset} of {path} (stale index?)",
            path=path, key=entry.key, offset=entry.offset)
    from .resilience import faults as _faults

    buf = _faults.maybe_corrupt_record(buf)
    if not verify:
        return buf
    if entry.length is not None and len(buf) != entry.length:
        raise RecordCorruptError(
            f"record {entry.key} at offset {entry.offset} of {path} is "
            f"{len(buf)} bytes but the index records {entry.length}",
            path=path, key=entry.key, offset=entry.offset)
    if entry.crc32 is not None:
        crc = zlib.crc32(buf) & 0xFFFFFFFF
        if crc != entry.crc32:
            raise RecordCorruptError(
                f"record {entry.key} at offset {entry.offset} of {path} "
                f"failed its CRC32 integrity check (index records "
                f"{entry.crc32:#010x}, payload hashes {crc:#010x})",
                path=path, key=entry.key, offset=entry.offset)
    return buf


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Packs a string payload with an IRHeader (recordio.py:344)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
        buf = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        buf = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                          header.id2) + label.tobytes()
    return buf + s


def unpack(s):
    """Unpacks an IRHeader + payload (recordio.py:365)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """Unpacks a record into header + decoded image (recordio.py:379)."""
    header, s = unpack(s)
    img = _imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Packs an image with an IRHeader (recordio.py:387)."""
    encoded = _imencode(img, quality, img_fmt)
    return pack(header, encoded)


def _imdecode(buf, iscolor=1):
    from io import BytesIO

    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image decode requires PIL") from e
    img = Image.open(BytesIO(buf.tobytes()))
    if iscolor == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
    return arr


def _imencode(img, quality=95, img_fmt=".jpg"):
    from io import BytesIO

    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image encode requires PIL") from e
    if hasattr(img, "asnumpy"):
        img = img.asnumpy()
    img = np.asarray(img).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    pil = Image.fromarray(img)
    bio = BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(bio, format=fmt, quality=quality)
    return bio.getvalue()
