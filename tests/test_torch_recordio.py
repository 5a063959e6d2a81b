"""The port's RecordIO (``mxnet_tpu_torch/recordio.py``) against
``mxnet_tpu/recordio.py`` on the CPU.

Tolerance: none. Both sides frame, index and hash the same bytes, so every
comparison is bitwise: files written by either package read in the other,
split records (cflag 1/2/3) re-join, a flipped byte fails the CRC of the
4-column ``.idx``, and the legacy 2-column ``.idx`` still loads.
"""
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads():
    """Headers with scalar and vector labels, raw bytes, a PNG and a JPEG
    image from a seed, and a payload holding the magic word (a plain
    writer keeps it whole, cflag 0)."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (9, 13, 3)).astype(np.uint8)
    out = [
        trec.pack(trec.IRHeader(0, 3.0, 7, 0), b"abc"),
        trec.pack(trec.IRHeader(0, [1.0, 2.5, -4.0], 8, 1), b""),
        trec.pack_img(trec.IRHeader(0, 5.0, 9, 0), img, img_fmt=".png"),
        trec.pack_img(trec.IRHeader(0, 6.0, 10, 0), img, quality=90),
        b"x" * 5 + MAGIC + b"y" * 6,
        bytes(rng.randint(0, 256, 1001).astype(np.uint8)),
    ]
    return out


def _write(lib, prefix, payloads):
    w = lib.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()


def _read(lib, prefix, n):
    r = lib.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    by_key = [r.read_idx(i) for i in range(n)]
    r.close()
    seq = lib.MXRecordIO(prefix + ".rec", "r")
    in_order = [seq.read() for _ in range(n)]
    assert seq.read() is None
    seq.close()
    assert by_key == in_order
    return by_key


@pytest.mark.parametrize("writer,reader", [(trec, jrec), (jrec, trec)])
def test_files_cross_read_bitwise(tmp_path, writer, reader):
    """Either package's .rec/.idx reads in the other, record for record;
    the two packages write byte-identical files."""
    payloads = _payloads()
    _write(writer, str(tmp_path / "w"), payloads)
    assert _read(reader, str(tmp_path / "w"), len(payloads)) == payloads
    other = trec if writer is jrec else jrec
    _write(other, str(tmp_path / "o"), payloads)
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("w" + ext)).read_bytes() == \
            (tmp_path / ("o" + ext)).read_bytes()
    assert trec.load_index(str(tmp_path / "w.idx")) == \
        [tuple(e) for e in jrec.load_index(str(tmp_path / "w.idx"))]


def test_pack_unpack_and_images_match():
    """pack / unpack / pack_img / unpack_img: the same bytes and arrays."""
    for p in _payloads()[:4]:
        th, ts = trec.unpack(p)
        jh, js = jrec.unpack(p)
        assert ts == js and th.flag == jh.flag and th.id == jh.id
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))
    img = np.random.RandomState(1).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)
    hdr = (0, 2.0, 3, 0)
    assert trec.pack_img(hdr, img, quality=80) == \
        jrec.pack_img(hdr, img, quality=80)
    buf = trec.pack_img(hdr, img, quality=80)
    for flag in (0, 1):
        np.testing.assert_array_equal(trec.unpack_img(buf, flag)[1],
                                      jrec.unpack_img(buf, flag)[1])


def _write_split(f, payload):
    chunks = payload.split(MAGIC)
    for i, chunk in enumerate(chunks):
        cflag = 1 if i == 0 else (3 if i == len(chunks) - 1 else 2)
        f.write(MAGIC + struct.pack("<I", (cflag << 29) | len(chunk)))
        f.write(chunk + b"\x00" * ((-len(chunk)) % 4))


def test_split_records(tmp_path):
    """A payload split at its magic words (kBegin/kMiddle/kEnd, as the
    dmlc-core writer leaves it) re-joins in both readers, and a split
    record left open is an error in both."""
    payload = b"A" * 10 + MAGIC + b"B" * 7 + MAGIC + b"C" * 3
    plain = b"D" * 9
    path = tmp_path / "split.rec"
    with open(path, "wb") as f:
        _write_split(f, payload)
        f.write(MAGIC + struct.pack("<I", len(plain)) + plain + b"\x00" * 3)
    for lib in (trec, jrec):
        r = lib.MXRecordIO(str(path), "r")
        assert (r.read(), r.read(), r.read()) == (payload, plain, None)
        r.close()
    cut = tmp_path / "cut.rec"
    cut.write_bytes(path.read_bytes()[:36])   # kBegin + kMiddle
    for lib in (trec, jrec):
        r = lib.MXRecordIO(str(cut), "r")
        with pytest.raises(ValueError, match="truncated split record"):
            r.read()
        r.close()


def test_crc_bit_flip_and_stale_length(tmp_path):
    """A byte flipped on disk fails the CRC of the 4-column index in both
    packages, naming the record; an index length that disagrees fails
    too; an unflipped record verifies."""
    payloads = _payloads()
    prefix = str(tmp_path / "d")
    _write(trec, prefix, payloads)
    raw = bytearray(open(prefix + ".rec", "rb").read())
    entries = trec.load_index(prefix + ".idx")
    raw[entries[3].offset + 8 + 40] ^= 0x10
    open(prefix + ".rec", "wb").write(bytes(raw))
    for lib in (trec, jrec):
        ents = lib.load_index(prefix + ".idx")
        with open(prefix + ".rec", "rb") as f:
            assert lib.read_record_at(f, ents[2], path="d.rec") == \
                payloads[2]
            with pytest.raises(lib.RecordCorruptError,
                               match="CRC32") as err:
                lib.read_record_at(f, ents[3], path="d.rec")
            assert (err.value.key, err.value.offset) == (3, ents[3].offset)
            bad = ents[2]._replace(length=ents[2].length + 1)
            with pytest.raises(lib.RecordCorruptError, match="bytes but"):
                lib.read_record_at(f, bad)
            off = ents[2]._replace(offset=ents[2].offset + 4)
            with pytest.raises(lib.RecordCorruptError,
                               match="unreadable record frame"):
                lib.read_record_at(f, off)


def test_armed_record_corrupt_fires_in_read_record_at(tmp_path):
    """Arming ``record_corrupt`` flips the middle byte of the next verified
    read, which the CRC then catches; the read after it is clean."""
    payloads = _payloads()
    prefix = str(tmp_path / "d")
    _write(trec, prefix, payloads)
    ents = trec.load_index(prefix + ".idx")
    faults.reset()
    try:
        with open(prefix + ".rec", "rb") as f:
            with faults.inject("record_corrupt") as fault:
                with pytest.raises(trec.RecordCorruptError, match="CRC32"):
                    trec.read_record_at(f, ents[5])
                assert fault.fired == 1
                assert trec.read_record_at(f, ents[5]) == payloads[5]
            with faults.inject("record_corrupt"):
                got = trec.read_record_at(f, ents[5], verify=False)
            mid = len(payloads[5]) // 2
            assert got[mid] == payloads[5][mid] ^ 0xFF
    finally:
        faults.reset()


def test_legacy_two_column_index(tmp_path):
    """A legacy ``key\\toffset`` index loads (length and CRC None) in both
    packages, the indexed reader takes it, and read_record_at reads
    without a CRC to check."""
    payloads = _payloads()
    prefix = str(tmp_path / "d")
    _write(trec, prefix, payloads)
    four = trec.load_index(prefix + ".idx")
    with open(prefix + ".idx", "w") as f:
        for e in four:
            f.write(f"{e.key}\t{e.offset}\n")
    for lib in (trec, jrec):
        ents = lib.load_index(prefix + ".idx")
        assert [(e.key, e.offset, e.length, e.crc32) for e in ents] == \
            [(e.key, e.offset, None, None) for e in four]
        assert _read(lib, prefix, len(payloads)) == payloads
        with open(prefix + ".rec", "rb") as f:
            assert lib.read_record_at(f, ents[1]) == payloads[1]
