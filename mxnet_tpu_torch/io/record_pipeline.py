"""ImageRecordIter — the RecordIO image training pipeline (port of
``mxnet_tpu/io/record_pipeline.py``; parity: the reference's
``mx.io.ImageRecordIter``, src/io/iter_image_recordio_2.cc).

Two backends assemble whole float32 NCHW batches on the host:

- ``_NativePipeline``, a ctypes driver over the unchanged
  ``src/io/record_pipeline.cc`` (OpenCV decode on a thread pool, a ring of
  ``prefetch_buffer`` batch slots). The library is built at first use
  with ``make -C src/io OUT=mxnet_tpu_torch/_build/libmxtpu_io.so`` under a
  file lock (ranks race to it); when the build fails the iterator warns and
  takes the Python backend (:func:`build_error` keeps the reason).
- ``_PyPipeline``: PIL decode on a thread pool, every sample drawn from its
  own ``RandomState`` seeded as ``mxnet_tpu``'s, so its batches are
  ``mxnet_tpu``'s Python pipeline's, bit for bit.

Batches land on the context current when the iterator was made (the
card unless made under ``with cpu():``), as ``mxnet_tpu``'s land on its
default device. For a card, a batch is assembled straight into one of two
pinned host buffers and reaches the card by one non-blocking copy; a
buffer is reused only after the event recorded behind its copy has
passed. A native
ring slot is copied into the pinned buffer on the host and released before
the card copy starts, so a decode worker never overwrites bytes in flight.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
import warnings

import numpy as _np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter", "load_native", "native_available",
           "build_error"]


class _CConfig(ctypes.Structure):
    # Field order/types mirror PipelineConfig in src/io/record_pipeline.cc.
    _fields_ = [
        ("batch_size", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("label_width", ctypes.c_int32),
        ("shuffle", ctypes.c_int32),
        ("seed", ctypes.c_uint32),
        ("num_threads", ctypes.c_int32),
        ("prefetch", ctypes.c_int32),
        ("rand_mirror", ctypes.c_int32),
        ("rand_crop", ctypes.c_int32),
        ("random_resized_crop", ctypes.c_int32),
        ("min_area", ctypes.c_float),
        ("max_area", ctypes.c_float),
        ("min_aspect", ctypes.c_float),
        ("max_aspect", ctypes.c_float),
        ("resize", ctypes.c_int32),
        ("mean", ctypes.c_float * 4),
        ("std", ctypes.c_float * 4),
        ("part_index", ctypes.c_int32),
        ("num_parts", ctypes.c_int32),
        ("round_batch", ctypes.c_int32),
        ("layout", ctypes.c_int32),
    ]


_lib = None
_lib_tried = False
_lib_error = None
_lib_lock = threading.Lock()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lib_path():
    return os.path.join(_PKG, "_build", "libmxtpu_io.so")


def build_error():
    """Why the native library could not be built or loaded (None when it
    loaded, or was never tried)."""
    return _lib_error


def load_native():
    """The native pipeline library, built at first use; None when it
    cannot be built or loaded (the reason in :func:`build_error`)."""
    global _lib, _lib_tried, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        path = _lib_path()
        if not os.path.exists(path):
            src = os.path.join(os.path.dirname(_PKG), "src", "io")
            if not os.path.isdir(src):
                _lib_error = f"no native source directory {src}"
                return None
            try:
                # several ranks of a fresh checkout race here: one builds
                os.makedirs(os.path.dirname(path), exist_ok=True)
                import fcntl

                with open(path + ".buildlock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(path):
                        subprocess.run(["make", "-C", src, f"OUT={path}"],
                                       check=True, capture_output=True,
                                       text=True)
            except subprocess.CalledProcessError as e:
                _lib_error = (e.stderr or e.stdout or str(e)).strip()
            except OSError as e:
                _lib_error = str(e)
            if _lib_error is not None:
                lines = _lib_error.splitlines() or [""]
                first = next((ln for ln in lines if "error" in ln),
                             lines[-1])
                warnings.warn(f"native data pipeline build failed "
                              f"({first.strip()}); falling back to the "
                              "Python loader")
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _lib_error = str(e)
            warnings.warn(f"cannot load {path}: {e}")
            return None
        lib.mxtpu_pipeline_create.restype = ctypes.c_void_p
        lib.mxtpu_pipeline_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(_CConfig)]
        lib.mxtpu_pipeline_next.restype = ctypes.c_int
        lib.mxtpu_pipeline_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int)]
        lib.mxtpu_pipeline_release.restype = None
        lib.mxtpu_pipeline_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mxtpu_pipeline_reset.restype = None
        lib.mxtpu_pipeline_reset.argtypes = [ctypes.c_void_p]
        lib.mxtpu_pipeline_destroy.restype = None
        lib.mxtpu_pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib.mxtpu_pipeline_size.restype = ctypes.c_int64
        lib.mxtpu_pipeline_size.argtypes = [ctypes.c_void_p]
        lib.mxtpu_pipeline_batches.restype = ctypes.c_int64
        lib.mxtpu_pipeline_batches.argtypes = [ctypes.c_void_p]
        lib.mxtpu_last_error.restype = ctypes.c_char_p
        lib.mxtpu_last_error.argtypes = []
        _lib = lib
        return _lib


def native_available():
    return load_native() is not None


def _build_config(batch_size, data_shape, label_width, shuffle, seed,
                  preprocess_threads, prefetch_buffer, rand_mirror, rand_crop,
                  random_resized_crop, min_random_area, max_random_area,
                  min_aspect_ratio, max_aspect_ratio, resize, mean, std,
                  part_index, num_parts, round_batch, layout):
    cfg = _CConfig()
    cfg.batch_size = batch_size
    cfg.channels, cfg.height, cfg.width = data_shape
    cfg.label_width = label_width
    cfg.shuffle = int(bool(shuffle))
    cfg.seed = seed & 0xFFFFFFFF
    cfg.num_threads = preprocess_threads
    cfg.prefetch = prefetch_buffer
    cfg.rand_mirror = int(bool(rand_mirror))
    cfg.rand_crop = int(bool(rand_crop))
    cfg.random_resized_crop = int(bool(random_resized_crop))
    cfg.min_area, cfg.max_area = min_random_area, max_random_area
    cfg.min_aspect, cfg.max_aspect = min_aspect_ratio, max_aspect_ratio
    cfg.resize = resize
    for i in range(4):
        cfg.mean[i] = mean[i] if i < len(mean) else 0.0
        # std=0 means "unset" in the reference's parameterization; coerce
        # here so the native and Python backends agree.
        cfg.std[i] = (std[i] or 1.0) if i < len(std) else 1.0
    cfg.part_index, cfg.num_parts = part_index, num_parts
    cfg.round_batch = int(bool(round_batch))
    cfg.layout = layout
    return cfg


class _Staging:
    """Two pinned host buffer pairs a batch is assembled in, and the
    non-blocking copy of a pair to the card. A pair is handed out again
    only once the event behind its last copy has passed."""

    def __init__(self, dshape, lshape, device):
        self.device = device
        self._pairs = [(torch.empty(dshape, dtype=torch.float32,
                                    pin_memory=True),
                        torch.empty(lshape, dtype=torch.float32,
                                    pin_memory=True)) for _ in range(2)]
        self._events = [None, None]
        self._i = 0

    def acquire(self):
        """numpy views of the next free pinned pair."""
        ev = self._events[self._i]
        if ev is not None:
            ev.synchronize()
        d, lab = self._pairs[self._i]
        return d.numpy(), lab.numpy()

    def upload(self):
        """The pair last acquired, on the card (one copy each, queued on
        the current stream); the pair is held until that copy is done."""
        d, lab = self._pairs[self._i]
        out_d = d.to(self.device, non_blocking=True)
        out_l = lab.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[self._i] = ev
        self._i ^= 1
        return out_d, out_l


class ImageRecordIter(DataIter):
    """RecordIO image iterator (reference surface: mx.io.ImageRecordIter,
    src/io/iter_image_recordio_2.cc).

    Parameters follow the reference: ``path_imgrec``, ``path_imgidx``,
    ``data_shape`` (C, H, W), ``batch_size``, ``shuffle``, ``rand_crop``,
    ``rand_mirror``, ``random_resized_crop`` (+ ``min_random_area``/
    ``max_random_area``/``min_aspect_ratio``/``max_aspect_ratio``),
    ``resize`` (shorter side), ``mean_r/g/b``, ``std_r/g/b``,
    ``label_width``, ``preprocess_threads``, ``prefetch_buffer``,
    ``num_parts``/``part_index`` (sharding), ``round_batch``, ``seed``.
    ``force_python`` takes the Python backend; :attr:`backend` names the
    one that runs. Batches land on the context current at construction.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, random_resized_crop=False,
                 min_random_area=0.08, max_random_area=1.0,
                 min_aspect_ratio=3.0 / 4.0, max_aspect_ratio=4.0 / 3.0,
                 resize=0, mean_r=0.0, mean_g=0.0, mean_b=0.0, mean_a=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, std_a=1.0, label_width=1,
                 preprocess_threads=4, prefetch_buffer=4, num_parts=1,
                 part_index=0, round_batch=True, seed=0,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 force_python=False, **kwargs):
        super().__init__(batch_size)
        if kwargs:
            warnings.warn(f"ImageRecordIter: ignoring unsupported arguments "
                          f"{sorted(kwargs)}")
        data_shape = tuple(int(d) for d in data_shape)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        if data_shape[0] not in (1, 3):
            raise MXNetError("channels must be 1 (grayscale) or 3 (RGB), "
                             f"got {data_shape[0]}")
        self._data_shape = data_shape
        self._label_width = label_width
        self._data_name, self._label_name = data_name, label_name
        self._dtype = _np.dtype(dtype)
        self._pad = 0
        self._ctx = current_context()
        mean = (mean_r, mean_g, mean_b, mean_a)
        std = (std_r, std_g, std_b, std_a)
        cfg = _build_config(
            batch_size, data_shape, label_width, shuffle, seed,
            preprocess_threads, prefetch_buffer, rand_mirror, rand_crop,
            random_resized_crop, min_random_area, max_random_area,
            min_aspect_ratio, max_aspect_ratio, resize, mean, std,
            part_index, num_parts, round_batch, layout=0)
        lib = None if force_python else load_native()
        if lib is not None:
            self._impl = _NativePipeline(lib, path_imgrec, path_imgidx, cfg)
            self.backend = "native"
        else:
            self._impl = _PyPipeline(path_imgrec, cfg,
                                     idx_path=path_imgidx)
            self.backend = "python"
        device = self._ctx.torch_device()
        self._staging = (_Staging((batch_size,) + data_shape,
                                  (batch_size, label_width), device)
                         if device.type == "cuda" else None)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape, self._dtype)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        return [DataDesc(self._label_name, shape, self._dtype)]

    def __len__(self):
        return self._impl.num_batches

    @property
    def num_samples(self):
        return self._impl.num_samples

    def reset(self):
        self._impl.reset()

    def next(self):
        bufs = None if self._staging is None else self._staging.acquire()
        out = self._impl.next(*(bufs or ()))
        if out is None:
            raise StopIteration
        data, label, pad = out
        self._pad = pad
        if self._staging is not None:
            data, label = self._staging.upload()
        else:
            data, label = torch.from_numpy(data), torch.from_numpy(label)
        if self._label_width == 1:
            label = label.reshape(self.batch_size)
        if self._dtype != _np.float32:
            from ..base import torch_dtype

            data = data.to(torch_dtype(self._dtype))
            label = label.to(torch_dtype(self._dtype))
        return DataBatch(data=[NDArray(data, self._ctx)],
                         label=[NDArray(label, self._ctx)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._next_batch.data

    def getlabel(self):
        return self._next_batch.label

    def getpad(self):
        return self._pad


class _NativePipeline:
    """ctypes driver for src/io/record_pipeline.cc."""

    def __init__(self, lib, rec_path, idx_path, cfg):
        self._lib = lib
        self._cfg = cfg
        self._h = lib.mxtpu_pipeline_create(
            rec_path.encode(), (idx_path or "").encode(), ctypes.byref(cfg))
        if not self._h:
            raise MXNetError("native pipeline: " +
                             lib.mxtpu_last_error().decode())
        self.num_samples = lib.mxtpu_pipeline_size(self._h)
        self.num_batches = lib.mxtpu_pipeline_batches(self._h)
        self._dshape = (cfg.batch_size, cfg.channels, cfg.height, cfg.width)
        self._lshape = (cfg.batch_size, cfg.label_width)

    def next(self, data=None, label=None):
        """The next batch as (data, label, pad), copied out of the borrowed
        ring slot into ``data``/``label`` (fresh arrays when None) before
        the slot is released; None at the epoch's end."""
        data_p = ctypes.POINTER(ctypes.c_float)()
        label_p = ctypes.POINTER(ctypes.c_float)()
        pad = ctypes.c_int()
        slot = self._lib.mxtpu_pipeline_next(
            self._h, ctypes.byref(data_p), ctypes.byref(label_p),
            ctypes.byref(pad))
        if slot < 0:
            return None
        try:
            src_d = _np.ctypeslib.as_array(data_p, shape=self._dshape)
            src_l = _np.ctypeslib.as_array(label_p, shape=self._lshape)
            if data is None:
                data, label = src_d.copy(), src_l.copy()
            else:
                _np.copyto(data, src_d)
                _np.copyto(label, src_l)
        finally:
            self._lib.mxtpu_pipeline_release(self._h, slot)
        return data, label, pad.value

    def reset(self):
        self._lib.mxtpu_pipeline_reset(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mxtpu_pipeline_destroy(self._h)
            self._h = None


class _PyPipeline:
    """Pure-Python backend with the native one's batch semantics (PIL
    decode); bitwise ``mxnet_tpu``'s ``_PyPipeline``."""

    def __init__(self, rec_path, cfg, idx_path=None):
        self._cfg = cfg
        # offset of each logical record's first frame: from the .idx
        # offset index when one exists (range reads, no full-file scan),
        # else a sequential framing scan
        self._records = self._load_index_offsets(rec_path, idx_path)
        if self._records is None:
            self._records = self._scan_offsets(rec_path)
        self._rec_path = rec_path
        self._tls = threading.local()
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=max(1, cfg.num_threads))
        if cfg.num_parts > 1:
            self._records = self._records[cfg.part_index::cfg.num_parts]
        if not self._records:
            raise MXNetError("no records in shard")
        self.num_samples = len(self._records)
        bs = cfg.batch_size
        self.num_batches = ((self.num_samples + bs - 1) // bs
                            if cfg.round_batch else self.num_samples // bs)
        if self.num_batches == 0:  # match the native backend's behavior
            raise MXNetError(
                "fewer records than batch_size and round_batch=0")
        self._order = _np.arange(self.num_samples)
        self._epoch = 0
        self._start_epoch(first=True)

    @staticmethod
    def _load_index_offsets(rec_path, idx_path):
        """Record offsets from the .idx index, or None when the index is
        absent or fails a cheap sanity check (a stale index must fall
        back to the scan, like the native reader does)."""
        if not idx_path or not os.path.isfile(idx_path):
            return None
        from ..recordio import load_index, read_logical_record

        try:
            offsets = [e.offset for e in load_index(idx_path)]
        except (OSError, ValueError):
            return None
        size = os.path.getsize(rec_path)
        if not offsets or offsets != sorted(offsets) \
                or offsets[0] != 0 or offsets[-1] >= size:
            return None
        # the index must reach EOF: an index from an earlier, shorter pack
        # of the same data passes every offset check but would silently
        # drop the trailing records
        try:
            with open(rec_path, "rb") as f:
                f.seek(offsets[-1])
                if read_logical_record(f) is None or f.tell() != size:
                    return None
        except (OSError, ValueError):
            return None
        return offsets

    @staticmethod
    def _scan_offsets(rec_path):
        from ..recordio import _decode_flag_len, _kMagic

        records = []
        with open(rec_path, "rb") as f:
            off = 0
            in_split = False
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                magic, fl = struct.unpack("<II", hdr)
                if magic != _kMagic:
                    raise MXNetError("bad record magic")
                cflag, length = _decode_flag_len(fl)
                if not in_split:
                    records.append(off)
                    in_split = cflag == 1  # kBegin
                elif cflag == 3:  # kEnd
                    in_split = False
                elif cflag != 2:  # not kMiddle
                    raise MXNetError("bad record framing")
                skip = (length + 3) & ~3
                f.seek(off + 8 + skip)
                off += 8 + skip
            if in_split:
                raise MXNetError("truncated split record")
        return records

    def _start_epoch(self, first=False):
        if not first:
            self._epoch += 1
        if self._cfg.shuffle:
            _np.random.RandomState(
                self._cfg.seed + self._epoch).shuffle(self._order)
        self._cursor = 0

    def _file(self):
        # One handle per pool thread: seek/read pairs must not interleave.
        f = getattr(self._tls, "f", None)
        if f is None:
            f = open(self._rec_path, "rb")
            self._tls.f = f
        return f

    def _read_logical(self, off):
        from ..recordio import read_logical_record

        f = self._file()
        f.seek(off)
        return read_logical_record(f)

    def _decode(self, rec_i, rng):
        from io import BytesIO

        from PIL import Image

        from ..recordio import unpack

        cfg = self._cfg
        buf = self._read_logical(self._records[rec_i])
        header, payload = unpack(buf)
        lab = _np.atleast_1d(_np.asarray(header.label, dtype=_np.float32))
        label = _np.zeros(cfg.label_width, dtype=_np.float32)
        label[:min(cfg.label_width, lab.size)] = lab[:cfg.label_width]

        img = Image.open(BytesIO(payload))
        img = img.convert("L" if cfg.channels == 1 else "RGB")
        W, H = cfg.width, cfg.height
        if cfg.random_resized_crop:
            src_area = img.size[0] * img.size[1]
            done = False
            for _ in range(10):
                area = src_area * rng.uniform(cfg.min_area, cfg.max_area)
                aspect = _np.exp(rng.uniform(_np.log(cfg.min_aspect),
                                             _np.log(cfg.max_aspect)))
                cw = int(round(_np.sqrt(area * aspect)))
                ch = int(round(_np.sqrt(area / aspect)))
                if 0 < cw <= img.size[0] and 0 < ch <= img.size[1]:
                    x = rng.randint(0, img.size[0] - cw + 1)
                    y = rng.randint(0, img.size[1] - ch + 1)
                    img = img.crop((x, y, x + cw, y + ch)).resize((W, H))
                    done = True
                    break
            if not done:
                side = min(img.size)
                x = (img.size[0] - side) // 2
                y = (img.size[1] - side) // 2
                img = img.crop((x, y, x + side, y + side)).resize((W, H))
        else:
            if cfg.resize > 0:
                scale = cfg.resize / min(img.size)
                img = img.resize((max(W, int(round(img.size[0] * scale))),
                                  max(H, int(round(img.size[1] * scale)))))
            if img.size != (W, H):
                if img.size[0] < W or img.size[1] < H:
                    img = img.resize((W, H))
                elif cfg.rand_crop:
                    x = rng.randint(0, img.size[0] - W + 1)
                    y = rng.randint(0, img.size[1] - H + 1)
                    img = img.crop((x, y, x + W, y + H))
                else:
                    x = (img.size[0] - W) // 2
                    y = (img.size[1] - H) // 2
                    img = img.crop((x, y, x + W, y + H))
        arr = _np.asarray(img, dtype=_np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if cfg.rand_mirror and rng.randint(0, 2):
            arr = arr[:, ::-1]
        mean = _np.array([cfg.mean[c] for c in range(cfg.channels)],
                         dtype=_np.float32)
        std = _np.array([cfg.std[c] for c in range(cfg.channels)],
                        dtype=_np.float32)
        arr = (arr - mean) / std
        return arr.transpose(2, 0, 1), label  # NCHW

    def next(self, data=None, label=None):
        """The next batch as (data, label, pad), assembled into
        ``data``/``label`` (fresh arrays when None); None at the epoch's
        end."""
        cfg = self._cfg
        bs = cfg.batch_size
        if self._cursor >= self.num_batches:
            return None
        b = self._cursor
        if data is None:
            data = _np.zeros((bs, cfg.channels, cfg.height, cfg.width),
                             dtype=_np.float32)
            label = _np.zeros((bs, cfg.label_width), dtype=_np.float32)
        pad = max(0, (b + 1) * bs - self.num_samples)

        def _one(pos):
            sample = b * bs + pos
            rec_i = self._order[sample % self.num_samples]
            rng = _np.random.RandomState(
                (cfg.seed * 2654435761 + self._epoch * 97 + sample)
                & 0xFFFFFFFF)
            data[pos], label[pos] = self._decode(rec_i, rng)

        # Per-sample RNGs are independently seeded, so pool scheduling
        # doesn't affect determinism.
        list(self._pool.map(_one, range(bs)))
        self._cursor += 1
        return data, label, pad

    def reset(self):
        self._start_epoch()
