"""ctypes binding of the host-side ingest runtime, ``native/sonic_native.cpp``.

The port's own copy of the JAX package's ``native/__init__.py``: PCM16
conversion, RMS/peak telemetry and ``NativeChunkRing``, the fixed-chunk
monotonic ring that ``stream/buffer.py`` stores a session's audio in. This
is host code, not a kernel.

g++ builds the library on first use into
``build/native/libsonic_native-<digest>.so`` at the root of the checkout,
or ``$SONIC_KERNEL_DIR/native`` where that variable names a deploy
directory (ops/_build.py, tools/prewarm.py); the digest covers the source
and the flags, so an edited source builds anew. ``load()`` returns the
bound library, or None where g++ or the source is missing; callers then
take the NumPy versions, as in the JAX package. ``library_counts``: built
with g++ in this process, loaded prebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from sonicscribe_tpu_torch.ops._build import KERNEL_DIR_ENV

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "sonic_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

library_counts = {"built": 0, "loaded": 0}

_lock = threading.Lock()
_lib = None
_tried = False


def build_dir() -> Path:
    """``native/`` of the deploy directory $SONIC_KERNEL_DIR, else BUILD_DIR."""
    root = os.environ.get(KERNEL_DIR_ENV)
    return Path(root) / "native" if root else BUILD_DIR


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"libsonic_native-{digest}.so"


def build() -> Optional[Path]:
    """Compile the library with g++ if it is missing. -> its path, or None."""
    if not SOURCE.exists():
        return None
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")  # processes may build at once
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning("native build failed (%s); using NumPy fallback", e)
        return None
    os.replace(tmp, out)
    library_counts["built"] += 1
    return out


def load():
    """The bound library (built on first use), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        built = library_counts["built"]
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native load failed (%s); using NumPy fallback", e)
            return None
        if library_counts["built"] == built:
            library_counts["loaded"] += 1

        i64, f32p, i16p, u8p = (
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_uint8),
        )
        lib.sonic_pcm16_to_f32.argtypes = [i16p, i64, f32p]
        lib.sonic_pcm16_to_f32.restype = None
        lib.sonic_rms_peak.argtypes = [i16p, i64, f32p, f32p]
        lib.sonic_rms_peak.restype = None
        lib.sonic_ring_create.restype = ctypes.c_void_p
        lib.sonic_ring_create.argtypes = [i64, i64]
        lib.sonic_ring_free.argtypes = [ctypes.c_void_p]
        lib.sonic_ring_free.restype = None
        lib.sonic_ring_push.restype = i64
        lib.sonic_ring_push.argtypes = [ctypes.c_void_p, u8p]
        lib.sonic_ring_next_id.restype = i64
        lib.sonic_ring_next_id.argtypes = [ctypes.c_void_p]
        lib.sonic_ring_oldest_id.restype = i64
        lib.sonic_ring_oldest_id.argtypes = [ctypes.c_void_p]
        lib.sonic_ring_read_range_f32.restype = i64
        lib.sonic_ring_read_range_f32.argtypes = [ctypes.c_void_p, i64, i64, f32p]
        _lib = lib
        return _lib


def pcm16_to_f32(data: bytes) -> np.ndarray:
    """Little-endian PCM16 -> float32 in [-1, 1)."""
    lib = load()
    n = len(data) // 2
    if lib is None:
        return np.frombuffer(data[: n * 2], dtype="<i2").astype(np.float32) / 32768.0
    out = np.empty(n, np.float32)
    src = np.frombuffer(data[: n * 2], dtype=np.int16)
    lib.sonic_pcm16_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def rms_peak(data: bytes) -> tuple[float, float]:
    """(RMS, peak) of a PCM16 frame, in float units."""
    lib = load()
    n = len(data) // 2
    src = np.frombuffer(data[: n * 2], dtype=np.int16)
    if lib is None:
        if not n:
            return 0.0, 0.0
        x = src.astype(np.float32) / 32768.0
        return float(np.sqrt(np.mean(x * x))), float(np.max(np.abs(x)))
    rms, peak = ctypes.c_float(), ctypes.c_float()
    lib.sonic_rms_peak(src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
                       ctypes.byref(rms), ctypes.byref(peak))
    return rms.value, peak.value


class NativeChunkRing:
    """Fixed-chunk monotonic ring over the C++ implementation: ids count
    up from 0, and the oldest chunks are dropped beyond `capacity_chunks`.
    Raises where the library is unavailable (`available()` says)."""

    @staticmethod
    def available() -> bool:
        return load() is not None

    def __init__(self, capacity_chunks: int, chunk_bytes: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._ring = self._lib.sonic_ring_create(capacity_chunks, chunk_bytes)
        if not self._ring:
            raise MemoryError("sonic_ring_create failed")
        self.chunk_bytes = chunk_bytes
        self.samples_per_chunk = chunk_bytes // 2

    def push(self, data: bytes) -> int:
        if len(data) != self.chunk_bytes:
            raise ValueError(f"chunk must be {self.chunk_bytes} bytes")
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.sonic_ring_push(self._ring, buf)

    @property
    def next_id(self) -> int:
        return self._lib.sonic_ring_next_id(self._ring)

    @property
    def oldest_id(self) -> int:
        return self._lib.sonic_ring_oldest_id(self._ring)

    def read_f32(self, start_id: int, end_id: int) -> np.ndarray:
        """Chunks [start_id, end_id] as one float32 array (evicted ids skipped)."""
        n = max(0, end_id - start_id + 1)
        out = np.empty(n * self.samples_per_chunk, np.float32)
        got = self._lib.sonic_ring_read_range_f32(
            self._ring, start_id, end_id, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out[: got * self.samples_per_chunk]

    def __del__(self):
        lib, ring = getattr(self, "_lib", None), getattr(self, "_ring", None)
        if lib is not None and ring:
            lib.sonic_ring_free(ring)
            self._ring = None
