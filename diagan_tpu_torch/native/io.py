"""ctypes bindings for the port's native host-data runtime (diagan_io.cpp).

The port's copy of diagan_tpu/native/io.py. The shared library is built with
g++ at first use into diagan_tpu_torch/build/ (listed in .gitignore) under a
name that carries the hash of the source, the flags and the CPU's feature
flags, so an edited source is rebuilt and a library built on another CPU is
never loaded. The flags are the JAX package's, -march=native included (the
dequantize's multiply-add then contracts alike), so the two libraries give
the same bits on one machine. There is no numpy fallback: a fallback would draw another
index stream than the JAX package's for the same seed, so a failed build or
load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "diagan_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB = None


def _cpu_features() -> str:
    """What -march=native compiles for: the CPU's feature flags (Linux), else
    the machine's architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


def _target() -> Path:
    key = _SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + _cpu_features().encode()
    return BUILD_DIR / f"libdiagan_io-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(so):
    """Compile into a temporary file and rename it into place, so processes
    that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _target()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.ws_create.restype = ctypes.c_void_p
        lib.ws_create.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        lib.ws_sample.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.ws_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.normalize_u8_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int]
        lib.gather_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
        return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeWeightedSampler:
    """O(1)-per-draw alias-method sampler over `weights` (any non-negative
    scale), with replacement: the WeightedRandomSampler equivalent."""

    def __init__(self, weights, seed=0):
        self._w = np.ascontiguousarray(weights, np.float64)
        self._lib = _load()
        self._h = self._lib.ws_create(_ptr(self._w), len(self._w), ctypes.c_uint64(seed))

    def sample(self, count) -> np.ndarray:
        """int64 (count,) indices; the stream continues across calls."""
        out = np.empty(count, np.int64)
        self._lib.ws_sample(self._h, _ptr(out), count)
        return out

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ws_destroy(self._h)
            self._h = None


class NativeLoader:
    """Threaded prefetching (batch, idx) stream over a uint8 array, drawn
    weighted (alias sampler) or uniformly. Yields (float32 (B, ...) in
    [-1, 1], int64 (B,)). With more than one thread the order in which
    batches arrive is the threads' race; with one it is the draw order."""

    def __init__(self, images: np.ndarray, batch_size: int, weights=None, n_threads: int = 4,
                 queue_cap: int = 8, seed: int = 0):
        self.images = np.ascontiguousarray(images)
        if self.images.dtype != np.uint8:
            raise TypeError(f"NativeLoader takes uint8 images, got {self.images.dtype}")
        self.item_shape = self.images.shape[1:]
        self.item_elems = int(np.prod(self.item_shape))
        self.batch_size = batch_size
        self._lib = _load()
        w = None
        if weights is not None:
            self._wbuf = np.ascontiguousarray(weights, np.float64)
            w = _ptr(self._wbuf)
        self._h = self._lib.dl_create(_ptr(self.images), len(self.images), self.item_elems, w,
                                      batch_size, n_threads, queue_cap, ctypes.c_uint64(seed))

    def next(self):
        data = np.empty((self.batch_size, self.item_elems), np.float32)
        idx = np.empty(self.batch_size, np.int64)
        if not self._lib.dl_next(self._h, _ptr(data), _ptr(idx)):
            raise StopIteration
        return data.reshape((self.batch_size,) + self.item_shape), idx

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def gather_u8(images: np.ndarray, idx, threads: int = 4, out=None) -> np.ndarray:
    """out[i] = images[idx[i]] through the threaded native gather. `images`
    is a C-contiguous uint8 array, e.g. a read-only np.memmap (only the
    touched pages are read); `out`, when given, is a C-contiguous uint8
    array of shape (len(idx),) + images.shape[1:] (e.g. a pinned buffer's
    numpy view) and is filled in place."""
    if images.dtype != np.uint8:
        raise TypeError(f"gather_u8 takes uint8 images, got {images.dtype}")
    if not images.flags.c_contiguous:
        raise ValueError("gather_u8 takes a C-contiguous array")
    idx = np.ascontiguousarray(idx, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(images)):
        raise IndexError(f"gather_u8 index out of range [0, {len(images)})")
    shape = (len(idx),) + images.shape[1:]
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}")
    _load().gather_u8(_ptr(images), int(np.prod(images.shape[1:])), _ptr(idx), len(idx),
                      _ptr(out), threads)
    return out


def normalize_u8(images: np.ndarray, threads: int = 8) -> np.ndarray:
    """uint8 -> float32 in [-1, 1], threaded."""
    flat = np.ascontiguousarray(images, np.uint8).reshape(-1)
    out = np.empty(flat.shape, np.float32)
    _load().normalize_u8_f32(_ptr(flat), _ptr(out), len(flat), threads)
    return out.reshape(np.shape(images))
