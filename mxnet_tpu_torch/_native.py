"""ctypes bindings to the native I/O runtime (``native/mxtpu_io.cc``).

The port's copy of ``mxnet_tpu/_native.py`` (reference: the C++ data path,
dmlc recordio and the OMP JPEG decode of
``src/io/iter_image_recordio_2.cc``).  ``native/mxtpu_io.cc`` is host C++
shared by both packages and used as it stands: this module compiles it
with ``g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpthread`` at first
use into ``mxnet_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name hashed from the source and the flags, so an edited source never loads
a stale library; it never writes under ``native/``.  Where the build fails
(no ``g++``, no ``jpeglib.h`` or ``libjpeg``), :func:`available` is False
and the callers take their OpenCV path (``image.ImageIter``).  Nothing
here runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_BUILD_ERROR = None
_LOCK = threading.Lock()

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "mxtpu_io.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")


def library_path():
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, "libmxtpu_io-%s.so" % digest)


def _build(so):
    # compile to a temp path and rename atomically so a concurrent process
    # never CDLLs a partially written .so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError("%s failed: %s" % (" ".join(cmd),
                                              e.stderr.strip())) from e
    os.replace(tmp, so)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED, _BUILD_ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = library_path()
            if not os.path.isfile(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.mxtpu_recordio_index.restype = ctypes.c_long
            lib.mxtpu_recordio_index.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_long]
            lib.mxtpu_recordio_read.restype = ctypes.c_long
            lib.mxtpu_recordio_read.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
            lib.mxtpu_decode_batch.restype = ctypes.c_long
            lib.mxtpu_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_long), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            if lib.mxtpu_version() < 1:
                raise RuntimeError("mxtpu_version() < 1")
            _LIB = lib
        except (OSError, RuntimeError) as e:
            _BUILD_ERROR = str(e)
            _LIB = None
        return _LIB


def available():
    return get_lib() is not None


def recordio_index(path):
    """Record offsets of a .rec file via the native scanner (fast path)."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.mxtpu_recordio_index(path.encode(), None, 0)
    if n < 0:
        return None
    offsets = (ctypes.c_long * n)()
    lib.mxtpu_recordio_index(path.encode(), offsets, n)
    return list(offsets)


_read_buf = None
_read_lock = threading.Lock()


def recordio_read(path, offset, max_len=1 << 22):
    """Read one record payload at a byte offset via the native reader.
    A module-level buffer is reused under a lock (pipelines run on
    background threads) and grown up to 64 MB when a record exceeds it."""
    global _read_buf
    lib = get_lib()
    if lib is None:
        return None
    with _read_lock:
        if _read_buf is None or len(_read_buf) < max_len:
            _read_buf = (ctypes.c_uint8 * max_len)()
        n = lib.mxtpu_recordio_read(path.encode(), offset, _read_buf,
                                    len(_read_buf))
        if n < 0 and len(_read_buf) < (1 << 26):
            # maybe just a too-small buffer: one retry at the 64 MB cap
            _read_buf = (ctypes.c_uint8 * (1 << 26))()
            n = lib.mxtpu_recordio_read(path.encode(), offset, _read_buf,
                                        len(_read_buf))
        if n < 0:
            return None
        return ctypes.string_at(_read_buf, n)


def default_threads():
    """Decode threads when the caller passes none: ``min(nproc, 16)``."""
    return min(os.cpu_count() or 1, 16)


def decode_batch(buffers, out_h, out_w, channels=3, resize_short=0,
                 num_threads=0):
    """Parallel JPEG decode+resize+crop into an (N, H, W, C) uint8 array.
    `buffers` is a list of bytes objects.  Returns (array, n_failures) or
    None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buffers)
    out = np.empty((n, out_h, out_w, channels), np.uint8)
    bufs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_long * n)(*[len(b) for b in buffers])
    if num_threads <= 0:
        num_threads = default_threads()
    fails = lib.mxtpu_decode_batch(
        bufs, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h, out_w, channels, resize_short, num_threads)
    return out, int(fails)
