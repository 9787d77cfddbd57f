"""Build the port's CUDA kernels at first use and load them with ctypes.

Each hand-written kernel is one ``mxnet_tpu_torch/csrc/<name>.cu`` with a
plain C interface.  :func:`load` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``mxnet_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags so
an edited source never loads a stale library, and returns the
``ctypes.CDLL``.  :func:`load_source` does the same for a source the
program emits (the mxgen kernels of ``analysis/codegen.py``): the text is
written into the build directory under the same hash.  :func:`build_all`
starts one ``nvcc`` per source at once.  Nothing here runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["load", "load_source", "build_all", "source_path",
           "KERNEL_SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# every kernel source of the port, by name
KERNEL_SOURCES = ("fused_ln", "fused_optimizer", "flash_attention",
                  "qmm_requant", "conv3x3_epilogue")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def source_path(name):
    return os.path.join(_CSRC, name + ".cu")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (PATH, CUDA_HOME or "
                         "/usr/local/cuda/bin); the port's CUDA kernels "
                         "build on a host with the CUDA toolkit")
    return path


def _job(name, src=None):
    """``(source file, library path)`` of kernel ``name``: the checked-in
    source, or the emitted text ``src`` (written under the build
    directory when its library has to be built)."""
    if src is None:
        path = source_path(name)
        with open(path, "rb") as f:
            data = f.read()
    else:
        data = src.encode()
    digest = hashlib.sha256(data + " ".join(_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest))
    if src is not None:
        path = os.path.join(BUILD_DIR, "%s-%s.cu" % (name, digest))
    return path, out


def _start(name, src=None):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp path, final path)``."""
    path, out = _job(name, src)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    if src is not None:
        tmp_src = "%s.%d.tmp" % (path, os.getpid())
        with open(tmp_src, "w", encoding="utf-8") as f:
            f.write(src)
        os.replace(tmp_src, path)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.Popen(
        [_nvcc(), *_FLAGS, "-o", tmp, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise MXNetError("nvcc failed for %s (rc=%d):\n%s"
                         % (name, proc.returncode, log))
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none


def build_all(names=KERNEL_SOURCES, emitted=None):
    """Compile every named source, and every emitted ``{name: source
    text}``, that is not built yet: one ``nvcc`` each, all started
    together; returns ``{name: library path}``."""
    jobs = [(n, None) for n in names] + sorted((emitted or {}).items())
    with _lock:
        started = [(n,) + _start(n, src) for n, src in jobs]
        for n, proc, tmp, out in started:
            _finish(n, proc, tmp, out)
    return {n: out for n, _, _, out in started}


def load(name):
    """The ``ctypes.CDLL`` of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_all((name,))[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(path)
    return lib


def load_source(name, src):
    """The ``ctypes.CDLL`` of the emitted CUDA text ``src``, built on
    first use (cached by the hash of the text, so two texts never share
    a library)."""
    out = _job(name, src)[1]
    lib = _libs.get(out)
    if lib is not None:
        return lib
    path = build_all((), {name: src})[name]
    with _lock:
        lib = _libs.get(out)
        if lib is None:
            lib = _libs[out] = ctypes.CDLL(path)
    return lib
