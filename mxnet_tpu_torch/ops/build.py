"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``mxnet_tpu_torch/csrc/<name>.cu`` with a plain C
interface.  :func:`load` compiles it with ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``mxnet_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags so an edited
source never loads a stale library, and returns the ``ctypes.CDLL``.
:func:`build_all` starts one ``nvcc`` per source at once.  Nothing here
runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["load", "build_all", "source_path", "KERNEL_SOURCES"]

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


def _lib_path(name):
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def _start(name):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp path, final path)``."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.Popen(
        [_nvcc(), *_FLAGS, "-o", tmp, source_path(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise MXNetError("nvcc failed for %s (rc=%d):\n%s"
                         % (source_path(name), proc.returncode, log))
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none


def build_all(names=KERNEL_SOURCES):
    """Compile every named source that is not built yet, one ``nvcc``
    each, all started together; returns ``{name: library path}``."""
    with _lock:
        started = [(n,) + _start(n) for n in names]
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
