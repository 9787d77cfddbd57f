"""Build the port's CUDA kernels at first use and load them with ctypes.

Each hand-written kernel is one ``mxnet_tpu_torch/csrc/<name>.cu`` with a
plain C interface.  :func:`load` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``mxnet_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``, found through ``-I csrc``) and the flags so an
edited source or header never loads a stale library, and returns the
``ctypes.CDLL``.  :func:`load_source` does the same for a source the
program emits (the mxgen kernels of ``analysis/codegen.py``): the text is
written into the build directory under the same hash.  :func:`build_all`
starts one ``nvcc`` per source at once.  :func:`ptxas_report` compiles
named sources once more to a cubin with ``-Xptxas -v`` and returns what
ptxas says of each kernel instantiation: registers, spills and its C75xx
advisories (``wgmma`` serialized, among them).  Nothing here runs on
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

from ..base import MXNetError

__all__ = ["load", "load_source", "build_all", "ptxas_report",
           "source_path", "KERNEL_SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# every kernel source of the port, by name
KERNEL_SOURCES = ("fused_ln", "fused_optimizer", "flash_attention",
                  "flash_fwd_wgmma", "flash_bwd_wgmma", "flash_bf16_wgmma",
                  "qmm_requant", "qmm_wgmma", "conv3x3_epilogue",
                  "conv3x3_wgmma")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def source_path(name):
    return os.path.join(_CSRC, name + ".cu")


def _headers():
    """The text of every shared header (``csrc/*.cuh``), in name order:
    part of every library's hash, since any source may include one."""
    names = sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh"))
    data = b""
    for n in names:
        with open(os.path.join(_CSRC, n), "rb") as f:
            data += n.encode() + b"\0" + f.read()
    return data


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
    digest = hashlib.sha256(data + _headers()
                            + " ".join(_FLAGS).encode()).hexdigest()[:12]
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
        [_nvcc(), *_FLAGS, "-I", _CSRC, "-o", tmp, path],
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


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_ADVICE = re.compile(r"\((C75\d\d)\) (.*?) in (?:the )?function '([^']+)'")


def _demangled(names):
    """``{mangled: readable}`` through the toolkit's ``cu++filt``, or the
    names as they are where it is missing."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=False).stdout
    lines = out.splitlines()
    if len(lines) != len(names):
        return {n: n for n in names}
    return dict(zip(names, lines))


def _parse_ptxas(log):
    """``[{kernel, registers, spill_stores, spill_loads, advisories}]`` of
    one ``-Xptxas -v`` log, a kernel (mangled) per compiled entry function
    in the order compiled; each advisory (``"C7511 <text>"``, printed
    before the entries) on the function it names."""
    rows, order, cur = {}, [], None

    def row(name):
        return rows.setdefault(name, {
            "kernel": name, "registers": None, "spill_stores": None,
            "spill_loads": None, "advisories": []})
    for line in log.splitlines():
        m = _ADVICE.search(line)
        if m:
            row(m.group(3))["advisories"].append("%s %s" % m.group(1, 2))
            continue
        m = _ENTRY.search(line)
        if m:
            cur = row(m.group(1))
            order.append(cur)
            continue
        m = _SPILL.search(line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return order


def ptxas_report(names):
    """``{source name: [{kernel, registers, spill_stores, spill_loads,
    advisories}]}``: each named ``csrc`` source compiled to a cubin with the
    libraries' flags and ``-Xptxas -v``, one ``nvcc`` each, all started
    together (into a temporary directory under the build directory); the
    log as ptxas wrote it is kept as ``<name>.ptxas.log`` there."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = [f for f in _FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {n: subprocess.Popen(
            [_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-I", _CSRC, "-o",
             os.path.join(tmp, n + ".cubin"), source_path(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names}
        out = {}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise MXNetError("nvcc -Xptxas -v failed for %s (rc=%d):\n%s"
                                 % (n, proc.returncode, log))
            with open(os.path.join(BUILD_DIR, n + ".ptxas.log"), "w",
                      encoding="utf-8") as f:
                f.write(log)
            out[n] = _parse_ptxas(log)
    names = _demangled([r["kernel"] for rows in out.values() for r in rows])
    for rows in out.values():
        for r in rows:
            r["kernel"] = names[r["kernel"]]
    return out
