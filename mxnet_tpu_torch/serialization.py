"""Binary serialization of NDArrays (``.params`` files): the port of
``mxnet_tpu/serialization.py``, byte for byte.

Two on-disk formats, told apart by their magic on load:

1. The reference MXNet dmlc stream (``NDArray::Save/Load``,
   src/ndarray/ndarray.cc:1537-1761): ``uint64 0x112`` list magic and a
   reserved ``uint64``, the arrays (``uint64`` count; per array ``uint32
   0xF993FAC9`` V2 magic, ``int32`` storage type, the shape as ``uint32
   ndim`` + ``int64`` dims, the context as two ``int32``, the ``int32``
   mshadow type flag, raw C-order data), then the names (``uint64``
   count, each a ``uint64`` length and its bytes).  V1 (0xF993FAC8) and
   pre-V1 records (the magic is ndim, ``uint32`` dims) load too.
   bfloat16 is widened to float32 and bool written as uint8 there (the
   mshadow table has no slot for either; flag 7 = bool is read on load
   only); a 0-dim array is written as shape (1,).
2. ``MXTPUND1``: the magic, a ``uint64`` length, a JSON index
   (``{"names": ..., "arrays": [{"shape", "dtype"}]}``) and the raw
   buffers — the default, since it keeps bfloat16 (its raw 16-bit words,
   dtype name ``"bfloat16"``).

Sparse arrays: the dmlc stream holds them as MXNet's V2 sparse records
(storage type 1 = row_sparse with its row indices, 2 = csr with indptr
then column indices; the storage shape before the shape, the aux arrays'
type flags and shapes before the data, the aux data after it; the aux
arrays always int64) and loads them as ``RowSparseNDArray`` /
``CSRNDArray``; ``MXTPUND1`` holds them densified, as the reference's
does.  The constants and the JSON layout are the reference's, so a file
either package writes from the same values is the same bytes, and each
loads the other's.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

__all__ = ["save_ndarrays", "load_ndarrays"]

_MAGIC = b"MXTPUND1"
_MXNET_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V1_MAGIC = 0xF993FAC8
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_MX_FLAG_TO_NP = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "int8", 6: "int64", 7: "bool"}
_NP_TO_MX_FLAG = {v: k for k, v in _MX_FLAG_TO_NP.items()}
_KCPU = 1


def _tensor(v):
    """The host tensor of an NDArray (a sparse one densified), tensor or
    array-like."""
    from .ndarray import NDArray
    from .ndarray.sparse import BaseSparseNDArray
    if isinstance(v, BaseSparseNDArray):
        v = v.todense()
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v, order="C"))


def _raw(t):
    """(dtype name, raw bytes) of a host tensor."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return a.dtype.name, a.tobytes()


def save_ndarrays(fname, data, format="mxtpu"):
    """Save a dict, list or single array; ``format="mxnet"`` writes the
    reference dmlc-stream layout."""
    if isinstance(data, dict):
        names, values = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, values = None, list(data)
    else:
        names, values = None, [data]
    if format == "mxnet":
        _save_mxnet(fname, values, names)
        return
    tensors = [_tensor(v) for v in values]
    raws = [_raw(t) for t in tensors]
    index = {"names": names,
             "arrays": [{"shape": list(t.shape), "dtype": dt}
                        for t, (dt, _) in zip(tensors, raws)]}
    blob = json.dumps(index).encode("utf-8")
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, b in raws:
            f.write(b)


def _from_bytes(buf, dtype, shape):
    if dtype == "bfloat16":
        a = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(a.copy())


def load_ndarrays(fname, ctx=None):
    """The arrays of a file in either format, as NDArrays on ``ctx`` (the
    CUDA device by default): a dict when the file holds names, else a
    list."""
    from .ndarray import NDArray, _device
    dev = _device(ctx)
    with open(fname, "rb") as f:
        magic = f.read(8)
        if magic == _MAGIC:
            names, tensors = _load_mxtpu(f)
        elif len(magic) == 8 and \
                struct.unpack("<Q", magic)[0] == _MXNET_LIST_MAGIC:
            names, tensors = _load_mxnet(f)
        else:
            raise ValueError(
                "not an NDArray params file (neither %s nor MXNet list "
                "magic 0x%x): %r" % (_MAGIC.decode(), _MXNET_LIST_MAGIC,
                                     fname))
    arrays = [_on_device(t, dev) for t in tensors]
    return arrays if not names else dict(zip(names, arrays))


def _on_device(t, dev):
    """A loaded record as an NDArray on ``dev``: a tensor, a sparse
    record ``(stype, shape, data, aux)`` or None (an empty record)."""
    from .ndarray import NDArray
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    if t is None:
        return None
    if not isinstance(t, tuple):
        return NDArray(t.to(dev))
    stype, shape, data, aux = t
    parts = [NDArray(a.to(dev)) for a in [data] + aux]
    if stype == _STYPE_ROW_SPARSE:
        return RowSparseNDArray(parts[0], parts[1], shape)
    # csr: aux 0 = indptr, aux 1 = column indices
    return CSRNDArray(parts[0], parts[2], parts[1], shape)


def _load_mxtpu(f):
    (n,) = struct.unpack("<Q", f.read(8))
    index = json.loads(f.read(n).decode("utf-8"))
    tensors = []
    for meta in index["arrays"]:
        size = 2 if meta["dtype"] == "bfloat16" \
            else np.dtype(meta["dtype"]).itemsize
        count = int(np.prod(meta["shape"])) if meta["shape"] else 1
        tensors.append(_from_bytes(f.read(count * size), meta["dtype"],
                                   meta["shape"]))
    return index["names"], tensors


def _read(f, n):
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError("truncated MXNet params file")
    return buf


def _read_tshape(f):
    (ndim,) = struct.unpack("<I", _read(f, 4))
    return struct.unpack("<%dq" % ndim, _read(f, 8 * ndim)) if ndim else ()


def _write_tshape(f, shape):
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack("<%dq" % len(shape), *[int(d) for d in shape]))


def _read_data(f, shape, type_flag):
    if type_flag not in _MX_FLAG_TO_NP:
        raise ValueError("unknown mshadow type flag %d" % type_flag)
    dt = _MX_FLAG_TO_NP[type_flag]
    count = int(np.prod(shape)) if shape else 1
    return _from_bytes(_read(f, count * np.dtype(dt).itemsize), dt, shape)


def _load_mxnet_one(f):
    (magic,) = struct.unpack("<I", _read(f, 4))
    if magic != _NDARRAY_V2_MAGIC:
        if magic == _NDARRAY_V1_MAGIC:
            shape = _read_tshape(f)
        else:
            ndim = magic
            if ndim > 32:
                raise ValueError("bad NDArray record magic 0x%x" % magic)
            shape = struct.unpack("<%dI" % ndim, _read(f, 4 * ndim)) \
                if ndim else ()
        if not shape:
            return None
        _read(f, 8)
        (type_flag,) = struct.unpack("<i", _read(f, 4))
        return _read_data(f, shape, type_flag)
    (stype,) = struct.unpack("<i", _read(f, 4))
    nad = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}.get(stype)
    if nad is None:
        raise ValueError("unknown storage type %d in params file" % stype)
    sshape = _read_tshape(f) if nad else None
    shape = _read_tshape(f)
    if not shape:
        return None
    _read(f, 8)
    (type_flag,) = struct.unpack("<i", _read(f, 4))
    aux = []
    for _ in range(nad):
        (aux_flag,) = struct.unpack("<i", _read(f, 4))
        aux.append((aux_flag, _read_tshape(f)))
    data = _read_data(f, sshape if nad else shape, type_flag)
    if not nad:
        return data
    return (stype, tuple(shape), data,
            [_read_data(f, ashape, aflag) for aflag, ashape in aux])


def _load_mxnet(f):
    (reserved,) = struct.unpack("<Q", _read(f, 8))
    if reserved != 0:
        raise ValueError("bad reserved field in MXNet params file")
    (count,) = struct.unpack("<Q", _read(f, 8))
    tensors = [_load_mxnet_one(f) for _ in range(count)]
    (n_names,) = struct.unpack("<Q", _read(f, 8))
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", _read(f, 8))
        names.append(_read(f, ln).decode("utf-8"))
    if names and len(names) != len(tensors):
        raise ValueError("name/array count mismatch in MXNet params file")
    return names, tensors


def _save_mxnet_one(f, v):
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    if isinstance(v, RowSparseNDArray):
        stype, t, aux = _STYPE_ROW_SPARSE, _tensor(v.data), [v.indices]
    elif isinstance(v, CSRNDArray):
        stype, t, aux = _STYPE_CSR, _tensor(v.data), [v.indptr, v.indices]
    else:
        stype, t, aux = _STYPE_DEFAULT, _tensor(v), []
    shape = tuple(v.shape) if aux else None
    aux = [_tensor(a).to(torch.int64) for a in aux]
    if t.dim() == 0:
        t = t.reshape(1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    elif t.dtype == torch.bfloat16:
        t = t.float()
    dt, buf = _raw(t)
    if dt not in _NP_TO_MX_FLAG:
        raise TypeError("dtype %s has no slot in the reference .params "
                        "format; cast explicitly before saving with "
                        "format='mxnet'" % dt)
    f.write(struct.pack("<I", _NDARRAY_V2_MAGIC))
    f.write(struct.pack("<i", stype))
    if aux:
        _write_tshape(f, t.shape)  # the storage shape
    _write_tshape(f, shape or t.shape)
    f.write(struct.pack("<ii", _KCPU, 0))
    f.write(struct.pack("<i", _NP_TO_MX_FLAG[dt]))
    for a in aux:
        f.write(struct.pack("<i", _NP_TO_MX_FLAG["int64"]))
        _write_tshape(f, a.shape)
    f.write(buf)
    for a in aux:
        f.write(_raw(a)[1])


def _save_mxnet(fname, values, names):
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _MXNET_LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(values)))
        for v in values:
            _save_mxnet_one(f, v)
        f.write(struct.pack("<Q", len(names) if names else 0))
        for name in names or []:
            b = name.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
