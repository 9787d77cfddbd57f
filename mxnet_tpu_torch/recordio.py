"""RecordIO: the reference's binary record container, bit-compatible.

The port's copy of ``mxnet_tpu/recordio.py`` (reference:
``python/mxnet/recordio.py`` and the dmlc-core recordio format read by
``src/io/iter_image_recordio_2.cc``):

- each record: ``uint32 kMagic(0xced7230a)``, ``uint32 lrec`` where the top
  3 bits are a continuation flag and the low 29 bits the payload length,
  then the payload padded to a 4-byte boundary.
- ``IRHeader`` (image record header): ``uint32 flag, float label,
  uint64 id, uint64 id2`` (24 bytes little-endian); ``flag > 0`` means the
  label is a float array of ``flag`` entries stored after the header.

Files written here are byte for byte those of the JAX package's writer,
and readable by either package's tooling (``tools/im2rec.py``,
``ImageRecordIter``).  Everything here is host code: numpy, and OpenCV for
``pack_img`` / ``unpack_img``.
"""
from __future__ import annotations

import numbers
import os
import struct

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1


class MXRecordIO:
    """Sequential record reader/writer (reference: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        """Override pickling behaviour (multiprocessing DataLoader workers
        re-open their own handle — reference: recordio.py __getstate__).
        The pickled reader leaves its own handle open: the reference's
        closes it, so the second of several workers unpickles a closed
        reader and fails its first read."""
        d = dict(self.__dict__)
        d.pop("handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        self.handle = None
        if is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        length = len(buf)
        if length > _LENGTH_MASK:
            raise ValueError("record too large: %d bytes" % length)
        self.handle.write(struct.pack("<II", _KMAGIC, length))
        self.handle.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC:
            raise IOError("invalid record magic %x in %s" % (magic, self.uri))
        if lrec >> _LFLAG_BITS:
            raise IOError(
                "continuation record (cflag=%d) in %s: the file was written "
                "by a dmlc writer that split a payload containing the magic "
                "word; multi-part records are not supported"
                % (lrec >> _LFLAG_BITS, self.uri))
        length = lrec & _LENGTH_MASK
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return buf

    def tell(self):
        return self.handle.tell()

    def read_at(self, offset):
        """Positional read of the record starting at ``offset`` via
        ``os.pread`` — the file cursor never moves, so any number of
        threads (prefetchers, pipeline workers sharing one handle) can
        read concurrently without a seek lock (the dmlc-core reader gets
        the same property from its own pread path)."""
        assert not self.writable
        fd = self.handle.fileno()
        head = os.pread(fd, 8, offset)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC:
            raise IOError("invalid record magic %x at %d in %s"
                          % (magic, offset, self.uri))
        if lrec >> _LFLAG_BITS:
            raise IOError("continuation record (cflag=%d) in %s"
                          % (lrec >> _LFLAG_BITS, self.uri))
        length = lrec & _LENGTH_MASK
        buf = os.pread(fd, length, offset + 8)
        if len(buf) < length:
            raise IOError("truncated record at %d in %s" % (offset, self.uri))
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer via a .idx sidecar file
    (reference: recordio.py MXIndexedRecordIO)."""

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
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fidx:
                for line in fidx:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        if self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if not self.is_open:
            return
        super().close()
        # an unpickled reader has no ``fidx`` (``__getstate__`` drops it;
        # the reference's close raises AttributeError there)
        fidx = getattr(self, "fidx", None)
        if fidx is not None and not fidx.closed:
            fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        # positional read: keyed access never disturbs the sequential
        # cursor, and concurrent readers need no lock
        return self.read_at(self.idx[idx])

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


class IRHeader:
    """Image record header (reference: recordio.py IRHeader namedtuple)."""
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        return iter((self.flag, self.label, self.id, self.id2))

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return "IRHeader(flag=%r, label=%r, id=%r, id2=%r)" % tuple(self)


_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header and byte payload into one record string
    (reference: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        packed = struct.pack(_IR_FORMAT, 0, float(header.label),
                             header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        packed = struct.pack(_IR_FORMAT, label.size, 0.0,
                             header.id, header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """Unpack a record into (IRHeader, payload bytes)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack a header + image array, encoding with OpenCV
    (reference: recordio.py pack_img)."""
    import cv2
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, BGR image ndarray)."""
    import cv2
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img
