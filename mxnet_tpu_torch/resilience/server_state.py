"""Durable parameter-server state: snapshots + a write-ahead log.

The port of ``mxnet_tpu/resilience/server_state.py``, byte for byte on
disk: a state directory written by either package's server is recovered
by the other's.  Host-only (stdlib, plus the port's ``checkpoint``).

The PS server (``kvstore_ps.PSServer``) is the one process whose memory
holds state no worker can reconstruct: server-held weights and the
server-side optimizer (updater) state.

- **snapshots** reuse the ``.mxckpt`` write-fsync-rename discipline of
  :mod:`.checkpoint` (``save_checkpoint`` / ``latest_checkpoint`` with
  ``keep=`` pruning, crashed-save tmp debris included): a SIGKILL
  mid-snapshot can only leave a stray tmp file, never a torn snapshot.
- **WAL**: between snapshots, every applied mutation (init /
  set_optimizer / push / client incarnation change) is appended to
  ``wal-<seq>.mxwal`` as a CRC-framed pickled record (``<II`` length and
  crc32, then the pickled ``(seq, record)``).  Appends are ``flush()``ed
  per record: a SIGKILLed server loses at most the record it was
  mid-``write()`` on (the torn tail is detected by length/CRC and dropped
  at replay), and that push was never acked, so the client re-sends it.
  Power loss is out of scope, as for checkpoints.

Recovery = newest loadable snapshot + replay of every WAL record with a
sequence number past the snapshot's.  Replay is idempotent: push records
carry ``(rank, push_step)`` and the server skips any pair at or below
the rank's recovered high-water mark.

A monotonic **generation** counter (its own rename-atomic file, bumped
at every recovery-armed server start) rides the hello handshake so
clients can tell a server *failover* from a TCP blip and restart
per-connection state (staged chunked transfers) wholesale.
"""
from __future__ import annotations

import os
import pickle
import re
import struct
import threading
import zlib

from . import checkpoint as _ckpt

__all__ = ["ServerStateStore", "WAL_SUFFIX"]

WAL_SUFFIX = ".mxwal"
_WAL_RE = re.compile(r"^wal-(\d+)" + re.escape(WAL_SUFFIX) + r"$")
_FRAME = struct.Struct("<II")          # (body length, crc32(body))


def _wal_path(directory, base_seq):
    return os.path.join(directory, "wal-%012d%s" % (int(base_seq),
                                                    WAL_SUFFIX))


def _read_wal(path):
    """Yield ``(seq, record)`` entries; a torn tail (crash mid-append)
    ends iteration silently — everything before it is intact by CRC."""
    try:
        f = open(path, "rb")
    except OSError:
        return
    with f:
        while True:
            hdr = f.read(_FRAME.size)
            if len(hdr) < _FRAME.size:
                return
            n, crc = _FRAME.unpack(hdr)
            body = f.read(n)
            if len(body) < n or zlib.crc32(body) != crc:
                return
            try:
                seq, record = pickle.loads(body)
            except Exception:
                return
            yield int(seq), record


class ServerStateStore:
    """Snapshot + WAL persistence for one PS server's state directory.

    The caller (``PSServer``) serializes all mutations behind its own
    state lock, so appends never race; the internal lock only guards the
    file handle across the snapshot rotation."""

    def __init__(self, directory, keep=3):
        self.directory = str(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._wal = None
        self._wal_base = 0

    # -- generation --------------------------------------------------------
    def bump_generation(self):
        """Read-increment-rename the generation file; returns the new
        generation (1 on a fresh directory).  Rename-atomic like the
        snapshots: two crashes between snapshots still bump twice."""
        path = os.path.join(self.directory, "GENERATION")
        gen = 0
        try:
            with open(path) as f:
                gen = int(f.read().strip())
        except (OSError, ValueError):
            pass
        gen += 1
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            f.write(str(gen))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return gen

    # -- WAL ---------------------------------------------------------------
    def wal_append(self, seq, record):
        """Append one ``(seq, record)`` frame and flush it to the OS.
        Survives SIGKILL (page cache outlives the process); per-record
        fsync would cost ~a disk flush per push for a durability class
        (power loss) the checkpoint tier does not claim either."""
        body = pickle.dumps((int(seq), record),
                            protocol=pickle.HIGHEST_PROTOCOL)
        frame = _FRAME.pack(len(body), zlib.crc32(body)) + body
        with self._lock:
            if self._wal is None:
                self._wal = open(_wal_path(self.directory, self._wal_base),
                                 "ab")
            self._wal.write(frame)
            self._wal.flush()

    def _wal_files(self):
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = _WAL_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    # -- snapshots ---------------------------------------------------------
    def save_snapshot(self, payload, seq):
        """Atomically install the snapshot covering WAL seqs <= ``seq``
        and rotate the WAL.  Old snapshots are pruned to ``keep``
        (checkpoint.py's discipline, tmp debris included).  WAL segments
        are pruned only when their NEWEST record is at or below the
        oldest retained snapshot's seq — a segment's base alone is not
        enough, because records appended between an async snapshot
        capture and this rotation land in the old segment with seqs
        PAST the snapshot.  Any retained snapshot keeps a complete
        replay chain behind it."""
        path = _ckpt.save_checkpoint(self.directory, payload, step=seq,
                                     keep=self.keep)
        retained = _ckpt.list_checkpoints(self.directory)
        floor = retained[0][0] if retained else int(seq)
        with self._lock:
            if self._wal is not None:
                self._wal.close()
            self._wal_base = int(seq)
            self._wal = open(_wal_path(self.directory, self._wal_base), "ab")
            for base, wpath in self._wal_files():
                if base == self._wal_base:
                    continue
                max_seq = base
                for rec_seq, _ in _read_wal(wpath):
                    max_seq = max(max_seq, rec_seq)
                if max_seq <= floor:
                    try:
                        os.remove(wpath)
                    except OSError:
                        pass
        return path

    # -- recovery ----------------------------------------------------------
    def recover(self):
        """-> ``(snapshot_payload_or_None, [(seq, record), ...])`` with the
        records strictly after the snapshot's seq, in order.  Subsequent
        appends continue into the newest snapshot's WAL segment."""
        snap = _ckpt.latest_checkpoint(self.directory)
        payload, base_seq = None, 0
        if snap is not None:
            payload = snap[1]["payload"]
            base_seq = int(snap[1]["step"])
        records = []
        for _, path in self._wal_files():
            for seq, record in _read_wal(path):
                if seq > base_seq:
                    records.append((seq, record))
        records.sort(key=lambda sr: sr[0])
        with self._lock:
            self._wal_base = base_seq
        return payload, records

    def close(self):
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None
