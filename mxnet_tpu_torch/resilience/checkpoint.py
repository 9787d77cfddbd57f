"""Atomic write-rename training snapshots: the port of
``mxnet_tpu/resilience/checkpoint.py``, host-only, and reading and
writing the reference's files byte for byte.

- **atomicity**: a snapshot is written to ``<name>.tmp.<pid>`` and
  ``os.replace``d into place — a crash (even SIGKILL) mid-save can only
  leave a stray tmp file, never a torn checkpoint (chaos site
  ``checkpoint.save``).
- **completeness**: the payload carries params, optimizer state, RNG
  state and the iterator cursor (epoch/batch), so ``resume=`` replays to
  a bitwise-identical run.
- **provenance**: every snapshot embeds a sha256 of the encoded payload
  plus the ``(epoch, step, train_run_id)`` the caller supplies.
- **sharded snapshots** (ZeRO-1): one ``.shard-<r>-of-<K>.mxshard``
  file per rank plus the ``.mxmanifest`` commit point, written last
  (chaos site ``ckpt.shard_write``); a missing or corrupt shard raises
  :class:`ShardIntegrityError` and the newest complete manifest wins.

Format (version 1): one pickled dict ``{"version", "step", "payload"}``
where arrays are ``("nd", dtype_str, shape, raw_bytes)`` tuples
(:func:`encode_array`).  numpy cannot name bfloat16 without
``ml_dtypes``, so a bf16 tensor is encoded from its raw bytes under the
dtype string ``"bfloat16"`` and decoded into a torch tensor: each
package loads the other's files.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import re

import numpy as _np

from . import chaos as _chaos

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "list_checkpoints", "encode_array", "decode_array",
           "decode_tensor",
           "payload_digest", "provenance", "CKPT_SUFFIX", "FORMAT_VERSION",
           "ShardIntegrityError", "save_sharded_checkpoint",
           "load_sharded_checkpoint", "latest_sharded_checkpoint",
           "list_manifests", "SHARD_SUFFIX", "MANIFEST_SUFFIX",
           "SHARD_FORMAT_VERSION"]

CKPT_SUFFIX = ".mxckpt"
FORMAT_VERSION = 1
_NAME_RE = re.compile(r"^ckpt-(\d+)" + re.escape(CKPT_SUFFIX) + r"$")

# shard-parallel snapshots (ZeRO-1 elastic training, docs/elastic.md):
# one <step>.shard-<r>-of-<K> file per rank plus a last-committed
# manifest — the manifest is the COMMIT POINT (written last), so a rank
# SIGKILLed mid shard write leaves the previous complete checkpoint
# authoritative
SHARD_SUFFIX = ".mxshard"
MANIFEST_SUFFIX = ".mxmanifest"
SHARD_FORMAT_VERSION = 1
_MANIFEST_RE = re.compile(r"^ckpt-(\d+)" + re.escape(MANIFEST_SUFFIX)
                          + r"$")


class ShardIntegrityError(RuntimeError):
    """A manifest references a shard that is missing or whose bytes do
    not match its recorded digest — the checkpoint is NOT loadable and
    the error names the shard and the reason (provenance for what used
    to surface as an anonymous load-time exception)."""


def encode_array(x):
    """Array or tensor -> ``("nd", dtype, shape, bytes)``, exact for every
    dtype: a bfloat16 tensor is encoded from its raw bytes as
    ``"bfloat16"`` (the reference's dtype string)."""
    import torch
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return ("nd", "bfloat16", tuple(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    a = _np.asarray(x)
    return ("nd", str(a.dtype), tuple(a.shape), a.tobytes())


def decode_array(enc):
    """``encode_array``'s inverse: a numpy array, or a torch bfloat16
    tensor where numpy cannot name the dtype."""
    tag, dtype, shape, raw = enc
    assert tag == "nd", enc
    if dtype == "bfloat16":
        return decode_tensor(enc)
    return _np.frombuffer(raw, dtype=_np.dtype(dtype)).reshape(shape)


def decode_tensor(enc, device=None):
    """An encoded array as a torch tensor (a copy) on ``device``."""
    import torch
    tag, dtype, shape, raw = enc
    assert tag == "nd", enc
    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(
            torch.bfloat16).reshape(shape)
    else:
        t = torch.from_numpy(_np.frombuffer(
            raw, dtype=_np.dtype(dtype)).reshape(shape).copy())
    return t if device is None else t.to(device)


def _ckpt_path(directory, step):
    return os.path.join(directory, "ckpt-%012d%s" % (int(step), CKPT_SUFFIX))


def payload_digest(payload):
    """sha256 hex digest of the pickled payload — the byte-exact identity
    of a checkpoint's content.  Pickling an insertion-ordered dict of
    ``encode_array`` tuples is deterministic, so the same training state
    always names the same digest (the property promotion audit records
    rely on)."""
    return hashlib.sha256(pickle.dumps(
        payload, protocol=pickle.HIGHEST_PROTOCOL)).hexdigest()


def provenance(record):
    """The provenance dict of a loaded checkpoint record, or ``None``
    for a pre-provenance snapshot (records stay back/forward readable:
    provenance is an additive key)."""
    if not isinstance(record, dict):
        return None
    return record.get("provenance")


def save_checkpoint(directory, payload, step, keep=3, provenance=None):
    """Atomically write ``payload`` as the step-``step`` checkpoint.

    The bytes are written to a tmp file, fsynced, then ``os.replace``d —
    the checkpoint either exists completely or not at all.  After a
    successful install, older checkpoints beyond ``keep`` (and stray tmp
    files from crashed saves) are pruned.  Returns the final path.

    ``provenance`` (optional dict, e.g. ``{"epoch", "train_run_id"}``)
    is embedded in the record beside an always-computed ``digest`` of
    the payload bytes and the ``step`` — the identity the serving fleet
    and the promotion controller surface."""
    os.makedirs(directory, exist_ok=True)
    final = _ckpt_path(directory, step)
    tmp = final + ".tmp.%d" % os.getpid()
    prov = dict(provenance or {})
    prov.setdefault("step", int(step))
    # a caller may pre-compute a canonicalized digest (the trainer
    # digests gensym-invariant content, so rebuilt-architecture reruns
    # name the same bytes); otherwise digest the payload as-is
    prov.setdefault("digest", payload_digest(payload))
    blob = pickle.dumps({"version": FORMAT_VERSION, "step": int(step),
                         "payload": payload, "provenance": prov},
                        protocol=pickle.HIGHEST_PROTOCOL)
    with open(tmp, "wb") as f:
        # two-part write with a probe between: the chaos harness kills
        # here to prove a torn save never shadows the previous snapshot
        f.write(blob[:len(blob) // 2])
        _chaos.maybe_inject("checkpoint.save")
        f.write(blob[len(blob) // 2:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory, keep):
    entries = list_checkpoints(directory)
    for step, path in entries[:-int(keep)] if keep else []:
        try:
            os.remove(path)
        except OSError:
            pass
    for name in os.listdir(directory):
        if ".tmp." in name and name.split(".tmp.")[0].endswith(CKPT_SUFFIX):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def list_checkpoints(directory):
    """[(step, path)] ascending by step; tmp/corrupt-named files ignored."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def load_checkpoint(path):
    """Load one checkpoint file -> ``{"version", "step", "payload"}``.
    Raises on a torn/garbage file (callers fall back to an older one)."""
    with open(path, "rb") as f:
        rec = pickle.load(f)
    if not isinstance(rec, dict) or rec.get("version") != FORMAT_VERSION:
        raise ValueError("not a version-%d checkpoint: %r"
                         % (FORMAT_VERSION, path))
    return rec


def latest_checkpoint(directory):
    """Newest *loadable* checkpoint -> ``(path, record)`` or ``None``.
    A torn newest file (crash between write and replace is impossible,
    but disk corruption is not) falls back to the next-newest."""
    for step, path in reversed(list_checkpoints(directory)):
        try:
            return path, load_checkpoint(path)
        except Exception:
            continue
    return None


# ---------------------------------------------------------------------------
# shard-parallel snapshots: per-rank shard files + a last-committed manifest
# ---------------------------------------------------------------------------
def _shard_name(step, rank, world):
    return "ckpt-%012d.shard-%05d-of-%05d%s" % (int(step), int(rank),
                                                int(world), SHARD_SUFFIX)


def _manifest_path(directory, step):
    return os.path.join(directory,
                        "ckpt-%012d%s" % (int(step), MANIFEST_SUFFIX))


def _atomic_write(path, blob):
    """fsync + rename install of ``blob`` at ``path`` (the snapshot
    discipline): the file exists completely or not at all."""
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_sharded_checkpoint(directory, payload, shards, step, keep=3,
                            provenance=None):
    """Shard-parallel atomic snapshot: write one shard file per rank,
    then commit the manifest.  Returns the manifest path.

    ``payload`` is the rank-agnostic common state (params, RNG, cursor,
    layout plan); ``shards[r]`` is rank ``r``'s own slice (its ZeRO-1
    optimizer-state shard).  Each shard is fsync+renamed into place
    with its sha256 digest recorded; the manifest — written LAST, same
    discipline — is the commit point: a rank SIGKILLed mid shard write
    (chaos site ``ckpt.shard_write``) leaves only tmp debris and the
    previous complete checkpoint stays the loadable latest.  Pruning
    keeps ``keep`` manifests and only deletes shard files no retained
    manifest references."""
    os.makedirs(directory, exist_ok=True)
    world = len(shards)
    entries = []
    for rank, shard_payload in enumerate(shards):
        blob = pickle.dumps(
            {"version": SHARD_FORMAT_VERSION, "step": int(step),
             "rank": int(rank), "world": int(world),
             "payload": shard_payload},
            protocol=pickle.HIGHEST_PROTOCOL)
        name = _shard_name(step, rank, world)
        # chaos probe: a scheduled fault (SIGKILL while writing shard
        # N) fires before the shard is installed — the atomicity test's
        # injection point
        _chaos.maybe_inject("ckpt.shard_write", ctx=(int(step), rank))
        _atomic_write(os.path.join(directory, name), blob)
        entries.append({"file": name, "rank": int(rank),
                        "digest": hashlib.sha256(blob).hexdigest(),
                        "bytes": len(blob)})
    prov = dict(provenance or {})
    prov.setdefault("step", int(step))
    prov.setdefault("digest", payload_digest(
        {"payload": payload, "shards": [e["digest"] for e in entries]}))
    blob = pickle.dumps(
        {"version": SHARD_FORMAT_VERSION, "step": int(step),
         "world": int(world), "payload": payload, "shards": entries,
         "provenance": prov},
        protocol=pickle.HIGHEST_PROTOCOL)
    final = _manifest_path(directory, step)
    _atomic_write(final, blob)
    _prune_sharded(directory, keep)
    return final


def list_manifests(directory):
    """[(step, manifest_path)] ascending; tmp/garbage names ignored."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def load_sharded_checkpoint(manifest_path):
    """Load + verify one sharded checkpoint -> ``{"version", "step",
    "world", "payload", "shards": [per-rank payloads], "provenance"}``.

    Every shard the manifest references must exist with byte-exact
    digest; a missing or corrupt shard raises
    :class:`ShardIntegrityError` naming the shard and the reason —
    callers (``latest_sharded_checkpoint``) fall back to an older
    complete checkpoint."""
    with open(manifest_path, "rb") as f:
        rec = pickle.load(f)
    if not isinstance(rec, dict) or \
            rec.get("version") != SHARD_FORMAT_VERSION:
        raise ValueError("not a version-%d sharded checkpoint manifest: "
                         "%r" % (SHARD_FORMAT_VERSION, manifest_path))
    directory = os.path.dirname(os.path.abspath(manifest_path))
    shard_payloads = []
    for entry in rec["shards"]:
        path = os.path.join(directory, entry["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise ShardIntegrityError(
                "manifest %s references missing shard %s (rank %d): %s"
                % (os.path.basename(manifest_path), entry["file"],
                   entry.get("rank", -1), e))
        got = hashlib.sha256(blob).hexdigest()
        if got != entry["digest"]:
            raise ShardIntegrityError(
                "shard %s (rank %d) is corrupt: digest %s does not "
                "match the manifest's %s"
                % (entry["file"], entry.get("rank", -1), got[:16],
                   entry["digest"][:16]))
        shard_payloads.append(pickle.loads(blob)["payload"])
    return {"version": rec["version"], "step": int(rec["step"]),
            "world": int(rec["world"]), "payload": rec["payload"],
            "shards": shard_payloads,
            "provenance": rec.get("provenance")}


def latest_sharded_checkpoint(directory):
    """Newest *complete* sharded checkpoint -> ``(manifest_path,
    record)`` or ``None``.  A manifest whose shard set fails the digest
    check (:class:`ShardIntegrityError`) falls back to the next-newest
    — the last-committed-manifest-wins semantics."""
    for step, path in reversed(list_manifests(directory)):
        try:
            return path, load_sharded_checkpoint(path)
        except Exception:
            continue
    return None


def _prune_sharded(directory, keep):
    """Drop manifests beyond ``keep`` plus every shard file no retained
    manifest references, and tmp debris from crashed saves."""
    manifests = list_manifests(directory)
    dropped = manifests[:-int(keep)] if keep else []
    kept = manifests[len(dropped):]
    referenced = set()
    for _, path in kept:
        try:
            with open(path, "rb") as f:
                rec = pickle.load(f)
            for entry in rec.get("shards", []):
                referenced.add(entry["file"])
        except Exception:
            continue
    for _, path in dropped:
        try:
            os.remove(path)
        except OSError:
            pass
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.endswith(SHARD_SUFFIX) and name not in referenced:
            try:
                os.remove(full)
            except OSError:
                pass
        elif ".tmp." in name and (
                name.split(".tmp.")[0].endswith(SHARD_SUFFIX)
                or name.split(".tmp.")[0].endswith(MANIFEST_SUFFIX)):
            try:
                os.remove(full)
            except OSError:
                pass
