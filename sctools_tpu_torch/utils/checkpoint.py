"""Verified ``.npz`` files: the integrity layer under the streaming
passes' resume files and the shard store's chunks.

Every file carries, beside its payload arrays, three ``_integrity/*``
keys: a content digest, the schema version and an optional identity
fingerprint.  A reader re-hashes the payload before trusting it; a file
that fails (bit rot, a write truncated by a crash, a renamed or
cross-wired file) is never deleted but moved aside by
:func:`quarantine_checkpoint` with a ``.reason.json`` sidecar.

The on-disk format is that of ``sctools_tpu/utils/checkpoint.py``, byte
for byte in its keys and digest: a file one package writes verifies in
the other.  Only the npz layer is ported (not the ``CellData``
checkpoints).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings

import numpy as np

#: bump when the npz layout changes incompatibly; files stamped with a
#: newer schema than the reader understands fail verification
CHECKPOINT_SCHEMA = 1

#: npz key prefix for integrity metadata, never part of the payload
_INTEGRITY = "_integrity/"


class CheckpointCorruptError(RuntimeError):
    """A file failed digest, schema or fingerprint verification.  A
    re-read of the same bytes fails the same way: callers quarantine
    and fall back, never retry.  ``.reason`` says why, ``.path`` which
    file."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"{path}: {reason}")
        self.path = path
        self.reason = reason


def _content_digest(arrays: dict) -> str:
    """Order-independent sha256 over every payload array (key, dtype,
    shape, raw bytes); ``_integrity/*`` keys are excluded, so the
    digest can be stored inside the file it covers."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        if k.startswith(_INTEGRITY):
            continue
        a = np.asarray(arrays[k])
        h.update(k.encode())
        h.update(f"|{a.dtype}|{a.shape}|".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _read_arrays(path: str) -> dict:
    """Every npz entry in memory, read once (which also runs the zip
    CRC checks)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _verify_arrays(arrays: dict,
                   expect_fingerprint: str | None = None) -> dict:
    """Integrity ruling over arrays already read: ``{"ok", "reason",
    "schema", "fingerprint"}``; a file without integrity keys is
    ``ok`` with reason ``"legacy"``."""
    if f"{_INTEGRITY}digest" not in arrays:
        return {"ok": True, "reason": "legacy", "schema": 0,
                "fingerprint": None}
    try:
        stored = str(arrays[f"{_INTEGRITY}digest"])
        schema = int(arrays[f"{_INTEGRITY}schema"])
        fp = str(arrays[f"{_INTEGRITY}fingerprint"]) or None
    except (KeyError, TypeError, ValueError) as e:
        # a digest without its sibling keys is a tampered or truncated
        # file, not a legacy one
        return {"ok": False, "schema": None, "fingerprint": None,
                "reason": "unreadable (integrity keys incomplete: "
                          f"{type(e).__name__}: {e})"}
    if schema > CHECKPOINT_SCHEMA:
        return {"ok": False, "schema": schema, "fingerprint": fp,
                "reason": f"schema {schema} newer than supported "
                          f"{CHECKPOINT_SCHEMA}"}
    computed = _content_digest(arrays)
    if computed != stored:
        return {"ok": False, "schema": schema, "fingerprint": fp,
                "reason": f"digest mismatch (stored {stored}, "
                          f"computed {computed})"}
    if expect_fingerprint and fp and fp != expect_fingerprint:
        return {"ok": False, "schema": schema, "fingerprint": fp,
                "reason": f"fingerprint mismatch (file {fp}, "
                          f"expected {expect_fingerprint})"}
    return {"ok": True, "reason": None, "schema": schema,
            "fingerprint": fp}


def save_npz_verified(path: str, *, fingerprint: str | None = None,
                      **arrays) -> str:
    """Write a dict of arrays as a checksummed ``.npz`` (atomic rename)
    with the ``_integrity/*`` keys.  Returns the content digest,
    computed once."""
    out = {k: np.asarray(v) for k, v in arrays.items()}
    digest = _content_digest(out)
    out[f"{_INTEGRITY}digest"] = np.array(digest)
    out[f"{_INTEGRITY}schema"] = np.array(CHECKPOINT_SCHEMA, np.int64)
    out[f"{_INTEGRITY}fingerprint"] = np.array(fingerprint or "")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return digest


def load_npz_verified(path: str, *,
                      expect_fingerprint: str | None = None,
                      require_digest: bool = False,
                      expect_digest: str | None = None) -> dict:
    """Read and verify the twin of :func:`save_npz_verified` in one
    pass; returns the payload arrays.  Any failure raises
    :class:`CheckpointCorruptError`.  ``require_digest`` rejects files
    without integrity keys; ``expect_digest`` (a digest recorded
    elsewhere, e.g. in a store manifest) catches intact bytes in the
    wrong slot."""
    try:
        arrays = _read_arrays(path)
    except Exception as e:  # noqa: BLE001 - unreadable is a ruling
        raise CheckpointCorruptError(
            path, f"unreadable ({type(e).__name__}: {e})") from e
    chk = _verify_arrays(arrays, expect_fingerprint)
    if not chk["ok"]:
        raise CheckpointCorruptError(path, chk["reason"])
    if require_digest and chk["reason"] == "legacy":
        raise CheckpointCorruptError(
            path, "missing integrity keys (digestless file where a "
                  "verified one is required)")
    if expect_digest:
        stored = str(arrays.get(f"{_INTEGRITY}digest", ""))
        if stored != expect_digest:
            raise CheckpointCorruptError(
                path, f"manifest digest mismatch (file {stored}, "
                      f"manifest {expect_digest})")
    return {k: v for k, v in arrays.items()
            if not k.startswith(_INTEGRITY)}


def save_npz_generations(path: str, fingerprint: str | None = None,
                         **arrays) -> str:
    """:func:`save_npz_verified` with generation rotation: the file at
    ``path`` moves to ``<path>.prev`` first, so a newest generation
    later ruled corrupt costs one save of work, not the whole pass."""
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    return save_npz_verified(path, fingerprint=fingerprint, **arrays)


def load_npz_generations(path: str,
                         fingerprint: str | None = None) -> dict | None:
    """The newest generation that verifies: ``path``, then
    ``<path>.prev``, then ``None`` (a fresh start).  A candidate that
    fails verification is quarantined, with a ``RuntimeWarning``."""
    for cand in (path, path + ".prev"):
        if not os.path.exists(cand):
            continue
        try:
            return load_npz_verified(cand,
                                     expect_fingerprint=fingerprint)
        except CheckpointCorruptError as e:
            dest = quarantine_checkpoint(cand, e.reason)
            warnings.warn(
                f"checkpoint {cand!r} failed verification "
                f"({e.reason}) — quarantined to {dest!r}, falling "
                f"back a generation", RuntimeWarning, stacklevel=3)
    return None


def clear_npz_generations(path: str) -> None:
    """Remove every generation at ``path`` (the pass completed)."""
    for cand in (path, path + ".prev"):
        if os.path.exists(cand):
            os.remove(cand)


def quarantine_checkpoint(path: str, reason: str) -> str:
    """Move a corrupt file into ``quarantine/`` beside it (never
    deleted: the bytes are the evidence) with a ``.reason.json``
    sidecar.  Returns the quarantined path."""
    d = os.path.dirname(os.path.abspath(path))
    qdir = os.path.join(d, "quarantine")
    os.makedirs(qdir, exist_ok=True)
    base = os.path.basename(path)
    dest = os.path.join(qdir, base)
    n = 1
    while os.path.exists(dest):
        dest = os.path.join(qdir, f"{base}.{n}")
        n += 1
    os.replace(path, dest)
    with open(dest + ".reason.json", "w") as f:
        json.dump({"reason": reason, "ts": round(time.time(), 3),
                   "original": os.path.abspath(path)}, f)
    return dest
