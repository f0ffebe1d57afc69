"""Self-describing byte format for serialized PopService session state —
the port's copy of ``repro/checkpoint/session_state.py``, byte-compatible
with it: a blob packed by either package unpacks in the other, and equal
configs give equal :func:`config_digest` strings in both.

`PopService.checkpoint()` / `PopService.restore()` (the rolling-restart
path) serialize every tenant session's warm state — PopPlan arrays +
solver iterates + entity ids + a config digest — into one `bytes` blob
through this module.  The format is deliberately dumb and fully
self-checking, so a torn write, a truncated copy, or a blob from a
different build degrades to a COLD START at restore time instead of a
crash or (worse) silently wrong warm state:

    MAGIC (8 bytes)  b"POPSES1\\n"
    LEN   (8 bytes)  little-endian manifest byte length
    MANIFEST         UTF-8 JSON: {"version", "payload_sha256",
                     "payload_len", "meta": <caller meta>}
    PAYLOAD          an .npz archive of the named arrays

Integrity = sha256 over the payload, pinned in the manifest; alignment
(array shapes vs. plan shapes, entity-id counts, config digests) is the
caller's job — :meth:`repro_torch.service.PopService.restore` checks those
per tenant.  Arrays are host numpy: the caller moves device tensors to the
host first.  Every parse failure raises :class:`CheckpointError` (a
``ValueError``), never anything rawer.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zipfile
from typing import Dict, Tuple

import numpy as np

__all__ = ["MAGIC", "VERSION", "CheckpointError", "pack_state",
           "unpack_state", "config_digest"]

MAGIC = b"POPSES1\n"
VERSION = 1

_LEN = struct.Struct("<Q")


class CheckpointError(ValueError):
    """Raised for any malformed / corrupt / incompatible checkpoint blob."""


def config_digest(*cfgs) -> str:
    """Stable digest of (frozen, repr-deterministic) config dataclasses.
    A restored session must reconstruct configs with the SAME digest, or
    the warm state belongs to a different solver setup and is stale."""
    h = hashlib.sha256()
    for c in cfgs:
        h.update(repr(c).encode("utf-8"))
    return h.hexdigest()[:16]


def pack_state(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize ``meta`` (JSON-able) + named numpy arrays to bytes."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    manifest = json.dumps({
        "version": VERSION,
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
        "payload_len": len(payload),
        "meta": meta,
    }, sort_keys=True).encode("utf-8")
    return MAGIC + _LEN.pack(len(manifest)) + manifest + payload


def unpack_state(data: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Parse a :func:`pack_state` blob -> (meta, arrays).

    Raises :class:`CheckpointError` on bad magic, truncation, version
    mismatch, hash mismatch, or undecodable manifest/payload.
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise CheckpointError(
            f"checkpoint must be bytes, got {type(data).__name__}")
    data = bytes(data)
    hdr = len(MAGIC) + _LEN.size
    if len(data) < hdr:
        raise CheckpointError(
            f"checkpoint truncated: {len(data)} bytes < {hdr}-byte header")
    if data[:len(MAGIC)] != MAGIC:
        raise CheckpointError("bad checkpoint magic (not a PopService "
                              "session checkpoint)")
    (mlen,) = _LEN.unpack(data[len(MAGIC):hdr])
    if len(data) < hdr + mlen:
        raise CheckpointError("checkpoint truncated inside manifest")
    try:
        manifest = json.loads(data[hdr:hdr + mlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(f"undecodable checkpoint manifest: {e}")
    version = manifest.get("version")
    if version != VERSION:
        raise CheckpointError(
            f"unsupported checkpoint version {version!r} (this build "
            f"reads version {VERSION})")
    payload = data[hdr + mlen:]
    want_len = manifest.get("payload_len")
    if want_len != len(payload):
        raise CheckpointError(
            f"checkpoint truncated: payload is {len(payload)} bytes, "
            f"manifest promises {want_len}")
    digest = hashlib.sha256(payload).hexdigest()
    if digest != manifest.get("payload_sha256"):
        raise CheckpointError("checkpoint payload hash mismatch "
                              "(corrupt or tampered blob)")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except (zipfile.BadZipFile, ValueError, OSError, KeyError) as e:
        raise CheckpointError(f"undecodable checkpoint payload: {e}")
    return manifest.get("meta", {}), arrays
