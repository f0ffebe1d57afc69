"""Host-memory page store for evicted tenant session state — the port's
copy of ``repro/checkpoint/paged.py``.

Each evicted tenant's state is ONE packed blob in host memory, encoded
with the self-checking codec the rolling-restart checkpoints use
(:mod:`repro_torch.checkpoint.session_state`), so a paged-out tenant is
byte-for-byte a single-tenant checkpoint: page-in reuses the restore
path, corruption degrades to a cold start, and
:meth:`~repro_torch.service.PopService.checkpoint` folds paged tenants
into a full-service blob without touching device memory.

The store is thread-safe (its own lock) but policy-free: WHO pages out and
when (LRU over resident sessions, the ``max_resident`` cap) is the
service's call; this is just the byte shelf.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from . import session_state

__all__ = ["PagedSessionStore"]


class PagedSessionStore:
    """Packed per-tenant blobs, insertion-ordered (oldest page-out first).

    ``put`` packs (meta, arrays of host numpy) through
    :func:`session_state.pack_state` and replaces any previous blob for
    the tenant.  ``take`` pops AND unpacks (a page-in consumes the blob);
    ``peek_packed`` reads the raw bytes without consuming (the service
    checkpoint path).  All methods are safe under concurrent callers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blobs: "OrderedDict[str, bytes]" = OrderedDict()

    def put(self, tenant: str, meta: dict,
            arrays: Dict[str, np.ndarray]) -> int:
        """Pack and shelve ``tenant``'s state; returns the blob size in
        bytes.  Raises whatever the codec raises (non-JSON meta, ...) —
        the caller decides whether a failed page-out drops state."""
        blob = session_state.pack_state(meta, arrays)
        with self._lock:
            self._blobs.pop(tenant, None)
            self._blobs[tenant] = blob
        return len(blob)

    def take(self, tenant: str) -> Optional[Tuple[dict, Dict[str, np.ndarray]]]:
        """Pop + unpack ``tenant``'s blob; ``None`` when not paged.
        Raises :class:`session_state.CheckpointError` on a corrupt blob
        (the blob is already consumed — a corrupt page never resurrects)."""
        with self._lock:
            blob = self._blobs.pop(tenant, None)
        if blob is None:
            return None
        return session_state.unpack_state(blob)

    def peek_packed(self, tenant: str) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get(tenant)

    def discard(self, tenant: str) -> bool:
        """Drop a tenant's blob (end_session / explicit purge)."""
        with self._lock:
            return self._blobs.pop(tenant, None) is not None

    def tenants(self) -> tuple:
        with self._lock:
            return tuple(self._blobs)

    def nbytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blobs.values())

    def __contains__(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._blobs

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)
