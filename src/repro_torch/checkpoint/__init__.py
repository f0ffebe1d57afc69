"""Atomic, async checkpointing of training state, the session-state byte
format and the host-memory page store for evicted serving tenants — the
port of ``repro/checkpoint``; a training checkpoint restores onto a
device mesh as DTensors (``Checkpointer.restore(mesh=, shardings=)``)."""
from .checkpointer import Checkpointer
from .paged import PagedSessionStore
from .session_state import (CheckpointError, config_digest, pack_state,
                            unpack_state)
