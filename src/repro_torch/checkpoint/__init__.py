"""Atomic, async checkpointing of training state, the session-state byte
format and the host-memory page store for evicted serving tenants — the
port of ``repro/checkpoint`` (sharded restores onto a mesh are ROADMAP
item 14.5)."""
from .checkpointer import Checkpointer
from .paged import PagedSessionStore
from .session_state import (CheckpointError, config_digest, pack_state,
                            unpack_state)
