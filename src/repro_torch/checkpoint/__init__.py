"""Session-state byte format and the host-memory page store for evicted
serving tenants — the port of ``repro/checkpoint`` (its sharded model
checkpointer comes with training, ROADMAP open items §1,
item 14.3)."""
from .paged import PagedSessionStore
from .session_state import (CheckpointError, config_digest, pack_state,
                            unpack_state)
