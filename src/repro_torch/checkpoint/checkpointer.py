"""Checkpointing with atomic commits, async writes and restart — the port
of ``repro/checkpoint/checkpointer.py``, with its on-disk layout, so
either package restores the other's checkpoint.

Layout (one directory per step):

    <dir>/step_000123/
        manifest.json        # keys, shapes, dtypes, extras
        arrays.npz           # one entry per leaf, path-keyed

Keys are the reference's: ``jax.tree_util.tree_flatten_with_path`` over
the tree, each path joined by ``/`` (dict keys sorted, list entries as
their index, a named tuple's fields as ``.field``, so an ``AdamWState``
gives ``opt/.step``, ``opt/.m/...``).  Commit protocol: write into
``step_N.tmp``, fsync, rename to ``step_N``; ``latest()`` only ever sees
fully committed directories.  ``save_async`` copies the leaves to host
memory before it returns (so the next step may update them in place) and
serialises in a thread.

Restores place each leaf on the device of the matching leaf of
``like_tree``, or, onto a device mesh, as a DTensor (``restore(mesh=,
shardings=)``).  A sharded tree (DTensor leaves) is saved whole: every
rank gathers each leaf (a collective, so every rank calls ``save``) and
rank 0 writes.  So a checkpoint written on one mesh restores onto another
or onto none.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..core.placement import P, Places, distribute, placements

def _entries(tree, path=()):
    """``(key, leaf)`` in the reference's flattening order (a spec or a
    placement tuple of ``core.placement`` is a leaf)."""
    if isinstance(tree, (P, Places)):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _entries(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _entries(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _entries(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _flatten(tree):
    entries = list(_entries(tree))
    return [k for k, _ in entries], [leaf for _, leaf in entries]


def _rebuild(like, leaf_of, path=()):
    """``like``'s structure with each leaf replaced by ``leaf_of(key,
    leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_of, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaf_of,
                                     path + (f".{f}",))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf_of, path + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaf_of("/".join(path), like)


def _host(leaf, keep: bool = True):
    """A host copy of a leaf (never a view of memory a later step may
    write); a DTensor is gathered whole first.  With ``keep=False`` the
    gather still runs (every rank takes part in it) and nothing is
    copied."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not keep:
            return None
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _host_copies(keys, leaves) -> dict:
    """Host copies of the leaves on the writing rank; a sharded leaf is
    gathered one at a time, and the other ranks keep nothing."""
    writer = _writer()
    return {k: _host(l, writer) for k, l in zip(keys, leaves)}


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only
    process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _write(directory: str, step: int, keys, host: dict, extras):
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "keys": keys,
        "shapes": {k: list(a.shape) for k, a in host.items()},
        "dtypes": {k: str(a.dtype) for k, a in host.items()},
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extras: Optional[dict] = None):
        keys, leaves = _flatten(tree)
        host = _host_copies(keys, leaves)
        if _writer():
            _write(self.dir, step, keys, host, extras)

    def save_async(self, step: int, tree, extras: Optional[dict] = None):
        """Copy to host memory now, write in the background.  Joins any
        in-flight write first (ordering)."""
        self.wait()
        keys, leaves = _flatten(tree)
        host = _host_copies(keys, leaves)

        def work():
            try:
                if _writer():
                    _write(self.dir, step, keys, host, extras)
            except Exception as exc:       # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="pop-checkpoint")
        self._thread.start()

    def wait(self):
        """Join the in-flight write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: int, like_tree, mesh=None, shardings=None):
        """Restore into the structure of ``like_tree`` (keys and shapes
        checked): ``(tree, extras)``, each leaf on the device of
        ``like_tree``'s leaf, in the dtype it was saved in.

        Onto a ``mesh`` each leaf becomes a DTensor: placed by the matching
        leaf of ``shardings`` (a tree like ``like_tree`` of placements, or
        of ``core.placement.P`` specs), else as ``like_tree``'s leaf is
        placed when it is a DTensor, else replicated.  Each rank keeps its
        own blocks; no collective runs."""
        if shardings is not None and mesh is None:
            raise ValueError("shardings= needs the mesh= they lie on")
        sharded = _sharded_leaf(mesh, shardings)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        keys, _ = _flatten(like_tree)
        if keys != manifest["keys"]:
            raise ValueError("checkpoint/model structure mismatch: "
                             f"{sorted(set(keys) ^ set(manifest['keys']))}")
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            def leaf_of(key, proto):
                a = arrays[key]
                if tuple(a.shape) != tuple(proto.shape):
                    raise ValueError(f"{key}: shape {a.shape}, expected "
                                     f"{tuple(proto.shape)}")
                if mesh is not None:
                    return sharded(key, proto, torch.from_numpy(a))
                device = (proto.device if isinstance(proto, torch.Tensor)
                          else "cpu")
                return torch.from_numpy(a).to(device, copy=True)
            tree = _rebuild(like_tree, leaf_of)
        return tree, manifest["extras"]


def _sharded_leaf(mesh, shardings):
    """``fn(key, proto, host tensor) -> DTensor`` for a restore onto
    ``mesh``; the placements of each key are read from ``shardings``."""
    if mesh is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate

    by_key = dict(_entries(shardings)) if shardings is not None else {}
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)

    def place(key, proto, host):
        pl = by_key.get(key)
        if isinstance(pl, P):
            pl = placements(pl, mesh)
        if pl is None:
            pl = (tuple(proto.placements) if isinstance(proto, DTensor)
                  else (Replicate(),) * mesh.ndim)
        return distribute(host, Places(pl), mesh, device=device)
    return place
