"""Trees and their placement on a ``torch.distributed`` device mesh: the
primitives that the launch layer's sharding rules, the model, the
checkpointer, the data pipeline and POP's map backends all use.

A spec is a :class:`P`, a tuple with one entry a tensor dim (an axis
name, a tuple of names, or None), entry for entry the reference's
``PartitionSpec``.  :func:`placements` turns one into a DTensor placement
a mesh dim (``Shard(d)`` / ``Replicate()``).  A mesh is a ``DeviceMesh``
or, for the rules alone, any object with ``axis_names`` and a ``shape``
mapping of axis name to size (the reference tests' stand-in).

The rules that choose the specs are ``launch/shardings.py``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from .problem import resolve_device


class P(tuple):
    """A partition spec: one entry a tensor dim (an axis name, a tuple of
    axis names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


class Places(tuple):
    """One leaf's DTensor placements, one a mesh dim (a tree leaf, never
    walked into)."""


# ---------------------------------------------------------------------------
# process groups and mesh axes
# ---------------------------------------------------------------------------

def backend_for(device: torch.device) -> str:
    """The process-group backend for ``device``: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def ensure_process_group(device=None) -> torch.device:
    """The process group for ``device`` (default: the card; no card raises):
    the one this process already has, which must use ``device``'s backend,
    or a new world of one on an in-process store.  Returns the device."""
    device = resolve_device(device)
    backend = backend_for(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() not in (backend, "fake"):
        raise RuntimeError(
            f"the process group runs {dist.get_backend()!r}, but a mesh on "
            f"{device} needs {backend!r}")
    return device


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, axis: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(axis))
    return int(mesh.shape[axis])


def dp_axes(mesh):
    """All pure data-parallel axes present in the mesh."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def leading_spec(mesh, ndim: int) -> P:
    """[B, ...] batch leaves of any rank: B on the data axes."""
    return P(dp_axes(mesh), *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------

class Key(NamedTuple):
    kind: str        # "dict" (a dict key) or "seq" (a list index or field)
    key: object


def map_with_path(fn, tree, path=()):
    """``tree``'s structure with each tensor leaf replaced by ``fn(path,
    leaf)``; a path is a tuple of :class:`Key`.  A named tuple's fields
    are "seq" entries, as ``jax.tree_util`` gives a ``KVCache``'s."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (Key("dict", k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (Key("seq", i),))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (Key("seq", i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def zip_map(fn, tree, *others):
    """``tree``'s structure with each leaf ``fn(leaf, *others' leaves)``
    (dicts matched by key)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (P, Places)):
        out = [zip_map(fn, v, *(o[i] for o in others))
               for i, v in enumerate(tree)]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    if tree is None:
        return None
    return fn(tree, *others)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> Places:
    """One DTensor placement a mesh dim: ``Shard(d)`` where tensor dim
    ``d``'s entry names that axis, else ``Replicate()``.  Several axes on
    one dim shard it in mesh order (("pod", "data") as the reference)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec) if name in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return Places(out)


def places_of(tree):
    """The placements of every DTensor leaf of ``tree``."""
    return zip_map(lambda t: Places(t.placements), tree)


def shard_dims(places) -> list:
    """``(mesh dim, tensor dim)`` of every ``Shard`` placement."""
    return [(i, p.dim) for i, p in enumerate(places)
            if getattr(p, "dim", None) is not None and p.is_shard()]


def block_range(size: int, dim: int, places, mesh) -> tuple:
    """``(start, length)`` of this rank's block of tensor dim ``dim``
    (``size`` long) under ``places``: the mesh dims that shard it split
    it in mesh order, the first outermost."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for i, d in shard_dims(places):
        if d == dim:
            index, count = index * mesh.size(i) + coord[i], \
                count * mesh.size(i)
    if size % count:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{count} ranks")
    return index * (size // count), size // count


def local_slice(t: torch.Tensor, places, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``places`` (a
    view; every sharded dim divides evenly, as the rules ensure)."""
    for d in sorted({d for _, d in shard_dims(places)}):
        start, length = block_range(t.shape[d], d, places, mesh)
        t = t.narrow(d, start, length)
    return t


def block(t: torch.Tensor, places, mesh) -> torch.Tensor:
    """This rank's block of ``t`` in storage of its own (``t`` itself when
    the block is all of it), so that ``t`` can be freed."""
    local = local_slice(t, places, mesh)
    if local.numel() == t.numel():
        return t
    return local.clone(memory_format=torch.contiguous_format)


def contiguous_stride(shape) -> tuple:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def from_local(local: torch.Tensor, places, mesh, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's block."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def distribute(t: torch.Tensor, places, mesh, device=None):
    """A DTensor of the global tensor ``t`` (the same on every rank) under
    ``places``: each rank keeps its own block (moved to ``device`` when
    given), no collective runs.  A block that is all of ``t`` is ``t``
    itself, not a copy; a DTensor already placed so comes back as it
    is."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and device is None and \
            tuple(t.placements) == tuple(places) and t.device_mesh == mesh:
        return t
    local = block(t.detach(), places, mesh)
    if device is not None:
        local = local.to(device)
    return from_local(local.contiguous(), places, mesh, t.shape)


def distribute_tree(tree, spec_tree, mesh):
    """Each leaf of ``tree`` distributed by the matching :class:`P`."""
    return zip_map(lambda t, s: distribute(t, placements(s, mesh), mesh),
                   tree, spec_tree)


def local_tree(tree):
    """The local block of every DTensor leaf (plain leaves as they are);
    the blocks share the DTensors' storage."""
    from torch.distributed.tensor import DTensor
    return zip_map(lambda t: t._local_tensor if isinstance(t, DTensor)
                   else t, tree)


def full_tree(tree):
    """Every DTensor leaf gathered whole on every rank."""
    from torch.distributed.tensor import DTensor
    return zip_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                   else t, tree)


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def gather(local: torch.Tensor, places, mesh) -> torch.Tensor:
    """The global tensor from this rank's block: an all-gather over each
    sharded mesh dim, innermost first.  A mesh dim of one rank gathers
    nothing, so on a world of one ``local`` itself comes back."""
    for i, d in reversed(shard_dims(places)):
        n = mesh.size(i)
        if n == 1:
            continue
        src = local.movedim(d, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(i))
        local = out.movedim(0, d)
    return local


class Gather(torch.autograd.Function):
    """:func:`gather` under autograd.  Its backward keeps this rank's block
    of the gradient: every rank of a sharded mesh dim runs the same data
    (the batch lies on the data axes only), so their gradients are equal
    and no collective is needed; the data axes are reduced once a step."""

    @staticmethod
    def forward(ctx, local, places, mesh):
        ctx.places, ctx.mesh = places, mesh
        return gather(local, places, mesh)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.places, ctx.mesh), None, None


def gather_leaf(local: torch.Tensor, places, mesh) -> torch.Tensor:
    if all(mesh.size(i) == 1 for i, _ in shard_dims(places)):
        return local
    return Gather.apply(local, places, mesh)
