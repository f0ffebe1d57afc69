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
# gathers of activations
# ---------------------------------------------------------------------------

def gather(local: torch.Tensor, places, mesh) -> torch.Tensor:
    """The global tensor from this rank's block: an all-gather over each
    sharded mesh dim, innermost first.  A mesh dim of one rank gathers
    nothing, so on a world of one ``local`` itself comes back.  (Decode
    attention gathers its outputs' head_dim blocks with it; no parameter
    is ever gathered.)"""
    for i, d in reversed(shard_dims(places)):
        n = mesh.size(i)
        if n == 1:
            continue
        local = _all_gather(local, d, mesh.get_group(i), n)
    return local


# ---------------------------------------------------------------------------
# the model axis: Megatron's conjugate collectives under autograd
# ---------------------------------------------------------------------------

def _all_reduce(x, group, op=None):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x, dim: int, group, n: int):
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim: int, group, n: int):
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _split(x, dim: int, n: int, rank: int):
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size)


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward (a
    replicated tensor entering products that each rank computes a part
    of)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax.group), None


class _Reduce(torch.autograd.Function):
    """Partial values summed over the group forward; identity backward
    (the sum is used alike on every rank)."""

    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    """Summed over the group both ways: a sum whose every rank's use is
    partial (a norm's statistics over a split dim)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax.group), None


class _Gather(torch.autograd.Function):
    """Blocks along ``dim`` all-gathered forward.  Backward, this rank's
    block of the gradient: taken as it is where every rank uses the whole
    alike (``partial=False``), reduce-scattered where each rank's use is a
    part of the whole's (``partial=True``)."""

    @staticmethod
    def forward(ctx, x, dim, ax, partial):
        ctx.dim, ctx.ax, ctx.partial = dim, ax, partial
        return _all_gather(x, dim, ax.group, ax.size)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        if ctx.partial:
            g = _reduce_scatter(g, ctx.dim, ax.group, ax.size)
        else:
            g = _split(g, ctx.dim, ax.size, ax.rank).contiguous()
        return g, None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``dim`` forward; the blocks' gradients
    all-gathered backward."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _split(x, dim, ax.size, ax.rank)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax.group, ctx.ax.size), \
            None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial values summed over the group and this rank's block along
    ``dim`` kept forward; the gradient blocks all-gathered backward."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _reduce_scatter(x, dim, ax.group, ax.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax.group, ctx.ax.size), \
            None, None


class _Shared(torch.autograd.Function):
    """Identity forward; the gradient divided by the group's size
    backward: a whole computation every rank runs alike on a tensor whose
    gradient is then summed over the group (the sequence-parallel
    gather's reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.size, None


class ModelAxis:
    """This rank's place on the ``model`` axis of a mesh and the
    collectives over it, each an autograd function (Megatron's pairs):

    * :meth:`copy` / :meth:`reduce`: enter / leave products that each
      rank computes a part of (identity / all-reduce forward, all-reduce /
      identity backward);
    * :meth:`gather` / :meth:`scatter`: an activation's blocks along a dim
      gathered / this rank's block kept;
    * :meth:`reduce_scatter`: partial values summed, this rank's block of
      a dim kept (the sequence-parallel exit);
    * :meth:`psum`: a sum used partially on every rank (summed both ways).

    ``sp`` is the sequence-parallel residual: between blocks each rank
    holds its slice of the sequence.  A block then enters by one
    all-gather of its norm output (:meth:`enter`) and leaves by a
    reduce-scatter (:meth:`leave`); without it a block enters by
    :meth:`copy` and leaves by :meth:`reduce`.

    A replicated parameter that a rank uses for its part of a product
    (KV heads of a replicated ``wk``, a router feeding split experts)
    takes a partial gradient; which leaves do is decided by the
    placements and the layouts alone
    (``models.transformer.partial_leaves``), and the train step sums
    their gradients over the axis before AdamW.  A group of one rank is
    never built: the model code then takes its unsharded path, op for
    op."""

    def __init__(self, mesh, sp: bool = False):
        names = axis_names(mesh)
        i = names.index("model")
        self.mesh = mesh
        self.group = mesh.get_group(i)
        self.size = mesh.size(i)
        self.rank = mesh.get_coordinate()[i]
        self.sp = sp

    def __repr__(self):
        shape = dict(zip(axis_names(self.mesh), self.mesh.shape))
        return f"the model axis of the mesh {shape} (rank {self.rank})"

    # where a leaf lies
    def dim(self, places) -> int | None:
        """The tensor dim that ``places`` shard over ``model``, else
        None."""
        if places is None:
            return None
        names = axis_names(self.mesh)
        for i, p in enumerate(places):
            if names[i] == "model" and p.is_shard():
                return p.dim
        return None

    def block(self, size: int) -> tuple:
        """``(start, length)`` of this rank's block of a dim of ``size``."""
        if size % self.size:
            raise ValueError(f"a dim of {size} does not split over a "
                             f"{self.size}-wide model axis")
        n = size // self.size
        return self.rank * n, n

    # collectives
    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def psum(self, x):
        return _Psum.apply(x, self)

    def amax(self, x):
        """The maximum over the group (no gradient)."""
        return _all_reduce(x.detach(), self.group, dist.ReduceOp.MAX)

    def gather(self, x, dim: int, partial: bool = False):
        return _Gather.apply(x, dim % x.ndim, self, partial)

    def scatter(self, x, dim: int):
        return _Scatter.apply(x, dim % x.ndim, self)

    def reduce_scatter(self, x, dim: int):
        return _ReduceScatter.apply(x, dim % x.ndim, self)

    def stack(self, x):
        """``x`` from every rank, stacked in rank order (no gradient)."""
        return _all_gather(x.detach().unsqueeze(0), 0, self.group, self.size)

    # blocks
    def sp_on(self, x) -> bool:
        """Whether ``x`` ([B, S, ...]) runs sequence-parallel: the flag is
        on and the sequence splits (decode's one position never does)."""
        return self.sp and x.shape[1] % self.size == 0

    def enter(self, h, sp: bool):
        """``(hp, hr)`` from a block's norm output ``h``: ``hp`` for the
        products each rank computes a part of, ``hr`` for those every rank
        computes whole.  Under ``sp`` ``h`` is this rank's sequence slice,
        gathered once for both."""
        if sp:
            hp = self.gather(h, 1, partial=True)
            return hp, _Shared.apply(hp, self)
        return self.copy(h), h

    def leave(self, y, sp: bool):
        """A block's partial output summed: whole, or under ``sp`` this
        rank's sequence slice."""
        return self.reduce_scatter(y, 1) if sp else self.reduce(y)

    def leave_whole(self, y, sp: bool):
        """A block's output computed whole on every rank: as it is, or
        under ``sp`` this rank's sequence slice."""
        return self.scatter(y, 1) if sp else y


def model_axis(mesh, sp: bool = False):
    """The :class:`ModelAxis` of ``mesh``, or None where it has no
    ``model`` axis of more than one rank (the unsharded path)."""
    if mesh is None or "model" not in axis_names(mesh):
        return None
    if axis_size(mesh, "model") == 1 or not hasattr(mesh, "get_group"):
        return None
    return ModelAxis(mesh, sp)
