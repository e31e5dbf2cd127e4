"""The five-axis training mesh as ``torch.distributed`` process groups.

Counterpart of ``theanompi_tpu/parallel/mesh.py``.  JAX builds one named
``Mesh`` over its devices and lets XLA place the collectives; here each
rank is its own process, so the mesh is a layout of the WORLD ranks plus
one process group per set of axes the step reduces over.

* **The layout.**  Ranks are laid out row-major over :data:`ALL_AXES`
  (``data, model, pipe, seq, expert``), as JAX's
  ``np.asarray(devices).reshape(shape)``: rank ``r`` holds the mesh
  coordinate JAX gives device ``r``.
* **The groups.**  :meth:`Mesh.axis` returns an :class:`AxisGroup` for a
  set of axes: the ranks that share every OTHER coordinate, ordered by
  rank, which is the row-major order of the set's own coordinates (JAX's
  index over a tuple of axes, e.g. ``P(('data', 'expert'))``).  A set
  that spans the whole world uses the default group (``group=None``), so
  a pure data-parallel mesh reduces exactly as the port did before it had
  a mesh.  A set of one rank has the group :data:`LOCAL`: a collective
  over one rank is never issued (XLA compiles a one-device collective
  away), and the exchanger (parallel/exchanger.py) treats it as it does
  a run without a process group.
* :func:`shard_batch` cuts this rank's block out of a global host batch
  under a partition such as ``("data", "seq")`` (rows over ``data``,
  time over ``seq``) or ``(("data", "expert"),)`` (rows over both).

Every group is made by :func:`make_training_mesh`, on every rank in the
same order (``dist.new_group`` is collective over the world).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names (JAX's).
AXIS_DATA = "data"          # data parallel (the reference's only axis)
AXIS_MODEL = "model"        # tensor parallel
AXIS_PIPE = "pipe"          # pipeline parallel
AXIS_SEQ = "seq"            # sequence/context parallel
AXIS_EXPERT = "expert"      # expert parallel (MoE)

ALL_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT)


class _Local:
    """The group of a set of axes with one rank (:data:`LOCAL`)."""

    def __repr__(self) -> str:
        return "LOCAL"


#: the ``group`` of a one-rank :class:`AxisGroup`: no collective is issued
LOCAL = _Local()


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees.  ``data=-1`` means "all remaining"."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def degrees(self, n_devices: int) -> dict[str, int]:
        fixed = self.model * self.pipe * self.seq * self.expert
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh degrees {data}x{fixed} != device count {n_devices}")
        return {AXIS_DATA: data, AXIS_MODEL: self.model,
                AXIS_PIPE: self.pipe, AXIS_SEQ: self.seq,
                AXIS_EXPERT: self.expert}


def _canon(axes) -> tuple[str, ...]:
    """A set of axes in :data:`ALL_AXES` order (a name or names)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in ALL_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes: {ALL_AXES}")
    return tuple(a for a in ALL_AXES if a in axes)


def mesh_coords(degrees: dict[str, int], rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinate on each axis, row-major over
    :data:`ALL_AXES`."""
    shape = tuple(degrees[a] for a in ALL_AXES)
    return dict(zip(ALL_AXES, (int(c) for c in
                               np.unravel_index(rank, shape))))


def axis_members(degrees: dict[str, int], rank: int,
                 axes) -> tuple[int, ...]:
    """The WORLD ranks that share ``rank``'s coordinate on every axis
    outside ``axes``, in rank order."""
    axes = _canon(axes)
    me = mesh_coords(degrees, rank)
    world = math.prod(degrees.values())
    return tuple(r for r in range(world)
                 if all(c == me[a] for a, c in
                        mesh_coords(degrees, r).items() if a not in axes))


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One set of mesh axes as seen by this rank: ``size`` ranks, this
    rank's ``index`` among them (row-major over the axes), the members'
    WORLD ranks, and the process group (``None``: the default group when
    the set spans the world; :data:`LOCAL` when ``size == 1``)."""

    axes: tuple[str, ...]
    size: int
    index: int
    members: tuple[int, ...]
    group: Any = None

    @property
    def trivial(self) -> bool:
        """One rank: no collective over this group is issued."""
        return self.size == 1

    def peer(self, index: int) -> int:
        """The WORLD rank at ``index`` (mod size) of the group."""
        return self.members[index % self.size]


class Mesh:
    """The mesh of one rank: the degrees (``shape``, in
    :data:`ALL_AXES` order), this rank's WORLD ``rank`` and coordinate,
    and an :class:`AxisGroup` for every set of axes (:meth:`axis`)."""

    def __init__(self, degrees: dict[str, int], rank: int,
                 groups: dict[tuple[str, ...], Any] | None = None):
        self.shape = {a: int(degrees[a]) for a in ALL_AXES}
        self.rank = int(rank)
        self.world = math.prod(self.shape.values())
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {rank} outside a mesh of {self.world}")
        self.coords = mesh_coords(self.shape, self.rank)
        self._groups = dict(groups or {})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _canon(axes))

    def place(self, axes) -> tuple[int, int]:
        """(this rank's index, size) along ``axes``, row-major: the block
        a batch dimension cut over them gives this rank (no group
        needed)."""
        index, size = 0, 1
        for a in _canon(axes):
            index = index * self.shape[a] + self.coords[a]
            size *= self.shape[a]
        return index, size

    def axis(self, axes) -> AxisGroup:
        """The :class:`AxisGroup` of ``axes`` (a name or names)."""
        axes = _canon(axes)
        members = axis_members(self.shape, self.rank, axes)
        big = tuple(a for a in axes if self.shape[a] > 1)
        group = LOCAL if len(members) == 1 else None
        if 1 < len(members) < self.world:
            group = self._groups.get(big)
            if group is None:
                raise RuntimeError(
                    f"no process group for axes {big}: build the mesh "
                    "with make_training_mesh on every rank")
        return AxisGroup(axes, len(members), members.index(self.rank),
                         members, group)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_training_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh of ``spec`` over the WORLD ranks (default: all of them on
    ``data``).  Every rank must call it, in the same order as its other
    group-making calls: a process group is made for each set of axes of
    degree above 1 that does not span the world."""
    spec = spec or MeshSpec()
    world, rank = _world()
    degrees = spec.degrees(world)
    big = [a for a in ALL_AXES if degrees[a] > 1]
    groups: dict = {}
    for k in range(1, len(big)):
        for axes in itertools.combinations(big, k):
            # every rank makes every group, in one order (new_group is
            # collective over the world); it keeps the one it is in
            seen = set()
            for r in range(world):
                members = axis_members(degrees, r, axes)
                if members in seen:
                    continue
                seen.add(members)
                pg = dist.new_group(list(members))
                if rank in members:
                    groups[axes] = pg
    return Mesh(degrees, rank, groups)


def data_mesh(n: int | None = None) -> Mesh:
    """Pure data-parallel mesh over the world (``n``, when given, must be
    the world size: one process per card)."""
    world, _ = _world()
    if n is not None and n != world:
        raise ValueError(f"requested {n} ranks but the world has {world}")
    return make_training_mesh(MeshSpec(data=world))


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape[AXIS_DATA]


def local_batch(global_batch: int, mesh: Mesh) -> int:
    n = data_axis_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data={n}")
    return global_batch // n


def log2_int(n: int) -> int:
    b = int(math.log2(n))
    if 2**b != n:
        raise ValueError(f"{n} is not a power of two")
    return b


def _slice(x, dim: int, index: int, parts: int):
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dimension {dim} of size {n} not divisible by "
                         f"{parts} shards")
    step = n // parts
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(index * step, (index + 1) * step)
    return x[tuple(idx)]


def shard_batch(batch, mesh: Mesh, partition: Sequence = (AXIS_DATA,)):
    """This rank's block of a global host batch (an array, or a tuple or
    list of arrays with the same leading dims): dimension ``i`` is cut
    over ``partition[i]`` (an axis name, a tuple of names sharded
    together, or ``None``: whole), as JAX's ``shard_batch`` places it
    under ``P(*partition)``.  numpy arrays and tensors alike."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh, partition) for x in batch)
    out = batch
    for dim, entry in enumerate(partition):
        if entry is None:
            continue
        index, size = mesh.place(entry)
        if size > 1:
            out = _slice(out, dim, index, size)
    if isinstance(out, np.ndarray):
        return np.ascontiguousarray(out)
    if torch.is_tensor(out):
        return out.contiguous()
    return out


def gather_named(named: dict, placement: dict, order) -> dict:
    """Whole tensors from every rank's shards: ``placement[name]`` is
    ``(AxisGroup, dim)`` for a tensor cut on ``dim`` over the group (an
    all-gather, concatenated in rank order), ``(AxisGroup, None)`` for a
    tensor only this rank of the group holds (the union over the group,
    by ``all_gather_object``), absent for a whole one.  Returns them in
    ``order``.  Every rank calls it together, with the same cut names in
    the same order."""
    full, owned = {}, {}
    for name, t in named.items():
        axis, dim = placement.get(name, (None, None))
        if axis is None or axis.trivial:
            full[name] = t.detach()
        elif dim is None:
            owned.setdefault(axis.axes, (axis, {}))[1][name] = (
                t.detach().cpu())
        else:
            parts = [torch.empty_like(t) for _ in range(axis.size)]
            dist.all_gather(parts, t.detach().contiguous(), group=axis.group)
            full[name] = torch.cat(parts, dim)
    device = next(iter(named.values())).device if named else None
    for axis, mine in owned.values():
        objs = [None] * axis.size
        dist.all_gather_object(objs, mine, group=axis.group)
        for got in objs:
            full.update({k: v.to(device) for k, v in got.items()})
    return {name: full[name] for name in order}


def local_named(full: dict, placement: dict, names) -> dict:
    """This rank's block of each of ``names`` from whole tensors
    (:func:`gather_named` inverted)."""
    out = {}
    for name in names:
        t = full[name]
        axis, dim = placement.get(name, (None, None))
        if axis is not None and dim is not None and not axis.trivial:
            t = t.chunk(axis.size, dim)[axis.index]
        out[name] = t
    return out
