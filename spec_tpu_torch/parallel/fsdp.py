"""FSDP/HSDP: the optimizer state sharded leaf-wise over groups of ranks
(torch twin of ``spec_tpu/parallel/__init__.py``'s ``create_hybrid_mesh``,
``fsdp_leaf_sharding``, ``fsdp_shardings`` and ``shard_like``).

The JAX package lays parameters and optimizer state out with
``NamedSharding`` s and lets XLA insert the all-gathers and
reduce-scatters. Here the layout is explicit:

* a :class:`ProcessMesh` describes the ranks of the process group as a
  1-D ``('data',)`` grid (full-axis FSDP, :func:`create_process_mesh`)
  or a 2-D ``('data', 'fsdp')`` grid of shape (n/fsdp, fsdp) whose rows
  are runs of consecutive ranks (HSDP, :func:`create_hybrid_mesh`);
* :func:`fsdp_leaf_sharding` is the reference's rule as a pure function
  of the shard group's size and a shape: a leaf of at least ``min_size``
  elements is split along its largest axis that the group divides (the
  first on ties), every other leaf is replicated;
* :func:`shard_like` binds a train state to those shardings: the
  optimizer (``train/state.Optimizer``) then steps on this rank's slice
  of each sharded leaf (a view of the model's parameter along the
  sharded axis) and keeps its slots at the slice's shape.

The parameters stay whole on every rank between steps. The train step
is one CUDA graph, which would gather sharded parameters into its
private memory pool and keep them there, so sharding them would save
nothing; validation, SMPLify's prediction graph, the TensorBoard
forward and export read whole parameters too. What is sharded is the
gradient after its reduction, the optimizer's slots and the update: in
a step (``train/steps.TrainStep``) the sharded leaves' gradients are
packed rank-major into one flat buffer and reduce-scattered over the
shard group (then all-reduced over the data group under HSDP), the
replicated leaves' are all-reduced over every rank, the optimizer
updates the slices, and :meth:`FsdpLayout.gather_params` all-gathers
the updated slices back into the parameters in place. The saving per
rank is the optimizer state (Adam's moments, SGD's trace, the
accumulator under GRAD_ACCUM_STEPS).

Collectives: ``reduce_scatter_tensor`` and ``all_gather_into_tensor``,
under NCCL and under gloo alike (gloo takes CPU and CUDA tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

# (this module is imported at the end of the package's __init__)
from spec_tpu_torch import parallel as par

DATA_AXIS = 'data'
FSDP_AXIS = 'fsdp'

@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """Ranks as a grid: ``ranks`` is a 1-D array (axis ``'data'``) or a
    2-D one (axes ``'data'``, ``'fsdp'``). ``shard_group`` and
    ``replica_group`` are this rank's groups along the sharding axis and,
    on a 2-D grid, along ``'data'`` (None without a process group)."""

    ranks: np.ndarray
    axis_names: tuple
    shard_group: Any = None
    replica_group: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def shard_axis(self) -> str:
        """Leaves shard over the inner 'fsdp' axis on a hybrid mesh, else
        over the data axis (full-axis ZeRO)."""
        return FSDP_AXIS if FSDP_AXIS in self.axis_names else DATA_AXIS

    def shard_index(self) -> int:
        """This rank's position along the sharding axis."""
        where = np.argwhere(self.ranks == par.process_index())
        if not len(where):
            raise ValueError(f'rank {par.process_index()} is not in the '
                             f'mesh {self.ranks.tolist()}')
        return int(where[0][-1])


def _groups_of(lines) -> Optional[Any]:
    """A group for each line of ranks, created on every rank in the same
    order (``dist.new_group`` is collective); returns this rank's."""
    me = par.process_index()
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if me in line:
            mine = g
    return mine


def _ranks(devices) -> list:
    if devices is None:
        return list(range(par.process_count()))
    return [int(r) for r in devices]


def _grouped(ranks) -> bool:
    """Whether ``ranks`` are the process group's (its groups exist)."""
    return par.is_initialized() and sorted(ranks) == list(
        range(par.process_count()))


def create_process_mesh(devices: Optional[Sequence[int]] = None
                        ) -> ProcessMesh:
    """1-D ``('data',)`` mesh over every rank of the process group (or
    the given ranks): full-axis FSDP shards over all of them."""
    ranks = _ranks(devices)
    group = dist.group.WORLD if _grouped(ranks) else None
    return ProcessMesh(np.asarray(ranks), (DATA_AXIS,), group, None)


def create_hybrid_mesh(devices: Optional[Sequence[int]] = None,
                       fsdp: int = 2) -> ProcessMesh:
    """2-D HSDP mesh ``('data', 'fsdp')`` of shape (n/fsdp, fsdp) over
    the ranks of the process group (or the given ranks): consecutive
    ranks form an fsdp group, as the reference's reshape groups a host's
    devices first, and the data groups take the ranks at the same place
    in each fsdp group. Leaves shard over the fsdp group and replicate
    over the data group. Under a process group every rank must call it
    (it creates the groups). ``fsdp=n`` is full-axis FSDP, ``fsdp=1``
    pure data parallelism."""
    ranks = _ranks(devices)
    n = len(ranks)
    if fsdp < 1 or n % fsdp != 0:
        raise ValueError(f'{n} devices not divisible by fsdp={fsdp}')
    grid = np.asarray(ranks).reshape(n // fsdp, fsdp)
    shard = replica = None
    if _grouped(ranks):
        shard = _groups_of(grid.tolist())
        replica = _groups_of(grid.T.tolist())
    return ProcessMesh(grid, (DATA_AXIS, FSDP_AXIS), shard, replica)


@dataclasses.dataclass(frozen=True)
class FsdpSharding:
    """A leaf split into ``count`` equal slices along ``dim``, one per
    rank of the mesh's ``axis_name``."""

    dim: int
    count: int
    axis_name: str
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def fsdp_leaf_sharding(mesh, shape, axis_name: Optional[str] = None,
                       min_size: int = 2 ** 14) -> Optional[FsdpSharding]:
    """ZeRO/FSDP sharding of one leaf of ``shape``: split the LARGEST
    axis that the shard group's size divides (the first on ties, as
    ``max`` picks); None (replicated) for a leaf smaller than
    ``min_size`` or with no divisible axis. ``axis_name``: of ``mesh``
    (by default its 'fsdp' axis on a hybrid mesh, else 'data'). Needs no
    process group. On the port's shapes (OIHW convolutions, (out, in)
    dense kernels) the set of sharded leaves and the size of each
    sharded axis are the reference's; only a tie may pick another axis
    index."""
    axis_name = axis_name or mesh.shard_axis
    n = mesh.shape[axis_name]
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape) if shape else 0
    if size < min_size:
        return None
    divisible = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not divisible:
        return None
    dim = max(divisible, key=lambda d: shape[d])
    return FsdpSharding(dim, n, axis_name, mesh)


def fsdp_shardings(tree, mesh, axis_name: Optional[str] = None,
                   min_size: int = 2 ** 14):
    """``tree`` (a pytree of tensors, or of shapes as ``torch.Size``)
    with each leaf replaced by its :func:`fsdp_leaf_sharding`."""
    return pytree.tree_map(
        lambda x: fsdp_leaf_sharding(mesh, getattr(x, 'shape', x),
                                     axis_name, min_size), tree)


def shard_like(state, shardings):
    """Bind ``state`` (a ``train.state.TrainState``) to ``shardings``,
    one per tensor of its optimizer (``fsdp_shardings(state.optimizer.
    params, mesh)``): the optimizer keeps this rank's slice of each
    sharded leaf's slots (sliced from their current values) and steps on
    slices from then on. Returns ``state``."""
    state.optimizer.shard(FsdpLayout(state.optimizer.params,
                                     list(shardings)))
    return state


class FsdpLayout:
    """``params`` laid out by ``shardings`` (None: replicated) over one
    :class:`ProcessMesh`: this rank's slices (:attr:`local`), the
    gradient reduction onto them and the gather of updated slices. In
    one process without a group every collective is the identity (a
    mesh of one rank)."""

    def __init__(self, params: list, shardings: list):
        if len(params) != len(shardings):
            raise ValueError(f'{len(shardings)} shardings for '
                             f'{len(params)} tensors')
        meshes = {id(s.mesh): s.mesh for s in shardings if s is not None}
        if len(meshes) > 1:
            raise ValueError('the shardings name more than one mesh')
        self.params = params
        self.shardings = shardings
        self.mesh = next(iter(meshes.values()), None)
        self.sharded = [i for i, s in enumerate(shardings) if s is not None]
        self.replicated = [i for i, s in enumerate(shardings) if s is None]
        self.count = shardings[self.sharded[0]].count if self.sharded else 1
        if self.count > 1 and self.mesh.shard_group is None:
            raise ValueError(f'a layout over {self.count} ranks needs their '
                             'process group')
        self.index = self.mesh.shard_index() if self.sharded else 0
        self.local = [p if s is None else self.slice(i, p)
                      for i, (p, s) in enumerate(zip(params, shardings))]
        # elements of each sharded leaf's slice, in the packed buffers
        self._sizes = [self.local[i].numel() for i in self.sharded]
        self._per_rank = sum(self._sizes)

    def slice(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``whole`` (a tensor of ``params[i]``'s
        shape) along leaf i's sharded axis: a view of its storage with no
        autograd history. (A view that autograd records would keep the
        parameter's gradient accumulator alive from the stream it was
        made on, and a CUDA graph capture of the backward on another
        stream would then wait on that one and fail.)"""
        s = self.shardings[i]
        if s is None:
            return whole
        c = whole.shape[s.dim] // s.count
        return whole.detach().narrow(s.dim, self.index * c, c)

    # -- collectives ------------------------------------------------------

    def _reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the shard group of ``flat`` (n rank-major
        chunks), this rank's chunk."""
        group, n = self.mesh.shard_group, self.count
        if group is None:
            return flat
        out = flat.new_empty(flat.numel() // n)
        dist.reduce_scatter_tensor(out, flat, group=group)
        return out

    def _all_gather(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's ``part``, rank-major, over the shard group."""
        group, n = self.mesh.shard_group, self.count
        if group is None:
            return part
        out = part.new_empty(part.numel() * n)
        dist.all_gather_into_tensor(out, part, group=group)
        return out

    # -- packing ----------------------------------------------------------

    def _pack_whole(self, tensors) -> torch.Tensor:
        """Whole tensors of the sharded leaves -> one flat fp32 buffer of
        ``count`` rank-major chunks (chunk r: every leaf's slice r)."""
        n = self.count
        cols = [t.detach().movedim(self.shardings[i].dim, 0).reshape(n, -1)
                .float() for i, t in zip(self.sharded, tensors)]
        return torch.cat(cols, dim=1).reshape(-1)

    def _pack_local(self, tensors) -> torch.Tensor:
        """Slices of the sharded leaves -> one flat fp32 chunk."""
        return torch.cat([t.detach().movedim(self.shardings[i].dim, 0)
                          .reshape(-1).float()
                          for i, t in zip(self.sharded, tensors)])

    def _unpack_local(self, part: torch.Tensor) -> list:
        """A flat chunk -> views shaped as the sharded leaves' slices."""
        out = []
        for i, chunk in zip(self.sharded, part.split(self._sizes)):
            d = self.shardings[i].dim
            moved = self.local[i].movedim(d, 0).shape
            out.append(chunk.view(moved).movedim(0, d))
        return out

    def _unpack_whole(self, full: torch.Tensor) -> list:
        """``count`` rank-major chunks -> whole tensors of the sharded
        leaves (fp32)."""
        rows = full.view(self.count, self._per_rank)
        out, off = [], 0
        for i, k in zip(self.sharded, self._sizes):
            d = self.shardings[i].dim
            moved = self.params[i].movedim(d, 0).shape
            out.append(rows[:, off:off + k].reshape(moved).movedim(0, d))
            off += k
        return out

    # -- the step ---------------------------------------------------------

    def reduce_gradients(self, grads: list) -> list:
        """Whole local gradients (one per tensor) -> the gradients of
        this rank's slices, summed over every rank: the sharded leaves'
        reduce-scattered over the shard group in one flat buffer (then
        all-reduced over the data group under HSDP), the replicated
        leaves' all-reduced over every rank in another."""
        if not par.is_initialized():
            return [self.slice(i, g) for i, g in enumerate(grads)]
        out = [None] * len(grads)
        if self.sharded:
            part = self._reduce_scatter(
                self._pack_whole([grads[i] for i in self.sharded]))
            if self.mesh.replica_group is not None:
                dist.all_reduce(part, group=self.mesh.replica_group)
            for i, g in zip(self.sharded, self._unpack_local(part)):
                out[i] = g.to(grads[i].dtype)
        if self.replicated:
            reduced = par.all_reduce_gradients(
                [grads[i] for i in self.replicated])
            for i, g in zip(self.replicated, reduced):
                out[i] = g
        return out

    def global_norm(self, grads: list) -> torch.Tensor:
        """The L2 norm of the whole gradient from its slices: the sharded
        leaves' squares summed over the shard group, the replicated
        leaves' (whole on every rank) added once."""
        norms = torch._foreach_norm(grads)

        def sum_sq(idx):
            if not idx:
                return norms[0].new_zeros(())
            return torch.stack([norms[i] for i in idx]).square().sum()

        sharded = sum_sq(self.sharded)
        if self.sharded and self.mesh.shard_group is not None:
            dist.all_reduce(sharded, group=self.mesh.shard_group)
        return torch.sqrt(sharded + sum_sq(self.replicated))

    @torch.no_grad()
    def gather_params(self) -> None:
        """All-gather the updated slices over the shard group into the
        whole parameters, in place."""
        if not self.sharded or self.mesh.shard_group is None:
            return
        whole = self.gather_whole(self.local)
        for i in self.sharded:
            self.params[i].copy_(whole[i])

    def gather_whole(self, tensors: list) -> list:
        """Slices (one per tensor, shaped as :attr:`local`) -> whole
        tensors, gathered over the shard group (a collective: every rank
        of the group calls it); replicated entries as given."""
        out = list(tensors)
        if not self.sharded:
            return out
        full = self._all_gather(self._pack_local(
            [tensors[i] for i in self.sharded]))
        for i, whole in zip(self.sharded, self._unpack_whole(full)):
            out[i] = whole.to(tensors[i].dtype)
        return out
