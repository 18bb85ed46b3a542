"""Data parallelism over ``torch.distributed`` (torch twin of
``spec_tpu/parallel/__init__.py``, the data-parallel part).

The JAX package runs one program over a 1-D ``('data',)`` mesh: batch
tensors are sharded over it, parameters and optimizer state replicated,
and XLA inserts the gradient ``psum``. Multi-host is the same program
under ``jax.distributed``. Here the two layouts are:

* **one process, several local devices** (``SpecPredictor(data_parallel
  =True)``, ``make_eval_step(mesh=...)``, ``YoloDetector(mesh=...)``):
  the "mesh" is a list of devices (:func:`create_mesh`). The model is
  copied to each (:func:`replicate`), each copy runs its own stage
  graph, and a call splits the batch into one equal part per device and
  concatenates the outputs on the first (:class:`ReplicatedStage`);
* **one process per GPU** (training): a process group
  (:func:`initialize_multihost`). Each rank loads its contiguous slice
  of every global batch (``data/loader.py``) and runs the step on its
  slice. Inside the step (:func:`sharded_batch`) the batch means of the
  losses divide by global counts and BatchNorm normalizes with the
  global batch statistics, as GSPMD computes them over the sharded
  batch; each rank's loss is then its share of the global loss, and the
  gradients are summed over the ranks in one flat buffer
  (:func:`all_reduce_gradients`). The JAX package runs one process per
  host instead, each driving all of the host's chips.

Backends: NCCL on the card, gloo on the CPU; a caller may name gloo on
the card (two ranks that share one GPU, which NCCL refuses). NCCL's
collectives can be captured in a CUDA graph, so the train step stays one
graph replay; gloo's cannot, so under gloo the step runs its eager body
(:func:`capturable`). That choice follows from the backend; it is never
made by catching a failed capture.

Not ported yet: the height-sharded ``spatial_parallel`` layout (ROADMAP.md
§1 item 12b) and FSDP/HSDP (item 12c); their functions raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

SPATIAL_NOT_PORTED = (
    'spatial_parallel (height-sharded stage 1 with a halo exchange) is '
    'not ported yet (ROADMAP.md §1 item 12b)')
FSDP_NOT_PORTED = (
    'FSDP/HSDP (sharded parameters and optimizer state) is not ported yet '
    '(ROADMAP.md §1 item 12c)')


# -- the process group ------------------------------------------------------


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend ('nccl', 'gloo'), or None."""
    return str(dist.get_backend()) if is_initialized() else None


def capturable() -> bool:
    """Whether a step that runs this process group's collectives can be
    captured in a CUDA graph: yes without a group and under NCCL, no
    under gloo (its collectives run on the host)."""
    return backend() in (None, 'nccl')


def local_rank() -> int:
    """This process's index on its host (a launcher's ``LOCAL_RANK``,
    else the global rank)."""
    return int(os.environ.get('LOCAL_RANK', process_index()))


def local_device(device) -> torch.device:
    """The device this process drives: under a process group, rank r on
    a CUDA device takes ``cuda:{local_rank % device_count}``; otherwise
    ``device`` as given."""
    device = torch.device(device)
    if device.type == 'cuda' and is_initialized():
        return torch.device('cuda', local_rank() % torch.cuda.device_count())
    return device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device='cuda') -> None:
    """Join the process group (once per process, before any collective).

    With ``coordinator_address`` (``host:port`` of rank 0), its world size
    and rank are ``num_processes`` and ``process_id``; a failure raises
    ``RuntimeError`` (running on as a single process would never reduce
    a gradient across ranks). Without it, a launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) is read, as ``jax.distributed.initialize()``
    detects its cluster; with none of them set the process stays on its
    own. ``backend``: 'nccl' or 'gloo'; by default NCCL for a CUDA
    ``device`` and gloo for the CPU. A no-op when a group exists."""
    if is_initialized():
        return
    if not coordinator_address and (num_processes is not None
                                    or process_id is not None):
        raise ValueError('--num_processes and --process_id need '
                         '--coordinator_address')
    device = torch.device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError('--coordinator_address needs --num_processes '
                             'and --process_id')
        kwargs = dict(init_method=f'tcp://{coordinator_address}',
                      world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                                       'MASTER_PORT')):
        kwargs = dict(init_method='env://')
    else:
        return
    if backend == 'nccl':
        rank = int(os.environ.get('LOCAL_RANK',
                                  kwargs.get('rank',
                                             os.environ.get('RANK', 0))))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, **kwargs)
    except Exception as e:
        if coordinator_address:
            raise RuntimeError(f'multi-host initialization failed: {e}') \
                from e
        print(f'[parallel] init_process_group skipped (single process): '
              f'{e}')


def _comm_device() -> torch.device:
    """Where this group's host-side values travel: the current card
    under NCCL, the CPU under gloo."""
    if backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def broadcast_string(s: str, max_len: int = 1024) -> str:
    """Rank 0's string on every rank (a no-op in one process): the ranks
    agree on rank 0's timestamped LOGDIR."""
    if process_count() == 1:
        return s
    data = s.encode()
    if len(data) > max_len:
        raise ValueError(f'string longer than {max_len} bytes: {s!r}')
    buf = torch.zeros(max_len, dtype=torch.uint8, device=_comm_device())
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8)
    dist.broadcast(buf, src=0)
    out = bytes(buf.cpu().tolist())
    return out.split(b'\0', 1)[0].decode()


def all_processes_any(flag: bool) -> bool:
    """OR of a per-rank boolean over the ranks (a no-op in one process).
    Branch into a collective (a checkpoint save, an early return) on a
    per-rank signal such as a SIGTERM latch only after this agreement:
    ranks whose signals arrive an iteration apart would otherwise enter
    different collectives and hang."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k >= n (a batch must divide the mesh)."""
    return ((n + k - 1) // k) * k


# -- meshes: lists of local devices ----------------------------------------


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return d


def create_mesh(devices: Optional[Sequence] = None,
                device=None) -> list:
    """The data-parallel "mesh": a list of local devices, ``devices`` as
    given, else every CUDA device (or ``[device]`` for a CPU ``device``).
    The one seam a test patches to stand for several devices."""
    if devices is not None:
        return [_norm_device(d) for d in devices]
    if device is not None and torch.device(device).type == 'cpu':
        return [torch.device('cpu')]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def create_hybrid_mesh(devices=None, fsdp: int = 2):
    raise NotImplementedError(FSDP_NOT_PORTED)


def fsdp_leaf_sharding(mesh, shape, axis_name=None, min_size=2 ** 14):
    raise NotImplementedError(FSDP_NOT_PORTED)


def fsdp_shardings(tree, mesh, axis_name=None, min_size=2 ** 14):
    raise NotImplementedError(FSDP_NOT_PORTED)


def spatial_sharding(mesh, axis_name=None, ndim: int = 4, dim: int = 1):
    raise NotImplementedError(SPATIAL_NOT_PORTED)


def _split(x, n: int):
    if x.shape[0] % n:
        raise ValueError(f'a batch of {x.shape[0]} rows does not split '
                         f'over {n} devices')
    return list(x.tensor_split(n))


def shard_batch(batch, mesh: Sequence):
    """A global batch (a pytree of tensors, leading dim the batch) as one
    part per device of ``mesh``, each on its device. In one process the
    parts are equal contiguous slices of the whole batch; under a
    process group (one device per rank) the single part is this rank's
    contiguous slice, as ``DataLoader(process_id=...)`` would load it."""
    leaves, spec = pytree.tree_flatten(batch)
    if process_count() > 1:
        if len(mesh) != 1:
            raise ValueError('under a process group each rank drives one '
                             'device')
        r = process_index()
        parts = [[_split(x, process_count())[r] for x in leaves]]
    else:
        split = [_split(x, len(mesh)) for x in leaves]
        parts = [[s[i] for s in split] for i in range(len(mesh))]
    return [pytree.tree_unflatten([x.to(d) for x in p], spec)
            for p, d in zip(parts, mesh)]


def replicate(module: torch.nn.Module, mesh: Sequence) -> list:
    """One copy of ``module`` per device of ``mesh``: the module itself
    where it already lies on the first device, deep copies elsewhere.
    Under a process group instead, every rank takes rank 0's parameters
    and buffers in place (:func:`broadcast_module`) and gets
    ``[module]``."""
    if is_initialized():
        broadcast_module(module)
        return [module]
    mesh = [_norm_device(d) for d in mesh]
    first = next(iter(module.parameters()), None)
    here = _norm_device(first.device) if first is not None else None
    out = []
    for i, d in enumerate(mesh):
        if i == 0 and here == d:
            out.append(module)
        else:
            out.append(copy.deepcopy(module).to(d))
    return out


@torch.no_grad()
def sync_replicas(replicas: Sequence[torch.nn.Module]) -> None:
    """Copy the first replica's parameters and buffers into the others,
    in place (their captured graphs read the same storage)."""
    src = replicas[0].state_dict()
    for r in replicas[1:]:
        for k, v in r.state_dict().items():
            v.copy_(src[k])


class ReplicatedStage:
    """A stage run as one replica per device: ``stages[i]`` (a
    ``StageGraph`` or any callable) takes the i-th of ``len(stages)``
    equal parts of every tensor argument's batch, on ``mesh[i]``, and the
    outputs are concatenated on ``mesh[0]``. ``out_dims``: the batch
    dimension of each output leaf (in ``pytree`` order), or one int for
    all. ``fn`` is the same split over the stages' eager bodies."""

    def __init__(self, stages: Sequence[Callable], mesh: Sequence,
                 out_dims=0):
        if len(stages) != len(mesh):
            raise ValueError('one stage per device')
        self.stages = list(stages)
        self.mesh = list(mesh)
        self.out_dims = out_dims

    @property
    def fn(self) -> 'ReplicatedStage':
        return ReplicatedStage([getattr(s, 'fn', s) for s in self.stages],
                               self.mesh, self.out_dims)

    def __call__(self, *args, **fixed):
        n = len(self.stages)
        if n == 1:
            return self.stages[0](*[a.to(self.mesh[0]) for a in args],
                                  **fixed)
        split = [_split(a, n) for a in args]
        outs = [stage(*[s[i].to(d) for s in split], **fixed)
                for i, (stage, d) in enumerate(zip(self.stages, self.mesh))]
        leaves = [pytree.tree_flatten(o)[0] for o in outs]
        spec = pytree.tree_flatten(outs[0])[1]
        dims = (self.out_dims if not isinstance(self.out_dims, int)
                else [self.out_dims] * len(leaves[0]))
        first = self.mesh[0]
        return pytree.tree_unflatten(
            [torch.cat([lv[k].to(first) for lv in leaves], dim=dims[k])
             for k in range(len(leaves[0]))], spec)


# -- the data-parallel train step -------------------------------------------

# Ranks the batch is sharded over while a step body runs (sharded_batch
# sets it and restores it). Module-level, not thread-local: the autograd
# engine may run a REMAT block's recompute, and its BatchNorms, on a
# thread of its own during the step's backward.
_BATCH_WORLD = 1


@contextlib.contextmanager
def sharded_batch():
    """Inside: the batch the code sees is this rank's slice of a global
    batch sharded over every rank of the process group. The loss
    reductions (:func:`batch_mean`, :func:`all_reduce_data`) and the
    train-mode BatchNorm statistics (``models/backbones/resnet.
    BatchNorm2d``) then reduce over the global batch. Outside, and in
    one process, they are the plain local reductions."""
    global _BATCH_WORLD
    prev, _BATCH_WORLD = _BATCH_WORLD, process_count()
    try:
        yield
    finally:
        _BATCH_WORLD = prev


def batch_world() -> int:
    """The number of ranks the current batch is sharded over (1 outside
    :func:`sharded_batch`)."""
    return _BATCH_WORLD


def all_reduce_data(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t``, a value that depends on the data
    only (a count, a confidence sum: no gradient flows through it), in a
    sharded batch; ``t`` itself otherwise."""
    if _BATCH_WORLD == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the ranks of x; the cotangent of x is the sum over
    the ranks of y's (every rank's loss reads its own y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` with autograd: its backward sums
    the cotangents over the ranks (each rank's loss is its share of the
    global loss). ``t`` itself outside a sharded batch."""
    if _BATCH_WORLD == 1:
        return t
    return _AllReduceSum.apply(t)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch, when ``x`` holds this rank's
    rows (every rank the same number): this rank's share, which summed
    over the ranks is the global mean. ``x.mean()`` in one process."""
    if _BATCH_WORLD == 1:
        return x.mean()
    return x.sum() / (x.numel() * _BATCH_WORLD)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every rank takes rank ``src``'s parameters and buffers, in
    place."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src)


def all_reduce_gradients(grads: Sequence[torch.Tensor]) -> list:
    """The sum over the ranks of every gradient, in one all-reduce of a
    flat fp32 buffer; returns views of the buffer shaped as ``grads``.
    (Under NCCL inside a CUDA graph capture the all-reduce is captured
    with the step.)"""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    out = []
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        out.append(part.view(g.shape).to(g.dtype))
    return out


def all_reduce_metrics(metrics: dict) -> dict:
    """Scalar metrics summed over the ranks in one all-reduce: in a
    sharded batch each rank's loss terms are its shares of the global
    ones."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    return {k: flat[i] for i, k in enumerate(keys)}
