"""Spatial partitioning of stage 1: bands of image rows over local
devices (torch twin of the reference's ``spatial_sharding`` layout,
``spec_tpu/parallel/__init__.py:80-103``, as
``spec_tpu/serving.py:307-322`` uses it).

The JAX package shards stage 1's NHWC frames along their height over the
mesh; GSPMD swaps each convolution's halo rows with the neighbouring
shards (a collective-permute), pads a ragged split and turns the global
average pool into a sum over the shards. Here that layout is explicit,
in one process over a list of local devices (``parallel.create_mesh``),
each with its own copy of the trunk (``parallel.replicate``):

* **bands.** Each device owns one band of rows. The cuts fall on
  multiples of the trunk's stride (32 input rows for a ResNet), so at
  every layer a band that owns input rows ``[2a, 2b)`` of a stride-2
  layer owns its output rows ``[a, b)``, and a block's residual branch
  lines up with its downsample. The trunk's last rows
  (``ceil(H / 32)``) are dealt in chunks of ``ceil(rows / n)``, as GSPMD
  splits a ragged dimension: bands at the end may own none, and then run
  nothing (:func:`band_rows`).
* **halos.** Before each layer whose window spans more than one row (the
  stem, the max pool, every 3x3 conv), a band takes the input rows its
  output rows need from the bands that own them: device-to-device copies
  (:func:`_gather`). Only the frame's top and bottom edges are padded
  (zeros; -inf for the pool, as torch pads it); an inner band edge never
  pads.
* **segments.** Between two exchanges a band runs a segment: the window
  layer without height padding, then the layers that act on each row
  (1x1 convs, eval BatchNorm, ReLU, the residual add) up to the next
  window. Each (band, segment) is a ``StageGraph`` on the band's device:
  on a card every segment replays a CUDA graph and the copies are queued
  between the replays; on the CPU it runs directly. The code is the same
  for two bands on one card and for two bands on two cards.
* **pool and heads.** A band's last segment returns the row sums of its
  part of the feature map (fp32); the first device adds them, divides by
  the full output height times width and runs the heads once.

Every band stays ``channels_last`` and runs inside the compute-dtype
context of the plain stage. The layout is inference only (BatchNorm in
eval mode acts on each element): a trunk in train mode is refused.
"""

from __future__ import annotations

import copy
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from spec_tpu_torch.utils.graphs import StageGraph
from spec_tpu_torch.utils.precision import compute_dtype

HRNET_NOT_PORTED = (
    'spatial_parallel over an HRNet CamCalib trunk (its parallel '
    'resolutions exchange rows at four strides) is not ported yet '
    '(ROADMAP.md §1 item 12d); use a ResNet camcalib_backbone')


class SpatialSharding(NamedTuple):
    """Which devices a batch is split over, and along which dimension
    (the counterpart of ``PartitionSpec(None, ('data',), None, None)``:
    an NHWC batch's height over the whole mesh)."""
    devices: list
    dim: int
    ndim: int


def spatial_sharding(mesh: Sequence, axis_name=None, ndim: int = 4,
                     dim: int = 1) -> SpatialSharding:
    """The height of an NHWC batch (``dim``) split over ``mesh`` (a list of
    devices; ``axis_name`` is the reference's, and the mesh here has one
    axis)."""
    return SpatialSharding(list(mesh), dim, ndim)


def band_rows(height: int, n: int, unit: int) -> List[tuple]:
    """Rows ``[lo, hi)`` of each of ``n`` bands of ``height`` rows, cut at
    multiples of ``unit`` (the stride still to come): the ``ceil(height /
    unit)`` units in chunks of ``ceil(units / n)``, the last band taking
    the ragged rest, bands past the units empty."""
    units = -(-height // unit)
    chunk = -(-units // n)
    return [(min(i * chunk * unit, height), min((i + 1) * chunk * unit,
                                                height))
            for i in range(n)]


class _Window:
    """A layer whose window spans rows: a conv or a max pool, applied
    without height padding to a tile that holds every row its output
    rows read (padding rows included)."""

    def __init__(self, layer: nn.Module):
        pair = nn.modules.utils._pair
        self.layer = layer
        self.k, self.kw = pair(layer.kernel_size)
        self.s, self.sw = pair(layer.stride)
        self.p, self.pw = pair(layer.padding)
        self.fill = float('-inf') if isinstance(layer, nn.MaxPool2d) else 0.0

    def out_size(self, h: int, w: int) -> tuple:
        return ((h + 2 * self.p - self.k) // self.s + 1,
                (w + 2 * self.pw - self.kw) // self.sw + 1)

    def needs(self, lo: int, hi: int) -> tuple:
        """The input rows ``[lo', hi')`` that output rows ``[lo, hi)``
        read (past the frame where they reach the padding)."""
        return lo * self.s - self.p, (hi - 1) * self.s - self.p + self.k

    def __call__(self, x):
        m = self.layer
        if isinstance(m, nn.MaxPool2d):
            return F.max_pool2d(x, m.kernel_size, m.stride, (0, self.pw),
                                m.dilation, m.ceil_mode)
        return F.conv2d(x, m.weight, m.bias, m.stride, (0, self.pw),
                        m.dilation, m.groups)


def _program(trunk: nn.Module) -> list:
    """A ResNet trunk (``models/backbones/resnet.ResNet``) as a list of
    (window layer, tail): segment j applies window j to its tile, then
    tail j, the row-wise layers up to the next window, which takes (the
    window's output, *carried tensors) and returns (the tensor the next
    window reads, *carried tensors). A residual block carries its
    identity branch; the last tail returns the row sums of the feature
    map in fp32."""
    from spec_tpu_torch.models.backbones.resnet import (
        BasicBlock,
        Bottleneck,
        ResNet,
    )

    if not isinstance(trunk, ResNet):
        raise NotImplementedError(HRNET_NOT_PORTED)
    ops: list = [trunk.conv1, lambda x: (trunk.relu(trunk.bn1(x)),),
                 trunk.maxpool]
    for layer in (trunk.layer1, trunk.layer2, trunk.layer3, trunk.layer4):
        for blk in layer:
            def ident(x, blk=blk):
                return x if blk.downsample is None else blk.downsample(x)

            if isinstance(blk, Bottleneck):
                ops += [lambda x, blk=blk, ident=ident: (
                            blk.relu(blk.bn1(blk.conv1(x))), ident(x)),
                        blk.conv2,
                        lambda y, idn, blk=blk: (blk.relu(
                            blk.bn3(blk.conv3(blk.relu(blk.bn2(y)))) + idn),)]
            elif isinstance(blk, BasicBlock):
                ops += [lambda x, ident=ident: (x, ident(x)),
                        blk.conv1,
                        lambda y, idn, blk=blk: (blk.relu(blk.bn1(y)), idn),
                        blk.conv2,
                        lambda y, idn, blk=blk: (blk.relu(blk.bn2(y) + idn),)]
            else:
                raise TypeError(f'a ResNet trunk of BasicBlock or '
                                f'Bottleneck blocks, not '
                                f'{type(blk).__name__}')
    ops.append(lambda x: (x.float().sum((2, 3)),))

    program = []
    for op in ops:
        if isinstance(op, nn.Module):
            program.append((_Window(op), []))
        else:
            program[-1][1].append(op)
    return [(window, _chain(tail)) for window, tail in program]


def _chain(fns: list) -> Callable:
    def tail(*state):
        for f in fns:
            state = f(*state)
        return state
    return tail


class _Segment:
    """One band's segment body: ``prep`` (the first segment's
    elementwise input transform), the edge padding rows, the window, the
    tail. ``top`` and ``bottom`` are the padding rows (fixed per graph)."""

    def __init__(self, window: _Window, tail: Callable, dtype: torch.dtype,
                 prep: Optional[Callable] = None):
        self.window = window
        self.tail = tail
        self.dtype = dtype
        self.prep = prep

    def __call__(self, tile, *carry, top: int, bottom: int):
        x = self.prep(tile) if self.prep is not None else tile
        with compute_dtype(self.dtype, x.device.type):
            if top or bottom:
                x = F.pad(x, (0, 0, top, bottom), value=self.window.fill)
            return self.tail(self.window(x), *carry)


def _gather(parts, rows, lo: int, hi: int, i: int, device) -> tuple:
    """Rows ``[lo, hi)`` (within the frame) of a tensor held as one part
    per band (``parts[j]`` NCHW, rows ``rows[j]``), on ``device`` for
    band ``i``: its own rows and copies of its neighbours'. Returns the
    tile, the rows that came from the bands above and below, and the
    number of copies (one per neighbour that sent rows)."""
    pieces, above, below, copies = [], 0, 0, 0
    for j, ((a, b), t) in enumerate(zip(rows, parts)):
        s, e = max(lo, a), min(hi, b)
        if s >= e:
            continue
        piece = t.narrow(2, s - a, e - s)
        if j != i:
            piece = piece.to(device)
            copies += 1
            if j < i:
                above += e - s
            else:
                below += e - s
        pieces.append(piece)
    tile = torch.cat(pieces, 2) if len(pieces) > 1 else pieces[0]
    return (tile.contiguous(memory_format=torch.channels_last), above, below,
            copies)


class SpatialStage:
    """A trunk, then a head, with the trunk split into bands of rows, one
    per device of ``mesh`` (see the module docstring).

    ``trunks[i]``: band i's copy of the ResNet trunk, on ``mesh[i]``;
    ``heads(*row_sums, count=...)``: the tail on ``mesh[0]`` (the pooled
    mean is ``sum(row_sums) / count``); ``prep``: an elementwise transform
    of each band's NCHW input tile (the stage's normalization); ``dtype``:
    the trunk's compute dtype; ``pools``: a CUDA graph pool per device of
    ``mesh`` (None on the CPU). ``whole``: the plain stage, which runs a
    one-device mesh (one band is the whole frame).

    A call takes an NHWC batch on ``mesh[0]`` and returns what ``heads``
    returns. ``last`` describes the last call: for each exchange, the
    window and the input height, and for each band the rows it owned,
    the rows it took from the bands above and below, its padding rows
    (past the frame's edges) and its tile's height; ``copies`` (the
    copies between bands: one per band, exchange and neighbour that sent
    it rows) and ``partials`` (the row sums the pool added). ``fn`` is the same stage over the segments'
    and the head's eager bodies.
    """

    def __init__(self, trunks: Sequence[nn.Module], heads: Callable,
                 mesh: Sequence, prep: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32,
                 pools: Optional[Sequence] = None,
                 whole: Optional[Callable] = None):
        self.sharding = spatial_sharding(mesh)
        self.mesh = self.sharding.devices
        if len(trunks) != len(self.mesh):
            raise ValueError('one trunk per device')
        if len(self.mesh) == 1 and whole is None:
            raise ValueError('a one-device mesh runs the plain stage: pass '
                             'whole')
        pools = list(pools) if pools is not None else [None] * len(self.mesh)
        self.trunks = list(trunks)
        self.whole = whole
        programs = [_program(t) for t in self.trunks]
        self.windows = [w for w, _ in programs[0]]
        self.segments = [
            [StageGraph(f'stage1 band {i} segment {j}',
                        _Segment(w, tail, dtype, prep if j == 0 else None),
                        pools[i])
             for j, (w, tail) in enumerate(program)]
            for i, program in enumerate(programs)]
        self.heads = StageGraph('stage1 heads', heads, pools[0])
        self.last: dict = {}

    @property
    def fn(self) -> 'SpatialStage':
        eager = copy.copy(self)
        eager.segments = [[s.fn for s in band] for band in self.segments]
        eager.heads = self.heads.fn
        eager.whole = getattr(self.whole, 'fn', self.whole)
        return eager

    def __call__(self, batch: torch.Tensor):
        if len(self.mesh) == 1:
            return self.whole(batch)
        sums = self.row_sums(batch)
        first = self.mesh[0]
        return self.heads(*[s.to(first) for s in sums],
                          count=self.last['count'])

    def row_sums(self, batch: torch.Tensor) -> list:
        """Band by band, the row sums (B, C) fp32 of its part of the
        trunk's feature map, each on its band's device (non-empty bands
        only)."""
        if any(t.training for t in self.trunks):
            raise ValueError('spatial_parallel runs inference only: the '
                             'trunk is in train mode')
        if batch.device != self.mesh[0]:
            raise ValueError(f'the batch lies on {batch.device}, the mesh '
                             f'starts at {self.mesh[0]}')
        n = len(self.mesh)
        x = batch.permute(0, 3, 1, 2)        # NCHW view (channels_last)
        h, w = x.shape[2:]
        unit = 1
        for win in self.windows:
            unit *= win.s
        rows = band_rows(h, n, unit)
        parts = [x.narrow(2, lo, hi - lo).to(dev) if hi > lo else None
                 for (lo, hi), dev in zip(rows, self.mesh)]
        carry: list = [()] * n
        exchanges, copies = [], 0
        for j, win in enumerate(self.windows):
            h_out, w_out = win.out_size(h, w)
            out_rows = band_rows(h_out, n, unit // win.s)
            records, new_parts = [], [None] * n
            for i, ((o0, o1), dev) in enumerate(zip(out_rows, self.mesh)):
                if o1 <= o0:
                    continue
                lo, hi = win.needs(o0, o1)
                tile, above, below, moved = _gather(
                    parts, rows, max(lo, 0), min(hi, h), i, dev)
                top, bottom = max(-lo, 0), max(hi - h, 0)
                copies += moved
                records.append(dict(band=i, rows=rows[i],
                                    above=above, below=below, top=top,
                                    bottom=bottom,
                                    tile=tile.shape[2] + top + bottom))
                out = self.segments[i][j](tile, *carry[i], top=top,
                                          bottom=bottom)
                new_parts[i], carry[i] = out[0], tuple(out[1:])
            exchanges.append(dict(window=(win.k, win.s, win.p), height=h,
                                  bands=records))
            parts, rows, h, w, unit = new_parts, out_rows, h_out, w_out, \
                unit // win.s
        sums = [p for p in parts if p is not None]
        self.last = dict(exchanges=exchanges, copies=copies,
                         partials=len(sums), count=h * w)
        return sums
