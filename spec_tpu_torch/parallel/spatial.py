"""Spatial partitioning of stage 1: bands of image rows over local
devices (torch twin of the reference's ``spatial_sharding`` layout,
``spec_tpu/parallel/__init__.py:80-103``, as
``spec_tpu/serving.py:307-322`` uses it).

The JAX package shards stage 1's NHWC frames along their height over the
mesh; GSPMD swaps each convolution's halo rows with the neighbouring
shards (a collective-permute), pads a ragged split and turns the global
average pool into a sum over the shards. Here that layout is explicit,
in one process over a list of local devices (``parallel.create_mesh``),
each with its own copy of the trunk (``parallel.replicate``). Two
trunks are covered: a ResNet (``models/backbones/resnet.ResNet``) and an
HRNet (``models/backbones/hrnet.HRNet``, ``-interp`` and ``-conv``).

* **state.** Between two layers a band holds its rows of a list of
  tensors, each at its own stride (rows of the trunk's input per row): a
  ResNet's feature map and the residual it carries, an HRNet's one to
  four branches at strides 4 to 32 and what their exchange carries.
* **bands.** Each device owns one band of rows. The cuts fall on
  multiples of the trunk's stride T (32 input rows), so at stride s a
  band that owns input rows ``[a, b)`` owns rows ``[a / s, b / s)`` of
  every tensor: a stride-2 layer's rows halve exactly, a residual lines
  up with its downsample, and an HRNet branch upsampled by 2^k lands on
  the rows of the branch it is added to. The trunk's last rows
  (``ceil(H / T)``) are dealt in chunks of ``ceil(rows / n)``, as GSPMD
  splits a ragged dimension: bands at the end may own none, and then run
  nothing (:func:`band_rows`). An HRNet adds branches of every stride,
  so its frame's sides must be multiples of T (the plain trunk fails on
  other sides too): a ResNet takes any height.
* **halos.** Each exchange serves the layers of one depth whose window
  spans rows (the stem, the max pool, every 3x3 conv; in an HRNet, every
  branch's conv of that depth): for each tensor such a window reads, a
  band takes the rows that its output rows need from the bands that own
  them, device-to-device copies (:func:`_gather`), once for all the
  windows that read it. Only the frame's top and bottom edges are padded
  (zeros; -inf for the pool, as torch pads it); an inner band edge never
  pads.
* **segments.** After each exchange a band runs a segment: the windows,
  without height padding, then the layers that act on each row (1x1
  convs, eval BatchNorm, ReLU, residual and fusion sums, an HRNet's
  nearest upsampling by 2^k and its ``-interp`` head's bilinear resize
  by an exact factor, whose two source rows lie inside the band) up to
  the next exchange. Each (band, segment) is a ``StageGraph`` on the
  band's device: on a card every segment replays a CUDA graph and the
  copies are queued between the replays; on the CPU it runs directly.
  The code is the same for two bands on one card and for two bands on
  two cards.
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


class _Level(NamedTuple):
    """One exchange and the segment after it. ``windows``: (state entry
    read, window) pairs, each run on a tile of its entry's rows with the
    halo; ``tail(state)`` maps the windows' outputs followed by the
    level's input state (each entry's own rows) to the next state;
    ``strides``: each next entry's stride, empty for the last level,
    whose tail returns the row sums ``[(B, C) fp32]``."""
    windows: tuple
    tail: Callable
    strides: tuple


class _Program:
    """A trunk as a list of :class:`_Level`, written layer by layer:
    :meth:`windows` opens a level, :meth:`rows` adds a row-wise function
    to its tail, :meth:`finish` ends the trunk with the row sums.
    ``strides`` is the current state's (the input's is 1); ``exact``:
    the trunk needs frame sides that are multiples of its stride."""

    def __init__(self, exact: bool = False):
        self.levels: List[_Level] = []
        self.strides = [1]
        self.exact = exact
        self._windows: Optional[tuple] = None
        self._fns: list = []

    def _close(self, strides: tuple) -> None:
        if self._windows is not None:
            fns = self._fns

            def tail(state):
                for f in fns:
                    state = f(state)
                return state

            self.levels.append(_Level(self._windows, tail, strides))

    def windows(self, pairs) -> None:
        """A new level: each (entry, conv or pool) of ``pairs`` reads the
        current state's entry; the state after them is the windows'
        outputs followed by the state before them."""
        self._close(tuple(self.strides))
        self._windows = tuple((e, _Window(m)) for e, m in pairs)
        self._fns = []
        self.strides = [self.strides[e] * w.s
                        for e, w in self._windows] + self.strides

    def rows(self, fn: Callable, like) -> None:
        """``fn`` (state list -> state list) acts on each row; ``like``
        gives each output entry's stride: an input entry's (its index),
        or an input entry's times a factor ((index, factor))."""
        self._fns.append(fn)
        self.strides = [self.strides[k] if isinstance(k, int)
                        else self.strides[k[0]] * k[1] for k in like]

    def finish(self, fn: Callable) -> None:
        """``fn`` (state -> the feature map) ends the trunk: its row sums
        in fp32 are the last level's output. Sets ``stride``, the
        trunk's (the largest of its tensors')."""
        self._fns.append(lambda s: [fn(s).float().sum((2, 3))])
        self._close(())
        self.stride = max([*self.strides,
                           *(s for lv in self.levels for s in lv.strides)])


def _split(seq: nn.Module) -> tuple:
    """A (possibly nested) ``nn.Sequential`` that starts with a conv: the
    conv, and the rest as one row-wise callable."""
    mods = [m for m in seq.modules() if not isinstance(m, nn.Sequential)]
    return mods[0], nn.Sequential(*mods[1:])


def _resnet_block(p: _Program, blk) -> None:
    """A residual block over the state ``[x]``: ``[y]`` after it."""
    from spec_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck

    first = blk.conv2 if isinstance(blk, Bottleneck) else blk.conv1
    s = first.stride[0]

    def ident(x):
        return x if blk.downsample is None else blk.downsample(x)

    if isinstance(blk, Bottleneck):
        p.rows(lambda st: [blk.relu(blk.bn1(blk.conv1(st[0]))),
                           ident(st[0])], (0, (0, s)))
        p.windows([(0, blk.conv2)])
        p.rows(lambda st: [blk.relu(blk.bn3(blk.conv3(
            blk.relu(blk.bn2(st[0])))) + st[2])], (0,))
    elif isinstance(blk, BasicBlock):
        p.rows(lambda st: [st[0], ident(st[0])], (0, (0, s)))
        p.windows([(0, blk.conv1)])
        p.rows(lambda st: [blk.relu(blk.bn1(st[0])), st[2]], (0, 2))
        p.windows([(0, blk.conv2)])
        p.rows(lambda st: [blk.relu(blk.bn2(st[0]) + st[2])], (0,))
    else:
        raise TypeError(f'a trunk of BasicBlock or Bottleneck blocks, not '
                        f'{type(blk).__name__}')


def _resnet_program(trunk) -> _Program:
    """A ResNet trunk: the stem conv, the max pool and every block's 3x3
    convs are windows; a block carries its identity branch."""
    p = _Program()
    p.windows([(0, trunk.conv1)])
    p.rows(lambda st: [trunk.relu(trunk.bn1(st[0]))], (0,))
    p.windows([(0, trunk.maxpool)])
    p.rows(lambda st: [st[0]], (0,))
    for layer in (trunk.layer1, trunk.layer2, trunk.layer3, trunk.layer4):
        for blk in layer:
            _resnet_block(p, blk)
    p.finish(lambda st: st[0])
    return p


def _hrnet_branch_blocks(p: _Program, blocks: Sequence) -> None:
    """One BasicBlock on each branch of the state ``[x_0 .. x_n-1]``, the
    branches' convs of one depth sharing an exchange."""
    n = len(blocks)
    p.windows([(b, blk.conv1) for b, blk in enumerate(blocks)])
    # [conv1 outs, x]
    p.rows(lambda st: [blk.relu(blk.bn1(st[b]))
                       for b, blk in enumerate(blocks)] + st[n:2 * n],
           tuple(range(2 * n)))
    p.windows([(b, blk.conv2) for b, blk in enumerate(blocks)])
    # [conv2 outs, h, x]
    p.rows(lambda st: [blk.relu(blk.bn2(st[b]) + st[2 * n + b])
                       for b, blk in enumerate(blocks)], tuple(range(n)))


def _hrnet_module(p: _Program, module) -> None:
    """A ``HighResolutionModule`` over the state ``[x_0 .. x_n-1]``: the
    branches' blocks depth by depth, then the exchange. Output i sums
    branch i, the branches above it through a 1x1 conv, BatchNorm and a
    nearest upsample (row-wise), and the branches below it through
    chains of i - j stride-2 3x3 convs; the chains' convs of one depth
    share an exchange. The state during the exchange is ``[x_0 ..
    x_n-1, c_0 .. c_m-1]``, one entry per chain (i, j), j < i."""
    n = len(module.branches)
    for depth in zip(*module.branches):
        _hrnet_branch_blocks(p, depth)
    chains = [(i, j) for i in range(n) for j in range(i)]
    steps = {c: [_split(m) for m in module.fuse_layers[c[0]][c[1]]]
             for c in chains}

    def fuse(st):
        feats, done = st[:n], dict(zip(chains, st[n:]))
        outs = []
        for i, row in enumerate(module.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = (feats[i] if j == i else layer(feats[j]) if j > i
                     else done[i, j])
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs

    for d in range(max((i - j for i, j in chains), default=0)):
        live = [c for c in chains if c[0] - c[1] > d]
        # a chain's input: its branch at depth 0, its carried entry after
        p.windows([(c[1] if d == 0 else n + chains.index(c), steps[c][d][0])
                   for c in live])
        m = len(live)

        def step(st, d=d, live=live, m=m):
            # [the live chains' conv outputs, x_0 .. x_n-1, c_0 .. c_m-1]
            return list(st[m:m + n]) + [
                steps[c][d][1](st[live.index(c)]) if c in live
                else st[m + n + k] for k, c in enumerate(chains)]

        p.rows(step, tuple(range(m, m + n)) + tuple(
            live.index(c) if c in live else m + n + k
            for k, c in enumerate(chains)))
    p.rows(fuse, tuple(range(n)))


def _hrnet_program(trunk) -> _Program:
    """An HRNet trunk (the official classification graph with the
    ``-interp`` or ``-conv`` head; ``models/backbones/hrnet.py``)."""
    from spec_tpu_torch.models.backbones.hrnet import STAGES

    p = _Program(exact=True)
    p.windows([(0, trunk.conv1)])
    p.rows(lambda st: [trunk.relu(trunk.bn1(st[0]))], (0,))
    p.windows([(0, trunk.conv2)])
    p.rows(lambda st: [trunk.relu(trunk.bn2(st[0]))], (0,))
    for blk in trunk.layer1:
        _resnet_block(p, blk)
    n = 1
    for s in range(1, len(STAGES) + 1):
        trans = getattr(trunk, f'transition{s}')
        order = [i for i, t in enumerate(trans) if t is not None]
        parts = {i: _split(trans[i]) for i in order}
        p.windows([(min(i, n - 1), parts[i][0]) for i in order])
        k = len(order)

        def adapt(st, k=k, order=order, parts=parts, width=len(trans)):
            return [parts[i][1](st[order.index(i)]) if i in parts
                    else st[k + i] for i in range(width)]

        p.rows(adapt, tuple(order.index(i) if i in parts else k + i
                            for i in range(len(trans))))
        n = len(trans)
        for module in getattr(trunk, f'stage{s + 1}'):
            _hrnet_module(p, module)
    if trunk.use_conv_downsample:
        # branch b reaches stride 32 after n - 1 - b stride-2 convs, the
        # branches' convs of one depth sharing an exchange
        chains = {b: [_split(m) for m in
                      getattr(trunk, f'downsample_stage_{b + 1}')]
                  for b in range(n - 1)}
        for d in range(n - 1):
            live = [b for b in range(n - 1) if len(chains[b]) > d]
            p.windows([(b, chains[b][d][0]) for b in live])
            m = len(live)

            def step(st, d=d, live=live, m=m):
                return [chains[b][d][1](st[live.index(b)]) if b in live
                        else st[m + b] for b in range(n)]

            p.rows(step, tuple(live.index(b) if b in live else m + b
                               for b in range(n)))
        p.finish(lambda st: torch.cat(st, 1))
    else:
        def head(st):
            target = st[-1].shape[-2:]
            return torch.cat([f if f.shape[-2:] == target else
                              F.interpolate(f, size=tuple(target),
                                            mode='bilinear',
                                            align_corners=False)
                              for f in st], 1)

        p.finish(head)
    return p


def _program(trunk: nn.Module) -> _Program:
    from spec_tpu_torch.models.backbones.hrnet import HRNet
    from spec_tpu_torch.models.backbones.resnet import ResNet

    if isinstance(trunk, ResNet):
        return _resnet_program(trunk)
    if isinstance(trunk, HRNet):
        return _hrnet_program(trunk)
    raise TypeError(f'spatial_parallel splits a ResNet or an HRNet trunk '
                    f'(models/backbones/resnet.ResNet, '
                    f'models/backbones/hrnet.HRNet), not '
                    f'{type(trunk).__name__}')


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return (t.contiguous(memory_format=torch.channels_last) if t.dim() == 4
            else t)


class _Segment:
    """One band's segment body: ``prep`` (the first segment's
    elementwise input transform), then each window on its rows of its
    entry's tile with its edge padding rows, then the tail over the
    windows' outputs and the band's own rows of every entry.
    ``geometry`` (fixed per graph): for each window the (start, length)
    of its rows in its tile and its (top, bottom) padding rows; for each
    entry the (start, length) of the band's own rows in its tile, or
    None where the entry is passed as the band's own rows."""

    def __init__(self, level: _Level, dtype: torch.dtype,
                 prep: Optional[Callable] = None):
        self.level = level
        self.dtype = dtype
        self.prep = prep

    def __call__(self, *state, geometry):
        wins, owns = geometry
        state = list(state)
        if self.prep is not None:
            state[0] = self.prep(state[0])
        with compute_dtype(self.dtype, state[0].device.type):
            outs = []
            for (e, win), (start, length, top, bottom) in zip(
                    self.level.windows, wins):
                x = state[e].narrow(2, start, length)
                if top or bottom:
                    x = F.pad(x, (0, 0, top, bottom), value=win.fill)
                outs.append(win(x))
            own = [t if g is None else t.narrow(2, *g)
                   for t, g in zip(state, owns)]
            return tuple(_channels_last(t)
                         for t in self.level.tail(outs + own))


def _pieces(rows, lo: int, hi: int, i: int) -> tuple:
    """Where rows ``[lo, hi)`` (within the frame) of a tensor held as one
    part per band (band j's part holds rows ``rows[j]``) lie, for band
    ``i``: (band, start in its part, length) in row order, and the rows
    that come from the bands above and below."""
    pieces, above, below = [], 0, 0
    for j, (a, b) in enumerate(rows):
        s, e = max(lo, a), min(hi, b)
        if s >= e:
            continue
        pieces.append((j, s - a, e - s))
        if j < i:
            above += e - s
        elif j > i:
            below += e - s
    return tuple(pieces), above, below


def _gather(parts, pieces, e: int, i: int, device) -> torch.Tensor:
    """Band ``i``'s tile of entry ``e``: its own rows and copies of its
    neighbours' (``pieces`` from :func:`_pieces`), on ``device``."""
    tiles = [parts[j][e].narrow(2, s, n) if j == i
             else parts[j][e].narrow(2, s, n).to(device)
             for j, s, n in pieces]
    tile = torch.cat(tiles, 2) if len(tiles) > 1 else tiles[0]
    return tile.contiguous(memory_format=torch.channels_last)


class SpatialStage:
    """A trunk, then a head, with the trunk split into bands of rows, one
    per device of ``mesh`` (see the module docstring).

    ``trunks[i]``: band i's copy of the ResNet or HRNet trunk, on
    ``mesh[i]``; ``heads(*row_sums, count=...)``: the tail on ``mesh[0]``
    (the pooled mean is ``sum(row_sums) / count``); ``prep``: an
    elementwise transform of each band's NCHW input tile (the stage's
    normalization); ``dtype``: the trunk's compute dtype; ``pools``: a
    CUDA graph pool per device of ``mesh`` (None on the CPU). ``whole``:
    the plain stage, which runs a one-device mesh (one band is the whole
    frame).

    A call takes an NHWC batch on ``mesh[0]`` and returns what ``heads``
    returns. ``levels`` are the trunk's exchanges. ``last`` describes the
    last call: for each exchange, for each tensor its windows read, the
    windows (kernel, stride, padding), the tensor's height and, for each
    band, the rows it owned, the rows it took from the bands above and
    below, its padding rows (past the frame's edges) and its tile's
    height; ``copies`` (the copies between bands: one per band, exchange,
    tensor and neighbour that sent it rows) and ``partials`` (the row
    sums the pool added). ``fn`` is the same stage over the segments' and
    the head's eager bodies.
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
        self.program = programs[0]
        self.levels = self.program.levels
        self.segments = [
            [StageGraph(f'stage1 band {i} segment {j}',
                        _Segment(level, dtype, prep if j == 0 else None),
                        pools[i])
             for j, level in enumerate(program.levels)]
            for i, program in enumerate(programs)]
        self.heads = StageGraph('stage1 heads', heads, pools[0])
        self.last: dict = {}
        self._plans: dict = {}       # (H, W) -> the band geometry

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

    def _plan(self, H: int, W: int) -> tuple:
        """The band geometry of an H x W frame, the same on every call:
        for each exchange, for each band that owns rows, where its tiles'
        rows lie, its segment's geometry and its output heights; and
        what ``last`` reports."""
        n = len(self.mesh)
        T = self.program.stride
        rows = {}

        def height(s):
            return -(-H // s)

        def rows_at(s):
            if s not in rows:
                rows[s] = band_rows(height(s), n, T // s)
            return rows[s]

        live = [i for i, (a, b) in enumerate(rows_at(1)) if b > a]
        strides, levels, exchanges, copies = [1], [], [], 0
        for level in self.levels:
            sources = sorted({e for e, _ in level.windows})
            records = {e: dict(entry=e, height=height(strides[e]),
                               windows=[(w.k, w.s, w.p)
                                        for f, w in level.windows if f == e],
                               bands=[]) for e in sources}
            bands = []
            for i in live:
                gathers, starts = [], {}
                for e in sources:
                    h = height(strides[e])
                    a, b = rows_at(strides[e])[i]
                    lo, hi = a, b
                    for f, w in level.windows:
                        if f == e:
                            nlo, nhi = w.needs(*rows_at(strides[e] * w.s)[i])
                            lo, hi = min(lo, nlo), max(hi, nhi)
                    t0 = starts[e] = max(lo, 0)
                    pieces, above, below = _pieces(rows_at(strides[e]), t0,
                                                   min(hi, h), i)
                    copies += sum(j != i for j, _, _ in pieces)
                    gathers.append((e, pieces))
                    records[e]['bands'].append(dict(
                        band=i, rows=(a, b), above=above, below=below,
                        top=max(-lo, 0), bottom=max(hi - h, 0),
                        tile=min(hi, h) - t0 + max(-lo, 0)
                        + max(hi - h, 0)))
                wins = []
                for f, w in level.windows:
                    h = height(strides[f])
                    lo, hi = w.needs(*rows_at(strides[f] * w.s)[i])
                    wins.append((max(lo, 0) - starts[f],
                                 min(hi, h) - max(lo, 0), max(-lo, 0),
                                 max(hi - h, 0)))
                owns = []
                for e, s in enumerate(strides):
                    a, b = rows_at(s)[i]
                    owns.append((a - starts[e], b - a) if e in starts
                                else None)
                heights = tuple(b - a for a, b in
                                (rows_at(s)[i] for s in level.strides))
                bands.append((i, tuple(gathers),
                              (tuple(wins), tuple(owns)), heights))
            levels.append(bands)
            exchanges.append([records[e] for e in sources])
            strides = list(level.strides)
        last = dict(exchanges=exchanges, copies=copies, partials=len(live),
                    count=height(T) * -(-W // T))
        return rows_at(1), levels, last

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
        x = batch.permute(0, 3, 1, 2)        # NCHW view (channels_last)
        H, W = x.shape[2:]
        T = self.program.stride
        if self.program.exact and (H % T or W % T):
            raise ValueError(
                f'an HRNet trunk takes frames whose sides are multiples of '
                f'{T} (its exchange adds branches upsampled by powers of '
                f'2); this one is {H}x{W}: resize it to such sides (e.g. '
                f'SpecPredictor\'s min_size)')
        if (H, W) not in self._plans:
            self._plans[H, W] = self._plan(H, W)
        rows, levels, last = self._plans[H, W]
        parts = [[x.narrow(2, a, b - a).to(dev)] if b > a else None
                 for (a, b), dev in zip(rows, self.mesh)]
        for j, bands in enumerate(levels):
            new_parts = [None] * len(parts)
            for i, gathers, geometry, heights in bands:
                dev = self.mesh[i]
                tensors = list(parts[i])
                for e, pieces in gathers:
                    tensors[e] = _gather(parts, pieces, e, i, dev)
                out = self.segments[i][j](*tensors, geometry=geometry)
                if tuple(t.shape[2] for t in out[:len(heights)]) != heights:
                    raise RuntimeError(
                        f'segment {j} of band {i} gave rows '
                        f'{[t.shape[2] for t in out]}, not {heights}')
                new_parts[i] = list(out)
            parts = new_parts
        self.last = last
        return [p[0] for p in parts if p is not None]
