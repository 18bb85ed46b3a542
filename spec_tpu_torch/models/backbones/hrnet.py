"""HRNet-W32/W48 backbones (torch twin of
``spec_tpu/models/backbones/hrnet.py``).

The official HRNet classification trunk (stem, bottleneck layer1, three
multi-resolution stages with exchange fusion) returning the four branch
maps concatenated at 1/32 resolution: 480 channels for W32
(32 + 64 + 128 + 256), 720 for W48. NCHW inside; the parameter names are
the official HRNet's (``conv1``, ``layer1.{k}``, ``transition{s}.{i}``,
``stage{s}.{m}.branches.{b}.{k}``, ``stage{s}.{m}.fuse_layers.{i}.{j}``),
which is what the JAX package's ``convert_torch_hrnet_params`` maps
from, so an official or PARE trunk loads with ``load_state_dict``.

``downsample`` head (the ``-conv`` / ``-interp`` suffix of the backbone
name): bilinear resize of every branch to the lowest resolution
(``F.interpolate(align_corners=False)``, no antialias, as the JAX
module's ``jax.image.resize(antialias=False)``), or chains of stride-2
3x3 conv + BN + ReLU per branch (``downsample_stage_{b}``, PARE's
addition to the trunk). Fusion upsamples nearest, as the official
graph.

``remat`` (TRAINING.REMAT): each exchange module runs under
``torch.utils.checkpoint``, as the JAX ``HRNet.remat`` wraps
``HighResolutionModule`` in ``nn.remat``; BatchNorm keeps its running
statistics out of the recompute (``resnet._Recompute``).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from spec_tpu_torch.models.backbones.resnet import (
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    _remat_contexts,
    conv1x1,
    conv3x3,
)

HRNET_CONFIGS = {
    'hrnet_w32': {
        'stage2': dict(num_modules=1, num_branches=2, num_blocks=(4, 4),
                       num_channels=(32, 64)),
        'stage3': dict(num_modules=4, num_branches=3, num_blocks=(4, 4, 4),
                       num_channels=(32, 64, 128)),
        'stage4': dict(num_modules=3, num_branches=4,
                       num_blocks=(4, 4, 4, 4),
                       num_channels=(32, 64, 128, 256)),
    },
    'hrnet_w48': {
        'stage2': dict(num_modules=1, num_branches=2, num_blocks=(4, 4),
                       num_channels=(48, 96)),
        'stage3': dict(num_modules=4, num_branches=3, num_blocks=(4, 4, 4),
                       num_channels=(48, 96, 192)),
        'stage4': dict(num_modules=3, num_branches=4,
                       num_blocks=(4, 4, 4, 4),
                       num_channels=(48, 96, 192, 384)),
    },
}

STAGES = ('stage2', 'stage3', 'stage4')


def _upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode='nearest')


def _conv_bn(cin: int, cout: int, stride: int, relu: bool) -> nn.Sequential:
    mods = [conv3x3(cin, cout, stride), BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


class FuseLayer(nn.Sequential):
    """Exchange unit from branch j to branch i (j != i): a 1x1 conv to
    C_i, BN and a nearest upsample by 2^(j - i) when j > i; else i - j
    stride-2 3x3 conv + BN, ReLU between them and none after the
    last."""

    def __init__(self, i: int, j: int, channels: Sequence[int]):
        if j > i:
            super().__init__(conv1x1(channels[j], channels[i]),
                             BatchNorm2d(channels[i]))
        else:
            super().__init__(*[
                _conv_bn(channels[j], channels[i] if k == i - j - 1
                         else channels[j], 2, relu=k < i - j - 1)
                for k in range(i - j)])
        self.factor = 2 ** (j - i) if j > i else 0

    def forward(self, x):
        x = super().forward(x)
        return _upsample_nearest(x, self.factor) if self.factor else x


class HighResolutionModule(nn.Module):
    """Per-branch BasicBlocks, then the full exchange: output i is the
    ReLU of the sum over j of FuseLayer(i, j)(branch j)."""

    def __init__(self, num_branches: int, num_blocks: Sequence[int],
                 channels: Sequence[int]):
        super().__init__()
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(channels[b], channels[b])
                            for _ in range(num_blocks[b])])
            for b in range(num_branches)])
        self.fuse_layers = nn.ModuleList([
            nn.ModuleList([None if j == i else FuseLayer(i, j, channels)
                           for j in range(num_branches)])
            for i in range(num_branches)])

    def forward(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        feats = [branch(x) for branch, x in zip(self.branches, inputs)]
        outs = []
        for row in self.fuse_layers:
            acc = None
            for fuse, x in zip(row, feats):
                y = x if fuse is None else fuse(x)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


def _transition(prev: Sequence[int], channels: Sequence[int]) -> nn.ModuleList:
    """Adapt the previous stage's branches to the next stage's widths
    (None where they agree) and spawn the new lowest-resolution branch
    from the last one (nested one deeper, as the official graph)."""
    layers = []
    for i, c in enumerate(channels):
        if i < len(prev):
            layers.append(None if prev[i] == c
                          else _conv_bn(prev[i], c, 1, relu=True))
        else:
            layers.append(nn.Sequential(_conv_bn(prev[-1], c, 2, relu=True)))
    return nn.ModuleList(layers)


class HRNet(nn.Module):
    """HRNet trunk returning (B, sum of the branch widths, H/32, W/32)."""

    def __init__(self, arch: str = 'hrnet_w32',
                 use_conv_downsample: bool = False, remat: bool = False):
        super().__init__()
        cfg = HRNET_CONFIGS[arch]
        self.arch = arch
        self.use_conv_downsample = use_conv_downsample
        self.remat = remat
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else 256, 64, 1,
                       nn.Sequential(conv1x1(64, 256), BatchNorm2d(256))
                       if k == 0 else None)
            for k in range(4)])
        prev = [256]
        for s, name in enumerate(STAGES, start=1):
            scfg = cfg[name]
            self.add_module(f'transition{s}',
                            _transition(prev, scfg['num_channels']))
            self.add_module(f'stage{s + 1}', nn.ModuleList([
                HighResolutionModule(scfg['num_branches'],
                                     scfg['num_blocks'],
                                     scfg['num_channels'])
                for _ in range(scfg['num_modules'])]))
            prev = list(scfg['num_channels'])
        n = len(prev)
        if use_conv_downsample:
            # Branch b (of n) reaches 1/32 after n - 1 - b stride-2 convs.
            for b in range(n - 1):
                self.add_module(f'downsample_stage_{b + 1}', nn.Sequential(*[
                    _conv_bn(prev[b], prev[b], 2, relu=True)
                    for _ in range(n - 1 - b)]))
        self.out_channels = sum(prev)

    def _module(self, module: HighResolutionModule,
                feats: List[torch.Tensor]) -> List[torch.Tensor]:
        if not (self.remat and torch.is_grad_enabled()):
            return module(*feats)
        return checkpoint(module, *feats, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(_remat_contexts,
                                                       module))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        feats = [self.layer1(x)]
        for s in range(1, len(STAGES) + 1):
            trans = getattr(self, f'transition{s}')
            feats = [feats[i] if t is None
                     else t(feats[min(i, len(feats) - 1)])
                     for i, t in enumerate(trans)]
            for module in getattr(self, f'stage{s + 1}'):
                feats = self._module(module, feats)
        target = feats[-1].shape[-2:]
        outs = []
        for b, f in enumerate(feats):
            if f.shape[-2:] == target:
                outs.append(f)
            elif self.use_conv_downsample:
                outs.append(getattr(self, f'downsample_stage_{b + 1}')(f))
            else:
                outs.append(F.interpolate(f, size=tuple(target),
                                          mode='bilinear',
                                          align_corners=False))
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator: Kaiming-normal
        (fan_out, relu) convs, BN scale 1 and shift 0, as the ResNets."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu',
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


def get_hrnet(name: str, use_conv: bool = False,
              remat: bool = False) -> HRNet:
    return HRNet(arch=name, use_conv_downsample=use_conv, remat=remat)
