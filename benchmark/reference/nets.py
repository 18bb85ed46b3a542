"""Plain PyTorch definitions of SPEC's networks: the ResNet and HRNet
trunks, the CamCalib camera regressor and the camera-conditioned HMR
regressor.

Frozen copies of the published module graphs (torchvision's ResNet, the
official HRNet classification trunk with PARE's conv downsample head,
SPIN's iterative regressor) with their parameter names, so one state
dict loads into these modules and into the program's. No kernel, graph,
cache or mixed precision: NCHW float32, stock ``nn.BatchNorm2d``. The
caller decides TF32 (``benchmark.reference.precision``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry as G


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv3x3(cin, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv1x1(cin, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


RESNETS = {
    'resnet18': (BasicBlock, (2, 2, 2, 2)),
    'resnet34': (BasicBlock, (3, 4, 6, 3)),
    'resnet50': (Bottleneck, (3, 4, 6, 3)),
    'resnet101': (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """torchvision's ResNet up to the last feature map (stride 32)."""

    def __init__(self, name: str):
        super().__init__()
        block, stages = RESNETS[name]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for s, n in enumerate(stages):
            planes, stride = 64 * 2 ** s, (1 if s == 0 else 2)
            blocks = []
            for k in range(n):
                st = stride if k == 0 else 1
                ds = None
                if k == 0 and (st != 1 or cin != planes * block.expansion):
                    ds = nn.Sequential(conv1x1(cin, planes * block.expansion,
                                               st),
                                       nn.BatchNorm2d(planes
                                                      * block.expansion))
                blocks.append(block(cin, planes, st, ds))
                cin = planes * block.expansion
            self.add_module(f'layer{s + 1}', nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


# HRNet-W32 / W48 (official classification trunk): per stage the number
# of exchange modules, and per branch its BasicBlocks and width.
HRNETS = {
    'hrnet_w32': ((1, (4, 4), (32, 64)), (4, (4, 4, 4), (32, 64, 128)),
                  (3, (4, 4, 4, 4), (32, 64, 128, 256))),
    'hrnet_w48': ((1, (4, 4), (48, 96)), (4, (4, 4, 4), (48, 96, 192)),
                  (3, (4, 4, 4, 4), (48, 96, 192, 384))),
}


def _conv_bn(cin, cout, stride, relu):
    mods = [conv3x3(cin, cout, stride), nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class _Fuse(nn.Sequential):
    """Branch j into branch i: 1x1 conv, BN and a nearest upsample when
    j > i; i - j stride-2 3x3 convs with BN (ReLU between) when j < i."""

    def __init__(self, i, j, ch):
        if j > i:
            super().__init__(conv1x1(ch[j], ch[i]), nn.BatchNorm2d(ch[i]))
        else:
            super().__init__(*[
                _conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j], 2,
                         relu=k < i - j - 1) for k in range(i - j)])
        self.factor = 2 ** (j - i) if j > i else 0

    def forward(self, x):
        x = super().forward(x)
        return (F.interpolate(x, scale_factor=self.factor, mode='nearest')
                if self.factor else x)


class _Exchange(nn.Module):
    def __init__(self, blocks: Sequence[int], ch: Sequence[int]):
        super().__init__()
        n = len(ch)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(ch[b], ch[b]) for _ in range(blocks[b])])
            for b in range(n)])
        self.fuse_layers = nn.ModuleList([
            nn.ModuleList([None if j == i else _Fuse(i, j, ch)
                           for j in range(n)]) for i in range(n)])

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        return [F.relu(sum(x if f is None else f(x) for f, x in zip(row, xs)))
                for row in self.fuse_layers]


class HRNet(nn.Module):
    """HRNet trunk; the four branches brought to stride 32 by stride-2
    conv chains (``-conv``, PARE) or bilinear resizes (``-interp``) and
    concatenated."""

    def __init__(self, name: str, conv_downsample: bool):
        super().__init__()
        self.conv_downsample = conv_downsample
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else 256, 64, 1,
                       nn.Sequential(conv1x1(64, 256), nn.BatchNorm2d(256))
                       if k == 0 else None) for k in range(4)])
        prev = [256]
        for s, (mods, blocks, ch) in enumerate(HRNETS[name], start=1):
            trans = []
            for i, c in enumerate(ch):
                if i < len(prev):
                    trans.append(None if prev[i] == c
                                 else _conv_bn(prev[i], c, 1, True))
                else:
                    trans.append(nn.Sequential(_conv_bn(prev[-1], c, 2,
                                                        True)))
            self.add_module(f'transition{s}', nn.ModuleList(trans))
            self.add_module(f'stage{s + 1}', nn.ModuleList([
                _Exchange(blocks, ch) for _ in range(mods)]))
            prev = list(ch)
        if conv_downsample:
            n = len(prev)
            for b in range(n - 1):
                self.add_module(f'downsample_stage_{b + 1}', nn.Sequential(*[
                    _conv_bn(prev[b], prev[b], 2, True)
                    for _ in range(n - 1 - b)]))
        self.n_stages = len(HRNETS[name])
        self.out_channels = sum(prev)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(1, self.n_stages + 1):
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(getattr(self, f'transition{s}'))]
            for module in getattr(self, f'stage{s + 1}'):
                xs = module(xs)
        size = xs[-1].shape[-2:]
        outs = []
        for b, f in enumerate(xs):
            if f.shape[-2:] == size:
                outs.append(f)
            elif self.conv_downsample:
                outs.append(getattr(self, f'downsample_stage_{b + 1}')(f))
            else:
                outs.append(F.interpolate(f, size=tuple(size),
                                          mode='bilinear',
                                          align_corners=False))
        return torch.cat(outs, dim=1)


def trunk(name: str) -> nn.Module:
    """A trunk by the reference's backbone name (``resnet50``,
    ``hrnet_w32-conv``, ``hrnet_w32`` = ``-interp``)."""
    base = name.split('-')[0]
    if base.startswith('hrnet'):
        return HRNet(base, conv_downsample=name.endswith('-conv'))
    return ResNet(base)


ANGLE_HEADS = ('fc_vfov', 'fc_pitch', 'fc_roll')


class CamCalib(nn.Module):
    """Trunk, global average pool, one linear layer of ``bins`` logits
    for each of vfov, pitch and roll."""

    def __init__(self, backbone: str, bins: int = 256):
        super().__init__()
        self.backbone = trunk(backbone)
        for name in ANGLE_HEADS:
            self.add_module(name, nn.Linear(self.backbone.out_channels,
                                            bins))

    def forward(self, x_nchw):
        pooled = self.backbone(x_nchw).mean(dim=(2, 3))
        return tuple(getattr(self, n)(pooled) for n in ANGLE_HEADS)


NPOSE = 24 * 6


class HMRHead(nn.Module):
    """SPIN's regressor: from the mean parameters, ``n_iter`` times
    [features, pose, shape, cam] -> fc1 -> fc2 -> linear deltas
    (dropout is off in inference)."""

    def __init__(self, num_features, n_iter=3, hidden=1024):
        super().__init__()
        self.n_iter = n_iter
        self.register_buffer('init_pose', torch.zeros(1, NPOSE))
        self.register_buffer('init_shape', torch.zeros(1, 10))
        self.register_buffer('init_cam', torch.zeros(1, 3))
        self.fc1 = nn.Linear(num_features + NPOSE + 13, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.decpose = nn.Linear(hidden, NPOSE)
        self.decshape = nn.Linear(hidden, 10)
        self.deccam = nn.Linear(hidden, 3)

    def forward(self, feats):
        x = feats.mean(dim=(2, 3))
        B = x.shape[0]
        pose = self.init_pose.expand(B, -1)
        shape = self.init_shape.expand(B, -1)
        cam = self.init_cam.expand(B, -1)
        for _ in range(self.n_iter):
            h = self.fc2(self.fc1(torch.cat([x, pose, shape, cam], dim=1)))
            pose = self.decpose(h) + pose
            shape = self.decshape(h) + shape
            cam = self.deccam(h) + cam
        return {'pred_pose': G.rot6d_to_rotmat(pose.reshape(B, 24, 6)),
                'pred_pose_6d': pose, 'pred_shape': shape, 'pred_cam': cam}


class HMR(nn.Module):
    """Trunk and regressor head (SPEC's stage 2 without camera features;
    the camera enters in the SMPL head, ``reference.smpl.cam_head``)."""

    def __init__(self, backbone: str, n_iter: int = 3, hidden: int = 1024):
        super().__init__()
        self.backbone = trunk(backbone)
        self.head = HMRHead(self.backbone.out_channels, n_iter, hidden)

    def forward(self, x_nchw):
        return self.head(self.backbone(x_nchw))
