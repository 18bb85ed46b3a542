"""ResNet feature extractors (torch twin of
``spec_tpu/models/backbones/resnet.py``).

The torchvision ResNet graph (7x7/2 stem, 3x3/2 maxpool, four stages of
basic or bottleneck blocks, stride on the 3x3 conv of each bottleneck)
with torchvision's parameter names, so released checkpoints load with
``load_state_dict``. NCHW inside; returns the pre-avgpool feature map
(B, C_out, H/32, W/32). The JAX package's TPU-only space-to-depth stem
is not carried over. BatchNorm in train mode updates its running
statistics as flax's does (:class:`BatchNorm2d`).

``remat`` (TRAINING.REMAT): each residual block runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the block's
input and recomputes its activations in the backward, as flax's
``nn.remat`` does. The recompute runs the block's forward a second
time; flax's statistics update is functional, but this BatchNorm
updates its buffers in place, so while its block is recomputed
(:class:`_Recompute`) it writes its running statistics to scratch
copies and counts no batch: the statistics after a step are those of a
step without ``remat``. The blocks draw no random numbers, so the RNG
state is not saved (``preserve_rng_state=False``, which also keeps the
checkpoint capturable in a CUDA graph).
"""

from __future__ import annotations

import contextlib
import functools

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from spec_tpu_torch import parallel as par


class _Recompute:
    """The context of a checkpointed block's recompute: its BatchNorms
    leave their running statistics alone inside it. (The autograd
    engine may recompute on a thread of its own, so the mark is on the
    modules, not thread-local.)"""

    def __init__(self, block: nn.Module):
        self.norms = [m for m in block.modules()
                      if isinstance(m, BatchNorm2d)]

    def __enter__(self):
        for m in self.norms:
            m.recomputing = True

    def __exit__(self, *exc):
        for m in self.norms:
            m.recomputing = False


def _remat_contexts(block):
    return contextlib.nullcontext(), _Recompute(block)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of the running variance
    uses the biased batch variance, as flax's ``BatchNorm`` (momentum 0.9
    there, 0.1 here) does; torch's own uses the unbiased one, n / (n - 1)
    larger. The batch statistics that normalize are the same in both.

    torch computes ``rv' = (1 - m) rv + m var_u`` with ``var_u = var_b n
    / (n - 1)``. Handing the fused batch-norm call a copy of the buffer
    scaled by n / (n - 1), and writing that copy back scaled by
    (n - 1) / n, gives ``(1 - m) rv + m var_b``. (The buffer itself may
    not be rescaled in place: autograd saves the tensor the call was
    given.)

    In a data-parallel train step (``parallel.sharded_batch`` over more
    than one rank, or under ``parallel.force_global_reductions``) the
    statistics are those of the GLOBAL batch, as
    flax's over the sharded batch of the JAX mesh step: one all-reduce
    of the per-channel sum, sum of squares and count, with autograd
    (:meth:`_global_forward`). Per-rank statistics (torch DDP's default)
    would normalize and train differently."""

    recomputing = False     # set by _Recompute

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if par.global_batch() and self.momentum is not None:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        if n < 2 or self.momentum is None:
            return super().forward(x)    # torch raises for one value
        if self.recomputing:
            # The same fused call on scratch copies of the statistics: the
            # output (batch statistics) is the first forward's, and the
            # buffers keep that forward's one update.
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var * (n / (n - 1)),
                                self.weight, self.bias, True, self.momentum,
                                self.eps)
        self.num_batches_tracked.add_(1)
        var = self.running_var * (n / (n - 1))
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(var * ((n - 1) / n))
        return y

    def _global_forward(self, x):
        """Train mode over a batch sharded across the ranks: the mean and
        biased variance (``E[x^2] - E[x]^2``, flax's) of the global
        batch normalize, and update the running statistics (flax's rule,
        biased variance) unless the block is being recomputed."""
        C = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        stats = par.all_reduce_sum(stats)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None]
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        if not self.recomputing:
            m = self.momentum
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.mul_(1 - m).add_(mean.detach() * m)
                self.running_var.mul_(1 - m).add_(var.detach() * m)
        return y.to(x.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs; expansion 1 (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = conv3x3(cin, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, expansion 4 (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = conv1x1(cin, planes)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """ResNet trunk returning the final NCHW feature map."""

    def __init__(self, block, stage_sizes: Sequence[int],
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for blk in range(num_blocks):
                s = stride if blk == 0 else 1
                ds = None
                if blk == 0 and (s != 1 or cin != planes * block.expansion):
                    ds = nn.Sequential(
                        conv1x1(cin, planes * block.expansion, s),
                        BatchNorm2d(planes * block.expansion))
                blocks.append(block(cin, planes, s, ds))
                cin = planes * block.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        if not (self.remat and torch.is_grad_enabled()):
            x = self.layer1(x)
            x = self.layer2(x)
            x = self.layer3(x)
            return self.layer4(x)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=functools.partial(
                                   _remat_contexts, block))
        return x

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torchvision's init from an explicit generator: Kaiming-normal
        (fan_out, relu) convs, BN scale 1 / shift 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu',
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


_RESNETS = {
    'resnet18': (BasicBlock, (2, 2, 2, 2)),
    'resnet34': (BasicBlock, (3, 4, 6, 3)),
    'resnet50': (Bottleneck, (3, 4, 6, 3)),
    'resnet101': (Bottleneck, (3, 4, 23, 3)),
    'resnet152': (Bottleneck, (3, 8, 36, 3)),
}


def get_backbone(backbone: str, remat: bool = False) -> ResNet:
    """Instantiate a ResNet trunk by name (``resnet18`` ... ``resnet152``;
    HRNet is ``models.backbones.get_backbone``'s). ``remat``: checkpoint
    each block."""
    name = backbone.split('-')[0]
    if name not in _RESNETS:
        raise ValueError(f'unknown ResNet {backbone!r}; use one of '
                         f'{sorted(_RESNETS)}')
    block, stages = _RESNETS[name]
    return ResNet(block, stages, remat=remat)
