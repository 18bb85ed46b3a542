"""Inference-fused ResNet trunk (Bottleneck archs): the torch twin of
``spec_tpu/models/backbones/fused_resnet.py``.

:class:`FusedResNet` takes one of this package's
:class:`~spec_tpu_torch.models.backbones.resnet.ResNet` trunks, folds
every BatchNorm into its conv once, at construction, and runs on NHWC
activations:

* the stem and each stage's projection block on cuDNN convolutions, with
  NHWC memory viewed as channels_last NCHW and the folded weights stored
  channels_last, so no layout conversion runs; bias added in the compute
  dtype, then ReLU (the JAX ``_conv``); the 3x3/2 max-pool pads with -inf;
* all identity blocks of a stage through one
  :func:`~spec_tpu_torch.ops.bottleneck.fused_bottleneck_chain` call (the
  hand-written kernel on a GPU, its plain version on the CPU). That
  function keeps the JAX limit of K < H blocks per chain, so on maps
  shorter than a stage's chain (inputs under about 100 px high) it is
  cut into calls of at most H - 1 blocks; a map 1 pixel high is refused.

The JAX trunk keeps a per-stage ``_POLICY`` table that is all zeros on
the TPU: Mosaic forced a relayout of the activations around each custom
call, and XLA's conv emitter already ran the blocks at ~90 % of HBM
bandwidth. Neither reason holds on this card, so the port has no policy
table and every identity block goes through the kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from spec_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from spec_tpu_torch.ops.bottleneck import fold_bn, fused_bottleneck_chain
from spec_tpu_torch.utils.precision import fp32_precision

_STAGES = {
    (3, 4, 6, 3): 'resnet50',
    (3, 4, 23, 3): 'resnet101',
    (3, 8, 36, 3): 'resnet152',
}


def _folded(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return fold_bn(conv.weight.detach(), bn.weight.detach(),
                   bn.bias.detach(), bn.running_mean, bn.running_var,
                   bn.eps)


class FusedResNet(nn.Module):
    """Folded-BN inference trunk of a Bottleneck ResNet (50/101/152).

    The folded weights are a snapshot of ``resnet``'s weights and BN
    statistics when the module is built: later changes to ``resnet`` do
    not reach it. ``dtype`` (float32 or bfloat16) is the compute and
    activation dtype; biases of the identity blocks stay float32.
    """

    def __init__(self, resnet: ResNet, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'unsupported compute dtype {dtype}')
        sizes = tuple(len(getattr(resnet, f'layer{i + 1}'))
                      for i in range(4))
        if (not isinstance(resnet.layer1[0], Bottleneck)
                or sizes not in _STAGES):
            raise ValueError(
                'fused trunk supports Bottleneck archs '
                f'{sorted(_STAGES.values())}, got stages {sizes} of '
                f'{type(resnet.layer1[0]).__name__}')
        self.dtype = dtype
        self.stage_sizes = sizes

        def conv_buffers(name, conv, bn):
            w, b = _folded(conv, bn)
            self.register_buffer(f'{name}_w', w.to(dtype).contiguous(
                memory_format=torch.channels_last))
            self.register_buffer(f'{name}_b', b.to(dtype))

        conv_buffers('stem', resnet.conv1, resnet.bn1)
        for s, n in enumerate(sizes):
            layer = getattr(resnet, f'layer{s + 1}')
            blk = layer[0]
            for i in (1, 2, 3):
                conv_buffers(f'l{s}_proj{i}', getattr(blk, f'conv{i}'),
                             getattr(blk, f'bn{i}'))
            conv_buffers(f'l{s}_down', blk.downsample[0], blk.downsample[1])
            for j in range(1, n):
                blk = layer[j]
                m = blk.conv1.out_channels
                w1, b1 = _folded(blk.conv1, blk.bn1)          # (M, C, 1, 1)
                w2, b2 = _folded(blk.conv2, blk.bn2)          # (M, M, 3, 3)
                w3, b3 = _folded(blk.conv3, blk.bn3)          # (C, M, 1, 1)
                kernel_layout = (
                    w1.reshape(m, -1).t(), b1,
                    w2.permute(2, 3, 1, 0).reshape(9, m, m), b2,
                    w3.reshape(-1, m).t(), b3)
                for name, t in zip(('w1', 'b1', 'w2', 'b2', 'w3', 'b3'),
                                   kernel_layout):
                    t = t if name.startswith('b') else t.to(dtype)
                    self.register_buffer(f'l{s}_id{j}_{name}', t.contiguous())

    def _conv(self, x, name, stride=1, padding=0):
        y = F.conv2d(x, getattr(self, f'{name}_w'), stride=stride,
                     padding=padding)
        return y + getattr(self, f'{name}_b').reshape(1, -1, 1, 1)

    def _chain(self, s):
        return tuple(
            tuple(getattr(self, f'l{s}_id{j}_{n}')
                  for n in ('w1', 'b1', 'w2', 'b2', 'w3', 'b3'))
            for j in range(1, self.stage_sizes[s]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) normalized NHWC images -> the NHWC feature map
        (B, H/32, W/32, C_out) in the compute dtype."""
        with fp32_precision():
            # channels_last NCHW view of the NHWC memory
            y = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)
            y = torch.relu(self._conv(y, 'stem', 2, 3))
            y = F.max_pool2d(y, 3, 2, padding=1)
            for s in range(4):
                stride = 1 if s == 0 else 2
                h = torch.relu(self._conv(y, f'l{s}_proj1'))
                h = torch.relu(self._conv(h, f'l{s}_proj2', stride, 1))
                h = self._conv(h, f'l{s}_proj3')
                y = torch.relu(h + self._conv(y, f'l{s}_down', stride))
                nhwc = y.permute(0, 2, 3, 1).contiguous()
                chain = self._chain(s)
                step = max(1, nhwc.shape[1] - 1)
                for i in range(0, len(chain), step):
                    nhwc = fused_bottleneck_chain(nhwc, chain[i:i + step])
                y = nhwc.permute(0, 3, 1, 2)
        return y.permute(0, 2, 3, 1)
