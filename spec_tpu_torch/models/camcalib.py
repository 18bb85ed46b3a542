"""CamCalib: single-image camera regressor (torch twin of
``spec_tpu/models/camcalib.py``).

A ResNet trunk, global average pooling and three parallel FC stacks with
256 logits each for the vfov / pitch / roll bin distributions (decoded by
:mod:`spec_tpu_torch.core.bins`). Parameter names follow the reference
checkpoints: ``backbone.*`` and ``fc_{vfov,pitch,roll}.weight`` (one
layer) or ``fc_{vfov,pitch,roll}.{i}.weight`` (a stack).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spec_tpu_torch.models.backbones import get_backbone
from spec_tpu_torch.utils.precision import compute_dtype

HEADS = ('fc_vfov', 'fc_pitch', 'fc_roll')


class CameraRegressorNetwork(nn.Module):
    """Backbone + avgpool + 3 bin heads. ``dtype`` is the backbone and FC
    compute dtype (float32 or bfloat16); logits come out float32."""

    def __init__(self, backbone: str = 'resnet50', num_fc_layers: int = 1,
                 num_fc_channels: int = 1024, num_out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_fc_layers = num_fc_layers
        self.backbone = get_backbone(backbone)
        nf = self.backbone.out_channels
        for name in HEADS:
            if num_fc_layers == 1:
                head = nn.Linear(nf, num_out_channels)
            else:
                widths = [nf] + [num_fc_channels] * (num_fc_layers - 1) + [
                    num_out_channels]
                head = nn.Sequential(*[
                    nn.Linear(widths[i], widths[i + 1])
                    for i in range(num_fc_layers)])
            self.add_module(name, head)

    def forward(self, images: torch.Tensor, trunk=None):
        """images (B, H, W, 3) ImageNet-normalized, NHWC like the JAX
        module -> (vfov, pitch, roll) logits, each (B, 256) float32.
        ``trunk``: a callable run in place of ``backbone`` (the same
        contract; the predictor's folded trunk), or None."""
        x = images.permute(0, 3, 1, 2)     # NCHW view (channels_last)
        with compute_dtype(self.dtype, images.device.type):
            feats = (trunk or self.backbone)(x)
            pooled = feats.mean(dim=(2, 3))
            return tuple(getattr(self, n)(pooled).float() for n in HEADS)

    def forward_pooled(self, row_sums, count: int):
        """The heads over a trunk split into bands of rows
        (``parallel/spatial.py``): the pooled mean of :meth:`forward` is
        the sum of the bands' (B, C) fp32 row sums of the feature map
        divided by ``count``, its full height times width. Returns the
        logits as :meth:`forward` does."""
        pooled = torch.stack(list(row_sums)).sum(0) / count
        with compute_dtype(self.dtype, pooled.device.type):
            return tuple(getattr(self, n)(pooled).float() for n in HEADS)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator: torchvision trunk
        init; single-layer heads N(0, 0.01) with zero bias (the JAX
        module's init), stacked heads torch's default Linear init."""
        self.backbone.reset_parameters(generator)
        for name in HEADS:
            for m in getattr(self, name).modules():
                if not isinstance(m, nn.Linear):
                    continue
                if self.num_fc_layers == 1:
                    m.weight.normal_(0.0, 0.01, generator=generator)
                    m.bias.zero_()
                else:
                    bound = m.in_features ** -0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)
