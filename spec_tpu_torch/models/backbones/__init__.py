"""Backbone registry (torch twin of ``spec_tpu/models/backbones/__init__.py``):
ResNet-18..152 (``resnet.py``) and HRNet-W32/W48 with the ``-conv`` or
``-interp`` downsample head (``hrnet.py``), by the reference's names, and
HMR 2.0's ViT-H/16 (``vit.py``, ``vit_h``; no JAX counterpart)."""

from __future__ import annotations

import torch.nn as nn

_BACKBONE_INFO = {
    'resnet18': dict(n_output_channels=512, downsample_rate=4),
    'resnet34': dict(n_output_channels=512, downsample_rate=4),
    'resnet50': dict(n_output_channels=2048, downsample_rate=4),
    'resnet101': dict(n_output_channels=2048, downsample_rate=4),
    'resnet152': dict(n_output_channels=2048, downsample_rate=4),
    'hrnet_w32': dict(n_output_channels=480, downsample_rate=4),
    'hrnet_w48': dict(n_output_channels=720, downsample_rate=4),
    'vit_h': dict(n_output_channels=1280, downsample_rate=16),
}


def get_backbone_info(backbone: str) -> dict:
    """Channel and stride metadata per backbone (PARE's
    ``get_backbone_info``)."""
    return _BACKBONE_INFO[backbone.split('-')[0]]


def get_backbone(backbone: str, remat: bool = False) -> nn.Module:
    """A trunk by name: ``resnet18`` ... ``resnet152``, or
    ``hrnet_w32`` / ``hrnet_w48`` with ``-conv`` (conv downsample head)
    or ``-interp`` (bilinear, the default), or ``vit_h``. ``remat``:
    checkpoint each residual block (ResNet) or exchange module (HRNet).
    Each trunk has ``out_channels`` and ``reset_parameters(generator)``."""
    name = backbone.split('-')[0]
    if name.startswith('vit'):
        from spec_tpu_torch.models.backbones.vit import get_vit

        return get_vit(name, remat=remat)
    if name.startswith('hrnet'):
        from spec_tpu_torch.models.backbones.hrnet import get_hrnet

        return get_hrnet(name, use_conv=backbone.endswith('-conv'),
                         remat=remat)
    from spec_tpu_torch.models.backbones.resnet import get_backbone as resnet

    return resnet(backbone, remat=remat)
