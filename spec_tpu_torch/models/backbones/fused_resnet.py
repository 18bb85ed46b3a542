"""Inference-fused ResNet trunk (Bottleneck archs): the torch twin of
``spec_tpu/models/backbones/fused_resnet.py``, and the form in which the
predictor's stages run a Bottleneck ResNet for inference.

:class:`FusedResNet` takes one of this package's
:class:`~spec_tpu_torch.models.backbones.resnet.ResNet` trunks and
folds every BatchNorm into its conv; it takes NHWC images and returns
the NHWC feature map, and runs:

* the stem and each stage's projection block on cuDNN convolutions, with
  activations and folded weights in the layout of cuDNN's kernels for
  the dtype (:func:`_layout`: channels_last in bfloat16, NCHW in
  float32), so cuDNN transposes nothing; bias added in the compute
  dtype, then ReLU (the JAX ``_conv``), where on a card in float32 one
  fused call takes bias, sum and ReLU (:func:`_conv`); the 3x3/2
  max-pool pads with -inf;
* each stage's identity blocks either as three folded convolutions each,
  like the rest of the trunk (``k3=False``: the predictor's stages), or
  through K3, one
  :func:`~spec_tpu_torch.ops.bottleneck.fused_bottleneck_chain` call a
  stage on NHWC memory (``k3=True``: ``pipeline.py``'s
  ``stage1='fused'``; the hand-written kernel on a GPU, its plain
  version on the CPU). That function keeps the JAX limit of K < H
  blocks per chain, so on maps shorter than a stage's chain (inputs
  under about 100 px high) it is cut into calls of at most H - 1
  blocks; a map 1 pixel high is refused. As CUDA-graph replays the
  folded cuDNN blocks beat K3 at every shape of the predict cells
  (PERF.md §6), which is why the predictor's stages take them.

The folded weights are buffers made at construction. :meth:`refresh`
folds them again, into the same storage (``copy_``, so CUDA graphs
captured over them stay valid), when a weight or BatchNorm statistic of
the source trunk has changed since (its version counter moved):
``utils/graphs.StageGraph`` calls a stage's ``refresh`` on the host
before every call, so a stage follows weights loaded after it was built.
Between refreshes the trunk is a snapshot of its source. A source made
under ``torch.inference_mode`` keeps no version counters, so
:meth:`refresh` refuses it and :func:`inference_trunk` leaves such a
model on its backbone.

The JAX trunk keeps a per-stage ``_POLICY`` table that is all zeros on
the TPU (every identity block an XLA convolution), as the predictor's
``k3=False`` trunk runs them here.
"""

from __future__ import annotations

from typing import Optional

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
_BLOCK = ('w1', 'b1', 'w2', 'b2', 'w3', 'b3')


def _stage_sizes(resnet: nn.Module) -> tuple:
    return tuple(len(getattr(resnet, f'layer{i + 1}', ()))
                 for i in range(4))


def supported(resnet: nn.Module) -> bool:
    """Whether :class:`FusedResNet` takes ``resnet``: a Bottleneck ResNet
    of 50, 101 or 152 layers."""
    return (isinstance(resnet, ResNet)
            and isinstance(resnet.layer1[0], Bottleneck)
            and _stage_sizes(resnet) in _STAGES)


def _watched(resnet: nn.Module) -> list:
    """The source tensors a fold reads: every conv's and BatchNorm's
    floating-point parameters and buffers."""
    return [t for m in resnet.modules()
            if isinstance(m, (nn.Conv2d, nn.BatchNorm2d))
            for t in (*m.parameters(recurse=False),
                      *m.buffers(recurse=False))
            if t.is_floating_point()]


def inference_trunk(model: nn.Module) -> Optional['FusedResNet']:
    """The folded trunk (identity blocks as cuDNN convolutions) of
    ``model.backbone`` where the backbone is a Bottleneck ResNet
    computing in float32 whose tensors keep version counters, else
    None: BasicBlock ResNets, HRNet and ViT; models made under
    ``torch.inference_mode``, whose later loads the trunk could not
    see; and bfloat16 models, where folding the scales into the weights
    before they round moves a ResNet-50 predictor's cameras past the
    bfloat16 limit of 1e-3 rad from its module path (PERF.md §6)."""
    if (model.dtype != torch.float32
            or not supported(model.backbone)
            or any(t.is_inference() for t in _watched(model.backbone))):
        return None
    return FusedResNet(model.backbone, dtype=model.dtype, k3=False)


def _folded(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return fold_bn(conv.weight.detach(), bn.weight.detach(),
                   bn.bias.detach(), bn.running_mean, bn.running_var,
                   bn.eps)


def _layout(dtype: torch.dtype) -> torch.memory_format:
    """The memory layout of the trunk's cuDNN convolutions and their
    weights: channels_last (NHWC memory) in bfloat16, whose tensor-core
    kernels are NHWC; NCHW in float32, where with TF32 off cuDNN runs
    NCHW kernels only and would transpose a channels_last operand in
    and out of every call."""
    return (torch.channels_last if dtype == torch.bfloat16
            else torch.contiguous_format)


def _conv(x, w, b=None, stride=1, padding=0, add=None, relu=False):
    """conv(x, w) + b (+ add), then ReLU when ``relu``. On a card in
    float32 one cuDNN call with the bias, the sum and the ReLU fused
    (``cudnn_convolution_relu`` / ``_add_relu``, which keep the TF32
    flag, off here); elsewhere the convolution, then the sum and ReLU
    apart: in bfloat16 each rounds, as in the JAX ``_conv``, and while
    exporting these calls make a program that runs on every device."""
    if (relu and x.is_cuda and x.dtype == torch.float32
            and not torch.compiler.is_exporting()):
        args = ((stride, stride), (padding, padding), (1, 1), 1)
        if add is None:
            return torch.cudnn_convolution_relu(x, w, b, *args)
        return torch.cudnn_convolution_add_relu(x, w, add, 1.0, b, *args)
    y = F.conv2d(x, w, b, stride=stride, padding=padding)
    if add is not None:
        y = y + add
    return torch.relu(y) if relu else y


def _max_pool(y: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3/2 max-pool, padded with -inf. While exporting it is
    the maximum over windows of a padded view: on a card max_pool2d's
    output-size rule branches on the parity of the map's size, which
    would tie a program exported there to the parity of the frames it
    was traced on."""
    if not torch.compiler.is_exporting():
        return F.max_pool2d(y, 3, 2, padding=1)
    y = F.pad(y, (1, 1, 1, 1), value=float('-inf'))
    return y.unfold(2, 3, 2).unfold(3, 3, 2).amax((-2, -1))


class FusedResNet(nn.Module):
    """Folded-BN inference trunk of a Bottleneck ResNet (50/101/152).

    ``dtype`` (float32 or bfloat16) is the compute and activation dtype;
    ``k3`` runs the identity blocks through K3 (whose biases stay
    float32), else as folded convolutions. The source trunk is held, not
    registered: the module's state is its folded buffers.
    """

    def __init__(self, resnet: ResNet, dtype: torch.dtype = torch.bfloat16,
                 k3: bool = True):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'unsupported compute dtype {dtype}')
        if not supported(resnet):
            raise ValueError(
                'fused trunk supports Bottleneck archs '
                f'{sorted(_STAGES.values())}, got stages '
                f'{_stage_sizes(resnet)} of '
                f'{type(resnet.layer1[0]).__name__}')
        self.dtype = dtype
        self.k3 = k3
        self.layout = _layout(dtype)
        self.stage_sizes = _stage_sizes(resnet)
        self._source = (resnet,)            # a tuple: not a submodule
        self._watched = _watched(resnet)
        with torch.no_grad():
            for name, t in self._folds().items():
                self.register_buffer(name, t)
        self._versions = self._source_versions()

    def _source_versions(self) -> Optional[list]:
        """The source tensors' version counters; None when one was made
        under inference_mode and keeps none."""
        if any(t.is_inference() for t in self._watched):
            return None
        return [t._version for t in self._watched]

    def _folds(self) -> dict:
        """Every folded tensor by name, from the source's current
        weights: ``<conv>_w`` / ``<conv>_b`` for the stem and projection
        convs; per identity block j of stage s ``l{s}_id{j}_{w1..b3}``,
        K3's operands or the three convs' weights and biases."""
        resnet, dt, fmt = self._source[0], self.dtype, self.layout
        out = {}

        def conv(name, w, b):
            out[f'{name}_w'] = w.to(dt).contiguous(memory_format=fmt)
            out[f'{name}_b'] = b.to(dt)

        conv('stem', *_folded(resnet.conv1, resnet.bn1))
        for s, n in enumerate(self.stage_sizes):
            layer = getattr(resnet, f'layer{s + 1}')
            blk = layer[0]
            for i in (1, 2, 3):
                conv(f'l{s}_proj{i}', *_folded(getattr(blk, f'conv{i}'),
                                               getattr(blk, f'bn{i}')))
            conv(f'l{s}_down', *_folded(blk.downsample[0],
                                        blk.downsample[1]))
            for j in range(1, n):
                blk, p = layer[j], f'l{s}_id{j}'
                folded = [_folded(getattr(blk, f'conv{i}'),
                                  getattr(blk, f'bn{i}')) for i in (1, 2, 3)]
                if not self.k3:
                    for i, (w, b) in enumerate(folded):
                        conv(f'{p}_c{i + 1}', w, b)
                    continue
                (w1, b1), (w2, b2), (w3, b3) = folded
                m = w1.shape[0]
                kernel_layout = (
                    w1.reshape(m, -1).t().to(dt), b1,
                    w2.permute(2, 3, 1, 0).reshape(9, m, m).to(dt), b2,
                    w3.reshape(-1, m).t().to(dt), b3)
                for name, t in zip(_BLOCK, kernel_layout):
                    out[f'{p}_{name}'] = t.contiguous()
        return out

    @torch.no_grad()
    def refresh(self) -> bool:
        """Fold again, into the same storage, when a weight or BatchNorm
        statistic of the source changed since the last fold (a version
        counter moved; ``load_state_dict`` and in-place updates move
        them). Returns whether it folded. Host work only when nothing
        changed. Raises for a source made under inference_mode, whose
        changes it cannot see."""
        if self._versions is None:
            raise RuntimeError('FusedResNet.refresh: the source trunk was '
                               'made under inference_mode and keeps no '
                               'version counters')
        versions = self._source_versions()
        if versions == self._versions:
            return False
        for name, t in self._folds().items():
            self.get_buffer(name).copy_(t)
        self._versions = versions
        return True

    def _conv_named(self, y, name, stride=1, padding=0, add=None,
                    relu=False):
        return _conv(y, self.get_buffer(f'{name}_w'),
                     self.get_buffer(f'{name}_b'), stride, padding, add,
                     relu)

    def _identity_blocks(self, s: int, y: torch.Tensor) -> torch.Tensor:
        """Stage ``s``'s identity blocks on the map ``y`` (in the trunk's
        layout)."""
        n = self.stage_sizes[s]
        if not self.k3:
            for j in range(1, n):
                p = f'l{s}_id{j}'
                h = self._conv_named(y, f'{p}_c1', relu=True)
                h = self._conv_named(h, f'{p}_c2', padding=1, relu=True)
                y = self._conv_named(h, f'{p}_c3', add=y, relu=True)
            return y
        chain = tuple(tuple(self.get_buffer(f'l{s}_id{j}_{k}')
                            for k in _BLOCK) for j in range(1, n))
        nhwc = y.permute(0, 2, 3, 1).contiguous()
        step = max(1, nhwc.shape[1] - 1)
        for i in range(0, len(chain), step):
            nhwc = fused_bottleneck_chain(nhwc, chain[i:i + step])
        return nhwc.permute(0, 3, 1, 2).contiguous(memory_format=self.layout)

    def nchw(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk with a backbone's contract: x (B, 3, H, W) (an NCHW
        view of NHWC images) -> the (B, C_out, H/32, W/32) feature map
        in the trunk's layout."""
        return self(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) normalized NHWC images -> the NHWC feature map
        (B, H/32, W/32, C_out) in the compute dtype (a view of the
        trunk's layout)."""
        with fp32_precision():
            y = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=self.layout)
            y = _max_pool(self._conv_named(y, 'stem', 2, 3, relu=True))
            for s in range(4):
                stride = 1 if s == 0 else 2
                h = self._conv_named(y, f'l{s}_proj1', relu=True)
                h = self._conv_named(h, f'l{s}_proj2', stride, 1, relu=True)
                down = self._conv_named(y, f'l{s}_down', stride)
                y = self._conv_named(h, f'l{s}_proj3', add=down, relu=True)
                y = self._identity_blocks(s, y)
        return y.permute(0, 2, 3, 1)
