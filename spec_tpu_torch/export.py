"""Deployment artifacts: the two-stage predictor as ``torch.export``
programs (port of ``spec_tpu/export.py``).

:func:`export_predictor` freezes a live :class:`~spec_tpu_torch.serving.
SpecPredictor`'s two stage modules (``serving.CamStage`` and
``serving.SpecStage``, the modules the live predictor's stages run) with
``torch.export`` into one ``.specx`` file; :func:`load_predictor` rebuilds
a working predictor from that file alone, without the model classes, the
SMPL model files or the checkpoints.

Artifact layout (a zip):

- ``meta.json``: ``format`` (``specx-torch/1``), the torch version,
  ``platforms`` (device types the artifact may be loaded on: ``cpu``,
  ``cuda``), the device type it was exported on, the compute dtype, and
  the predictor's ``loss_type``, ``min_size``, ``img_res`` and
  ``batch_size``, and the ranges ``torch.export`` gave each program's
  symbolic sizes (as text);
- ``cam.pt2`` / ``spec.pt2``: the two programs (``torch.export.save``),
  each holding its own stage's weights once: stage 1 the CamCalib
  network, stage 2 HMR and the SMPL tensors that its forward reads (K1's
  packed operands and the extra-joint regressor). Deployment needs no
  SMPL model directory. Both are stored without compression.

Stage 1 is exported over ``(b, h, w, 3)`` uint8 frames (any resized
frame bucket; h, w >= 33), stage 2 over ``(b, 224, 224, 3)`` fp32 crops
and the six ``(b, ...)`` camera and box columns: one artifact serves every
batch and frame shape. The batch is traced at 2 with the range
torch.export derives (``meta['ranges']``: b >= 2, and on a CUDA trace
b <= 65535); by torch.export's 0/1 rule a program traced at 2 also takes
b = 1, which the predictor's power-of-two padding gives for a single
frame or person (held to the live predictor by the tests). The programs
are lowered to ATen operations (``run_decompositions``), so a bf16
predictor's autocast is baked in as explicit casts, with the autocast
policy of the device it was exported on.

SMPL's vertices are the op ``spec_tpu_torch::fused_lbs``
(``ops/lbs.py``): one node of the program with a plain implementation on
the CPU and K1 on a card. An artifact exported on a CPU therefore runs
the plain version on a CPU and **K1** on a card, the counterpart of the
JAX artifact's portability over ``platforms=('cpu', 'tpu')``. A stage
whose trunk is a Bottleneck ResNet is traced through its folded trunk
(``models/backbones/fused_resnet.py``), the convolutions the live stage
runs with the folded weights (bias, sum and ReLU as separate nodes,
where the live fp32 stage fuses them into its cuDNN calls on a card).
The stage is traced through ``exported()``, a copy without the source
backbone, so the program stores the folded weights alone. On a card
each loaded stage replays a CUDA graph per input signature
(``utils/graphs.StageGraph``), as the live predictor's stages do; every
call runs with TF32 off (the fp32 predictor's precision; bf16 casts are
in the program).

The artifact executes on one device; multi-device serving stays on the
live predictor.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Sequence

import torch

FORMAT = 'specx-torch/1'
PLATFORMS = ('cpu', 'cuda')


def _check_platforms(platforms: Sequence[str]) -> list:
    platforms = list(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f'cannot export for platforms {bad or platforms}: '
                         f'the port serves {list(PLATFORMS)}')
    return platforms


def _program_bytes(module, args, dynamic_shapes) -> tuple:
    """``module`` traced over ``args`` with ``dynamic_shapes``, lowered
    to ATen operations, serialized -> (bytes, the ranges torch.export
    gave the symbolic sizes, as text)."""
    with torch.no_grad():
        ep = torch.export.export(module, args,
                                 dynamic_shapes=dynamic_shapes)
    ep = ep.run_decompositions({})
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), sorted({str(r) for r in
                                   ep.range_constraints.values()})


def export_predictor(pred, path: str,
                     platforms: Sequence[str] = PLATFORMS) -> str:
    """Serialize ``pred``'s two stages, their weights and its config
    into ``path``; returns ``path``. ``pred`` is a live
    :class:`~spec_tpu_torch.serving.SpecPredictor`; the programs are
    traced on its device. A platform the port cannot serve (``tpu``)
    raises ``ValueError``."""
    from torch.export import Dim

    platforms = _check_platforms(platforms)
    dev = pred.device
    # The batch is dynamic with the range torch.export derives (a CUDA
    # trace bounds it by the grid's 65535); a traced size of 2 stands
    # for every b, b = 1 included (torch.export's 0/1 rule).
    b = Dim.AUTO
    h = max(int(pred.min_size), 33)
    frames = torch.zeros((2, h, h * 4 // 3, 3), dtype=torch.uint8,
                         device=dev)
    cam, cam_ranges = _program_bytes(pred._stage1.fn.exported(), (frames,),
                                     ({0: b, 1: Dim.AUTO, 2: Dim.AUTO},))

    res = pred.img_res

    def f4(*shape):
        return torch.ones((2, *shape), dtype=torch.float32, device=dev)

    eye = torch.eye(3, device=dev).expand(2, 3, 3).contiguous()
    spec_args = (f4(res, res, 3), eye, eye.clone(), f4(), f4(2), f4(),
                 f4())
    spec, spec_ranges = _program_bytes(pred._stage2.fn.exported(),
                                       spec_args,
                                       tuple({0: b} for _ in spec_args))

    meta = {
        'format': FORMAT,
        'torch_version': torch.__version__,
        'platforms': platforms,
        'exported_on': dev.type,
        'dtype': str(pred.spec.dtype).replace('torch.', ''),
        'loss_type': pred.loss_type,
        'min_size': pred.min_size,
        'img_res': pred.img_res,
        'batch_size': pred.batch_size,
        'ranges': {'cam': cam_ranges, 'spec': spec_ranges},
    }
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_STORED) as z:
        z.writestr('meta.json', json.dumps(meta, indent=1))
        z.writestr('cam.pt2', cam)
        z.writestr('spec.pt2', spec)
    return path


class _Program:
    """A loaded stage program, called with TF32 off."""

    def __init__(self, module):
        self.module = module

    def __call__(self, *args):
        from spec_tpu_torch.utils.precision import fp32_precision

        with fp32_precision():
            return self.module(*args)


def read_meta(path: str) -> dict:
    """The artifact's ``meta.json``; a format other than
    ``specx-torch/1`` (the JAX package's ``specx/1`` among them) raises
    ``ValueError`` naming it."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read('meta.json'))
    if meta.get('format') != FORMAT:
        raise ValueError(f'{path}: unsupported artifact format '
                         f'{meta.get("format")!r} (expected {FORMAT!r})')
    return meta


def load_predictor(path: str, batch_size: Optional[int] = None,
                   device: str | torch.device = 'cuda'):
    """Rebuild a serving predictor from a ``.specx`` artifact on
    ``device``.

    Returns a :class:`~spec_tpu_torch.serving.SpecPredictor` made with
    ``__new__`` (its knobs resolve to the class defaults): the same host
    code, with the device stages read from the artifact. No model class
    is built and no checkpoint or SMPL file is read. Loading onto a
    device type that is not in the artifact's ``platforms`` raises
    ``ValueError``.
    """
    from torch.export.passes import move_to_device_pass

    # torch.export.load resolves the op's node by name: register it first.
    import spec_tpu_torch.ops.lbs  # noqa: F401
    from spec_tpu_torch.serving import SpecPredictor
    from spec_tpu_torch.utils.graphs import StageGraph

    device = torch.device(device)
    meta = read_meta(path)
    if device.type not in meta['platforms']:
        raise ValueError(f'{path} was exported for {meta["platforms"]}, '
                         f'not {device.type}')

    def program(name):
        with zipfile.ZipFile(path) as z:
            ep = torch.export.load(io.BytesIO(z.read(name)))
        return _Program(move_to_device_pass(ep, str(device)).module())

    pred = SpecPredictor.__new__(SpecPredictor)
    pred.device = device
    pred.img_res = int(meta['img_res'])
    pred.batch_size = int(batch_size or meta['batch_size'])
    pred.min_size = int(meta['min_size'])
    pred.loss_type = meta['loss_type']
    pred.assets = None             # in the stage-2 program
    pred.camcalib = pred.spec = None
    pool = (torch.cuda.graph_pool_handle() if device.type == 'cuda'
            else None)
    pred._stage1 = StageGraph('stage1', program('cam.pt2'), pool)
    pred._stage2 = StageGraph('stage2', program('spec.pt2'), pool)
    return pred
