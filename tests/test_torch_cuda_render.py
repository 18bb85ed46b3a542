"""The mesh overlay over the card's outputs: ``render_mesh_overlay`` on
``SpecPredictor.predict``'s meshes from the card against the same
overlay from the CPU's (the same weights, fp32), and K1's launch on the
path.

Marked ``cuda``; skips without a GPU. It imports no JAX:

    python -m pytest tests/test_torch_cuda_render.py -m cuda --noconftest

Small sizes (ResNet-18 in both stages, three 96x128 frames, five
persons). The overlays may differ in at most RENDER_PIXEL_SHARE of each
frame's mesh pixels, the budget of ``chip_smoke.py``'s render phase.
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.ops import lbs as L
from spec_tpu_torch.serving import SpecPredictor
from spec_tpu_torch.utils.renderer import render_mesh_overlay

RENDER_PIXEL_SHARE = 5e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the overlay of the card outputs)')
    return torch.device('cuda')


def _inputs():
    rng = np.random.RandomState(11)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    boxes = [np.array([[64.0, 48.0, 60.0, 80.0]], np.float32),
             np.array([[40.0, 55.0, 50.0, 50.0], [90.0, 50.0, 40.0, 70.0]],
                      np.float32),
             np.array([[60.0, 50.0, 40.0, 70.0], [100.0, 40.0, 30.0, 55.0]],
                      np.float32)]
    return frames, boxes


def _overlays(pred, frames, boxes):
    results, cams = pred.predict(frames, boxes, return_cameras=True)
    faces = pred.assets.faces.cpu().numpy()
    return [render_mesh_overlay(
        f, [p['smpl_vertices'] for p in r], [p['pred_cam_t'] for p in r],
        faces, c['f_pix'], c['pitch'], c['roll'])
        for f, r, c in zip(frames, results, cams)]


@pytest.mark.cuda
def test_overlay_of_card_outputs_matches_the_cpu(cuda_device):
    frames, boxes = _inputs()
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              use_cam_feats=True, min_size=96, img_res=64, batch_size=8)
    card = SpecPredictor(device=cuda_device, **kw)
    card.predict(frames, boxes)                       # captures
    L.LAUNCHES = 0
    got = _overlays(card, frames, boxes)
    assert L.LAUNCHES == 1                            # one stage-2 chunk
    want = _overlays(SpecPredictor(device='cpu', **kw), frames, boxes)
    for frame, g, w in zip(frames, got, want):
        mesh = ((g != frame).any(-1) | (w != frame).any(-1)).sum()
        assert mesh > 0
        assert (g != w).any(-1).sum() <= RENDER_PIXEL_SHARE * mesh
