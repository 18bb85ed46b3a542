"""The predictor's folded ResNet-50 trunks on a card: the trunk against
the module it folds at the predict cells' stage shapes, with no K3
launch; replays after a second ``load_state_dict`` serve the new
weights (the refold lands in the captured graphs' buffers); and a
``.specx`` round trip of the folded predictor, exported and loaded on
the card, held to the live one.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_fused_trunk.py -m cuda --noconftest
"""

import copy

import numpy as np
import pytest
import torch

from spec_tpu_torch.ops import bottleneck as TB

# card vs card, fp32: the module path (cuDNN, TF32 off) against the folded
# trunk (folded cuDNN, TF32 off); chip_smoke.py's PREDICT_LIMITS['fp32']
# hold the card to the CPU with these.
LIMITS = dict(pred_pose=2e-3, pred_pose_6d=2e-3, pred_shape=2e-3,
              pred_cam=2e-3, pred_cam_t=2e-3, smpl_vertices=5e-3,
              smpl_joints3d=5e-3, smpl_joints2d=0.1)
ANGLE_LIMIT = 1e-4
# (B, H, W) of the trunk inputs of the predict cells: stage-2 chunks of
# 32 and 8 crops of 224², and stage-1 buckets of photos and keyframes at
# a 600-px short side.
CELL_SHAPES = [(32, 224, 224), (8, 224, 224), (1, 600, 1067),
               (2, 600, 800), (2, 800, 600), (1, 900, 600)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernel has no CPU mode)')
    return torch.device('cuda')


def _state(model, seed):
    """A state_dict for ``model``: torchvision init from ``seed``,
    BatchNorm scales 0.35 and statistics drawn around 0 and 1."""
    m = copy.deepcopy(model).cpu()
    m.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.fill_(0.35)
                mod.running_mean.normal_(0.0, 0.1, generator=g)
                mod.running_var.uniform_(0.75, 1.25, generator=g)
    return m.state_dict()


def _load(pred, seed):
    pred.camcalib.load_state_dict(_state(pred.camcalib, seed))
    pred.spec.load_state_dict(_state(pred.spec, seed + 10))


def _predictor(device, **kw):
    from spec_tpu_torch.serving import SpecPredictor

    return SpecPredictor(device=device, backbone='resnet50',
                         camcalib_backbone='resnet50', min_size=128,
                         batch_size=32, **kw)


def _frames(persons, seed=11):
    """128x224 frames: stage 1 takes them at their size (min_size 128)."""
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(128, 224, 3) * 255).astype(np.uint8)
              for _ in persons]
    boxes = [np.array([[rng.uniform(60, 200), rng.uniform(40, 100),
                        rng.uniform(30, 60), rng.uniform(50, 100)]
                       for _ in range(k)], np.float32).reshape(-1, 4)
             for k in persons]
    return frames, boxes


def _module_path(pred, frames, boxes):
    """``predict`` eagerly, both stages on their backbones."""
    stages = pred._stage1, pred._stage2
    trunks = stages[0].fn.trunk, stages[1].fn.trunk
    pred._stage1, pred._stage2 = stages[0].fn, stages[1].fn
    pred._stage1.trunk = pred._stage2.trunk = None
    try:
        return pred.predict(frames, boxes, return_cameras=True)
    finally:
        pred._stage1.trunk, pred._stage2.trunk = trunks
        pred._stage1, pred._stage2 = stages


def _hold(got, want):
    (res_g, cams_g), (res_e, cams_e) = got, want
    for cg, ce in zip(cams_g, cams_e, strict=True):
        for k in ('vfov', 'pitch', 'roll'):
            assert abs(cg[k] - ce[k]) <= ANGLE_LIMIT, k
    assert [len(r) for r in res_g] == [len(r) for r in res_e]
    for rg, re in zip(res_g, res_e):
        for pg, pe in zip(rg, re):
            for k, lim in LIMITS.items():
                assert np.isfinite(pg[k]).all(), k
                assert np.abs(pg[k] - pe[k]).max() <= lim, k


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CELL_SHAPES)
def test_folded_trunk_matches_the_module_at_the_cells_shapes(cuda_device,
                                                            shape):
    """fp32 ResNet-50 at the predict cells' trunk inputs: the folded
    trunk's feature map within 1e-4 of the largest value of the eval
    module's (both cuDNN, TF32 off: folding changes the rounding only),
    with no K3 launch."""
    from spec_tpu_torch.models.backbones.fused_resnet import FusedResNet
    from spec_tpu_torch.models.backbones.resnet import get_backbone
    from spec_tpu_torch.utils.precision import fp32_precision

    port = get_backbone('resnet50')
    port.load_state_dict(_state(port, 5))
    port = port.to(cuda_device).eval()
    trunk = FusedResNet(port, dtype=torch.float32, k3=False)
    x = torch.randn(*shape, 3, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    before = TB.LAUNCHES
    with torch.inference_mode():
        got = trunk(x)
        with fp32_precision():
            want = port(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert TB.LAUNCHES == before
    assert (want > 0).float().mean() > 0.3
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-4, float(err)


@pytest.mark.cuda
def test_replays_follow_a_second_load(cuda_device):
    """Graphs captured under the first weights replay the second's: the
    folded trunk refolds into the buffers the graphs read. The replays
    launch no K3."""
    pred = _predictor(cuda_device)
    _load(pred, 20)
    frames, boxes = _frames([16, 16])
    first = pred.predict(frames, boxes, return_cameras=True)   # captures
    _hold(first, _module_path(pred, frames, boxes))
    _load(pred, 50)
    before = TB.LAUNCHES
    got = pred.predict(frames, boxes, return_cameras=True)     # replays
    torch.cuda.synchronize()
    assert TB.LAUNCHES == before
    _hold(got, _module_path(pred, frames, boxes))
    assert not np.allclose(got[0][0][0]['smpl_vertices'],
                           first[0][0][0]['smpl_vertices'], atol=1e-3)


@pytest.mark.cuda
def test_specx_round_trip_on_the_card(cuda_device, tmp_path):
    """Exported on the card from the folded predictor, loaded on the
    card: it serves what the live predictor serves, within card-vs-card
    limits (the program adds bias, sum and ReLU apart, where the live
    fp32 stages fuse them into their cuDNN calls)."""
    from spec_tpu_torch import export as EX

    pred = _predictor(cuda_device)
    _load(pred, 70)
    path = EX.export_predictor(pred, str(tmp_path / 'r50.specx'))
    loaded = EX.load_predictor(path, device=cuda_device)
    frames, boxes = _frames([3, 0, 5], seed=13)
    got = loaded.predict(frames, boxes, return_cameras=True)
    _hold(got, pred.predict(frames, boxes, return_cameras=True))
