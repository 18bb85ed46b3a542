"""The YOLOv3 detector and HMR-HRNet on a card: their CUDA graphs held
to the eager bodies, and K1 on both paths.

Marked ``cuda``; skips without a GPU (a CUDA graph has no CPU mode). It
imports no JAX:

    python -m pytest tests/test_torch_cuda_detector.py -m cuda \\
        --noconftest

Small sizes (YOLOv3 at 64², ResNet-18 or HRNet-W32 at 64² crops): what
is checked is the capture and the replay, each held to its eager body
bit for bit, the detector in fp32 against the CPU, and K1's launches
when ``predict(frames)`` runs the detector's boxes through stage 2.
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch.models.detector import YoloDetector, YoloV3
from spec_tpu_torch.ops import lbs as L
from spec_tpu_torch.serving import SpecPredictor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _frames():
    rng = np.random.RandomState(4)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8)
            for hw in ((48, 64), (48, 64), (64, 96))]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_detector_replays_match_eager(cuda_device, dtype):
    det = YoloDetector(img_size=64, batch_size=4, dtype=dtype,
                       device=cuda_device)
    rng = np.random.RandomState(0)
    with torch.inference_mode():
        for B in (4, 2, 1):
            x = torch.from_numpy(rng.rand(B, 64, 64, 3).astype('f4')).to(
                cuda_device)
            want = det._fwd.fn(x)
            det._fwd(x)                                   # capture
            assert torch.equal(det._fwd(x), want), B
    assert sorted(k[0][0][0] for k in det._fwd.signatures()) == [1, 2, 4]


@pytest.mark.cuda
def test_detector_fp32_matches_the_cpu(cuda_device):
    model = YoloV3(torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model.eval()(x)
        got = model.to(cuda_device)(x.to(cuda_device)).cpu()
    assert (got - want).abs().max() <= 1e-3 * max(1.0, want.abs().max())


@pytest.mark.cuda
def test_predict_without_boxes_launches_k1(cuda_device):
    pred = SpecPredictor(backbone='resnet18', camcalib_backbone='resnet18',
                         min_size=64, img_res=64, batch_size=4,
                         detector='yolo', yolo_img_size=64,
                         device=cuda_device)
    pred.detector.conf_thresh = 0.2
    frames = _frames()
    boxes = pred.detector.detect(frames)
    assert all(len(b) for b in boxes)
    pred.predict(frames)                                  # captures
    L.LAUNCHES = 0
    got = pred.predict(frames)
    assert L.LAUNCHES >= 1
    assert [len(r) for r in got] == [len(b) for b in boxes]
    want = pred.predict(frames, boxes=boxes)
    for rg, rw in zip(got, want):
        for pg, pw in zip(rg, rw):
            np.testing.assert_array_equal(pg['smpl_vertices'],
                                          pw['smpl_vertices'])


@pytest.mark.cuda
def test_hmr_hrnet_stage2_replay_matches_eager(cuda_device):
    from spec_tpu_torch.serving import _spec_forward
    from spec_tpu_torch.utils.graphs import StageGraph

    pred = SpecPredictor(backbone='hrnet_w32-conv',
                         camcalib_backbone='resnet18', min_size=64,
                         img_res=64, batch_size=4, dtype=torch.bfloat16,
                         device=cuda_device)
    frames = _frames()
    boxes = [np.array([[32.0, 24.0, 30.0, 40.0]], np.float32)] * 3
    with torch.inference_mode():
        frames_dev = [pred._upload(f) for f in frames]
        cams = pred.estimate_cameras(frames)
        (x,) = [a for *_, a in pred._stage2_batches(frames_dev, boxes, cams)]
        stage = StageGraph('hrnet stage2', lambda *a: _spec_forward(
            pred.spec, pred.assets, *a))
        want = stage.fn(*x)
        stage(*x)                                         # capture
        L.LAUNCHES = 0
        got = stage(*x)
        assert L.LAUNCHES == 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
