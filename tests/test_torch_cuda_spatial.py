"""spatial_parallel's banded stage 1 (``parallel/spatial.py``) on a card,
against the plain stage 1: two bands of rows on ``cuda:0`` through the
device-list seam (``parallel.create_mesh``), each band replaying a CUDA
graph per segment with the halo copies between the replays.

Marked ``cuda``; skips without a GPU. It imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda_spatial.py -m cuda --noconftest

Small models (ResNet-18 in both stages, frames resized to 64 rows, two
bands of 32): the bands' angles within chip_smoke.py's fp32 card limit
of the plain stage's, each band's replayed row sums equal to its eager
segments' bit for bit, every segment captured on the card. An HRNet-W32
CamCalib trunk (96x128 frames, 91 exchanges) the same way in fp32, and
in bf16 with its logits within chip_smoke.py's two bf16 spacings.
"""

import numpy as np
import pytest
import torch

from spec_tpu_torch import parallel as par

ANGLE_LIMIT = 1e-4      # rad, chip_smoke.py's fp32 card-vs-CPU limit
LOGIT_ULPS = 2          # bf16 spacings, chip_smoke.py's SPATIAL_LOGIT_ULPS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    return torch.device('cuda', 0)


def _predictors(monkeypatch, tmp_path, dev):
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              batch_size=4, min_size=64, device='cuda')
    plain = SpecPredictor(**kw)
    monkeypatch.setattr(par, 'create_mesh',
                        lambda devices=None, device=None: [dev, dev])
    return plain, SpecPredictor(spatial_parallel=True, **kw)


@pytest.mark.cuda
def test_two_bands_on_one_card_match_plain(cuda_device, monkeypatch,
                                           tmp_path):
    plain, sp = _predictors(monkeypatch, tmp_path, cuda_device)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in range(2)]
    boxes = [np.array([[64, 48, 60, 80]], np.float32)] * 2
    frames_dev = [sp._upload(f) for f in frames]
    (_, batch), = sp._stage1_batches(frames_dev)
    stage = sp._stage1
    assert isinstance(stage, par.SpatialStage)
    with torch.inference_mode():
        want = plain._stage1(batch)
        stage(batch)                                   # capture
        got = stage(batch)                             # replay
        sums = stage.row_sums(batch)
        eager = stage.fn.row_sums(batch)
    assert stage.last['partials'] == 2 and stage.last['copies'] > 10
    for s, e in zip(sums, eager):
        assert s.device == cuda_device and torch.equal(s, e)
    for band in stage.segments:
        for seg in band:
            (sig,) = seg.signatures()
            assert all('cuda' in str(item[2]) for item in sig
                       if len(item) == 3)
    err = float((got[-1] - want[-1]).abs().max())
    assert err <= ANGLE_LIMIT, err
    r_sp = sp.predict(frames, boxes)
    r_plain = plain.predict(frames, boxes)
    for fs, fp in zip(r_sp, r_plain):
        for ps, pp in zip(fs, fp):
            for k in ('vfov', 'pitch', 'roll'):
                assert abs(ps['camera'][k] - pp['camera'][k]) <= ANGLE_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_two_hrnet_bands_on_one_card_match_plain(cuda_device, monkeypatch,
                                                 tmp_path, dtype):
    from chip_smoke import _calibrated_camcalib
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='hrnet_w32',
              camcalib_ckpt=_calibrated_camcalib('hrnet_w32',
                                                 tmp_path / 'cam.pt', 64,
                                                 n=8),
              batch_size=4, min_size=96, device='cuda',
              dtype={'fp32': torch.float32, 'bf16': torch.bfloat16}[dtype])
    plain = SpecPredictor(**kw)
    monkeypatch.setattr(par, 'create_mesh',
                        lambda devices=None, device=None: [cuda_device] * 2)
    sp = SpecPredictor(spatial_parallel=True, **kw)
    rng = np.random.RandomState(1)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)]
    (_, batch), = sp._stage1_batches([sp._upload(f) for f in frames])
    stage = sp._stage1
    with torch.inference_mode():
        want = plain._stage1(batch)
        stage(batch)                                   # capture
        got = stage(batch)                             # replay
        sums = stage.row_sums(batch)
        eager = stage.fn.row_sums(batch)
    assert len(stage.levels) == 91 and stage.last['partials'] == 2
    for s, e in zip(sums, eager):
        assert torch.equal(s, e)
    if dtype == 'fp32':
        err = float((got[-1] - want[-1]).abs().max())
        assert err <= ANGLE_LIMIT, err
    else:
        top = max(float(t.abs().max()) for t in want[:3])
        spacing = 2.0 ** (np.floor(np.log2(top)) - 7)
        err = max(float((g - w).abs().max())
                  for g, w in zip(got[:3], want[:3]))
        assert err <= LOGIT_ULPS * spacing, (err, spacing)
