"""spec_tpu_torch's spatial_parallel layout (``parallel/spatial.py``): stage
1 split into bands of image rows, one per device, with halo rows
exchanged before every layer whose window spans rows, on the CPU.

* The reference's inputs (``tests/test_parallel_infer.py::
  test_camcalib_spatial_partition_matches_replicated``): a ResNet-18
  CamCalib, one 96x128 frame, 8 devices. The port's banded forward
  equals JAX's height-sharded forward on JAX's 8 CPU devices (the same
  weights through ``state_dict_from_flax``) and the port's plain forward
  within 1e-5. The counterparts of the reference's compiled-program
  asserts (more than 10 collective-permutes, an all-reduce): more than
  10 halo copies per call, the pooled sums of more than one band added,
  and no band's tile taller than its own rows and its halo.
* Heights and band counts that test the partition: 256 (one layer4 row a
  band), 200 and 90 (ragged, some bands empty) on 8 bands, 2 and 3
  bands; ResNet-50's bottlenecks and ResNet-34's basic blocks.
* ``SpecPredictor(spatial_parallel=True)`` against the plain predictor
  on the reference test's inputs (``test_serving_spatial_parallel_
  matches_plain``), its pads, and the layouts' ``ValueError``s.

The device-list seam ``parallel.create_mesh`` stands for 8 CPU devices,
as in tests/test_torch_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

TOL = 1e-5
N_DEV = 8
CPU8 = [torch.device('cpu')] * N_DEV


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: whole models under a parallel test run (see
    tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eight_devices(monkeypatch):
    """The seam: ``create_mesh`` gives 8 CPU devices."""
    monkeypatch.setattr(par, 'create_mesh',
                        lambda devices=None, device=None: list(CPU8))


def _banded(model, n):
    """``model``'s forward split into ``n`` bands on the CPU."""
    mesh = CPU8[:1] * n
    return par.SpatialStage(
        par.replicate(model.backbone, mesh),
        lambda *sums, count: model.forward_pooled(sums, count), mesh)


def _checked(stage):
    """``stage`` with every segment body checking that its tile and its
    carried tensors are channels_last, as are the feature maps it
    returns."""
    def wrap(fn):
        def body(*tensors, **fixed):
            out = fn(*tensors, **fixed)
            for t in tensors + tuple(out):
                if t.dim() == 4:
                    assert t.is_contiguous(memory_format=torch.channels_last)
            return out
        return body

    for band in stage.segments:
        for seg in band:
            seg.fn = wrap(seg.fn)
    return stage


def _hold_partition(stage, n_bands):
    """The halo's bounds at every exchange, for each tensor the exchange's
    windows read: each band takes the windows' rows above (the largest
    ``p``) and below (the largest ``k - p - s``) from the bands that own
    them, pads only rows past the frame's top and bottom (the last band
    of an odd height one row more), and holds no more rows than its own
    plus that halo."""
    last = stage.last
    assert last['partials'] == n_bands
    for level in last['exchanges']:
        assert level
        for src in level:
            wins = src['windows']
            H = src['height']
            p = max(pw for _, _, pw in wins)
            halo_below = max(max(k - pw - s for k, s, pw in wins), 0)
            slack = max(s for _, s, _ in wins) - 1
            bands = src['bands']
            assert [b['band'] for b in bands] == list(range(n_bands))
            for b in bands:
                lo, hi = b['rows']
                assert b['above'] + b['top'] == p
                assert b['top'] == max(p - lo, 0)
                if b['band'] < n_bands - 1:
                    assert b['below'] + b['bottom'] == halo_below
                    assert b['bottom'] == max(hi + halo_below - H, 0)
                else:
                    assert hi == H and b['below'] == 0
                    assert b['bottom'] <= halo_below + slack
                assert b['tile'] <= hi - lo + p + halo_below + slack


def test_banded_forward_matches_jax_spatial_sharding():
    """The reference's spatial-partition test, ported."""
    import spec_tpu.parallel as jpar
    from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib

    H, W = 96, 128
    rng = np.random.RandomState(42)
    x = rng.randn(1, H, W, 3).astype('f4')
    m = JaxCamCalib(backbone='resnet18')
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    mesh = jpar.create_mesh()
    rep = jpar.replicated(mesh)
    sp = jpar.spatial_sharding(mesh)
    f = jax.jit(lambda v, x: m.apply(v, x), in_shardings=(rep, sp),
                out_shardings=(rep, rep, rep))
    want = f(jax.device_put(v, rep), jax.device_put(jnp.asarray(x), sp))

    model = CameraRegressorNetwork(backbone='resnet18')
    model.load_state_dict(state_dict_from_flax(v, 'camcalib', 'resnet18'))
    model.eval()
    stage = _checked(_banded(model, N_DEV))
    with torch.no_grad():
        got = stage(torch.from_numpy(x))
        plain = model(torch.from_numpy(x))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=TOL, atol=TOL)
    # 96 rows give 3 rows at layer4: three bands of 32 input rows, five
    # empty ones (GSPMD's ragged split)
    assert stage.last['copies'] > 10
    assert stage.last['partials'] == 3
    _hold_partition(stage, 3)
    assert len(stage.last['exchanges']) == 18     # stem, pool, 16 3x3s


@pytest.mark.parametrize('arch,H,n', [
    ('resnet18', 256, 8), ('resnet18', 200, 8), ('resnet18', 90, 8),
    ('resnet18', 96, 2), ('resnet18', 200, 3), ('resnet50', 75, 3),
    ('resnet34', 33, 2)])
def test_banded_forward_matches_plain(arch, H, n):
    """Band counts and heights: one layer4 row a band (256 on 8), ragged
    heights with empty bands (200, 90), an odd height at every stride
    (75, 33), 2 and 3 bands; basic blocks and bottlenecks."""
    model = CameraRegressorNetwork(backbone=arch)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    x = torch.from_numpy(
        np.random.RandomState(H).randn(2, H, 64, 3).astype('f4'))
    stage = _checked(_banded(model, n))
    with torch.no_grad():
        got = stage(x)
        want = model(x)
    for g, w in zip(got, want):
        # float association; a random ResNet-50's logits reach the tens
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale)
    units = -(-H // 32)                   # layer4's rows
    chunk = -(-units // n)
    bands = -(-units // chunk)            # the bands that own rows
    _hold_partition(stage, bands)
    assert stage.last['count'] == units * 2        # layer4's H x W (64/32)
    assert stage.last['copies'] > 10


def test_band_rows_partition():
    assert par.band_rows(96, 8, 32) == [(0, 32), (32, 64), (64, 96)] + [
        (96, 96)] * 5
    assert par.band_rows(256, 8, 32) == [(32 * i, 32 * i + 32)
                                         for i in range(8)]
    assert par.band_rows(200, 3, 32) == [(0, 96), (96, 192), (192, 200)]
    assert par.band_rows(75, 2, 16) == [(0, 48), (48, 75)]
    sh = par.spatial_sharding(CPU8)
    assert (sh.devices, sh.dim, sh.ndim) == (CPU8, 1, 4)


def test_spatial_stage_refuses_train_mode_and_hrnet():
    """A trunk in train mode, a trunk that is neither a ResNet nor an
    HRNet, and an HRNet frame whose sides are not multiples of 32."""
    model = CameraRegressorNetwork(backbone='resnet18')
    stage = _banded(model.eval(), 2)
    model.backbone.train()
    with pytest.raises(ValueError, match='inference only'):
        stage(torch.zeros(1, 64, 64, 3))
    trunk = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1))
    with pytest.raises(TypeError, match='ResNet or an HRNet'):
        par.SpatialStage([trunk] * 2, None, CPU8[:2])
    hrnet = _banded(CameraRegressorNetwork(backbone='hrnet_w32').eval(), 2)
    with pytest.raises(ValueError, match='multiples of 32'):
        hrnet(torch.zeros(1, 64, 80, 3))


def _frames_boxes(seed=0):
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(96, 128, 3) * 255).astype(np.uint8)
              for _ in range(2)]
    boxes = [np.array([[64, 48, 60, 80], [40, 40, 30, 50]], np.float32),
             np.array([[48, 60, 40, 70]], np.float32)]
    return frames, boxes


def test_spatial_predictor_matches_plain(eight_devices, tmp_path,
                                         monkeypatch):
    """``tests/test_parallel_infer.py::test_serving_spatial_parallel_
    matches_plain``, ported: stage-1 frames split over their height
    (batch 1 stays batch 1), stage 2 over the person batch; cameras
    within rtol 1e-4 and atol 1e-5, the rest within 1e-5."""
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='resnet18',
              batch_size=8, min_size=64, device='cpu')
    plain = SpecPredictor(**kw)
    sp = SpecPredictor(spatial_parallel=True, **kw)
    assert sp._min_pad_s1 == 1 and sp._padded(2, sp._min_pad_s1) == 2
    assert sp._min_pad == 8 and sp._padded(3) == 8
    assert isinstance(sp._stage1, par.SpatialStage)
    assert isinstance(sp._stage2, par.ReplicatedStage)
    assert len(sp._stage1.segments) == len(sp._stage2.stages) == N_DEV

    frames, boxes = _frames_boxes()
    r_plain = plain.predict(frames, boxes)
    r_sp = sp.predict(frames, boxes)
    # 64 resized rows: two bands of 32
    assert sp._stage1.last['partials'] == 2
    assert sp._stage1.last['copies'] > 10
    assert [len(r) for r in r_sp] == [len(r) for r in r_plain] == [2, 1]
    for fp, fs in zip(r_plain, r_sp):
        for pp, ps in zip(fp, fs):
            for ck in ('vfov', 'f_pix', 'pitch', 'roll'):
                np.testing.assert_allclose(ps['camera'][ck],
                                           pp['camera'][ck],
                                           rtol=1e-4, atol=1e-5)
            for key in ('smpl_vertices', 'smpl_joints2d', 'pred_cam_t',
                        'pred_pose', 'pred_shape'):
                np.testing.assert_allclose(ps[key], pp[key], rtol=TOL,
                                           atol=TOL)
    cams = sp.estimate_cameras(frames)
    for c, r in zip(cams, r_plain):
        for ck in ('vfov', 'f_pix', 'pitch', 'roll'):
            np.testing.assert_allclose(c[ck], r[0]['camera'][ck], rtol=1e-4,
                                       atol=1e-5)


def test_spatial_and_data_parallel_exclusive(eight_devices):
    """``tests/test_parallel_infer.py:207-215``, ported (with the
    indivisible batch under each layout)."""
    from spec_tpu_torch.serving import SpecPredictor

    with pytest.raises(ValueError, match='mutually exclusive'):
        SpecPredictor(backbone='resnet18', camcalib_backbone='resnet18',
                      batch_size=N_DEV, min_size=64, device='cpu',
                      data_parallel=True, spatial_parallel=True)
    for layout in ('data_parallel', 'spatial_parallel'):
        with pytest.raises(ValueError, match='multiple'):
            SpecPredictor(backbone='resnet18', camcalib_backbone='resnet18',
                          batch_size=N_DEV + 1, min_size=64, device='cpu',
                          **{layout: True})


def test_band_segments_are_capturable(eight_devices, tmp_path, monkeypatch):
    """Every band segment and the heads, the bodies a card captures,
    build no tensor from host data, read nothing back and take no
    data-dependent shape (tests/test_torch_graphs.py's check), in fp32
    and bf16; the exchange between them runs outside the graphs."""
    from spec_tpu_torch.serving import SpecPredictor
    from tests.test_torch_graphs import _uncapturable_ops

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    frames, _ = _frames_boxes()
    for dtype in (torch.float32, torch.bfloat16):
        pred = SpecPredictor(backbone='resnet18', camcalib_backbone='resnet18',
                             batch_size=8, min_size=64, device='cpu',
                             dtype=dtype, spatial_parallel=True)
        frames_dev = [pred._upload(f) for f in frames]
        (_, batch), = pred._stage1_batches(frames_dev)
        assert _uncapturable_ops(pred._stage1.fn, batch) == []


# -- HRNet trunks (item 12d) -------------------------------------------------

HRNET_EXCHANGES = {'hrnet_w32': 91, 'hrnet_w32-conv': 94}


def _scale_tol(want):
    """1e-5 of the largest logit (at least 1): float association over a
    random HRNet's logits, which reach the hundreds (JAX's init) or far
    more (the port's unit BatchNorm statistics)."""
    return TOL * max(1.0, max(float(w.abs().max()) for w in want))


def test_banded_hrnet_matches_jax_spatial_sharding():
    """The reference's height-sharded HRNet-W32 CamCalib (``-interp``) on
    JAX's 8 CPU devices, 96x128: the port's 8 bands equal it and the
    port's plain forward within 1e-5 of the largest logit."""
    import spec_tpu.parallel as jpar
    from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib

    H, W = 96, 128
    x = np.random.RandomState(42).randn(1, H, W, 3).astype('f4')
    m = JaxCamCalib(backbone='hrnet_w32')
    # flax's init does not depend on the input size: a small one (run
    # op by op, which is faster here than compiling it)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    mesh = jpar.create_mesh()
    rep = jpar.replicated(mesh)
    sp = jpar.spatial_sharding(mesh)
    f = jax.jit(lambda v, x: m.apply(v, x), in_shardings=(rep, sp),
                out_shardings=(rep, rep, rep))
    want = [torch.from_numpy(np.array(w)) for w in
            f(jax.device_put(v, rep), jax.device_put(jnp.asarray(x), sp))]

    model = CameraRegressorNetwork(backbone='hrnet_w32')
    model.load_state_dict(state_dict_from_flax(v, 'camcalib', 'hrnet_w32'))
    model.eval()
    stage = _checked(_banded(model, N_DEV))
    with torch.no_grad():
        got = stage(torch.from_numpy(x))
        plain = model(torch.from_numpy(x))
    tol = _scale_tol(want)
    for g, p, w in zip(got, plain, want):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
        torch.testing.assert_close(g, p, rtol=0, atol=tol)
    # three bands of 32 input rows, five empty
    assert stage.last['partials'] == 3
    assert len(stage.last['exchanges']) == HRNET_EXCHANGES['hrnet_w32']
    _hold_partition(stage, 3)


@pytest.mark.parametrize('arch,H,W,n', [
    ('hrnet_w32', 64, 64, 2), ('hrnet_w32', 96, 64, 8),
    ('hrnet_w32', 160, 32, 3), ('hrnet_w32-conv', 128, 64, 3),
    ('hrnet_w32-conv', 96, 96, 2), ('hrnet_w32-conv', 64, 32, 8)])
def test_banded_hrnet_matches_plain(arch, H, W, n):
    """Both heads at heights and band counts that test the partition: one
    row of stride 32 a band (64 on 2), empty bands (96 and 64 on 8, 128
    on 3), a ragged chunk (160 on 3, 96 on 2)."""
    model = CameraRegressorNetwork(backbone=arch)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model.eval()
    x = torch.from_numpy(
        np.random.RandomState(H + W).randn(2, H, W, 3).astype('f4'))
    stage = _checked(_banded(model, n))
    with torch.no_grad():
        got = stage(x)
        want = model(x)
    tol = _scale_tol(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    units = H // 32
    chunk = -(-units // n)
    _hold_partition(stage, -(-units // chunk))
    assert len(stage.levels) == HRNET_EXCHANGES[arch]
    assert stage.last['count'] == units * (W // 32)
    # the exchange moves rows of each of the four branches
    assert max(len(level) for level in stage.last['exchanges']) == 4


def test_hrnet_interp_head_is_band_local():
    """The ``-interp`` head resizes each branch to stride 32 by an exact
    factor f (bilinear, align_corners=False, no antialias): output row o
    reads source rows f*o + f/2 - 1 and f*o + f/2, half each, so rows
    cut at multiples of f resize band by band to the rows of the whole,
    bit for bit."""
    import torch.nn.functional as F

    rng = np.random.RandomState(0)
    for f in (2, 4, 8):
        x = torch.from_numpy(rng.randn(2, 5, 6 * f, 7).astype('f4'))
        whole = F.interpolate(x, size=(6, 7), mode='bilinear',
                              align_corners=False)
        rows = x[:, :, f // 2 - 1::f] * 0.5 + x[:, :, f // 2::f] * 0.5
        torch.testing.assert_close(whole, rows, rtol=1e-6, atol=1e-6)
        for cuts in ((0, 1, 6), (0, 3, 4, 6), (0, 2, 6)):
            bands = [F.interpolate(x[:, :, a * f:b * f], size=(b - a, 7),
                                   mode='bilinear', align_corners=False)
                     for a, b in zip(cuts, cuts[1:])]
            assert torch.equal(torch.cat(bands, 2), whole)


@pytest.mark.parametrize('arch', ['hrnet_w32', 'hrnet_w32-conv'])
def test_hrnet_plain_and_banded_refuse_unaligned_frames(arch):
    """A 72-row frame gives 18, 9 and 5 rows at strides 4, 8 and 16: the
    plain HRNet's exchange cannot add branch 2 upsampled (10 rows) to
    branch 1 (9 rows), and the bands refuse the frame up front."""
    model = CameraRegressorNetwork(backbone=arch).eval()
    x = torch.zeros(1, 72, 64, 3)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match='size of tensor'):
            model(x)
        with pytest.raises(ValueError, match='multiples of 32'):
            _banded(model, 2)(x)


def _calibrated_camcalib(path, arch):
    """A random ``arch`` CamCalib whose BatchNorm statistics are those of
    one batch of 8 random 64x64 crops
    (``chip_smoke._calibrated_camcalib``),
    saved to ``path``: each layer stays near unit scale, so the logits
    stay moderate."""
    from chip_smoke import _calibrated_camcalib as calibrated

    return calibrated(arch, path, 64, n=8)


def test_spatial_hrnet_predictor_matches_plain(eight_devices, tmp_path,
                                               monkeypatch):
    """``SpecPredictor(camcalib_backbone='hrnet_w32', spatial_parallel=
    True)`` against the plain predictor on 96x128 frames (min_size 96:
    three bands of 32 rows on the 8-device seam), at the ResNet test's
    limits."""
    from spec_tpu_torch.serving import SpecPredictor

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    kw = dict(backbone='resnet18', camcalib_backbone='hrnet_w32',
              camcalib_ckpt=_calibrated_camcalib(tmp_path / 'cam.pt',
                                                 'hrnet_w32'),
              batch_size=8, min_size=96, device='cpu')
    plain = SpecPredictor(**kw)
    sp = SpecPredictor(spatial_parallel=True, **kw)
    assert isinstance(sp._stage1, par.SpatialStage)
    frames, boxes = _frames_boxes()
    r_plain = plain.predict(frames, boxes)
    r_sp = sp.predict(frames, boxes)
    assert sp._stage1.last['partials'] == 3
    assert len(sp._stage1.last['exchanges']) == 91
    for fp, fs in zip(r_plain, r_sp):
        for pp, ps in zip(fp, fs):
            for ck in ('vfov', 'f_pix', 'pitch', 'roll'):
                np.testing.assert_allclose(ps['camera'][ck],
                                           pp['camera'][ck],
                                           rtol=1e-4, atol=1e-5)
            for key in ('smpl_vertices', 'smpl_joints2d', 'pred_cam_t'):
                np.testing.assert_allclose(ps[key], pp[key], rtol=1e-4,
                                           atol=1e-5)


@pytest.mark.parametrize('arch', ['hrnet_w32', 'hrnet_w32-conv'])
def test_hrnet_band_segments_are_capturable(eight_devices, tmp_path,
                                            monkeypatch, arch):
    """Every HRNet band segment and the heads build no tensor from host
    data, read nothing back and take no data-dependent shape
    (tests/test_torch_graphs.py's check), in fp32 and bf16."""
    from spec_tpu_torch.serving import SpecPredictor
    from tests.test_torch_graphs import _uncapturable_ops

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    frames, _ = _frames_boxes()
    for dtype in (torch.float32, torch.bfloat16):
        pred = SpecPredictor(backbone='resnet18', camcalib_backbone=arch,
                             batch_size=8, min_size=64, device='cpu',
                             dtype=dtype, spatial_parallel=True)
        frames_dev = [pred._upload(f[:64, :64]) for f in frames]
        (_, batch), = pred._stage1_batches(frames_dev)
        assert tuple(batch.shape[1:3]) == (64, 64)      # two bands
        assert _uncapturable_ops(pred._stage1.fn, batch) == []
