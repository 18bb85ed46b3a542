"""The slice end to end: spec_tpu_torch.serving.SpecPredictor vs
spec_tpu.serving.SpecPredictor (plain jnp LBS) on the same lightning
checkpoints and SMPL files, on the CPU.

Checkpoints are written from the port's own randomly initialized modules
(the JAX predictor loads them through its torch converters), SMPL comes
through both packages' chumpy-pkl loaders, and frames have a short side
of 96 = min_size, so PIL's stage-1 resize is the identity. Tolerances are
those of tests/test_composition_parity.py.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from spec_tpu.core import constants as C
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR
from tests.test_smpl import write_synthetic_smpl_pkl

H, W = 96, 128
BOXES = [
    np.zeros((0, 4), np.float32),                       # empty frame
    np.array([[40.0, 55.0, 50.0, 50.0]], np.float32),   # 1 person
    np.array([[60.0, 50.0, 40.0, 70.0],                 # 3 persons, one
              [90.0, 40.0, 30.0, 55.0],                 # over the edge
              [120.0, 10.0, 45.0, 60.0]], np.float32),
]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_predictor_data(root):
    """The SMPL files, J_regressor_extra.npy and both checkpoints under
    ``root`` -> the predictors' keyword arguments (build them with
    SPEC_DATA_ROOT set to ``root``, where J_regressor_extra.npy lies)."""
    smpl_dir = root / 'body_models' / 'smpl'
    smpl_dir.mkdir(parents=True)
    write_synthetic_smpl_pkl(smpl_dir / 'SMPL_NEUTRAL.pkl',
                             num_vertices=C.NUM_SMPL_VERTICES)
    rng = np.random.RandomState(5)
    jre = rng.rand(9, C.NUM_SMPL_VERTICES).astype(np.float32)
    np.save(root / 'J_regressor_extra.npy', jre / jre.sum(1, keepdims=True))

    ckpts = {}
    for name, model, seed in (
            ('camcalib', CameraRegressorNetwork(backbone='resnet18'), 0),
            ('spec', HMR(backbone='resnet18', use_cam_feats=True), 1)):
        model.reset_parameters(torch.Generator().manual_seed(seed))
        ckpts[name] = str(root / f'{name}.ckpt')
        torch.save({'state_dict': {'model.' + k: v
                                   for k, v in model.state_dict().items()},
                    'epoch': 1}, ckpts[name])
    return dict(spec_ckpt=ckpts['spec'], camcalib_ckpt=ckpts['camcalib'],
                smpl_model_dir=str(smpl_dir), backbone='resnet18',
                use_cam_feats=True, camcalib_backbone='resnet18',
                min_size=96, batch_size=8)


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    from spec_tpu.serving import SpecPredictor as JaxPredictor
    from spec_tpu_torch.serving import SpecPredictor as TorchPredictor

    root = tmp_path_factory.mktemp('spec_data')
    kwargs = write_predictor_data(root)
    mp = pytest.MonkeyPatch()
    mp.setenv('SPEC_DATA_ROOT', str(root))   # J_regressor_extra.npy
    try:
        jax_pred = JaxPredictor(use_fused_lbs=False, **kwargs)
        port_pred = TorchPredictor(device='cpu', **kwargs)
    finally:
        mp.undo()
    return jax_pred, port_pred


def _frames(seed, n, bright=None):
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(n)]
    if bright is not None:   # a hard cut: a much brighter shot
        for i in bright:
            frames[i] = (frames[i] // 4 + 190).astype(np.uint8)
    return frames


def _assert_cameras_close(cams_port, cams_jax):
    assert len(cams_port) == len(cams_jax)
    for cp, cj in zip(cams_port, cams_jax):
        for k in ('vfov', 'pitch', 'roll'):
            assert abs(cp[k] - cj[k]) < 1e-4, (k, cp[k], cj[k])
        assert abs(cp['f_pix'] - cj['f_pix']) < 0.05


def _assert_people_close(res_port, res_jax):
    assert [len(r) for r in res_port] == [len(r) for r in res_jax]
    for fi, (rp, rj) in enumerate(zip(res_port, res_jax)):
        for pi, (pp, pj) in enumerate(zip(rp, rj)):
            loc = f'frame {fi} person {pi}'
            assert set(pp) >= set(pj) - {'camera'}
            for k in ('pred_shape', 'pred_cam', 'pred_pose', 'pred_pose_6d'):
                np.testing.assert_allclose(pp[k], np.asarray(pj[k]),
                                           atol=2e-3, err_msg=f'{loc} {k}')
            np.testing.assert_allclose(pp['pred_cam_t'],
                                       np.asarray(pj['pred_cam_t']),
                                       rtol=2e-3, atol=2e-3, err_msg=loc)
            for k in ('smpl_vertices', 'smpl_joints3d'):
                np.testing.assert_allclose(pp[k], np.asarray(pj[k]),
                                           atol=5e-3, err_msg=f'{loc} {k}')
            np.testing.assert_allclose(pp['smpl_joints2d'],
                                       np.asarray(pj['smpl_joints2d']),
                                       atol=0.1, err_msg=loc)
            assert pp['smpl_vertices'].shape == (C.NUM_SMPL_VERTICES, 3)
            assert pp['smpl_joints2d'].shape == (49, 2)


def test_predict_matches_jax_predictor(predictors):
    from spec_tpu_torch.ops import lbs as L

    jax_pred, port_pred = predictors
    frames = _frames(11, 3)
    res_j, cams_j = jax_pred.predict(frames, BOXES, return_cameras=True)
    launches = L.LAUNCHES
    res_p, cams_p = port_pred.predict(frames, BOXES, return_cameras=True)
    # SMPL went through the fused-LBS wrapper, on the CPU its plain version.
    assert port_pred.assets.packed_lbs is not None
    assert L.LAUNCHES == launches
    assert [len(r) for r in res_p] == [0, 1, 3]
    _assert_cameras_close(cams_p, cams_j)
    _assert_cameras_close(port_pred.estimate_cameras(frames), cams_j)
    _assert_people_close(res_p, res_j)
    for r in res_p:
        for person in r:
            assert all(np.isfinite(v).all() for k, v in person.items()
                       if k != 'camera')


def test_camcalib_every_stream_matches_jax(predictors):
    """camcalib_every=3 over two calls of a 6-frame stream with a hard
    cut at frame 4: same keyframes and cameras as the JAX predictor,
    and the stream state advances only through successful calls."""
    from spec_tpu import serving as JServing
    from spec_tpu_torch import serving as TServing

    jax_pred, port_pred = predictors
    frames = _frames(13, 6, bright=[4, 5])
    boxes = [np.array([[60.0, 50.0, 40.0, 70.0]], np.float32)] * 6

    keys = {}
    for name, mod in (('jax', JServing), ('port', TServing)):
        sel = mod.KeyframeSelector(3, 0.5)
        keys[name] = [sel.is_keyframe(mod.frame_signature(f))
                      for f in frames]
    assert keys['port'] == keys['jax'] == [True, False, False, True, True,
                                           False]

    for pred in predictors:
        pred.camcalib_every = 3
    try:
        out = {}
        for name, pred in (('jax', jax_pred), ('port', port_pred)):
            pred.reset_camera_stream('s', all_streams=True)
            with pytest.raises(Exception):   # a failing call commits nothing
                pred.predict(frames[:3], [np.zeros((1, 3))] * 3, stream='s')
            cams = []
            for lo in (0, 3):
                res, c = pred.predict(frames[lo:lo + 3], boxes[lo:lo + 3],
                                      stream='s', return_cameras=True)
                cams += c
            out[name] = (cams, res, dict(pred._cam_streams['s']))
        cams_p, res_p, st_p = out['port']
        cams_j, res_j, st_j = out['jax']
        _assert_cameras_close(cams_p, cams_j)
        # keyframe cameras are reused on the frames in between
        assert cams_p[1] == cams_p[0] and cams_p[2] == cams_p[0]
        assert cams_p[5] == cams_p[4] and cams_p[3] != cams_p[4]
        assert st_p['i'] == st_j['i'] == 6
        _assert_people_close(res_p, res_j)
    finally:
        for pred in predictors:
            pred.camcalib_every = 1


# id -> (shape, dtype, channels reversed, frame_signature kwargs)
SIGNATURE_CASES = {
    **{f'{h}x{w}-{np.dtype(d).name}': ((h, w, 3), d, False, {})
       for h, w in ((720, 1280), (1080, 1920), (481, 641), (7, 10))
       for d in (np.uint8, np.float32)},
    'gray-481x641': ((481, 641), np.uint8, False, {}),
    'rgba-100x200': ((100, 200, 4), np.uint8, False, {}),
    'bgr-view': ((481, 641, 3), np.uint8, True, {}),
    'bins20-side50': ((481, 641, 3), np.uint8, False,
                      dict(bins=20, max_side=50)),
}


@pytest.mark.parametrize('case', list(SIGNATURE_CASES))
def test_frame_signature_matches_jax(case):
    """The port's signature strides before its channel mean; the
    reference's takes the mean of the whole frame first. Every kind of
    frame gets the same bits from both."""
    from spec_tpu import serving as JServing
    from spec_tpu_torch import serving as TServing

    shape, dtype, reverse, kwargs = SIGNATURE_CASES[case]
    rng = np.random.default_rng(list(SIGNATURE_CASES).index(case))
    f = rng.uniform(0.0, 256.0, shape).astype(dtype)
    if reverse:
        f = f[..., ::-1]
    port = TServing.frame_signature(f, **kwargs)
    assert np.array_equal(port, JServing.frame_signature(f, **kwargs))
    assert port.dtype == np.float32


def test_frame_signature_reads_no_full_frame():
    """Signing a 1080p frame allocates about the strided pixels alone
    (~0.13 MB), not the full frame's float64 channel mean (~16.7 MB)."""
    import tracemalloc

    from spec_tpu_torch.serving import frame_signature

    f = np.random.default_rng(0).integers(0, 256, (1080, 1920, 3), np.uint8)
    tracemalloc.start()
    try:
        frame_signature(f)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1_000_000, peak


@pytest.mark.parametrize('kwargs', [
    dict(spatial_parallel=True, batch_size=3),
    dict(spatial_parallel=True),
    dict(detector='yolo', spatial_parallel=True)])
def test_spatial_parallel_builds(kwargs):
    """spatial_parallel on the CPU's one device: one band is the whole
    frame, so stage 1 runs the plain stage; the layout's pads (stage 1
    never pads for the mesh, stage 2 to the device count, 1 here) and an
    unsplit detector."""
    from spec_tpu_torch import parallel as par
    from spec_tpu_torch.serving import SpecPredictor

    pred = SpecPredictor(device='cpu', backbone='resnet18',
                         camcalib_backbone='resnet18', **kwargs)
    assert pred.mesh == [torch.device('cpu')]
    assert (pred._min_pad_s1, pred._min_pad) == (1, 1)
    assert pred._padded(2, pred._min_pad_s1) == 2
    assert isinstance(pred._stage1, par.SpatialStage)
    assert pred._stage1.whole.fn.camcalib is pred.camcalib
    if 'detector' in kwargs:
        assert (pred.detector._min_pad, pred.detector.batch_size) == (1, 8)
        assert not isinstance(pred.detector._fwd, par.ReplicatedStage)


@pytest.mark.parametrize('kwargs,err', [
    (dict(cfg_file='no_such_config.yaml'), FileNotFoundError),
    (dict(detector='ssd'), ValueError),
    (dict(use_fused_lbs=False), ValueError),
    (dict(uint8_crops=True), ValueError),
])
def test_unported_options_raise(kwargs, err):
    from spec_tpu_torch.serving import SpecPredictor

    with pytest.raises(err):
        SpecPredictor(device='cpu', **kwargs)


def test_import_hygiene():
    """The port's serving path, the e2e pipeline, the bench, the CLIs and
    their host helpers, the detector and HRNet, the eval path (metrics,
    eval loop, evaluator, the eval dataset and loader), the training path
    (the trainers, SMPLify, the pano datasets), the stage graphs, every
    kernel wrapper, the host-native bindings, the renderer, profiling and
    the region cache, the artifact export and loader, export_model,
    prepare_data, the offline data generators (datagen/) and the
    data-parallel and spatial layouts (parallel/) import no JAX, flax,
    PIL, cv2,
    PyYAML, joblib, matplotlib, tensorboard
    or triton (none of them exist on the machine with the card), no
    requests (the Flickr downloader imports it when it runs) and
    nothing of the JAX package spec_tpu, and importing them builds no
    kernel or host library, captures no graph and touches no CUDA
    device."""
    code = (
        'import sys\n'
        'import torch\n'
        'import spec_tpu_torch.serving\n'
        'import spec_tpu_torch.pipeline\n'
        'import spec_tpu_torch.bench\n'
        'import spec_tpu_torch.models.backbones.fused_resnet\n'
        'from spec_tpu_torch.models import backbones, detector\n'
        'from spec_tpu_torch.models.backbones import hrnet\n'
        'from spec_tpu_torch.data import detection\n'
        'from spec_tpu_torch.cli import camcalib_demo, serve, spec_demo\n'
        'from spec_tpu_torch.cli import annotate_camcalib, compute_error, '
        'spec_eval\n'
        'from spec_tpu_torch.data import cache, cam_dataset, image_folder, '
        'loader, tracking, transforms\n'
        'from spec_tpu_torch.data import pano_agora_dataset, pano_dataset\n'
        'from spec_tpu_torch.cli import camcalib_train, spec_train\n'
        'from spec_tpu_torch.train import smplify, trainer\n'
        'from spec_tpu_torch.eval import eval_loop, evaluator, metrics\n'
        'from spec_tpu_torch.core import kp_utils\n'
        'from spec_tpu_torch.utils import cam_params, config, smoothing, '
        'vis\n'
        'from spec_tpu_torch.ops import bottleneck, cuda_build, lbs, '
        'projection\n'
        'from spec_tpu_torch.utils import graphs\n'
        'import spec_tpu_torch.utils\n'
        'from spec_tpu_torch import native\n'
        'from spec_tpu_torch.utils import profiling, renderer\n'
        'from spec_tpu_torch.data import region_cache\n'
        'from spec_tpu_torch import export\n'
        'from spec_tpu_torch.cli import export_model, prepare_data\n'
        'import spec_tpu_torch.datagen\n'
        'from spec_tpu_torch.datagen import flickr, synthetic\n'
        'from spec_tpu_torch import parallel\n'
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'PIL', 'cv2', 'yaml', 'joblib', "
        "'matplotlib', 'triton', 'tensorboard', 'requests') "
        "or m == 'spec_tpu' or m.startswith('spec_tpu.')]\n"
        'assert not bad, bad\n'
        'assert cuda_build.build_library.cache_info().currsize == 0\n'
        'assert cuda_build.load_library.cache_info().currsize == 0\n'
        'assert cuda_build.build_host_library.cache_info().currsize == 0\n'
        'for fn in (native._raster, native._jpeg, native.jpeg_engine):\n'
        '    assert fn.cache_info().currsize == 0, fn\n'
        'for mod in (bottleneck, lbs, projection):\n'
        '    assert mod._kernel.cache_info().currsize == 0, mod\n'
        '    assert mod.LAUNCHES == 0, mod\n'
        'assert graphs._CONSTANTS == {}\n'
        'assert not torch.cuda.is_initialized()\n')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
