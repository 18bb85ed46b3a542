"""spec_tpu_torch.export on the CPU: the port's predictor exported by
export_model (torch.export) into one .specx artifact and rebuilt from
the file alone, held to the port's live predict (bit for bit on the
CPU, where both run the same ATen kernels) and to the JAX package's
live predictor (tests/test_torch_serving.py's limits), over several
frame and batch shapes including a batch of one. Also: the artifact's
layout, the load building no model class, foreign formats refused,
serve --exported over HTTP, opcheck of K1's op and the class-level knob
defaults of a predictor built with ``__new__``.

The JAX export is not run here: tests/test_export.py holds the JAX
package's live predictor to its own artifact.
"""

import io
import json
import os
import threading
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from spec_tpu_torch import export as EX
from tests.test_torch_serving import (
    BOXES,
    _assert_cameras_close,
    _assert_people_close,
    _frames,
    write_predictor_data,
)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: under a parallel test run (several workers
    sharing the cores) every parallel region's barrier waits on
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    """The artifact ``export_model`` writes (--device cpu) from the
    serving test's checkpoints and SMPL files (ResNet-18, camera
    features from a cfg yaml, min_size 96, batch 8), and the port's and
    the JAX package's live predictors built from the same files ->
    (live port predictor, JAX predictor, artifact path)."""
    from spec_tpu.serving import SpecPredictor as JaxPredictor
    from spec_tpu_torch.cli import export_model
    from spec_tpu_torch.serving import SpecPredictor

    root = tmp_path_factory.mktemp('spec_data')
    kw = write_predictor_data(root)
    cfg = root / 'spec.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n  USE_CAM_FEATS: true\n')
    path = str(root / 'model.specx')
    mp = pytest.MonkeyPatch()
    mp.setenv('SPEC_DATA_ROOT', str(root))   # J_regressor_extra.npy
    try:
        export_model.main([
            '--output', path, '--spec_ckpt', kw['spec_ckpt'],
            '--camcalib_ckpt', kw['camcalib_ckpt'], '--cfg', str(cfg),
            '--smpl_model_dir', kw['smpl_model_dir'],
            '--camcalib_backbone', 'resnet18', '--min_size', '96',
            '--batch_size', '8', '--device', 'cpu'])
        live = SpecPredictor(device='cpu', **kw)
        jax_pred = JaxPredictor(use_fused_lbs=False, **kw)
    finally:
        mp.undo()
    return live, jax_pred, path


@pytest.fixture(scope='module')
def loaded(artifact):
    return EX.load_predictor(artifact[2], device='cpu')


def _assert_same(res_a, res_b):
    assert [len(r) for r in res_a] == [len(r) for r in res_b]
    for ra, rb in zip(res_a, res_b):
        for pa, pb in zip(ra, rb):
            assert set(pa) == set(pb)
            assert pa['camera'] == pb['camera']
            for k in pa:
                if k != 'camera':
                    np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_artifact_layout_and_meta(artifact):
    """One zip: meta.json and the two programs; each stage's weights
    stored once (the programs hold the parameters, BatchNorm statistics
    and SMPL buffers of the two stage modules and little else)."""
    live, _, path = artifact
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {'meta.json', 'cam.pt2', 'spec.pt2'}
        meta = json.loads(z.read('meta.json'))
        stored = sum(i.file_size for i in z.infolist())
    assert meta['format'] == EX.FORMAT == 'specx-torch/1'
    assert meta['platforms'] == ['cpu', 'cuda']
    assert meta['exported_on'] == 'cpu' and meta['dtype'] == 'float32'
    assert (meta['min_size'], meta['img_res'], meta['batch_size']) == (
        96, 224, 8)
    assert meta['loss_type'] == live.loss_type
    assert meta['torch_version'] == torch.__version__
    weights = sum(t.numel() * t.element_size()
                  for stage in (live._stage1.fn, live._stage2.fn)
                  for t in stage.state_dict().values())
    assert weights < stored < 1.05 * weights + 4 * 2 ** 20, (stored,
                                                              weights)


def test_loaded_matches_live_and_jax_without_model_code(artifact,
                                                        monkeypatch):
    """The load builds no HMR and no CameraRegressorNetwork (both are
    made to raise while it runs); the loaded predictor equals the live
    one bit for bit and the JAX predictor within the serving test's
    limits, cameras included."""
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.models.hmr import HMR

    live, jax_pred, path = artifact

    def _boom(*a, **k):
        raise AssertionError('load_predictor built a model class')

    monkeypatch.setattr(HMR, '__init__', _boom)
    monkeypatch.setattr(CameraRegressorNetwork, '__init__', _boom)
    pred = EX.load_predictor(path, device='cpu')
    monkeypatch.undo()
    assert pred.spec is None and pred.camcalib is None
    assert pred.batch_size == 8          # the meta's, when not overridden

    frames = _frames(11, 3)
    res, cams = pred.predict(frames, BOXES, return_cameras=True)
    assert [len(r) for r in res] == [0, 1, 3]
    _assert_same(res, live.predict(frames, BOXES))
    res_j, cams_j = jax_pred.predict(frames, BOXES, return_cameras=True)
    _assert_cameras_close(cams, cams_j)
    _assert_people_close(res, res_j)


def test_one_artifact_many_shapes_and_a_batch_of_one(artifact, loaded):
    """New frame buckets (wide, tall, square) and batch sizes use the
    same programs: one frame with one person alone (stage 1 and stage 2
    at b = 1), and the frames together at a batch ceiling of 2 (several
    padded batches), equal the live predictor's results."""
    live = artifact[0]
    rng = np.random.RandomState(2)
    frames = [(rng.rand(96, 200, 3) * 255).astype(np.uint8),
              (rng.rand(210, 96, 3) * 255).astype(np.uint8),
              (rng.rand(100, 100, 3) * 255).astype(np.uint8)]
    boxes = [np.array([[100.0, 48.0, 40.0, 70.0]], np.float32),
             np.array([[48.0, 100.0, 30.0, 60.0],
                       [40.0, 150.0, 30.0, 50.0]], np.float32),
             np.array([[50.0, 50.0, 40.0, 60.0]], np.float32)]
    _assert_same(loaded.predict(frames[:1], boxes[:1]),
                 live.predict(frames[:1], boxes[:1]))
    small = EX.load_predictor(artifact[2], batch_size=2, device='cpu')
    assert small.batch_size == 2
    want = live.predict(frames, boxes)
    got = small.predict(frames, boxes)
    assert [len(r) for r in got] == [1, 2, 1]
    # other padded batch sizes: the same up to the CPU's per-batch
    # kernel choices
    for rg, rw in zip(got, want):
        for pg, pw in zip(rg, rw):
            for k in pg:
                if k != 'camera':
                    np.testing.assert_allclose(pg[k], pw[k], rtol=1e-5,
                                               atol=1e-5, err_msg=k)


def test_loaded_stages_are_capturable(artifact, loaded):
    """The loaded programs (their input checks included) read no device
    value on the host and build no tensor from host data after a
    warm-up: on a card each replays as a CUDA graph."""
    from tests.test_torch_graphs import _uncapturable_ops

    frames = _frames(3, 2)
    with torch.inference_mode():
        frames_dev = [loaded._upload(f) for f in frames]
        (_, batch), = loaded._stage1_batches(frames_dev)
        assert _uncapturable_ops(loaded._stage1.fn, batch) == []
        cams = loaded.estimate_cameras(frames)
        (*_, inputs), = loaded._stage2_batches(frames_dev, BOXES[1:],
                                               cams)
        assert _uncapturable_ops(loaded._stage2.fn, *inputs) == []


def test_export_leaves_no_fake_constant(artifact):
    """Tracing builds device constants without caching them: the cache
    holds real tensors only, and a live predict still runs after an
    export."""
    from torch._subclasses.fake_tensor import FakeTensor

    from spec_tpu_torch.utils import graphs

    live = artifact[0]
    assert graphs._CONSTANTS
    assert not any(isinstance(t, FakeTensor)
                   for t in graphs._CONSTANTS.values())
    res = live.predict(_frames(5, 2), BOXES[1:])
    assert [len(r) for r in res] == [1, 3]


def test_streams_on_a_new_built_predictor(artifact, loaded):
    """A predictor made with __new__ (as load_predictor makes it) reads
    every knob of predict, estimate_cameras and the stream helpers from
    the class: no detector, camcalib_every 1, then a camcalib_every=3
    stream of its own; box-less calls raise as on a live predictor."""
    from spec_tpu_torch.serving import SpecPredictor

    live = artifact[0]
    bare = SpecPredictor.__new__(SpecPredictor)
    for name in ('device', 'img_res', 'batch_size', 'min_size',
                 'loss_type', '_stage1', '_stage2'):
        setattr(bare, name, getattr(live, name))
    assert bare.detector is None and bare.camcalib_every == 1
    frames = _frames(7, 3)
    _assert_same(bare.predict(frames, BOXES), live.predict(frames, BOXES))
    with pytest.raises(ValueError, match='detector'):
        loaded.predict(frames)
    loaded.camcalib_every, loaded.cut_threshold = 3, 0.0
    try:
        boxes = [BOXES[1]] * 4
        _, cams = loaded.predict(_frames(8, 4), boxes, stream='s',
                                 return_cameras=True)
        assert cams[1] == cams[0] == cams[2] and cams[3] != cams[0]
        assert loaded._cam_streams['s']['i'] == 4
        assert SpecPredictor._cam_streams is None   # not the class's
    finally:
        loaded.camcalib_every, loaded.cut_threshold = 1, 0.5
        loaded.reset_camera_stream(all_streams=True)


def test_foreign_formats_and_platforms_refused(artifact, tmp_path):
    """The JAX package's specx/1 and any other format raise ValueError
    naming it; a platform the port cannot serve raises at export; a
    device the artifact was not exported for raises at load."""
    live, _, path = artifact
    jax_style = tmp_path / 'jax.specx'
    with zipfile.ZipFile(jax_style, 'w') as z:
        z.writestr('meta.json', json.dumps({'format': 'specx/1'}))
    with pytest.raises(ValueError, match="'specx/1'"):
        EX.load_predictor(str(jax_style), device='cpu')
    with pytest.raises(ValueError, match='tpu'):
        EX.export_predictor(live, str(tmp_path / 'x.specx'),
                            platforms=('cpu', 'tpu'))
    assert not (tmp_path / 'x.specx').exists()
    cuda_only = tmp_path / 'cuda_only.specx'
    with zipfile.ZipFile(path) as src, \
            zipfile.ZipFile(cuda_only, 'w') as dst:
        meta = json.loads(src.read('meta.json'))
        dst.writestr('meta.json', json.dumps(dict(meta,
                                                  platforms=['cuda'])))
    with pytest.raises(ValueError, match="exported for \\['cuda'\\]"):
        EX.load_predictor(str(cuda_only), device='cpu')


def test_fused_lbs_op_opcheck(rng):
    """K1's custom op: schema, autograd registration (the closed-form
    backward), fake implementation and AOT dispatch, on the CPU."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.ops import lbs as L

    packed = L.pack_lbs_operands(S.create_test_assets(num_vertices=333))
    coeffs = torch.from_numpy(rng.randn(2, 218).astype('f4'))
    rel_tf = torch.from_numpy(rng.randn(2, 24, 3, 4).astype('f4'))
    result = torch.library.opcheck(
        torch.ops.spec_tpu_torch.fused_lbs.default,
        (packed.dirs, packed.weights_t, coeffs.requires_grad_(True),
         rel_tf.requires_grad_(True), packed.num_vertices))
    assert set(result.values()) == {'SUCCESS'}, result


def test_export_cli_then_serve_exported_over_http(artifact, monkeypatch):
    """serve --exported serves the artifact export_model wrote (the
    module's): one /predict over HTTP, the --camcalib_every and
    --batch_size flags applied to the loaded predictor. Without a card
    and without --device cpu both entry points exit non-zero."""
    from spec_tpu_torch.cli import export_model
    from spec_tpu_torch.cli import serve as TServe

    path = artifact[2]
    assert EX.read_meta(path)['platforms'] == ['cpu', 'cuda']
    args = TServe.parse_args(['--exported', path, '--device', 'cpu',
                              '--camcalib_every', '2', '--batch_size', '2'])
    pred = TServe.build_predictor(args, torch.device('cpu'))
    assert pred.camcalib is None and pred.camcalib_every == 2
    assert pred.batch_size == 2
    server = TServe.create_server(pred, host='127.0.0.1', port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        rng = np.random.RandomState(4)
        frame = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
        buf = io.BytesIO()
        np.savez(buf, frame_0=frame,
                 boxes_0=np.array([[64, 48, 60, 80]], np.float32))
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.server_address[1]}/predict',
            data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=300) as r:
            out = np.load(io.BytesIO(r.read()))
        assert int(out['n_frames']) == 1 and int(out['f0_n_persons']) == 1
        assert out['f0_p0_smpl_vertices'].shape == (6890, 3)
        assert np.isfinite(out['f0_p0_smpl_vertices']).all()
        assert np.isfinite(out['f0_camera']).all()
    finally:
        server.shutdown()
        server.server_close()

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main, argv in ((export_model.main, ['--output', path + '.2']),
                       (TServe.main, ['--exported', path])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code not in (0, None)
        assert 'device cpu' in str(e.value)
    assert not os.path.exists(path + '.2')
