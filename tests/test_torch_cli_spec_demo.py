"""spec_tpu_torch.cli.spec_demo against spec_tpu.cli.spec_demo, on the CPU.

The reference crops on the host (``data/transforms.crop``); the port cuts
crops on the device (``serving.crop_boxes``). The two halves are held to
the reference apart, never end to end at a tolerance that could hide a
model fault:

* the port's crops against the reference's ``T.crop`` path, within
  tests/test_native.py's budget (max 2e-3, mean 1e-3 on [0, 1] values);
* the port's stage 2 (and the folder demo's results) on those crops
  against the JAX package's HMR with the same weights (PRNGKey(0) init,
  carried over by ``state_dict_from_flax``), at tests/test_torch_models.py's
  1e-4.

The keyframe, carry-forward and OBJ helpers are held to the reference's
exactly; the video and webcam modes run on cv2-written clips as
tests/test_cli.py:347-645 runs the reference's.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from spec_tpu_torch.cli import spec_demo as TDemo

RES = 224


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def bridged(tmp_path_factory):
    """The JAX HMR (ResNet-18, PRNGKey(0)) and its variables; the same
    weights as a torch checkpoint; a config yaml naming ResNet-18."""
    from spec_tpu.core import smpl as JS
    from spec_tpu.models import HMR as JaxHMR
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    jassets = JS.create_test_assets()
    model = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=False,
                   img_res=RES)
    eye = jnp.eye(3)[None]
    one = jnp.ones((1,))
    variables = model.init(jax.random.PRNGKey(0), jassets,
                           jnp.zeros((1, RES, RES, 3)), eye, eye, one,
                           jnp.ones((1, 2)), one, one)
    root = tmp_path_factory.mktemp('spec_ckpt')
    ckpt = str(root / 'spec_r18.pt')
    torch.save(dict(state_dict_from_flax(variables, 'hmr', 'resnet18')),
               ckpt)
    cfg = root / 'spec_r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n  USE_CAM_FEATS: false\n')

    apply = jax.jit(lambda v, *a: model.apply(v, jassets, *a))
    return dict(ckpt=ckpt, cfg=str(cfg), variables=variables, apply=apply)


def _reference_hmr(bridged, crops, chunk):
    """The JAX HMR on the given crops and work items (frame key, center,
    scale, cam_rotmat, K, w, h)."""
    cols = [np.stack([c[3] for c in chunk]), np.stack([c[4] for c in chunk]),
            np.array([c[2] for c in chunk], 'f4'),
            np.stack([c[1] for c in chunk]).astype('f4'),
            np.array([c[5] for c in chunk], 'f4'),
            np.array([c[6] for c in chunk], 'f4')]
    out = bridged['apply'](bridged['variables'], jnp.asarray(crops),
                           *(jnp.asarray(c) for c in cols))
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_outputs_close(got, want, n):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k])[:n], want[k][:n],
                                   atol=1e-4, err_msg=k)


def _work(rng, frames):
    """Work items over ``frames`` ({key: (H, W, 3) uint8}): boxes inside,
    across an edge and bigger than the frame, with cameras."""
    from spec_tpu.core.geometry import euler_pitch_roll_np
    from spec_tpu_torch.data.detection import bbox_to_center_scale

    boxes = {'a': [[80, 60, 70, 110], [150, 20, 60, 90]],
             'b': [[40, 50, 300, 260]]}
    chunk = []
    for key, bx in boxes.items():
        h, w = frames[key].shape[:2]
        centers, scales = bbox_to_center_scale(np.asarray(bx, 'f4'))
        K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], 'f4')
        R = euler_pitch_roll_np(rng.randn() * 0.1, rng.randn() * 0.05)
        chunk += [(key, centers[i], scales[i], R, K, w, h)
                  for i in range(len(bx))]
    return chunk


def test_device_crops_and_stage2_match_reference(bridged, rng):
    """The demo's stage 2 (spec_on_crops) on two frames of different
    sizes: its crops against T.crop, its outputs against the JAX HMR on
    the same crops."""
    from spec_tpu.data import transforms as T
    from spec_tpu_torch.core import constants as C
    from spec_tpu_torch.ops.preprocess import spin_crop_corners
    from spec_tpu_torch.serving import crop_boxes

    frames = {'a': (rng.rand(120, 160, 3) * 255).astype('u1'),
              'b': (rng.rand(90, 100, 3) * 255).astype('u1')}
    chunk = _work(rng, frames)
    chunk.append(chunk[-1])                       # a padded row
    frames_dev = {k: torch.from_numpy(v) for k, v in frames.items()}
    crops = crop_boxes(frames_dev, [c[0] for c in chunk], spin_crop_corners(
        np.stack([c[1] for c in chunk]), [c[2] for c in chunk], res=RES),
        RES).numpy()
    for crop, c in zip(crops, chunk):
        want = T.crop(frames[c[0]].astype('f4'), c[1], float(c[2]),
                      [RES, RES]) / 255.0
        diff = np.abs(crop * C.IMG_NORM_STD + C.IMG_NORM_MEAN - want)
        assert diff.max() < 2e-3 and diff.mean() < 1e-3, (c[0], diff.max())

    _, model, stage = TDemo._get_spec_model('', bridged['cfg'],
                                            bridged['ckpt'], RES, 'cpu')
    out = TDemo.spec_on_crops(stage, frames_dev, chunk, RES)
    assert out['smpl_vertices'].shape == (len(chunk), 6890, 3)
    _assert_outputs_close({k: v.numpy() for k, v in out.items()},
                          _reference_hmr(bridged, crops, chunk), len(chunk))


def _write_images(folder, rng, shapes):
    os.makedirs(folder, exist_ok=True)
    for i, (h, w) in enumerate(shapes):
        cv2.imwrite(os.path.join(folder, f'im{i}.png'),
                    (rng.rand(h, w, 3) * 255).astype('u1'))


@pytest.mark.parametrize('boxes', ['bbox_file', 'full_frame'])
def test_folder_mode_matches_reference_model(bridged, tmp_path, rng, boxes):
    """Folder mode end to end (stage 1, pickles, crops, stage 2, results,
    overlays, OBJ files): each image's results equal the JAX HMR on the
    port's crops with the cameras read back from the written pickles by
    the reference's reader."""
    from spec_tpu.data.detection import bbox_to_center_scale
    from spec_tpu.utils.cam_params import read_cam_params
    from spec_tpu_torch.ops.preprocess import spin_crop_corners
    from spec_tpu_torch.serving import crop_boxes

    img_dir = str(tmp_path / 'imgs')
    _write_images(img_dir, rng, [(96, 128), (64, 96), (96, 128)])
    argv = ['--image_folder', img_dir, '--output_folder',
            str(tmp_path / 'out'), '--spec_ckpt', bridged['ckpt'],
            '--cfg', bridged['cfg'], '--min_size', '64', '--batch_size', '2',
            '--device', 'cpu', '--save_obj']
    if boxes == 'bbox_file':
        dets = {'im0.png': [[60, 50, 40, 70], [100, 40, 30, 50]],
                'im1.png': [], 'im2.png': [[20, 30, 50, 60]]}
        import json
        with open(tmp_path / 'dets.json', 'w') as f:
            json.dump(dets, f)
        argv += ['--bbox_file', str(tmp_path / 'dets.json')]
    else:
        from spec_tpu.data.detection import full_image_bboxes
        dets = {k: v.tolist() for k, v in full_image_bboxes(
            {'im0.png': (96, 128), 'im1.png': (64, 96),
             'im2.png': (96, 128)}).items()}
    TDemo.main(argv)

    out = tmp_path / 'out'
    assert sorted(p.name for p in (out / 'camcalib').glob('*.pkl')) == [
        'im0.png.pkl', 'im1.png.pkl', 'im2.png.pkl']
    chunk, frames_dev = [], {}
    for name in sorted(dets):
        if not dets[name]:
            continue
        img = cv2.cvtColor(cv2.imread(os.path.join(img_dir, name)),
                           cv2.COLOR_BGR2RGB)
        frames_dev[name] = torch.from_numpy(img)
        h, w = img.shape[:2]
        R, K, *_ = read_cam_params(str(out / 'camcalib' / f'{name}.pkl'),
                                   w, h)
        centers, scales = bbox_to_center_scale(np.asarray(dets[name], 'f4'))
        chunk += [(name, centers[i], scales[i], R, K, w, h)
                  for i in range(len(centers))]
    crops = crop_boxes(frames_dev, [c[0] for c in chunk], spin_crop_corners(
        np.stack([c[1] for c in chunk]), [c[2] for c in chunk], res=RES),
        RES).numpy()
    want = _reference_hmr(bridged, crops, chunk)
    row = 0
    for name in sorted(frames_dev):
        stem = name.rsplit('.', 1)[0]
        got = joblib.load(out / 'spec_results' / f'{stem}.pkl')
        n = len(dets[name])
        assert got['smpl_vertices'].shape == (n, 6890, 3)
        _assert_outputs_close(got, {k: v[row:row + n]
                                    for k, v in want.items()}, n)
        row += n
        assert (out / 'spec_images' / name).exists()
        objs = sorted((out / 'meshes' / stem).glob('*.obj'))
        assert len(objs) == n
        assert objs[0].read_text().count('\nv ') == 6890 - 1
    if boxes == 'bbox_file':
        assert not (out / 'spec_results' / 'im1.pkl').exists()


def test_folder_mode_chunk_wider_than_frame_cache(bridged, tmp_path, rng,
                                                  monkeypatch):
    """A chunk whose boxes span more images than the uploaded-frame cache
    holds keeps every frame it needs on the device (the cache evicts only
    frames the chunk does not use)."""
    monkeypatch.setattr(TDemo, '_IMAGE_CACHE_MAX', 1)
    img_dir = str(tmp_path / 'imgs')
    _write_images(img_dir, rng, [(48, 64)] * 5)
    out = tmp_path / 'out'
    TDemo.main(['--image_folder', img_dir, '--output_folder', str(out),
                '--spec_ckpt', bridged['ckpt'], '--cfg', bridged['cfg'],
                '--min_size', '64', '--batch_size', '4', '--no_render',
                '--device', 'cpu'])
    assert len(list((out / 'spec_results').glob('*.pkl'))) == 5


def test_write_obj_matches_reference(tmp_path, rng):
    from spec_tpu.cli.spec_demo import write_obj as ref_write

    verts = rng.randn(10, 3).astype('f4')
    faces = rng.randint(0, 10, (7, 3))
    TDemo.write_obj(str(tmp_path / 'p.obj'), verts, faces)
    ref_write(str(tmp_path / 'r.obj'), verts, faces)
    assert ((tmp_path / 'p.obj').read_bytes()
            == (tmp_path / 'r.obj').read_bytes())


def test_stage1_keyframes_match_reference(tmp_path):
    """Every Nth frame plus shot cuts (a hard cut at frame 4), with and
    without the cut trigger: the reference's keyframes."""
    from spec_tpu.cli.spec_demo import _stage1_keyframes as ref_keys

    rng = np.random.RandomState(3)
    names = []
    for i in range(7):
        lvl = 30 if i < 4 else 225
        p = str(tmp_path / f'{i:03d}.jpg')
        cv2.imwrite(p, np.clip(lvl + rng.rand(48, 64, 3) * 30, 0,
                               255).astype(np.uint8))
        names.append(p)
    keys = TDemo._stage1_keyframes(names, every=3)
    assert keys == ref_keys(names, every=3) == [names[0], names[3],
                                                names[4], names[6]]
    assert (TDemo._stage1_keyframes(names, every=3, cut_threshold=0)
            == ref_keys(names, every=3, cut_threshold=0)
            == [names[0], names[3], names[6]])


def test_carry_cameras_forward_matches_reference(tmp_path):
    from spec_tpu.cli.spec_demo import _carry_cameras_forward as ref_carry

    names = ['a.png', 'b.png', 'c.png', 'd.png']
    shapes = {'a.png': (100, 160), 'b.png': (100, 160),
              'c.png': (200, 320), 'd.png': (100, 160)}
    key = {'vfov': 1.0, 'f_pix': 100 / (2 * np.tan(0.5)), 'pitch': 0.1,
           'roll': -0.05}
    dirs = []
    for tag, carry in (('p', TDemo._carry_cameras_forward),
                       ('r', ref_carry)):
        d = tmp_path / tag
        d.mkdir()
        joblib.dump(key, d / 'a.png.pkl')
        joblib.dump(dict(key, pitch=0.3), d / 'd.png.pkl')
        carry(names, str(d), shapes)
        dirs.append(d)
    for n in names:
        assert (joblib.load(dirs[0] / f'{n}.pkl')
                == joblib.load(dirs[1] / f'{n}.pkl'))
    c = joblib.load(dirs[0] / 'c.png.pkl')
    assert np.isclose(c['f_pix'], 200 / (2 * np.tan(0.5)))


def _clip(path, n, fps, levels=None, seed=0):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), fps,
                        (64, 48))
    rng = np.random.RandomState(seed)
    for i in range(n):
        if levels is None:
            w.write((rng.rand(48, 64, 3) * 255).astype(np.uint8))
        else:
            w.write(np.clip(levels[i] + rng.rand(48, 64, 3) * 30, 0,
                            255).astype(np.uint8))
    w.release()


def _count_frames(path):
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    return n, cap.get(cv2.CAP_PROP_FPS)


def test_video_mode(bridged, tmp_path):
    """--mode video: frames in chunks of 2 -> the folder pipeline -> an
    annotated mp4 at the source fps, tracks, and --smooth (the track's
    betas become its mean, poses stay rotations); --camcalib_every 2
    reuses frame 0's camera on frame 1."""
    vid = tmp_path / 'clip.mp4'
    _clip(vid, 3, 12)
    out = tmp_path / 'out'
    TDemo.main(['--vid_file', str(vid), '--output_folder', str(out),
                '--batch_size', '2', '--exp', 'v1', '--chunk_size', '2',
                '--smooth', '--camcalib_every', '2', '--min_size', '64',
                '--spec_ckpt', bridged['ckpt'], '--cfg', bridged['cfg'],
                '--device', 'cpu'])
    exp_dir = out / 'clip_v1'
    n, fps = _count_frames(exp_dir / 'spec_video_output.mp4')
    assert n == 3 and abs(fps - 12) < 0.5
    assert len(list((exp_dir / 'spec_results').glob('*.pkl'))) == 3
    assert not (exp_dir / 'frames').exists()
    assert not (exp_dir / 'frames_chunk').exists()
    tracks = joblib.load(exp_dir / 'tracking.pkl')
    assert list(tracks) == [0]
    assert tracks[0]['frames'].tolist() == [0, 1, 2]
    res = [joblib.load(p) for p in
           sorted((exp_dir / 'spec_results').glob('*.pkl'))]
    np.testing.assert_allclose(res[0]['pred_shape'], res[1]['pred_shape'],
                               atol=1e-6)
    R = res[2]['pred_pose'][0]
    np.testing.assert_allclose(R @ np.transpose(R, (0, 2, 1)),
                               np.tile(np.eye(3), (24, 1, 1)), atol=1e-4)
    assert np.isfinite(res[1]['smpl_vertices']).all()
    cams = [joblib.load(exp_dir / 'camcalib' / f'{i:06d}.png.pkl')
            for i in range(3)]
    assert cams[0] == cams[1]


def test_video_mode_checks_bbox_keys_and_input(tmp_path):
    import json

    vid = tmp_path / 'clip.mp4'
    _clip(vid, 2, 10)
    with open(tmp_path / 'dets.json', 'w') as f:
        json.dump({'img.jpg': [[1, 2, 3, 4]]}, f)
    with pytest.raises(ValueError, match='frame-name-convention'):
        TDemo.main(['--vid_file', str(vid), '--bbox_file',
                    str(tmp_path / 'dets.json'), '--output_folder',
                    str(tmp_path / 'o'), '--device', 'cpu'])
    with pytest.raises((FileNotFoundError, SystemExit)):
        TDemo.main(['--image_folder', str(tmp_path), '--mode', 'video',
                    '--device', 'cpu'])


def test_webcam_mode(bridged, tmp_path):
    """--mode webcam on a clip standing in for the camera: stops after
    --max_frames, writes the video and per-frame results."""
    vid = tmp_path / 'cam.mp4'
    _clip(vid, 4, 10)
    out = tmp_path / 'out'
    TDemo.main(['--mode', 'webcam', '--webcam_source', str(vid),
                '--output_folder', str(out), '--exp', 'w1',
                '--max_frames', '3', '--min_size', '64',
                '--spec_ckpt', bridged['ckpt'], '--cfg', bridged['cfg'],
                '--device', 'cpu'])
    exp_dir = out / 'cam_w1'
    assert _count_frames(exp_dir / 'spec_webcam_output.mp4')[0] == 3
    pkls = sorted((exp_dir / 'webcam_results').glob('*.pkl'))
    assert [p.name for p in pkls] == ['000000.pkl', '000001.pkl',
                                      '000002.pkl']
    res = joblib.load(pkls[1])
    assert set(res['camera']) == {'vfov', 'f_pix', 'pitch', 'roll'}
    assert res['smpl_vertices'].shape == (1, 6890, 3)
    assert np.isfinite(res['smpl_vertices']).all()


def test_webcam_shot_cut_reanchors(bridged, tmp_path):
    """--camcalib_every 4 with a hard cut at frame 3: frames 0-2 share
    keyframe 0's camera, the cut frame gets a fresh one, frame 5 reuses
    frame 4's."""
    vid = tmp_path / 'cam.mp4'
    _clip(vid, 6, 10, levels=[25, 25, 25, 220, 220, 220], seed=1)
    out = tmp_path / 'out'
    TDemo.main(['--mode', 'webcam', '--webcam_source', str(vid),
                '--output_folder', str(out), '--exp', 'w2',
                '--camcalib_every', '4', '--min_size', '64',
                '--spec_ckpt', bridged['ckpt'], '--cfg', bridged['cfg'],
                '--device', 'cpu'])
    pkls = sorted((out / 'cam_w2' / 'webcam_results').glob('*.pkl'))
    cams = [joblib.load(p)['camera'] for p in pkls]
    assert len(cams) == 6
    assert cams[0] == cams[1] == cams[2]
    assert cams[3] != cams[2]
    assert cams[5] == cams[4]


def test_model_cache_reused(bridged):
    a = TDemo._get_spec_model('', bridged['cfg'], bridged['ckpt'], RES,
                              'cpu')
    b = TDemo._get_spec_model('', bridged['cfg'], bridged['ckpt'], RES,
                              torch.device('cpu'))
    assert a[2] is b[2]


def test_reference_flag_surface_and_unported(capsys, monkeypatch, tmp_path):
    """The reference demo's flags parse (--help lists them); a detector
    other than yolo is refused; without a card and without --device cpu
    the demo exits non-zero."""
    from spec_tpu.cli.spec_demo import main as ref_main

    monkeypatch.setenv('COLUMNS', '200')
    helps = []
    for main in (TDemo.main, ref_main):
        with pytest.raises(SystemExit) as e:
            main(['--help'])
        assert e.value.code == 0
        helps.append(capsys.readouterr().out)
    ref_flags = {w.strip('[,') for w in helps[1].split()
                 if w.startswith(('--', '[--'))}
    port_flags = {w.strip('[,') for w in helps[0].split()
                  if w.startswith(('--', '[--'))}
    assert ref_flags <= port_flags and '--device' in port_flags
    with pytest.raises(ValueError, match='unknown detector'):
        TDemo.run_spec_on_folder(str(tmp_path), str(tmp_path / 'o'),
                                 detector='ssd', device='cpu')
    with pytest.raises(SystemExit, match='maskrcnn'):
        TDemo.main(['--image_folder', str(tmp_path), '--detector',
                    'maskrcnn'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='device cpu'):
        TDemo.main(['--image_folder', str(tmp_path)])


@pytest.mark.parametrize('stage', ['camcalib_demo', 'smooth'])
def test_cli_stage_bodies_are_capturable(stage, rng):
    """The stage bodies the CLIs add to the predictor's (camcalib_demo's
    stage 1, the --smooth recompute) are capturable as CUDA graphs: after
    a warm-up they upload nothing, sync nothing and take no
    data-dependent shape (tests/test_torch_graphs.py's check)."""
    import functools

    from spec_tpu_torch.cli import camcalib_demo
    from spec_tpu_torch.core import geometry as G
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.heads.smpl_head import smpl_cam_head
    from tests.test_torch_graphs import _uncapturable_ops

    if stage == 'camcalib_demo':
        model, graph = camcalib_demo._get_model('', 'resnet18',
                                                'softargmax_l2', 'cpu')
        args = (torch.from_numpy((rng.rand(2, 64, 80, 3) * 255)
                                 .astype(np.uint8)),)
        fn = graph.fn
    else:
        fn = functools.partial(smpl_cam_head,
                               S.with_packed_lbs(S.create_test_assets()),
                               crop_res=RES)
        B = 4
        pose = G.rodrigues(torch.from_numpy(
            rng.randn(B, 24, 3).astype('f4') * 0.3))
        K = torch.tensor([[300.0, 0, 64], [0, 300, 48], [0, 0, 1]])
        args = (pose, torch.zeros(B, 10), torch.tensor([[0.9, 0, 0]] * B),
                torch.eye(3).repeat(B, 1, 1), K.repeat(B, 1, 1),
                torch.full((B,), 0.5), torch.full((B, 2), 50.0),
                torch.full((B,), 128.0), torch.full((B,), 96.0))
    with torch.inference_mode():
        assert _uncapturable_ops(fn, *args) == []
