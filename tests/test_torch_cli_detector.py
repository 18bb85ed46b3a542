"""The YOLOv3 detector through the port's entry points, on the CPU.

* ``SpecPredictor(detector='yolo').predict(frames)`` without boxes
  equals ``predict(frames, boxes=detector.detect(frames))`` (the same
  boxes reach stage 2), with and without ``camcalib_every``; without a
  detector it raises the reference's ``ValueError``.
* ``spec_demo --detector yolo`` in folder mode writes ``detections.json``
  (as the reference's ``test_demo_folder_yolo_detector_path``); in video
  mode its boxes are tracked (``tracking.pkl``) and each frame's
  results are written; webcam mode takes it per frame.
* ``serve --detector yolo`` answers a request without boxes with
  ``predict(frames)``'s persons; the flags reach the predictor.
* ``bench --mode detect`` and ``--mode serving --detector``, tiny, print
  one result line.

Random-init detectors find almost no one at the reference's 0.7, so the
detectors here run at ``conf_thresh`` 0.2 (a host-only knob) and each
frame must yield a box.
"""

import io
import json
import math

import cv2
import joblib
import numpy as np
import pytest
import torch

from spec_tpu_torch import bench as TBench
from spec_tpu_torch.cli import serve as TServe
from spec_tpu_torch.cli import spec_demo as TDemo
from tests.test_torch_cli_serve import _people, _Server
from tests.test_torch_cli_spec_demo import _clip

CONF = 0.2


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: these tests run many small operations, and
    under a parallel test run (several workers sharing the cores) every
    parallel region's barrier waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def predictor():
    from spec_tpu_torch.serving import SpecPredictor

    pred = SpecPredictor(backbone='resnet18', camcalib_backbone='resnet18',
                         min_size=64, img_res=64, batch_size=4,
                         detector='yolo', yolo_img_size=64, device='cpu')
    pred.detector.conf_thresh = CONF
    return pred


def _frames():
    rng = np.random.RandomState(4)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8)
            for hw in ((48, 64), (48, 64), (64, 96))]


def _assert_same(got, want):
    assert [len(r) for r in got] == [len(r) for r in want]
    for rg, rw in zip(got, want):
        for pg, pw in zip(rg, rw):
            assert pg['camera'] == pw['camera']
            for k in pw:
                if k != 'camera':
                    np.testing.assert_array_equal(pg[k], pw[k], err_msg=k)


@pytest.mark.parametrize('every', [1, 2])
def test_predict_without_boxes_runs_the_detector(predictor, every):
    frames = _frames()
    boxes = predictor.detector.detect(frames)
    assert all(len(b) >= 1 for b in boxes), [len(b) for b in boxes]
    predictor.camcalib_every = every
    try:
        got = predictor.predict(frames)
        predictor.reset_camera_stream()
        want = predictor.predict(frames, boxes=boxes)
        predictor.reset_camera_stream()
    finally:
        predictor.camcalib_every = 1
    assert [len(r) for r in got] == [len(b) for b in boxes]
    _assert_same(got, want)
    v = got[2][0]['smpl_vertices']
    assert v.shape == (6890, 3) and np.isfinite(v).all()


def test_predict_without_boxes_or_detector_raises(predictor):
    detector, predictor.detector = predictor.detector, None
    try:
        with pytest.raises(ValueError, match='in-process detector'):
            predictor.predict(_frames())
    finally:
        predictor.detector = detector


def test_spec_demo_folder_writes_detections(tmp_path):
    """The reference's folder-mode detector test through the port's CLI
    (random init at the default threshold: every image has an entry)."""
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(img_dir / f'f{i}.jpg'),
                    (rng.rand(60, 80, 3) * 255).astype(np.uint8))
    cfg = tmp_path / 'r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n')
    out = tmp_path / 'out'
    TDemo.main(['--image_folder', str(img_dir), '--output_folder', str(out),
                '--detector', 'yolo', '--yolo_img_size', '64',
                '--batch_size', '2', '--no_render', '--min_size', '64',
                '--cfg', str(cfg), '--device', 'cpu'])
    with open(out / 'detections.json') as f:
        dets = json.load(f)
    assert set(dets) == {'f0.jpg', 'f1.jpg'}
    assert (out / 'camcalib').exists()


def test_spec_demo_video_tracks_the_detections(tmp_path):
    vid = tmp_path / 'clip.mp4'
    _clip(vid, 3, 12)
    cfg = tmp_path / 'r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n')
    out = tmp_path / 'out'
    TDemo.run_spec_on_video(
        str(vid), str(out), chunk_size=2, batch_size=2, min_size=64,
        cfg_file=str(cfg), detector='yolo', yolo_img_size=64,
        detection_threshold=CONF, render=False, device='cpu')
    with open(out / 'detections.json') as f:
        dets = json.load(f)
    names = [f'{i:06d}.png' for i in range(3)]
    assert sorted(dets) == names
    assert all(len(dets[n]) >= 1 for n in names)
    pkls = sorted((out / 'spec_results').glob('*.pkl'))
    assert [p.stem for p in pkls] == [n[:-len('.png')] for n in names]
    res = joblib.load(pkls[0])
    assert res['smpl_vertices'].shape == (len(dets[names[0]]), 6890, 3)
    tracks = joblib.load(out / 'tracking.pkl')
    assert sum(len(t['frames']) for t in tracks.values()) == sum(
        len(dets[n]) for n in names)
    for t in tracks.values():
        assert t['bboxes'].shape == (len(t['frames']), 4)


def test_spec_demo_webcam_takes_the_detector(tmp_path):
    """--mode webcam with --detector yolo: predict(frames) without boxes
    per frame (a random detector at 0.7 may find no one; each frame
    still writes its results with the camera)."""
    vid = tmp_path / 'cam.mp4'
    _clip(vid, 3, 10)
    cfg = tmp_path / 'r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n')
    n, latencies = TDemo.run_spec_webcam(
        source=str(vid), output_folder=str(tmp_path / 'out'),
        cfg_file=str(cfg), detector='yolo', yolo_img_size=64, min_size=64,
        max_frames=2, device='cpu')
    assert n == 2 and len(latencies) == 2
    pkls = sorted((tmp_path / 'out' / 'webcam_results').glob('*.pkl'))
    assert [p.name for p in pkls] == ['000000.pkl', '000001.pkl']
    assert set(joblib.load(pkls[0])['camera']) == {'vfov', 'f_pix', 'pitch',
                                                   'roll'}


def test_serve_answers_requests_without_boxes(predictor):
    frames = _frames()[:2]
    want = predictor.predict(frames)
    buf = io.BytesIO()
    np.savez(buf, frame_0=frames[0], frame_1=frames[1])
    with _Server(TServe, predictor) as srv:
        res, cams = _people(srv.post(buf.getvalue()))
    assert [len(r) for r in res] == [len(r) for r in want]
    for rg, rw in zip(res, want):
        for pg, pw in zip(rg, rw):
            np.testing.assert_allclose(pg['smpl_vertices'],
                                       pw['smpl_vertices'], atol=1e-5)


def test_serve_flags_build_the_detector(monkeypatch):
    import spec_tpu_torch.serving as serving

    seen = {}
    monkeypatch.setattr(serving, 'SpecPredictor',
                        lambda **kw: seen.update(kw))
    args = TServe.parse_args(['--detector', 'yolo', '--yolo_weights',
                              'w.weights', '--yolo_img_size', '320'])
    TServe.build_predictor(args, torch.device('cpu'))
    assert (seen['detector'], seen['yolo_weights'],
            seen['yolo_img_size']) == ('yolo', 'w.weights', 320)


@pytest.mark.parametrize('case', ['detect', 'serving detector'])
def test_bench_detector_modes_print_one_result_line(case, capsys):
    argv = {'detect': ['--mode', 'detect', '--batch', '2', '--frame_h',
                       '64'],
            'serving detector': ['--mode', 'serving', '--detector',
                                 '--frames', '2', '--persons', '1',
                                 '--frame_h', '48', '--frame_w', '64',
                                 '--min_size', '64']}[case]
    assert TBench.main(argv + ['--device', 'cpu', '--iters', '1']) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result['device'] == 'cpu' and result['spread']['windows'] >= 10
    assert math.isfinite(result['value']) and result['value'] > 0
    if case == 'detect':
        assert result['unit'] == 'img/s/gpu' and result['ms_per_batch'] > 0
        assert 'B=2' in result['metric']
    else:
        for k in ('overlap', 'sequential'):
            assert result[f'detect_stage1_{k}_ms_per_frame'] > 0
    assert TBench.parse_args(['--mode', 'detect']).batch == 32
    assert TBench.parse_args(['--mode', 'detect']).frame_h == 416
