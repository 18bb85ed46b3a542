"""spec_tpu_torch.cli.serve (the HTTP server) against spec_tpu.cli.serve,
on the CPU.

The micro-batcher's rules are held to the reference's by driving both
``_Batcher`` classes with the same rounds over a duck-typed predictor;
the request codec by decoding and encoding the same payloads with both;
the server end to end by sending the same requests to the reference's
server over the JAX predictor and to the port's over the port's
predictor (same checkpoints, tests/test_torch_serving.py's fixture and
tolerances). Two tests cover faults the port does not copy: named
streams evicted by header-less requests, and an unlocked
``requests_total``.
"""

import io
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spec_tpu.cli import serve as JServe
from spec_tpu_torch.cli import serve as TServe
from tests.test_torch_serving import (  # noqa: F401  (module fixture)
    _assert_people_close,
    predictors,
)

H, W = 96, 128
BX = np.array([[2, 2, 2, 2]], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: this file runs whole models, and under a
    parallel test run (several workers sharing the cores) torch's default
    threads wait on each other (tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _FakePredictor:
    """Duck-typed predictor logging its calls (tests/test_serving.py's)."""

    camcalib_every = 1

    def __init__(self, batch_size=8, fail_batched=False):
        self.batch_size = batch_size
        self.fail_batched = fail_batched
        self.calls = []          # (n_frames, has_boxes) per predict()
        self.streams = []        # stream key per predict()
        self.resets = []         # reset_camera_stream keys

    def reset_camera_stream(self, stream=None, all_streams=False):
        self.resets.append('*' if all_streams else stream)

    def predict(self, frames, boxes, cameras=None, stream=None,
                return_cameras=False):
        self.calls.append((len(frames), boxes is not None))
        self.streams.append(stream)
        if self.fail_batched and len(frames) > 1:
            raise RuntimeError('batched call sabotaged')
        if boxes is None:
            boxes = [np.zeros((1, 4), np.float32) for _ in frames]
        results = [[{'tag': float(np.asarray(f).sum())} for _ in b]
                   for f, b in zip(frames, boxes)]
        cams = [{'vfov': 1.0, 'pitch': 0.0, 'roll': 0.0,
                 'f_pix': float(np.asarray(f).shape[1])} for f in frames]
        return (results, cams) if return_cameras else results


def _item(n, stream=None, has_boxes=True, value=7):
    return {'frames': [np.full((4, 4, 3), value + i, np.uint8)
                       for i in range(n)],
            'boxes': [BX] * n if has_boxes else None, 'stream': stream,
            'ev': threading.Event()}


def _harness(mod, pred, max_frames):
    """A _Batcher without its dispatcher thread: tests drive _drain."""
    b = mod._Batcher.__new__(mod._Batcher)
    b.pred, b.max_frames = pred, max_frames
    return b


ROUNDS = {
    'coalesce': (1, 8, [(1, None, True), (2, None, True),
                        (1, None, False)]),
    'streams': (2, 16, [(1, 'a', True), (1, None, True), (2, 'a', True),
                        (1, 'c', True), (1, None, True)]),
    'order': (4, 16, [(1, 'a', True), (1, 'a', False), (1, 'a', True)]),
    'sequential_default': (2, 1, [(1, None, True)]),
    'failing_round': (1, 8, [(1, None, True), (2, None, True)]),
}


@pytest.mark.parametrize('name', sorted(ROUNDS))
def test_batcher_rounds_match_reference(name):
    """The same round through both _Batchers: the same predictor calls
    (frames, box mode, stream), resets, per-request results, cameras and
    errors."""
    every, max_frames, spec = ROUNDS[name]
    logs = []
    for mod in (TServe, JServe):
        pred = _FakePredictor(fail_batched=name == 'failing_round')
        pred.camcalib_every = every
        items = [_item(n, sid, hb, value=10 * k)
                 for k, (n, sid, hb) in enumerate(spec)]
        _harness(mod, pred, max_frames)._drain(items)
        assert all(i['ev'].is_set() for i in items)
        logs.append((pred.calls, pred.streams, pred.resets,
                     [(i.get('results'), i.get('cameras'),
                       repr(i.get('error'))) for i in items]))
    assert logs[0] == logs[1]


def test_batcher_coalesces_queued_requests():
    pred = _FakePredictor()
    b = _harness(TServe, pred, 8)
    f = [np.full((4, 4, 3), i, np.uint8) for i in range(3)]
    items = [{'frames': [f[0]], 'boxes': [BX], 'ev': threading.Event()},
             {'frames': [f[1], f[2]], 'boxes': [BX, BX],
              'ev': threading.Event()},
             {'frames': [f[0]], 'boxes': None, 'ev': threading.Event()}]
    b._drain(items)
    assert sorted(pred.calls) == [(1, False), (3, True)]
    assert [len(i['results']) for i in items] == [1, 2, 1]
    assert items[1]['results'][1][0]['tag'] == float(f[2].sum())
    assert len(items[0]['cameras']) == 1 and len(items[1]['cameras']) == 2


def test_batcher_isolates_failing_request_and_solo_not_retried():
    pred = _FakePredictor(fail_batched=True)
    one, two = _item(1), _item(2)
    _harness(TServe, pred, 8)._drain([one, two])
    assert 'results' in one and 'error' not in one      # retried alone
    assert isinstance(two.get('error'), RuntimeError)
    # A failing one-request round is not retried.
    pred.calls.clear()
    solo = _item(2)
    _harness(TServe, pred, 8)._drain([solo])
    assert isinstance(solo.get('error'), RuntimeError)
    assert pred.calls == [(2, True)]


def test_batcher_stream_grouping_and_ephemeral_reset():
    pred = _FakePredictor()
    pred.camcalib_every = 2
    a1, anon, a2, c = _item(1, 'a'), _item(1), _item(2, 'a'), _item(1, 'c')
    _harness(TServe, pred, 16)._drain([a1, anon, a2, c])
    assert len(pred.calls) == 3 and (3, True) in pred.calls
    eph = [s for s in pred.streams if s and s.startswith('\x00')]
    assert len(eph) == 1 and pred.resets == eph
    assert [len(i['results']) for i in (a1, a2, c, anon)] == [1, 2, 1, 1]


def _held(pred):
    """Make pred.predict wait on the returned gate."""
    gate = threading.Event()
    orig = pred.predict

    def predict(*a, **kw):
        gate.wait(timeout=30)
        return orig(*a, **kw)

    pred.predict = predict
    return gate


def _wait_until(cond, seconds=10.0):
    t_end = time.time() + seconds
    while not cond() and time.time() < t_end:
        time.sleep(0.01)
    assert cond()


def test_batcher_hard_frame_cap_and_stop():
    """A round never exceeds max_frames (an overshooting request waits
    for the next round); stop() joins the dispatcher and later submits
    fail fast."""
    pred = _FakePredictor()
    gate = _held(pred)
    b = TServe._Batcher(pred, max_frames=4)
    threads = [threading.Thread(target=b.submit,
                                args=([np.zeros((4, 4, 3), np.uint8)] * n,
                                      [BX] * n)) for n in (1, 3, 3, 3)]
    for t in threads:
        t.start()
    # All four submitted while round 1 is held (its batch, and any
    # request carried past the cap, are out of the queue by then).
    _wait_until(lambda: b.stats()['requests_total'] == 4
                and b.stats()['rounds_total'] >= 1)
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert all(n <= 4 for n, _ in pred.calls), pred.calls
    assert sum(n for n, _ in pred.calls) == 10
    assert 3 <= b.stats()['max_round_frames'] <= 4
    b.stop()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match='shutting down'):
        b.submit([np.zeros((4, 4, 3), np.uint8)], [BX])


def test_batcher_stop_rejects_pending():
    """An item queued behind stop() gets an error instead of hanging."""
    pred = _FakePredictor()
    gate = _held(pred)
    b = TServe._Batcher(pred, max_frames=1)
    ok = []
    t1 = threading.Thread(target=lambda: ok.append(
        b.submit([np.zeros((4, 4, 3), np.uint8)], [BX])))
    t1.start()
    _wait_until(lambda: b.stats()['rounds_total'] == 1)   # held there
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    _wait_until(lambda: b._stopped)
    late = _item(1)
    b._q.put(late)
    gate.set()
    for t in (t1, stopper):
        t.join(timeout=30)
    assert len(ok) == 1
    assert late['ev'].wait(timeout=10)
    assert 'shutting down' in str(late.get('error'))


def test_requests_total_exact_under_concurrent_submitters():
    """16 threads submit 25 requests each: /stats counts all 400, with
    frames and persons to match (the counters are bumped under a lock;
    the reference bumps requests_total unlocked from every handler
    thread)."""
    import sys

    pred = _FakePredictor()
    b = TServe._Batcher(pred, max_frames=8)
    start = threading.Barrier(16)

    def client():
        start.wait()
        for _ in range(25):
            b.submit([np.zeros((4, 4, 3), np.uint8)], [BX])

    threads = [threading.Thread(target=client) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s = b.stats()
    b.stop()
    assert (s['requests_total'], s['frames_total'],
            s['persons_total']) == (400, 400, 400)
    assert s['request_errors'] == 0 and s['queue_depth'] == 0
    assert s['rounds_total'] <= 400 and s['calls_total'] == len(pred.calls)


PAYLOADS = {
    'single': dict(frame=np.ones((6, 8, 3), np.uint8), boxes=BX),
    'single_no_boxes': dict(frame=np.ones((6, 8, 3), np.uint8)),
    'pairs': dict(frame_0=np.ones((6, 8, 3), np.uint8), boxes_0=BX,
                  frame_1=np.zeros((5, 8, 3), np.uint8),
                  boxes_1=np.zeros((0, 4), np.float32)),
    'pairs_no_boxes': dict(frame_0=np.ones((6, 8, 3), np.uint8),
                           frame_1=np.ones((6, 8, 3), np.uint8)),
    'orphan_boxes': dict(frame_0=np.ones((6, 8, 3), np.uint8), boxes_1=BX),
    'index_gap': dict(frame_0=np.ones((6, 8, 3), np.uint8), boxes_0=BX,
                      frame_2=np.ones((6, 8, 3), np.uint8), boxes_2=BX),
    'missing_boxes': dict(frame_0=np.ones((6, 8, 3), np.uint8), boxes_0=BX,
                          frame_1=np.ones((6, 8, 3), np.uint8)),
    'empty': dict(other=np.ones(3)),
}


@pytest.mark.parametrize('name', sorted(PAYLOADS))
def test_decode_request_matches_reference(name):
    body = _npz(**PAYLOADS[name])
    out = []
    for mod in (TServe, JServe):
        try:
            out.append(mod._decode_request(body))
        except ValueError as e:
            out.append(('error', str(e)))
    if out[1][0] == 'error':
        assert out[0] == out[1]
        return
    (fp, bp), (fr, br) = out
    assert len(fp) == len(fr) and (bp is None) == (br is None)
    for a, b in zip(fp, fr):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(bp or [], br or []):
        np.testing.assert_array_equal(a, b)


def test_decode_jpeg_frames_and_missing_cv2(monkeypatch, rng):
    """Encoded frames decode as the reference decodes them; without cv2
    a JPEG frame is a client error that says so."""
    import cv2
    import sys

    frame = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    ok, enc = cv2.imencode('.jpg', frame)
    assert ok
    body = _npz(frame_0_jpeg=np.frombuffer(enc.tobytes(), np.uint8),
                boxes_0=BX, frame_1=frame, boxes_1=BX)
    (fp, _), (fr, _) = (m._decode_request(body) for m in (TServe, JServe))
    for a, b in zip(fp, fr):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='did not decode'):
        TServe._decode_request(_npz(frame_jpeg=np.zeros(10, np.uint8)))
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ValueError, match=r'OpenCV \(cv2\)'):
        TServe._decode_request(body)


def test_encode_response_matches_reference(rng):
    results = [[], [{'smpl_vertices': rng.rand(5, 3).astype('f4'),
                     'pred_cam': rng.rand(3).astype('f4'),
                     'camera': {'vfov': 1.0}}]]
    cameras = [{'vfov': 0.8, 'pitch': 0.1, 'roll': -0.2, 'f_pix': 300.0},
               {'vfov': 1.0, 'pitch': 0.0, 'roll': 0.0, 'f_pix': 99.0}]
    port = np.load(io.BytesIO(TServe._encode_response(results, cameras)))
    ref = np.load(io.BytesIO(JServe._encode_response(results, cameras)))
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(port[k], ref[k])


class _Server:
    """A create_server() instance on a free localhost port, serving in a
    thread; shut down on exit."""

    def __init__(self, mod, predictor, **kw):
        self.server = mod.create_server(predictor, host='127.0.0.1',
                                        port=0, **kw)
        self.base = f'http://127.0.0.1:{self.server.server_address[1]}'
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.read()

    def post(self, body, stream=None, path='/predict'):
        req = urllib.request.Request(self.base + path, data=body)
        if stream:
            req.add_header('X-Spec-Stream', stream)
        with urllib.request.urlopen(req, timeout=300) as r:
            return np.load(io.BytesIO(r.read()))

    def status(self, body, path='/predict'):
        try:
            self.post(body, path=path)
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.headers.get('Content-Type') == 'application/json':
                return e.code, json.loads(body)['error']
            return e.code, body.decode()
        return 200, ''


def _people(out):
    """Response npz -> per-frame person dicts (the keys both servers
    send) and the frame cameras."""
    res, cams = [], []
    for fi in range(int(out['n_frames'])):
        n = int(out[f'f{fi}_n_persons'])
        res.append([{k.split('_', 2)[2]: out[k] for k in out.files
                     if k.startswith(f'f{fi}_p{pi}_')} for pi in range(n)])
        cams.append(out[f'f{fi}_camera'])
    return res, cams


def test_http_roundtrip_matches_reference_server(predictors, rng):
    """The same requests to the reference's server (JAX predictor) and
    the port's (port predictor, same checkpoints): the same arrays, at
    tests/test_torch_serving.py's limits; healthz, 404, 400 and 413 as
    the reference answers them."""
    import cv2

    jax_pred, port_pred = predictors
    frame = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    boxes = np.array([[64, 48, 60, 80], [30, 40, 28, 40]], np.float32)
    ok, enc = cv2.imencode('.png', cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    bodies = [_npz(frame_0=frame, boxes_0=boxes, frame_1=frame[::-1].copy(),
                   boxes_1=np.zeros((0, 4), np.float32)),
              _npz(frame_jpeg=np.frombuffer(enc.tobytes(), np.uint8),
                   boxes=boxes[:1])]
    with _Server(TServe, port_pred) as tp, _Server(JServe, jax_pred) as rf:
        assert tp.get('/healthz') == rf.get('/healthz') == b'ok'
        for body in bodies:
            out_p, out_r = tp.post(body), rf.post(body)
            assert sorted(set(out_r.files) - set(out_p.files)) == []
            (res_p, cams_p), (res_r, cams_r) = _people(out_p), _people(out_r)
            _assert_people_close(res_p, res_r)
            for cp, cr in zip(cams_p, cams_r):
                np.testing.assert_allclose(cp[:3], cr[:3], atol=1e-4)
                np.testing.assert_allclose(cp[3], cr[3], atol=0.05)
        assert [len(r) for r in _people(tp.post(bodies[0]))[0]] == [2, 0]
        for server in (tp, rf):
            assert server.status(b'not-an-npz')[0] == 400
            assert server.status(b'x', path='/nowhere')[0] == 404
        code, msg = tp.status(_npz(frame=frame))
        assert code == 400 and (code, msg) == rf.status(_npz(frame=frame))
        assert tp.get('/healthz') == b'ok'
    with _Server(TServe, port_pred, max_request_bytes=100) as small:
        assert small.status(b'x' * 200)[0] == 413


def test_http_stats_and_concurrent_requests(predictors, rng):
    """Four concurrent clients all get their answer (identical requests,
    possibly in different batch compositions: vertices within 1e-4);
    /stats counts them; a failing request is a 500 counted in
    request_errors and the server stays up."""
    _, port_pred = predictors
    frame = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    body = _npz(frame=frame, boxes=np.array([[64, 48, 60, 80]], np.float32))
    with _Server(TServe, port_pred) as srv:
        outs, errs = [None] * 4, []

        def hit(i):
            try:
                outs[i] = srv.post(body)
            except Exception as e:   # pragma: no cover - diagnostic
                errs.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs
        ref = outs[0]['f0_p0_smpl_vertices']
        for o in outs:
            assert int(o['f0_n_persons']) == 1
            np.testing.assert_allclose(o['f0_p0_smpl_vertices'], ref,
                                       atol=1e-4)
        s = json.loads(srv.get('/stats'))
        assert (s['requests_total'], s['frames_total'],
                s['persons_total'], s['request_errors']) == (4, 4, 4, 0)
        assert 1 <= s['rounds_total'] <= 4 and s['uptime_s'] > 0
        assert s['avg_round_frames'] == round(4 / s['rounds_total'], 3)
        code, _ = srv.status(_npz(frame=frame, boxes=np.zeros(3, 'f4')))
        assert code == 500
        s = json.loads(srv.get('/stats'))
        assert s['request_errors'] == 1 and s['requests_total'] == 5
        srv.post(body)
        assert json.loads(srv.get('/stats'))['persons_total'] == 5


# A response against predict() on the same frames, same device and
# weights: only the padded batch differs (metres, radians and unitless
# parameters; joints2d in px).
SAME_DEVICE_ATOL = 1e-5
SAME_DEVICE_ATOL_PX = 1e-3


def _diffs(out, want):
    """Max |difference| per key between a response and predict()'s
    per-frame person dicts (the counts must agree)."""
    res, _ = _people(out)
    assert [len(r) for r in res] == [len(r) for r in want]
    d = {}
    for rp, rw in zip(res, want):
        for pp, pw in zip(rp, rw):
            for k, v in pp.items():
                d[k] = max(d.get(k, 0.0),
                           float(np.abs(v - np.asarray(pw[k])).max()))
    return d


def _within(d):
    return all(v <= (SAME_DEVICE_ATOL_PX if k == 'smpl_joints2d'
                     else SAME_DEVICE_ATOL) for k, v in d.items())


def test_http_coalesced_requests_get_their_own_results(predictors, rng):
    """Two requests (different frames and boxes, two persons each) queued
    behind a held call run as one predictor call (/stats: 2 rounds and 2
    calls for 3 requests); each response matches predict() on its own
    frame (1e-5, joints2d 1e-3 px) and not on the other's."""
    _, pred = predictors
    frames = [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(2)]
    boxes = [np.array([[40, 50, 40, 60], [90, 40, 30, 50]], np.float32),
             np.array([[60, 45, 50, 70], [30, 60, 25, 40]], np.float32)]
    bodies = [_npz(frame=f, boxes=b) for f, b in zip(frames, boxes)]
    outs = [None] * 3
    gate = _held(pred)
    try:
        with _Server(TServe, pred) as srv:
            batcher = srv.server.batcher

            def send(i, body):
                outs[i] = srv.post(body)

            threads = [threading.Thread(target=send, args=(0, bodies[0]))]
            threads[0].start()
            _wait_until(lambda: batcher.stats()['rounds_total'] == 1)
            threads += [threading.Thread(target=send, args=(i + 1, b))
                        for i, b in enumerate(bodies)]
            for t in threads[1:]:
                t.start()
            _wait_until(lambda: batcher.stats()['queue_depth'] == 2)
            gate.set()
            for t in threads:
                t.join(timeout=300)
            s = json.loads(srv.get('/stats'))
    finally:
        gate.set()
        del pred.predict                  # the bound method again
    assert (s['requests_total'], s['rounds_total'], s['calls_total'],
            s['max_round_frames'], s['persons_total']) == (3, 2, 2, 2, 6)
    want = [pred.predict([f], [b]) for f, b in zip(frames, boxes)]
    for i in (0, 1):
        assert _within(_diffs(outs[i + 1], want[i])), i
        assert not _within(_diffs(outs[i + 1], want[1 - i])), i


def test_http_stream_header(predictors, rng):
    """--camcalib_every over HTTP amortizes per stream: an off-stride
    request of a named stream runs no stage 1; a header-less request
    re-anchors on its own frame and leaves the named stream's counter
    alone."""
    _, pred = predictors
    calls = []
    orig = pred._cameras_dispatch

    def counting(fr):
        calls.append(len(fr))
        return orig(fr)

    fa = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    fb = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    bx = np.array([[64, 48, 40, 60]], np.float32)

    def body(*frames):
        arrays = {}
        for i, f in enumerate(frames):
            arrays[f'frame_{i}'], arrays[f'boxes_{i}'] = f, bx
        return _npz(**arrays)

    pred.camcalib_every, pred.cut_threshold = 3, 0.0
    pred._cameras_dispatch = counting
    try:
        with _Server(TServe, pred) as srv:
            r1 = srv.post(body(fa, fa), stream='cam1')
            assert calls == [1]
            r2 = srv.post(body(fb), stream='cam1')
            assert calls == [1]
            np.testing.assert_array_equal(r2['f0_camera'], r1['f0_camera'])
            calls.clear()
            r3 = srv.post(body(fb))
            assert calls == [1]
            assert not np.array_equal(r3['f0_camera'], r1['f0_camera'])
            srv.post(body(fa), stream='cam1')     # i = 3: a keyframe
            assert calls == [1, 1]
            assert not any(k.startswith('\x00') for k in pred._cam_streams)
    finally:
        pred.camcalib_every, pred.cut_threshold = 1, 0.5
        pred._cameras_dispatch = orig
        pred.reset_camera_stream(all_streams=True)


def test_named_streams_survive_headerless_requests(predictors):
    """256 named streams (max_streams) keep their keyframe state across
    300 header-less requests through the server's batcher: each of those
    runs as an ephemeral stream that neither counts towards the cap nor
    evicts a named stream, so a named stream's next off-stride frame
    still runs no stage 1. A 257th named stream still evicts the least
    recently used named one. Stage 1 is a counting stand-in here (the
    stream bookkeeping is what is under test; frames carry no persons,
    so stage 2 does not run)."""
    import torch

    _, pred = predictors
    assert pred.max_streams == 256
    calls = []

    def stage1(frames_dev):
        calls.append(len(frames_dev))
        n = len(frames_dev)
        return [(list(range(n)), torch.full((3, n), 0.5))]

    frame = np.zeros((8, 8, 3), np.uint8)
    none = [np.zeros((0, 4), np.float32)]
    pred.camcalib_every, pred.cut_threshold = 2, 0.0
    pred._cameras_dispatch = stage1
    try:
        for i in range(256):
            pred.predict([frame], none, stream=f'cam{i}')
        assert len(calls) == 256
        before = {k: dict(v) for k, v in pred._cam_streams.items()}
        b = TServe._Batcher(pred, max_frames=8)
        try:
            for _ in range(300):
                b.submit([frame], none)
        finally:
            b.stop()
        assert len(calls) == 256 + 300
        assert {k: dict(v) for k, v in pred._cam_streams.items()} == before
        calls.clear()
        pred.predict([frame], none, stream='cam0')   # i = 1: off-stride
        assert calls == []
        pred.predict([frame], none, stream='cam256')
        assert 'cam1' not in pred._cam_streams       # the LRU named one
        assert len(pred._cam_streams) == 256
    finally:
        pred.camcalib_every, pred.cut_threshold = 1, 0.5
        del pred._cameras_dispatch                   # the bound method
        pred.reset_camera_stream(all_streams=True)


def test_serve_help_documents_streams_and_unported_flags(capsys,
                                                         monkeypatch):
    monkeypatch.setenv('COLUMNS', '200')
    with pytest.raises(SystemExit) as e:
        TServe.main(['--help'])
    assert e.value.code == 0
    helptext = capsys.readouterr().out
    for phrase in ('X-Spec-Stream', 'PER STREAM', '--device',
                   'box-less requests', '.specx artifact',
                   'one band of rows per card'):
        assert phrase in helptext, phrase
    # --exported (item 11) and --spatial_parallel (item 12b) are ported;
    # no serve flag waits for an item
    assert 'item 11' not in helptext and 'item 12' not in helptext


@pytest.mark.parametrize('flags', [
    ['--detector', 'yolo', '--spatial_parallel'],
    ['--data_parallel', '--spatial_parallel'],
    ['--spatial_parallel'],
    ['--exported', 'art.specx', '--spatial_parallel']])
def test_serve_spatial_parallel_flag(flags, monkeypatch, tmp_path, capsys):
    """--spatial_parallel builds the banded predictor (here on two CPU
    devices through the device-list seam); with --detector yolo the
    detector stays on the first device, unsplit; with --data_parallel
    the predictor raises the reference's ValueError; with --exported the
    flag is ignored (the artifact runs on one device)."""
    from spec_tpu_torch import export
    from spec_tpu_torch import parallel as par

    monkeypatch.setenv('SPEC_DATA_ROOT', str(tmp_path))
    monkeypatch.setattr(par, 'create_mesh', lambda devices=None,
                        device=None: [torch.device('cpu')] * 2)
    loaded = types.SimpleNamespace()
    monkeypatch.setattr(export, 'load_predictor',
                        lambda path, batch_size, device: loaded)
    cfg = tmp_path / 'r18.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n')
    args = TServe.parse_args(flags + ['--cfg', str(cfg), '--min_size', '64',
                                      '--batch_size', '4'])
    assert args.spatial_parallel
    if '--data_parallel' in flags:
        with pytest.raises(ValueError, match='mutually exclusive'):
            TServe.build_predictor(args, torch.device('cpu'))
        return
    if '--exported' in flags:
        pred = TServe.build_predictor(args, torch.device('cpu'))
        assert pred is loaded
        assert '--spatial_parallel does not apply to --exported' in \
            capsys.readouterr().out
        return
    pred = TServe.build_predictor(args, torch.device('cpu'))
    assert isinstance(pred._stage1, par.SpatialStage)
    assert len(pred._stage1.mesh) == 2
    assert (pred._min_pad_s1, pred._min_pad) == (1, 2)
    if '--detector' in flags:
        assert (pred.detector._min_pad, pred.detector.batch_size) == (1, 8)
        assert not isinstance(pred.detector._fwd, par.ReplicatedStage)


def test_serve_main_needs_a_card_unless_asked(monkeypatch):
    """Without a card and without --device cpu, main exits non-zero and
    builds nothing; with --device cpu it builds the predictor from the
    flags and serves it."""
    import torch

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    built = []
    monkeypatch.setattr(TServe, 'build_predictor',
                        lambda args, device: built.append((args, device)))
    with pytest.raises(SystemExit) as e:
        TServe.main([])
    assert e.value.code not in (0, None) and 'device cpu' in str(e.value)
    assert built == []

    class _FakeServer:
        server_address = ('127.0.0.1', 12345)

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            built.append('shutdown')

    monkeypatch.setattr(TServe, 'create_server',
                        lambda *a, **kw: _FakeServer())
    TServe.main(['--device', 'cpu', '--camcalib_every', '4'])
    (args, device), stop = built
    assert device.type == 'cpu' and args.camcalib_every == 4
    assert stop == 'shutdown'


def test_build_predictor_applies_flags(tmp_path):
    """build_predictor hands serve's flags to the port's SpecPredictor,
    --cfg included."""
    cfg = tmp_path / 'spec.yaml'
    cfg.write_text('HMR:\n  BACKBONE: resnet18\n  USE_CAM_FEATS: true\n')
    args = TServe.parse_args(['--cfg', str(cfg), '--batch_size', '4',
                              '--min_size', '64', '--camcalib_every', '3',
                              '--cut_threshold', '0.25'])
    pred = TServe.build_predictor(args, 'cpu')
    assert (pred.batch_size, pred.min_size, pred.camcalib_every,
            pred.cut_threshold) == (4, 64, 3, 0.25)
    assert pred.spec.use_cam_feats
    assert pred.spec.backbone.out_channels == 512      # resnet18
