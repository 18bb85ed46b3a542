"""HTTP serving front-end over :class:`spec_tpu_torch.serving.SpecPredictor`
(port of ``spec_tpu/cli/serve.py``; same protocol).

The persistent two-stage predictor behind stdlib ``http.server`` with npz
payloads. One dispatcher thread owns the device and does every device
operation (uploads, graph captures and replays, fetches); handler threads
only parse and write npz. Requests that queue while the device is busy
are coalesced into one predictor call (:class:`_Batcher`): large batches
under load, no added latency when idle.

Protocol (numpy .npz over POST):
  GET  /healthz            -> 200 'ok'
  GET  /stats              -> 200 JSON serving counters (requests/
                              frames/persons/rounds/calls totals,
                              request_errors, queue_depth, uptime_s,
                              avg/max frames coalesced per round)
  POST /predict            body: npz with either
                             frame  (H, W, 3) uint8   + boxes (N, 4) f32
                           or multi-frame pairs
                             frame_0, boxes_0, frame_1, boxes_1, ...
                           boxes are [cx, cy, w, h] (scale =
                           max_side / 200). A request without boxes asks
                           for server-side detection (start with
                           --detector yolo; 400 otherwise). Any frame
                           may instead come
                           ENCODED as frame_jpeg / frame_{i}_jpeg: a 1-D
                           uint8 buffer of JPEG or PNG bytes, decoded on
                           the server with OpenCV (400 where cv2 is not
                           installed).
                           With --camcalib_every N, the optional
                           X-Spec-Stream header names the client's video
                           stream: keyframe-camera state persists per
                           stream name across requests; without it,
                           amortization is scoped to the frames inside
                           the one request.
       response: npz with n_frames, and per person arrays named
                 f{frame}_p{person}_{key} for the SPEC outputs
                 (smpl_vertices, smpl_joints3d, smpl_joints2d,
                 pred_cam_t, pred_pose, pred_pose_6d, pred_shape,
                 pred_cam) plus f{frame}_camera = [vfov, pitch, roll,
                 f_pix] and f{frame}_n_persons.

Run: ``python -m spec_tpu_torch.cli.serve --port 8080 [--device cpu]``,
or ``... --exported model.specx`` to serve an artifact of
``spec_tpu_torch.cli.export_model``.

Example client:
    buf = io.BytesIO()
    np.savez(buf, frame=img, boxes=np.array([[320, 240, 100, 200]], 'f4'))
    r = urllib.request.urlopen('http://host:8080/predict', buf.getvalue())
    out = np.load(io.BytesIO(r.read()))
    out['f0_p0_smpl_vertices']        # (6890, 3)
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from spec_tpu_torch.cli._device import add_device_flag, resolve_device
from spec_tpu_torch.serving import EPHEMERAL_PREFIX


def _decode_jpeg(buf: np.ndarray) -> np.ndarray:
    """JPEG/PNG bytes (1-D uint8) -> RGB (H, W, 3) uint8."""
    try:
        import cv2
    except ImportError as e:
        raise ValueError('frame_jpeg needs OpenCV (cv2) on the server, '
                         'which is not installed; send raw uint8 frames '
                         "('frame' / 'frame_i')") from e
    img = cv2.imdecode(np.asarray(buf, np.uint8).reshape(-1),
                       cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError('frame_jpeg bytes did not decode as an image')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _decode_request(body: bytes):
    """-> (frames, boxes) where boxes is None when the request carries
    no box arrays at all (server-side detection)."""
    data = np.load(io.BytesIO(body), allow_pickle=False)
    if 'frame' in data or 'frame_jpeg' in data:
        frame = (_decode_jpeg(data['frame_jpeg'])
                 if 'frame_jpeg' in data else data['frame'])
        return [frame], ([data['boxes']] if 'boxes' in data else None)
    frames, boxes = [], []
    i = 0
    while f'frame_{i}' in data or f'frame_{i}_jpeg' in data:
        frames.append(_decode_jpeg(data[f'frame_{i}_jpeg'])
                      if f'frame_{i}_jpeg' in data
                      else data[f'frame_{i}'])
        if f'boxes_{i}' in data:
            boxes.append(data[f'boxes_{i}'])
        i += 1
    if not frames:
        raise ValueError("npz must contain 'frame'/'frame_jpeg'"
                         "[+'boxes'] or 'frame_0'[+'boxes_0'], ...")
    # Arrays past the contiguous frame_0..frame_{n-1} run would otherwise
    # be dropped silently (frame_2 without frame_1, a boxes_1 typo).
    def _idx(k: str):
        parts = k.split('_')
        return parts[1] if len(parts) >= 2 else ''

    orphans = sorted(
        k for k in data.files
        if (k.startswith('frame_') or k.startswith('boxes_'))
        and k != 'frame_jpeg'
        and not (_idx(k).isdigit() and int(_idx(k)) < len(frames)))
    if orphans:
        raise ValueError(
            f'arrays {orphans} do not match any frame_0..'
            f'frame_{len(frames) - 1}; frame indices must be contiguous '
            'from 0 and every boxes_i needs its frame_i')
    if boxes and len(boxes) != len(frames):
        raise ValueError('either every frame_i needs a boxes_i or none '
                         f'may have one (got {len(boxes)} boxes arrays '
                         f'for {len(frames)} frames)')
    return frames, (boxes or None)


def _encode_response(results, cameras) -> bytes:
    out = {'n_frames': np.asarray(len(results), np.int32)}
    for fi, persons in enumerate(results):
        cam = cameras[fi]
        # Every frame has a camera, also one without persons.
        out[f'f{fi}_camera'] = np.asarray(
            [cam.get('vfov', 0.0), cam.get('pitch', 0.0),
             cam.get('roll', 0.0), cam.get('f_pix', 0.0)], np.float32)
        out[f'f{fi}_n_persons'] = np.asarray(len(persons), np.int32)
        for pi, person in enumerate(persons):
            for k, v in person.items():
                if k != 'camera':
                    out[f'f{fi}_p{pi}_{k}'] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


class _Batcher:
    """Adaptive micro-batching for concurrent requests.

    Every device call runs on ONE dispatcher thread; requests that
    arrive while the device is busy coalesce into a single
    ``predict(return_cameras=True)`` call of at most ``max_frames``
    frames (a request that would overshoot waits for the next round).
    No wait window: an idle server dispatches at once. Requests with and
    without boxes go to separate calls.

    If a coalesced call fails with more than one member, each request is
    retried alone, so one bad input cannot fail its neighbours.

    With ``camcalib_every > 1`` on the predictor, a round makes one call
    per named stream (``X-Spec-Stream``), its requests in arrival order,
    so a stream's keyframe counter never interleaves with other clients'
    frames. Requests without a stream name run as one-shot ephemeral
    streams (amortized within the request, no state kept), except when
    ``max_frames == 1`` (strictly sequential rounds), where they share
    the predictor's default stream across requests.

    The counters of GET /stats are updated under a lock: handler threads
    count submitted requests, the dispatcher thread the rest.
    """

    _STOP = object()

    def __init__(self, predictor, max_frames: int = 0):
        self.pred = predictor
        self.max_frames = int(max_frames or predictor.batch_size)
        self._q: queue.Queue = queue.Queue()
        self._stopped = False
        self._eph = 0
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.counters = {
            'requests_total': 0,     # submitted requests
            'request_errors': 0,     # requests answered with an error
            'frames_total': 0,       # frames through the predictor
            'persons_total': 0,      # person results returned
            'rounds_total': 0,       # dispatcher rounds (drain calls)
            'calls_total': 0,        # predictor calls (groups)
            'max_round_frames': 0,   # best coalescing seen
        }
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name='spec-serve-batcher')
        self._thread.start()

    def stats(self) -> dict:
        """Snapshot for GET /stats (monotonic counters + derived)."""
        with self._lock:
            c = dict(self.counters)
        c['uptime_s'] = round(time.time() - self.started_at, 3)
        c['queue_depth'] = self._q.qsize()
        c['avg_round_frames'] = round(
            c['frames_total'] / c['rounds_total'], 3) if c['rounds_total'] else 0.0
        return c

    def submit(self, frames, boxes, stream=None):
        """Blocking: returns (cameras, results) for this request only."""
        if self._stopped:
            raise RuntimeError('server is shutting down')
        self._bump(requests_total=1)
        item = {'frames': frames, 'boxes': boxes, 'stream': stream,
                'ev': threading.Event()}
        self._q.put(item)
        if self._stopped:
            # Raced with stop(): the dispatcher may never drain the queue
            # again, so fail pending items here (get_nowait is atomic:
            # each item errors exactly once).
            self._reject_pending()
        item['ev'].wait()
        if 'error' in item:
            raise item['error']
        return item['cameras'], item['results']

    def stop(self):
        self._stopped = True
        self._q.put(self._STOP)
        self._thread.join(timeout=30)
        self._reject_pending()

    def _reject_pending(self):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is self._STOP:
                continue
            item['error'] = RuntimeError('server is shutting down')
            item['ev'].set()

    # -- dispatcher side ----------------------------------------------------

    def _loop(self):
        carry = None      # request popped but deferred by the frame cap
        try:
            while True:
                first = carry if carry is not None else self._q.get()
                carry = None
                if first is self._STOP:
                    return
                batch = [first]
                n = len(first['frames'])
                while n < self.max_frames:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is self._STOP:
                        self._drain(batch)
                        return
                    if n + len(nxt['frames']) > self.max_frames:
                        carry = nxt    # would overshoot the cap: next round
                        break
                    batch.append(nxt)
                    n += len(nxt['frames'])
                self._drain(batch)
        finally:
            # Nothing will service the queue again: fail fast instead of
            # leaving submitters blocked.
            self._stopped = True
            if carry is not None and not carry['ev'].is_set():
                carry['error'] = RuntimeError('server is shutting down')
                carry['ev'].set()
            self._reject_pending()

    def _call(self, frames, boxes, stream=None, ephemeral=False):
        # predict(return_cameras=True) returns the cameras it used; a
        # separate estimate_cameras() pass would run stage 1 on every
        # frame and defeat camcalib_every.
        try:
            results, cameras = self.pred.predict(
                frames, boxes, stream=stream, return_cameras=True)
        finally:
            if ephemeral:
                # One-shot stream: no state may outlive this request.
                self.pred.reset_camera_stream(stream=stream)
        return cameras, results

    def _bump(self, **kw):
        """Advance serving counters; a no-op on instances built without
        __init__ (unit tests drive _drain directly)."""
        c = getattr(self, 'counters', None)
        if c is None:
            return
        with self._lock:
            for k, v in kw.items():
                c[k] = max(c[k], v) if k == 'max_round_frames' else c[k] + v

    def _ephemeral_key(self) -> str:
        # Only the dispatcher thread allocates these.
        n = getattr(self, '_eph', 0)
        self._eph = n + 1
        return f'{EPHEMERAL_PREFIX}ephemeral-{n}'

    def _drain(self, batch):
        """One round: service ``batch`` in one predictor call per
        (box mode, stream) group, splitting results back out."""
        n_round = sum(len(b['frames']) for b in batch)
        self._bump(rounds_total=1, frames_total=n_round,
                   max_round_frames=n_round)
        every = int(getattr(self.pred, 'camcalib_every', 1) or 1)
        groups = []   # (members, stream_key, ephemeral)
        if every <= 1:
            for has_boxes in (True, False):
                g = [b for b in batch
                     if (b['boxes'] is not None) is has_boxes]
                if g:
                    groups.append((g, None, False))
        else:
            # A stream's requests reach the predictor in arrival order
            # (the stride counter and cut signatures are sequential), so
            # a stream coalesces only contiguous same-box-mode runs.
            default_persistent = self.max_frames == 1
            by_stream: dict = {}
            order = []
            for b in batch:
                sid = b.get('stream')
                if sid is None and not default_persistent:
                    groups.append(([b], self._ephemeral_key(), True))
                    continue
                if sid not in by_stream:
                    by_stream[sid] = []
                    order.append(sid)
                by_stream[sid].append(b)
            for sid in order:
                run = []
                for b in by_stream[sid]:
                    if run and ((b['boxes'] is not None)
                                != (run[-1]['boxes'] is not None)):
                        groups.append((run, sid, False))
                        run = []
                    run.append(b)
                groups.append((run, sid, False))
        for group, stream, ephemeral in groups:
            has_boxes = group[0]['boxes'] is not None
            frames = [f for b in group for f in b['frames']]
            boxes = ([bx for b in group for bx in b['boxes']]
                     if has_boxes else None)
            try:
                cameras, results = self._call(frames, boxes, stream,
                                              ephemeral)
                self._bump(calls_total=1,
                           persons_total=sum(len(r) for r in results))
            except Exception as exc:
                self._bump(calls_total=1)
                if len(group) == 1:
                    # A solo retry would repeat the identical failure.
                    self._bump(request_errors=1)
                    group[0]['error'] = exc
                    group[0]['ev'].set()
                    continue
                for b in group:
                    try:
                        b['cameras'], b['results'] = self._call(
                            b['frames'], b['boxes'], stream, ephemeral)
                        self._bump(calls_total=1, persons_total=sum(
                            len(r) for r in b['results']))
                    except Exception as e:
                        self._bump(calls_total=1, request_errors=1)
                        b['error'] = e
                    b['ev'].set()
                continue
            i = 0
            for b in group:
                k = len(b['frames'])
                b['cameras'] = cameras[i:i + k]
                b['results'] = results[i:i + k]
                i += k
                b['ev'].set()


def create_server(predictor, host: str = '0.0.0.0', port: int = 8080,
                  max_request_bytes: int = 512 * 1024 * 1024,
                  max_batch_frames: int = 0):
    """ThreadingHTTPServer serving ``predictor``. Device work is owned by
    one dispatcher thread that micro-batches concurrent requests
    (:class:`_Batcher`; ``max_batch_frames`` caps the frames of a round,
    0 = the predictor's batch_size). Requests above ``max_request_bytes``
    are refused with 413 before being read. ``shutdown()`` and
    ``server_close()`` also stop the dispatcher."""
    batcher = None   # bound once the socket is up

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _send(self, code, body, ctype='application/octet-stream'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, msg):
            self._send(code, json.dumps({'error': msg}).encode(),
                       'application/json')

        def do_GET(self):
            if self.path == '/healthz':
                self._send(200, b'ok', 'text/plain')
            elif self.path == '/stats':
                self._send(200, json.dumps(batcher.stats()).encode(),
                           'application/json')
            else:
                self._send(404, b'not found', 'text/plain')

        def do_POST(self):
            if self.path != '/predict':
                self._send(404, b'not found', 'text/plain')
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                if n > max_request_bytes:
                    self._error(413, f'payload {n} bytes exceeds limit '
                                     f'{max_request_bytes}')
                    return
                frames, boxes = _decode_request(self.rfile.read(n))
            except Exception as e:      # malformed payload -> client error
                self._error(400, str(e))
                return
            if boxes is None and getattr(predictor, 'detector',
                                         None) is None:
                self._error(400, 'request has no boxes and the server was '
                                 'started without --detector')
                return
            try:
                stream = self.headers.get('X-Spec-Stream') or None
                cameras, results = batcher.submit(frames, boxes, stream)
                self._send(200, _encode_response(results, cameras))
            except Exception as e:      # predictor failure -> server error
                self._error(500, str(e))

    # Server first: if the bind fails, no dispatcher thread is started.
    server = ThreadingHTTPServer((host, port), Handler)
    batcher = _Batcher(predictor, max_frames=max_batch_frames)
    server.batcher = batcher
    _orig_shutdown = server.shutdown
    _orig_close = server.server_close

    def _shutdown():
        _orig_shutdown()
        batcher.stop()

    def _close():
        _orig_close()
        batcher.stop()

    server.shutdown = _shutdown
    server.server_close = _close
    return server


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='SPEC HTTP serving (two-stage predictor, PyTorch)')
    parser.add_argument('--host', type=str, default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--spec_ckpt', type=str, default='')
    parser.add_argument('--camcalib_ckpt', type=str, default='')
    parser.add_argument('--smpl_model_dir', type=str, default='')
    parser.add_argument('--cfg', type=str, default='',
                        help='model config yaml shipped with the ckpt')
    parser.add_argument('--batch_size', type=int, default=None,
                        help='pad ceiling per stage batch (default 32)')
    parser.add_argument('--min_size', type=int, default=600,
                        help='stage-1 (CamCalib) min-side resize bucket; '
                             'smaller buckets trade accuracy for '
                             'throughput: pair with a checkpoint '
                             'fine-tuned at that bucket')
    parser.add_argument('--camcalib_every', type=int, default=1,
                        help='stage-1 stream amortization: run CamCalib '
                             'only on every Nth frame PER STREAM and '
                             'reuse the latest keyframe camera; hard '
                             'shot cuts re-anchor automatically '
                             '(histogram-delta trigger). Streams are '
                             'keyed by the X-Spec-Stream request header '
                             "(state persists across that client's "
                             'requests, LRU-capped); requests without '
                             'the header amortize only within their own '
                             'frames and never evict a named stream. '
                             'With --max_batch_frames 1 (sequential '
                             'single-client serving), header-less '
                             'requests share the default stream')
    parser.add_argument('--cut_threshold', type=float, default=0.5,
                        help='shot-cut re-anchor sensitivity for '
                             '--camcalib_every streams (gray-histogram '
                             'L1 delta; raise for strobe/flash footage, '
                             '0 disables the trigger)')
    parser.add_argument('--max_request_mb', type=int, default=512,
                        help='reject request bodies above this size')
    parser.add_argument('--max_batch_frames', type=int, default=0,
                        help='cap on frames micro-batched per device '
                             'round across concurrent requests '
                             '(0 = batch_size)')
    parser.add_argument('--detector', type=str, default='',
                        choices=['', 'yolo'],
                        help="'yolo' serves box-less requests with the "
                             'in-process YOLOv3 (--yolo_weights)')
    parser.add_argument('--yolo_weights', type=str, default='',
                        help='official darknet yolov3.weights path')
    parser.add_argument('--yolo_img_size', type=int, default=416,
                        help='detector letterbox size (multiple of 32)')
    parser.add_argument('--exported', type=str, default='',
                        help='serve from a .specx artifact (export_model; '
                             'ignores the ckpt, cfg, SMPL, min_size and '
                             'detector flags: the artifact is the model)')
    parser.add_argument('--data_parallel', action='store_true',
                        help='replicate the predictor on every card of '
                             'this process and split each batch over '
                             'them (--batch_size a multiple of the count)')
    add_device_flag(parser)
    g = parser.add_argument_group(
        'reference flags not ported yet (each raises NotImplementedError)')
    g.add_argument('--spatial_parallel', action='store_true',
                   help='ROADMAP.md §1 item 12b')
    return parser.parse_args(argv)


def _unported(args) -> None:
    if args.spatial_parallel:
        from spec_tpu_torch.parallel import SPATIAL_NOT_PORTED

        raise NotImplementedError(SPATIAL_NOT_PORTED)


def build_predictor(args, device):
    """The predictor ``main`` serves, from parsed flags: the artifact of
    ``--exported``, or a live predictor."""
    from spec_tpu_torch.serving import SpecPredictor

    if args.exported:
        from spec_tpu_torch.export import load_predictor

        pred = load_predictor(args.exported, batch_size=args.batch_size,
                              device=device)
        # Stream amortization is a serving knob, not part of the model.
        pred.camcalib_every = max(1, args.camcalib_every)
        pred.cut_threshold = args.cut_threshold
        if args.data_parallel:
            print('[serve] --data_parallel does not apply to --exported: '
                  'the artifact runs on one device', flush=True)
        return pred
    return SpecPredictor(
        spec_ckpt=args.spec_ckpt, camcalib_ckpt=args.camcalib_ckpt,
        smpl_model_dir=args.smpl_model_dir, cfg_file=args.cfg,
        batch_size=args.batch_size or 32, min_size=args.min_size,
        detector=args.detector, yolo_weights=args.yolo_weights,
        yolo_img_size=args.yolo_img_size,
        camcalib_every=args.camcalib_every,
        cut_threshold=args.cut_threshold, device=device,
        data_parallel=args.data_parallel)


def main(argv=None):
    args = parse_args(argv)
    _unported(args)
    device = resolve_device(args.device, 'spec_tpu_torch.cli.serve')
    predictor = build_predictor(args, device)
    server = create_server(predictor, args.host, args.port,
                           max_request_bytes=args.max_request_mb * 2 ** 20,
                           max_batch_frames=args.max_batch_frames)
    print(f'[serve] listening on {args.host}:{server.server_address[1]} '
          f'({device})', flush=True)

    # SIGTERM (preemption, an orchestrator's stop) -> drain and exit 0.
    import signal

    def _term(signum, frame):
        print('[serve] SIGTERM received; shutting down', flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    print('[serve] stopped')


if __name__ == '__main__':
    main()
