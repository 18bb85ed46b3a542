"""YOLOv3 person detector (torch twin of ``spec_tpu/models/detector.py``).

The standard YOLOv3 graph (Darknet-53 trunk and three FPN heads) over
the same static layer table as the JAX module, which is the official
``yolov3.cfg`` order and so the darknet weight-file order:
:func:`load_darknet_weights` reads a released ``yolov3.weights`` buffer
straight into the model's ``state_dict`` (darknet kernels are already
OIHW). Parameter names are the flax module's: ``conv{i}`` and ``bn{i}``.
Convolutions go to cuDNN, NCHW inside; the decode is fp32.

:class:`YoloDetector` is the batched person detector of the serving
path: frames are letterboxed on their device (antialiased bilinear,
rounded to uint8, as :func:`ops.preprocess.resize_min_side`; the
reference letterboxes on the host with PIL), the forward and the
device-side top-K person filter run as one stage graph per (batch,
size) on a GPU, and only (B, topk, 5) candidates reach the host, where
the confidence filter and NMS run (numpy, tiny arrays).

No detector weights ship with the repository: with
``weights_path=None`` the network is a random init from ``seed``
(pipeline checks only).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spec_tpu_torch import parallel as par
from spec_tpu_torch.utils.batching import pad_pow2
from spec_tpu_torch.utils.graphs import StageGraph, device_constant
from spec_tpu_torch.utils.precision import compute_dtype

# ---------------------------------------------------------------------------
# Architecture table (a copy of the JAX module's). Entries:
#   ('conv', out_ch, kernel, stride, batchnorm)   leaky 0.1 iff batchnorm
#   ('shortcut', rel_offset)                      x = out[-1] + out[rel]
#   ('route', (rel_or_abs, ...))                  channel concat
#   ('upsample',)                                 2x nearest
#   ('yolo', (anchor, ...))                       detection head (raw in)
# ---------------------------------------------------------------------------

ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
           (116, 90), (156, 198), (373, 326))


def _res(blocks: int, mid: int, out: int) -> list:
    layers = []
    for _ in range(blocks):
        layers += [('conv', mid, 1, 1, True), ('conv', out, 3, 1, True),
                   ('shortcut', -3)]
    return layers


YOLOV3_LAYERS: tuple = tuple(
    [('conv', 32, 3, 1, True), ('conv', 64, 3, 2, True)]
    + _res(1, 32, 64)
    + [('conv', 128, 3, 2, True)] + _res(2, 64, 128)
    + [('conv', 256, 3, 2, True)] + _res(8, 128, 256)      # layer 36 = C3
    + [('conv', 512, 3, 2, True)] + _res(8, 256, 512)      # layer 61 = C4
    + [('conv', 1024, 3, 2, True)] + _res(4, 512, 1024)    # layer 74 = C5
    + [('conv', 512, 1, 1, True), ('conv', 1024, 3, 1, True),
       ('conv', 512, 1, 1, True), ('conv', 1024, 3, 1, True),
       ('conv', 512, 1, 1, True), ('conv', 1024, 3, 1, True),
       ('conv', 255, 1, 1, False), ('yolo', (6, 7, 8)),
       ('route', (-4,)), ('conv', 256, 1, 1, True), ('upsample',),
       ('route', (-1, 61)),
       ('conv', 256, 1, 1, True), ('conv', 512, 3, 1, True),
       ('conv', 256, 1, 1, True), ('conv', 512, 3, 1, True),
       ('conv', 256, 1, 1, True), ('conv', 512, 3, 1, True),
       ('conv', 255, 1, 1, False), ('yolo', (3, 4, 5)),
       ('route', (-4,)), ('conv', 128, 1, 1, True), ('upsample',),
       ('route', (-1, 36)),
       ('conv', 128, 1, 1, True), ('conv', 256, 3, 1, True),
       ('conv', 128, 1, 1, True), ('conv', 256, 3, 1, True),
       ('conv', 128, 1, 1, True), ('conv', 256, 3, 1, True),
       ('conv', 255, 1, 1, False), ('yolo', (0, 1, 2))]
)

NUM_CLASSES = 80  # COCO; person = class 0


class YoloV3(nn.Module):
    """YOLOv3 over the static layer table. Input (B, S, S, 3) in [0, 1]
    (NHWC, as the JAX module), S a multiple of 32. Returns float32
    (B, S²/32²·3·21, 85): decoded [cx, cy, w, h] in input pixels,
    objectness and 80 class probabilities (darknet decode).

    ``dtype``: the convolutions' and BatchNorms' compute dtype (bf16 by
    default, as the JAX detector). Darknet's stride-2 convs pad (p, p)
    explicitly, as ``nn.Conv2d(padding=(k - 1) // 2)`` does."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin, hist, conv_i = 3, [], 0
        for spec in YOLOV3_LAYERS:
            if spec[0] == 'conv':
                _, ch, k, s, has_bn = spec
                self.add_module(f'conv{conv_i}', nn.Conv2d(
                    cin, ch, k, stride=s, padding=(k - 1) // 2,
                    bias=not has_bn))
                if has_bn:
                    self.add_module(f'bn{conv_i}',
                                    nn.BatchNorm2d(ch, eps=1e-5))
                cin = ch
                conv_i += 1
            elif spec[0] == 'route':
                cin = sum(hist[i] for i in spec[1])
            hist.append(cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[1]
        outs: List[torch.Tensor] = []
        dets: List[torch.Tensor] = []
        x = x.permute(0, 3, 1, 2)
        conv_i = 0
        with compute_dtype(self.dtype, x.device.type):
            for spec in YOLOV3_LAYERS:
                kind = spec[0]
                if kind == 'conv':
                    x = getattr(self, f'conv{conv_i}')(x)
                    if spec[4]:
                        x = F.leaky_relu(getattr(self, f'bn{conv_i}')(x),
                                         0.1)
                    conv_i += 1
                elif kind == 'shortcut':
                    x = x + outs[spec[1]]
                elif kind == 'route':
                    srcs = [outs[i] for i in spec[1]]
                    x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, 1)
                elif kind == 'upsample':
                    x = F.interpolate(x, scale_factor=2, mode='nearest')
                elif kind == 'yolo':
                    dets.append(_decode_head(x, spec[1], size))
                outs.append(x)
        return torch.cat(dets, dim=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator: LeCun-normal kernels
        (the flax init's variance), BatchNorm identity statistics, zero
        biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _decode_head(raw: torch.Tensor, anchor_ids: Sequence[int],
                 input_size: int) -> torch.Tensor:
    """Darknet YOLO-layer decode: raw NCHW (B, 255, G, G) -> (B, G·G·3,
    85) float32, boxes in input pixels: cx = (sigmoid(tx) + gx) *
    stride, w = exp(tw) * anchor_w; independent class sigmoids. Rows are
    cell-major (row-major cells), anchors contiguous within a cell, as
    the JAX module's NHWC reshape gives them."""
    B, G = raw.shape[0], raw.shape[2]
    stride = input_size // G
    raw = raw.float().permute(0, 2, 3, 1).reshape(B, G, G, 3, 85)
    ar = torch.arange(G, dtype=torch.float32, device=raw.device)
    gy, gx = torch.meshgrid(ar, ar, indexing='ij')
    anchors = device_constant([ANCHORS[i] for i in anchor_ids], raw.device)
    xy = (torch.sigmoid(raw[..., :2])
          + torch.stack([gx, gy], -1)[:, :, None, :]) * stride
    wh = torch.exp(raw[..., 2:4]) * anchors
    conf = torch.sigmoid(raw[..., 4:])
    out = torch.cat([xy, wh, conf], dim=-1)
    return out.reshape(B, G * G * 3, 85)


# ---------------------------------------------------------------------------
# Darknet binary weights
# ---------------------------------------------------------------------------

def load_darknet_weights(state_dict: dict, data: bytes
                         ) -> Tuple['OrderedDict[str, torch.Tensor]', int]:
    """An official darknet ``.weights`` buffer -> a copy of ``state_dict``
    (a :class:`YoloV3`'s) with its weights.

    Format (darknet ``parser.c``): three int32 (major, minor, revision),
    a seen counter (int64 if major * 10 + minor >= 2, else int32), then
    float32s. Per conv layer in cfg order: [bn bias, bn scale, running
    mean, running var] with batch norm, else [conv bias]; then the
    kernel, OIHW. Returns (state_dict, floats consumed); raises
    ValueError on a short buffer or left-over floats."""
    header = np.frombuffer(data[:12], dtype='<i4')
    major, minor = int(header[0]), int(header[1])
    off = 12 + (8 if major * 10 + minor >= 2 else 4)
    buf = np.frombuffer(data[off:], dtype='<f4')
    pos = 0

    def take(n, like):
        nonlocal pos
        if pos + n > buf.size:
            raise ValueError(
                f'darknet weight file too short: need {pos + n} floats, '
                f'have {buf.size}')
        out = torch.from_numpy(buf[pos:pos + n].copy()).reshape(like.shape)
        pos += n
        return out.to(like.dtype)

    out = OrderedDict((k, v.clone()) for k, v in state_dict.items())
    conv_i = 0
    for spec in YOLOV3_LAYERS:
        if spec[0] != 'conv':
            continue
        w = out[f'conv{conv_i}.weight']
        cout = w.shape[0]
        if spec[4]:
            for name in ('bias', 'weight', 'running_mean', 'running_var'):
                key = f'bn{conv_i}.{name}'
                out[key] = take(cout, out[key])
        else:
            key = f'conv{conv_i}.bias'
            out[key] = take(cout, out[key])
        out[f'conv{conv_i}.weight'] = take(w.numel(), w)
        conv_i += 1
    if pos != buf.size:
        raise ValueError(
            f'darknet weight file has {buf.size - pos} unread floats '
            f'(expected an exact fit for YOLOv3)')
    return out, pos


# ---------------------------------------------------------------------------
# Letterbox (device), candidates (device), NMS (host)
# ---------------------------------------------------------------------------

def letterbox(img: torch.Tensor, size: int = 416,
              pad_value: float = 0.5) -> Tuple[torch.Tensor, float, float,
                                               float]:
    """(H, W, 3) frame (uint8, or float in [0, 255], truncated to uint8
    as the reference does) on any device -> ((size, size, 3) float32 in
    [0, 1] on that device, scale, pad_x, pad_y): the aspect kept, the
    frame resized with the antialiased bilinear filter and rounded to
    uint8 (within one uint8 level of the reference's PIL resize), then
    centred on a ``pad_value`` canvas. Detections map back as ``orig =
    (pred - pad) / scale``."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    px, py = (size - nw) // 2, (size - nh) // 2
    u8 = img if img.dtype == torch.uint8 else img.to(torch.uint8)
    if (nh, nw) == (h, w):
        resized = u8
    else:
        x = u8.permute(2, 0, 1)[None].float()
        resized = F.interpolate(x, size=(nh, nw), mode='bilinear',
                                align_corners=False, antialias=True)
        resized = resized.round().clamp(0, 255).to(torch.uint8)[0].permute(
            1, 2, 0)
    out = torch.full((size, size, 3), pad_value, dtype=torch.float32,
                     device=img.device)
    out[py:py + nh, px:px + nw] = resized.float() / 255.0
    return out, scale, float(px), float(py)


def top_person_candidates(dets: torch.Tensor, k: int = 256) -> torch.Tensor:
    """(B, N, 85) decoded rows -> (B, min(k, N), 5) [cx, cy, w, h,
    obj * P(person)], by score descending, on the device: only NMS-sized
    data crosses to the host."""
    score = dets[..., 4] * dets[..., 5]
    top, idx = torch.topk(score, min(k, score.shape[-1]), dim=-1)
    boxes = torch.gather(dets[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    return torch.cat([boxes, top[..., None]], dim=-1)


def nms_person(dets: np.ndarray, conf_thresh: float = 0.7,
               nms_thresh: float = 0.4) -> np.ndarray:
    """Person-class confidence filter + greedy IoU NMS (host numpy).

    ``dets``: (N, 85) decoded rows or (N, 5) rows of
    :func:`top_person_candidates`; score = obj * P(person). Returns
    (M, 5) [cx, cy, w, h, score] by score descending."""
    score = (dets[:, 4] if dets.shape[1] == 5
             else dets[:, 4] * dets[:, 5])
    keep = score > conf_thresh
    if not keep.any():
        return np.zeros((0, 5), np.float32)
    boxes = dets[keep, :4].astype(np.float32)
    score = score[keep].astype(np.float32)
    order = np.argsort(-score)
    boxes, score = boxes[order], score[order]
    x1 = boxes[:, 0] - boxes[:, 2] / 2
    y1 = boxes[:, 1] - boxes[:, 3] / 2
    x2 = boxes[:, 0] + boxes[:, 2] / 2
    y2 = boxes[:, 1] + boxes[:, 3] / 2
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    picked = []
    alive = np.ones(len(boxes), bool)
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        picked.append(i)
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        iou = inter / np.maximum(area[i] + area - inter, 1e-9)
        alive &= iou <= nms_thresh
        alive[i] = False
    out = np.concatenate([boxes[picked], score[picked, None]], axis=1)
    return out.astype(np.float32)


def square_cxcywh(boxes: np.ndarray) -> np.ndarray:
    """(N, >=4) [cx, cy, w, h] -> square boxes of side max(w, h), the
    convention of the crop path (scale = side / 200 downstream)."""
    if boxes.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    side = np.maximum(boxes[:, 2], boxes[:, 3])
    return np.stack([boxes[:, 0], boxes[:, 1], side, side],
                    axis=1).astype(np.float32)


def _detect_forward(model: YoloV3, topk: int,
                    batch: torch.Tensor) -> torch.Tensor:
    """The detector's stage body: (B, S, S, 3) letterboxed batch ->
    (B, topk, 5) person candidates."""
    return top_person_candidates(model(batch), k=topk)


class YoloDetector:
    """Persistent batched person detector: frames in, square ``[cx, cy,
    w, h]`` person boxes per frame out.

    Frames (numpy HWC arrays, or tensors already on the device) are
    letterboxed on ``device`` and stacked into batches of
    ``batch_size``; a tail batch pads to the next power of two (at most
    log2(batch_size) + 1 shapes), so a one-frame call does not pay a
    full batch. On a GPU the forward and the top-K filter replay one
    CUDA graph per (batch, size) (``utils/graphs.StageGraph``, the
    counterpart of the reference's ``jax.jit``); on the CPU they run
    eagerly. ``conf_thresh`` and ``nms_thresh`` are host-only and may be
    overridden per call. ``dtype``: the convolutions' compute dtype
    (bf16, as the reference). ``mesh``: a list of local devices, the
    first ``device`` (``parallel.create_mesh``); the detector then runs
    as one replica per device, each with its graphs, every batch split
    into one equal part per device (``parallel.ReplicatedStage``).
    ``batch_size`` must divide over the mesh; tail batches pad to a
    multiple of its size."""

    def __init__(self, weights_path: Optional[str] = None,
                 img_size: int = 416, batch_size: int = 8,
                 conf_thresh: float = 0.7, nms_thresh: float = 0.4,
                 topk: int = 256, seed: int = 0, mesh=None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = 'cuda', pool=None):
        if img_size % 32:
            raise ValueError('img_size must be a multiple of 32')
        self._min_pad = 1
        if mesh is not None:
            if int(batch_size) % len(mesh):
                raise ValueError(
                    f'detector batch_size {batch_size} must be a multiple '
                    f'of the {len(mesh)}-device mesh')
            self._min_pad = len(mesh)
            device = mesh[0]
        self.img_size = int(img_size)
        self.batch_size = int(batch_size)
        self.conf_thresh = float(conf_thresh)
        self.nms_thresh = float(nms_thresh)
        self.device = torch.device(device)
        self.model = YoloV3(dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        if weights_path is not None:
            with open(weights_path, 'rb') as f:
                sd, _ = load_darknet_weights(self.model.state_dict(),
                                             f.read())
            self.model.load_state_dict(sd)
        self.model = self.model.to(self.device).eval()
        self._fwd = StageGraph('detector', functools.partial(
            _detect_forward, self.model, int(topk)), pool)
        if mesh is not None and len(mesh) > 1:
            models = par.replicate(self.model, mesh)
            self._fwd = par.ReplicatedStage(
                [self._fwd] + [StageGraph('detector', functools.partial(
                    _detect_forward, m, int(topk)),
                    pool if d == self.device else None)
                    for m, d in zip(models[1:], mesh[1:])], mesh)

    def _to_device(self, frame) -> torch.Tensor:
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        elif not arr.flags.writeable:        # e.g. a PIL image's buffer
            arr = arr.copy()
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.inference_mode()
    def detect_dispatch(self, frames: Sequence) -> list:
        """Letterbox and queue every detector batch without fetching, so
        a caller can queue other device work behind it before
        :meth:`detect_fetch`. Returns the pending batches."""
        pending = []
        B, S = self.batch_size, self.img_size
        for start in range(0, len(frames), B):
            chunk = [self._to_device(f) for f in frames[start:start + B]]
            boxed = [letterbox(f, S) for f in chunk]
            bp = pad_pow2(len(chunk), B)
            # under a mesh, every replica's part is non-empty
            bp = par.pad_to_multiple(bp, self._min_pad)
            batch = torch.zeros((bp, S, S, 3), dtype=torch.float32,
                                device=self.device)
            batch[:len(chunk)] = torch.stack([b[0] for b in boxed])
            pending.append(([b[1:] for b in boxed], self._fwd(batch)))
        return pending

    def detect_fetch(self, pending: list,
                     conf_thresh: Optional[float] = None,
                     nms_thresh: Optional[float] = None) -> List[np.ndarray]:
        """Fetch the dispatched candidates and finish on the host:
        confidence filter, NMS, back to frame pixels, square boxes."""
        conf = self.conf_thresh if conf_thresh is None else conf_thresh
        nms = self.nms_thresh if nms_thresh is None else nms_thresh
        results: List[np.ndarray] = []
        for params, dets_dev in pending:
            dets = dets_dev.cpu().numpy()
            for i, (scale, px, py) in enumerate(params):
                kept = nms_person(dets[i], conf, nms)
                kept[:, 0] = (kept[:, 0] - px) / scale
                kept[:, 1] = (kept[:, 1] - py) / scale
                kept[:, 2:4] = kept[:, 2:4] / scale
                results.append(square_cxcywh(kept))
        return results

    def detect(self, frames: Sequence,
               conf_thresh: Optional[float] = None,
               nms_thresh: Optional[float] = None) -> List[np.ndarray]:
        return self.detect_fetch(self.detect_dispatch(frames),
                                 conf_thresh, nms_thresh)
