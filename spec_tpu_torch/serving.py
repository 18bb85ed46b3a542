"""In-process serving engine: persistent two-stage SPEC predictor on a
torch device (port of ``spec_tpu/serving.py``).

numpy frames (and person boxes, or the in-process YOLOv3 detector's) in,
per-person SMPL results out. Both models stay on the device across
calls. Each frame is uploaded once; the
stage-1 resize and normalization, the stage-2 SPIN crops and the SMPL
forward (through the fused LBS CUDA kernel on a GPU) all run on the
device. Stage-1 and stage-2 batches are padded to a power of two (capped
at ``batch_size``), and every stage-2 chunk is queued before any result
is fetched. On a GPU each stage replays a CUDA graph captured once per
padded shape (``utils/graphs.py``), the counterpart of the reference's
jitted ``_cam_forward`` and ``_spec_forward``. The resize (one call per
frame size), the crops (one call per frame size in a chunk), the uploads
and the fetches stay outside the graphs.

While a profiler runs, a call is a tree of ``profiling.annotate`` spans:
the root ``predict`` (``estimate_cameras``) with the children
``predict/upload``, ``predict/detect``, ``predict/keyframes``,
``predict/stage1_inputs``, ``predict/stage1_fetch``,
``predict/work_list``, ``predict/stage2_inputs``,
``predict/stage2_fetch`` and ``predict/results``, and the stages'
``graph/stage1/...`` and ``graph/stage2/...`` spans beside them.

Example:
    predictor = SpecPredictor(spec_ckpt=..., camcalib_ckpt=...,
                              device='cuda')
    results = predictor.predict(frames, boxes)   # len(frames) lists
    results[0][0]['smpl_vertices']               # (6890, 3)
"""

from __future__ import annotations

import copy
import dataclasses
import os
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from spec_tpu_torch import parallel as par
from spec_tpu_torch.core import bins
from spec_tpu_torch.core import geometry as G
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.data.detection import bbox_to_center_scale
from spec_tpu_torch.models.backbones.fused_resnet import inference_trunk
from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
from spec_tpu_torch.models.hmr import HMR, default_img_res
from spec_tpu_torch.ops.preprocess import (
    crop_resize_normalize,
    normalize_u8,
    resize_min_side,
    spin_crop_corners,
)
from spec_tpu_torch.utils import paths, profiling
from spec_tpu_torch.utils.batching import pad_pow2
from spec_tpu_torch.utils.checkpoints import (
    hmr_state_dict,
    load_checkpoint_variables,
    load_torch_state_dict,
    select_state_dict,
)
from spec_tpu_torch.utils.graphs import StageGraph

# Stream names that start with this are one-shot streams (the HTTP
# server's, for requests without X-Spec-Stream); '\x00' cannot occur in
# an HTTP header value, so no client-chosen name starts with it.
EPHEMERAL_PREFIX = '\x00'


def frame_signature(frame: np.ndarray, bins: int = 32,
                    max_side: int = 64) -> np.ndarray:
    """Cheap per-frame signature for shot-cut detection: a normalized
    gray histogram of a strided ~``max_side``-px downsample. Reads only
    the strided pixels, O(``max_side``^2) whatever the frame's size, and
    takes the channel mean of those alone: the same values as the full
    frame's mean strided afterwards."""
    a = np.asarray(frame)
    step = max(1, -(-max(a.shape[:2]) // max_side))
    a = a[::step, ::step]
    if a.ndim == 3:
        a = a.mean(axis=2)
    hist, _ = np.histogram(a, bins=bins, range=(0.0, 256.0))
    return hist.astype(np.float32) / max(int(hist.sum()), 1)


def cut_score(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    """L1 distance between two :func:`frame_signature` vectors, in
    [0, 2]. Hard cuts land well above 0.5; pans/jitter stay near 0."""
    return float(np.abs(np.asarray(sig_a) - np.asarray(sig_b)).sum())


class KeyframeSelector:
    """The ``camcalib_every`` keyframe rule: frame i is a stage-1
    keyframe iff ``i % every == 0`` OR its :func:`frame_signature` delta
    vs the previous readable frame exceeds ``cut_threshold`` (0 disables
    the trigger). ``is_keyframe(sig)`` consumes one frame's signature (or
    None when unreadable) and advances the counter; an unreadable frame
    keeps the previous signature."""

    def __init__(self, every: int, cut_threshold: float = 0.5,
                 start_index: int = 0, prev_sig=None):
        self.every = max(1, int(every))
        self.cut_threshold = float(cut_threshold or 0.0)
        self.i = int(start_index)
        self.prev_sig = prev_sig

    def is_keyframe(self, sig=None) -> bool:
        key = self.i % self.every == 0
        if (not key and self.cut_threshold > 0.0 and sig is not None
                and self.prev_sig is not None
                and cut_score(self.prev_sig, sig) > self.cut_threshold):
            key = True
        if sig is not None:
            self.prev_sig = sig
        self.i += 1
        return key


def _cam_forward(camcalib, loss_type: str, batch_u8: torch.Tensor,
                 trunk=None):
    """Stage 1 on one padded bucket of resized uint8 frames (B, H, W, 3):
    normalize, CamCalib (its backbone, or ``trunk`` in its place), bin
    decode -> (vfov, pitch, roll logits (B, 256) each, angles (3, B) =
    (vfov, pitch, roll)). The predictor keeps the angles;
    ``camcalib_demo`` also plots the logits."""
    return _cam_outputs(camcalib(normalize_u8(batch_u8), trunk=trunk),
                        loss_type)


def _cam_outputs(logits, loss_type: str):
    """Stage 1's outputs from CamCalib's logits: the logits and the
    angles (3, B) of their bin decode."""
    return (*logits, torch.stack(bins.convert_preds_to_angles(
        *logits, loss_type=loss_type)))


def _normalize_nchw(tile_u8: torch.Tensor) -> torch.Tensor:
    """``normalize_u8`` of an NCHW view of uint8 frames, as an NCHW
    (channels_last) view: spatial_parallel's bands normalize their own
    rows."""
    return normalize_u8(tile_u8.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _spec_forward(spec, assets, crops, rotmat, K, bbox_scale, bbox_center,
                  img_w, img_h, trunk=None) -> dict:
    """Stage 2 on one padded chunk of normalized crops: HMR (its
    backbone, or ``trunk`` in its place), SMPL through K1 and the camera
    (``HMR.forward``'s outputs)."""
    return spec(assets, crops, rotmat, K, bbox_scale, bbox_center, img_w,
                img_h, trunk=trunk)


class _FoldedTrunk(nn.Module):
    """A stage module's trunk for inference. Where the model's backbone
    is a Bottleneck ResNet computing in float32, the stage holds its
    folded form
    (:func:`~spec_tpu_torch.models.backbones.fused_resnet.
    inference_trunk`: BatchNorm folded into every conv, NCHW cuDNN
    convolutions) as ``trunk`` and
    runs it in the backbone's place whenever the model is in eval mode
    and autograd is off; otherwise (training, gradients, other
    backbones and dtypes, models made under inference mode) the
    backbone runs.
    :meth:`refresh` refolds after the model's weights change; the stage
    graph calls it before every call. The model itself, its
    ``state_dict`` and checkpoints, are untouched."""

    def _init_trunk(self, name: str) -> None:
        self._model_name = name
        self.trunk = inference_trunk(getattr(self, name))

    def _trunk_for(self, model: nn.Module):
        if (self.trunk is None or model.training
                or torch.is_grad_enabled()):
            return None
        return self.trunk.nchw

    def refresh(self) -> None:
        if self.trunk is not None:
            self.trunk.refresh()

    def exported(self) -> nn.Module:
        """The module ``export.py`` traces: this stage, or, where it runs
        a folded trunk, a shallow copy whose model holds no backbone (the
        traced forward reads only the folded weights, refolded here from
        the model's current ones, and a program stores every weight of
        the module it traces)."""
        if self.trunk is None:
            return self
        self.refresh()
        model = copy.copy(getattr(self, self._model_name))
        model._modules = dict(model._modules, backbone=None)
        stage = copy.copy(self)
        stage._modules = dict(self._modules, **{self._model_name: model})
        return stage


class CamStage(_FoldedTrunk):
    """Stage 1 as a module: :func:`_cam_forward` over ``camcalib``, with
    its folded trunk where it has one (:class:`_FoldedTrunk`). The live
    predictor's stage-1 graph runs it, and ``export.py`` exports this
    same module, so the two bodies cannot drift apart."""

    def __init__(self, camcalib: nn.Module, loss_type: str):
        super().__init__()
        self.camcalib = camcalib
        self.loss_type = loss_type
        self._init_trunk('camcalib')

    def forward(self, batch_u8: torch.Tensor):
        return _cam_forward(self.camcalib, self.loss_type, batch_u8,
                            trunk=self._trunk_for(self.camcalib))


class SpecStage(_FoldedTrunk):
    """Stage 2 as a module: :func:`_spec_forward` over ``spec``, with its
    folded trunk where it has one (:class:`_FoldedTrunk`).

    The SMPL tensors that the fused forward reads (K1's packed operands
    and the extra-joint regressor) are buffers of this module, so
    ``torch.export`` stores them with the weights and a loaded program
    moves them to its device; the assets' other fields (the kinematic
    tree, the extra vertex ids) are Python values traced as constants.
    Like :class:`CamStage`, the live predictor and ``export.py`` share
    it."""

    def __init__(self, spec: nn.Module, assets: S.SMPLAssets):
        super().__init__()
        if assets.packed_lbs is None:
            raise ValueError('SpecStage needs assets with packed LBS '
                             'operands (core.smpl.with_packed_lbs)')
        self.spec = spec
        self._assets = assets
        self._init_trunk('spec')
        packed = assets.packed_lbs
        self.register_buffer('lbs_dirs', packed.dirs)
        self.register_buffer('lbs_weights_t', packed.weights_t)
        self.register_buffer('lbs_joints_template', packed.joints_template)
        self.register_buffer('lbs_shapedirs_j', packed.shapedirs_j)
        self.register_buffer('j_regressor_extra', assets.j_regressor_extra)

    def assets(self) -> S.SMPLAssets:
        """The assets with this module's buffers in place of theirs."""
        packed = dataclasses.replace(
            self._assets.packed_lbs, dirs=self.lbs_dirs,
            weights_t=self.lbs_weights_t,
            joints_template=self.lbs_joints_template,
            shapedirs_j=self.lbs_shapedirs_j)
        return dataclasses.replace(self._assets, packed_lbs=packed,
                                   j_regressor_extra=self.j_regressor_extra)

    def forward(self, crops, rotmat, K, bbox_scale, bbox_center, img_w,
                img_h) -> dict:
        return _spec_forward(self.spec, self.assets(), crops, rotmat, K,
                             bbox_scale, bbox_center, img_w, img_h,
                             trunk=self._trunk_for(self.spec))


def build_camcalib(ckpt: str, backbone: str, device, dtype=None,
                   seed: int = 0, tag: str = 'serving'):
    """Stage 1's CameraRegressorNetwork (one FC layer) with ``ckpt``'s
    weights, or, when the file is missing, a random init from ``seed``
    with a warning; on ``device``, in eval mode."""
    model = CameraRegressorNetwork(backbone=backbone, num_fc_layers=1,
                                   dtype=dtype or torch.float32)
    if os.path.exists(ckpt):
        model.load_state_dict(select_state_dict(load_torch_state_dict(ckpt),
                                                model))
    else:
        print(f'[{tag}] WARNING: camcalib ckpt {ckpt} missing; random init')
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_hmr(ckpt: str, device, cfg_file: str = '',
              backbone: str = 'resnet50', use_cam_feats: bool = False,
              img_res: Optional[int] = None, dtype=None, seed: int = 1,
              tag: str = 'serving', remat: bool = False,
              head: str = 'hmr'):
    """Stage 2's HMR (camera-aware) with ``ckpt``'s weights (a reference
    torch file, or a trainer checkpoint directory: its latest step), or,
    when it is missing, a random init from ``seed`` with a warning; on
    ``device``, in eval mode. ``cfg_file`` (a SPEC config yaml) sets
    ``backbone``, ``use_cam_feats`` and ``head`` (``HMR.HEAD``) as in the
    reference; ``img_res`` None is the trunk's own
    (``models.hmr.default_img_res``: 256 for ``vit_h``, else 224), and
    the model's ``img_res`` tells callers the crop side; ``remat``
    checkpoints the backbone's blocks (training)."""
    if cfg_file:
        from spec_tpu_torch.utils.config import hmr_hparams_from_cfg
        backbone, use_cam_feats, head = hmr_hparams_from_cfg(cfg_file)
    model = HMR(backbone=backbone, use_cam=True, use_cam_feats=use_cam_feats,
                img_res=img_res or default_img_res(backbone),
                dtype=dtype or torch.float32, remat=remat, head=head)
    if os.path.isdir(ckpt):
        model.load_state_dict(load_checkpoint_variables(ckpt))
    elif os.path.exists(ckpt):
        model.load_state_dict(hmr_state_dict(load_torch_state_dict(ckpt),
                                             model))
    else:
        print(f'[{tag}] WARNING: spec ckpt {ckpt} missing; random init')
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class SpecPredictor:
    """Persistent camera-aware human mesh recovery predictor.

    Arguments are those of ``spec_tpu.serving.SpecPredictor``, plus
    ``device``. ``dtype`` is the backbone/head-FC compute dtype
    (``torch.float32`` or ``torch.bfloat16``; None = float32). SMPL
    vertices always go through ``ops.lbs.fused_lbs_vertices``, which
    launches the CUDA kernel on a GPU and runs its plain version on the
    CPU, so ``use_fused_lbs=False`` raises. On a GPU both stages replay
    CUDA graphs (one per padded shape, at most 8 per stage, in one memory
    pool); on the CPU they run eagerly. ``uint8_crops=True`` raises
    too: it shrinks the reference's host-to-device crop upload, and here
    crops are cut on the device from the frame already uploaded. Missing
    checkpoints give a random init from fixed seeds, with a warning
    (smoke tests only). ``cfg_file`` (a SPEC config yaml) sets
    ``backbone``, ``use_cam_feats`` and ``head`` as in the reference.
    ``head``: SPIN's regressor (``hmr``) or HMR 2.0's transformer
    decoder (``transformer_decoder``, with ``backbone='vit_h'``: HMR
    2.0 as stage 2); ``img_res`` None is the trunk's crop side (256 for
    ``vit_h``, else 224).
    ``detector='yolo'`` builds a :class:`~spec_tpu_torch.models.detector.
    YoloDetector` (bf16, batches of 8, its graphs in the stages' pool;
    random init without ``yolo_weights``, with a warning) that
    ``predict(frames)`` without boxes runs first.
    ``data_parallel=True`` replicates both stages (and the detector)
    on every local card (``parallel.create_mesh``), each replica with
    graphs of its own: a padded batch splits into one equal part per
    card and the outputs gather on the first, so ``batch_size`` must be a
    multiple of the card count and padding never drops below one item
    per card (``_min_pad``, ``_min_pad_s1``). ``spatial_parallel=True``
    is the single-frame latency layout: stage 1 splits each frame's rows
    into one band per card, the bands exchanging halo rows before every
    layer whose window spans rows and the first card adding the bands'
    pooled sums and running the heads (``parallel.SpatialStage``), so a
    one-frame call stays one frame (``_min_pad_s1`` 1); stage 2 splits
    its person batch as under ``data_parallel`` (``_min_pad`` the card
    count, ``batch_size`` a multiple of it); the detector stays on the
    first card. With one card the one band is the whole frame: stage 1
    is the plain stage. The two layouts exclude each other.

    Streams: ``camcalib_every`` state is kept per stream name, at most
    ``max_streams`` named streams, least recently used evicted. Unlike
    the reference (``spec_tpu/serving.py:485-500``), ephemeral streams
    (names that start with ``'\x00'``, the HTTP server's one-shot
    streams for requests without a stream header, dropped after their
    request) do not count towards ``max_streams`` and never evict a
    named stream.
    """

    # Class-level defaults of the knobs that predict, estimate_cameras and
    # the stream helpers read: export.load_predictor builds a predictor
    # with __new__ and skips __init__, so each such knob must resolve
    # through the class. A new knob gets a default here, not only in
    # __init__.
    detector = None
    camcalib_every = 1      # stage-1 stream amortization (1 = every frame)
    cut_threshold = 0.5     # shot-cut re-anchor (L1 histogram delta; 0 off)
    # camcalib_every state per stream name, made on first use (a mutable
    # class default would be shared by every instance)
    _cam_streams: Optional[OrderedDict] = None
    max_streams = 256  # LRU cap on retained named camcalib_every streams
    mesh = None             # data_parallel's or spatial_parallel's devices
    _min_pad = 1            # padded batches are multiples of these
    _min_pad_s1 = 1

    def __init__(
        self,
        spec_ckpt: str = '',
        camcalib_ckpt: str = '',
        cfg_file: str = '',
        smpl_model_dir: str = '',
        backbone: str = 'resnet50',
        use_cam_feats: bool = False,
        camcalib_backbone: str = 'resnet50',
        loss_type: str = 'softargmax_biased_l2',
        img_res: Optional[int] = None,
        batch_size: int = 32,
        min_size: int = 600,
        dtype: Optional[torch.dtype] = None,
        use_fused_lbs: Optional[bool] = None,
        uint8_crops: bool = False,
        data_parallel: bool = False,
        spatial_parallel: bool = False,
        detector: str = '',
        yolo_weights: str = '',
        yolo_img_size: int = 416,
        camcalib_every: int = 1,
        cut_threshold: float = 0.5,
        device: str | torch.device = 'cuda',
        head: str = 'hmr',
    ):
        if detector not in ('', 'yolo'):
            raise ValueError(f'unknown detector {detector!r}; '
                             "use '' (caller boxes) or 'yolo'")
        if data_parallel and spatial_parallel:
            raise ValueError(
                'data_parallel and spatial_parallel are mutually '
                'exclusive layouts (throughput vs single-frame latency)')
        if use_fused_lbs is False:
            raise ValueError(
                'use_fused_lbs=False has no counterpart in the port: SMPL '
                'vertices always go through fused_lbs_vertices (the CUDA '
                'kernel on a GPU, its plain version on the CPU)')
        if uint8_crops:
            raise ValueError(
                'uint8_crops=True has no counterpart in the port: crops '
                'are cut on the device from the uploaded frame, so there '
                'is no crop upload to shrink')

        self.device = torch.device(device)
        if data_parallel or spatial_parallel:
            self.mesh = par.create_mesh(device=self.device)
            n_dev = len(self.mesh)
            if batch_size % n_dev:
                raise ValueError(
                    f'batch_size {batch_size} must be a multiple of the '
                    f'device count {n_dev} for '
                    'data_parallel/spatial_parallel')
            self.device = self.mesh[0]
            # padded batches stay divisible by the mesh (powers of two
            # compose with power-of-two meshes above this floor); under
            # spatial_parallel stage 1 splits rows, not frames
            self._min_pad = n_dev
            self._min_pad_s1 = 1 if spatial_parallel else n_dev
        self.batch_size = batch_size
        self.min_size = min_size
        self.loss_type = loss_type
        self.camcalib_every = max(1, int(camcalib_every))
        self.cut_threshold = float(cut_threshold)

        self.assets = S.with_packed_lbs(
            S.load_assets_or_test(smpl_model_dir, tag='serving').to(
                self.device))
        self.camcalib = build_camcalib(
            camcalib_ckpt or paths.camcalib_checkpoint_path(),
            camcalib_backbone, self.device, dtype, seed=0)
        self.spec = build_hmr(
            spec_ckpt or paths.spec_checkpoint_path(), self.device,
            cfg_file, backbone, use_cam_feats, img_res, dtype, seed=1,
            head=head)
        self.img_res = self.spec.img_res

        # One graph memory pool for both stages (none on the CPU).
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == 'cuda' else None)
        self._stage1 = StageGraph(
            'stage1', CamStage(self.camcalib, self.loss_type), pool)
        self._stage2 = StageGraph(
            'stage2', SpecStage(self.spec, self.assets), pool)
        if self.mesh is not None:
            self._replicate_stages(pool, spatial_parallel)

        if detector == 'yolo':
            from spec_tpu_torch.models.detector import YoloDetector

            if not yolo_weights:
                print('[serving] WARNING: detector=yolo without '
                      'yolo_weights runs a random-init detector '
                      '(pipeline smoke only)')
            # Detection splits over the mesh under data_parallel; under
            # spatial_parallel it stays on the first card (its 416² input
            # is small: split into bands it would be mostly halo).
            det_mesh = self.mesh if data_parallel else None
            det_bs = 8
            if det_mesh is not None:    # the batch must divide the mesh
                det_bs = par.pad_to_multiple(det_bs, len(det_mesh))
            self.detector = YoloDetector(
                weights_path=yolo_weights or None, img_size=yolo_img_size,
                batch_size=det_bs, device=self.device, pool=pool,
                mesh=det_mesh)

    def _replicate_stages(self, pool, spatial: bool) -> None:
        """data_parallel: each stage as one replica per device of the
        mesh, the first the stages built above; spatial_parallel: stage 2
        so, and stage 1 split into bands of rows over the mesh. A card's
        replicas and bands share that card's graph pool (their replays
        run in turn)."""
        pools = {self.device: pool}
        for dev in self.mesh[1:]:
            if dev not in pools:
                with torch.cuda.device(dev):
                    pools[dev] = torch.cuda.graph_pool_handle()
        s2 = [self._stage2]
        specs = par.replicate(self.spec, self.mesh)
        for spec, dev in zip(specs[1:], self.mesh[1:]):
            assets = S.with_packed_lbs(self.assets.to(dev))
            s2.append(StageGraph('stage2', SpecStage(spec, assets),
                                 pools[dev]))
        self._stage2 = par.ReplicatedStage(s2, self.mesh)
        cams = par.replicate(self.camcalib, self.mesh)
        if not spatial:
            s1 = [self._stage1] + [
                StageGraph('stage1', CamStage(cam, self.loss_type),
                           pools[dev])
                for cam, dev in zip(cams[1:], self.mesh[1:])]
            # stage 1's angles are (3, B): their batch is dimension 1
            self._stage1 = par.ReplicatedStage(s1, self.mesh,
                                               out_dims=(0, 0, 0, 1))
            return
        camcalib, loss_type = self.camcalib, self.loss_type

        def heads(*row_sums, count):
            return _cam_outputs(camcalib.forward_pooled(row_sums, count),
                                loss_type)

        self._stage1 = par.SpatialStage(
            [cam.backbone for cam in cams], heads, self.mesh,
            prep=_normalize_nchw, dtype=camcalib.dtype,
            pools=[pools[dev] for dev in self.mesh], whole=self._stage1)

    def _padded(self, n_valid: int, mult: Optional[int] = None) -> int:
        """The batch a chunk of ``n_valid`` items runs at: the next power
        of two capped at ``batch_size``, rounded up to a multiple of the
        mesh size under data_parallel and spatial_parallel (every
        replica's part non-empty). ``mult`` overrides that multiple
        (stage 1 passes ``_min_pad_s1``, 1 under spatial_parallel, whose
        stage 1 splits rows)."""
        bp = pad_pow2(n_valid, self.batch_size)
        mp = self._min_pad if mult is None else mult
        return -(-bp // mp) * mp

    # -- stage 1 ------------------------------------------------------------

    def _upload(self, frame) -> torch.Tensor:
        """One frame (HWC, uint8 or float in [0, 255]) -> the same values
        on the device, as uint8 or float32."""
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _upload_all(self, frames) -> List[torch.Tensor]:
        with profiling.annotate('predict/upload') as span:
            frames_dev = [self._upload(fr) for fr in frames]
            if span:
                span.count(bytes=sum(f.nbytes for f in frames_dev))
        return frames_dev

    def _stage1_batches(self, frames_dev: Sequence[torch.Tensor]):
        """Resize on the device (one call per frame size and up to
        ``batch_size`` frames) and bucket by the resized size: yields
        (frame indices, the bucket's padded uint8 batch), stage 1's
        inputs."""
        with profiling.annotate('predict/stage1_inputs'):
            by_size = defaultdict(list)
            for i, fr in enumerate(frames_dev):
                by_size[tuple(fr.shape)].append(i)
            resized: List[torch.Tensor] = [None] * len(frames_dev)
            for same in by_size.values():
                for s0 in range(0, len(same), self.batch_size):
                    idxs = same[s0:s0 + self.batch_size]
                    # Stage 1 sees uint8 (float frames truncate, as
                    # numpy's astype).
                    batch = resize_min_side(torch.stack(
                        [frames_dev[i] for i in idxs]).to(torch.uint8),
                        self.min_size)
                    for k, i in enumerate(idxs):
                        resized[i] = batch[k]
            buckets = defaultdict(list)
            for i, img in enumerate(resized):
                buckets[tuple(img.shape[:2])].append(i)
            chunks = [idxs[s0:s0 + self.batch_size]
                      for idxs in buckets.values()
                      for s0 in range(0, len(idxs), self.batch_size)]
        for chunk in chunks:
            # a span per step: none stays open across the yield
            with profiling.annotate('predict/stage1_inputs') as span:
                bp = self._padded(len(chunk), self._min_pad_s1)
                pad = chunk + [chunk[-1]] * (bp - len(chunk))
                batch = torch.stack([resized[i] for i in pad])
                span.count(rows=bp, valid=len(chunk))
            yield chunk, batch

    @torch.inference_mode()
    def _cameras_dispatch(self, frames_dev: Sequence[torch.Tensor]):
        """Queue every stage-1 batch (no fetch). Returns the pending
        chunks for :meth:`_cameras_fetch`."""
        return [(chunk, self._stage1(batch)[-1])
                for chunk, batch in self._stage1_batches(frames_dev)]

    @staticmethod
    def _cameras_fetch(pending, heights: Sequence[int]) -> List[dict]:
        out: List[Optional[dict]] = [None] * len(heights)
        with profiling.annotate('predict/stage1_fetch'):
            for chunk, angles in pending:
                vfov, pitch, roll = angles.cpu().numpy()
                for k, i in enumerate(chunk):
                    out[i] = {
                        'vfov': float(vfov[k]),
                        'f_pix': float(heights[i] / 2.0
                                       / np.tan(vfov[k] / 2.0)),
                        'pitch': float(pitch[k]),
                        'roll': float(roll[k]),
                    }
        return out  # type: ignore[return-value]

    def estimate_cameras(self, frames: Sequence[np.ndarray]) -> List[dict]:
        """CamCalib over raw RGB frames (uint8/float HWC, any sizes).
        Returns one dict per frame: {vfov, f_pix, pitch, roll} (radians;
        f_pix w.r.t. the original frame height)."""
        with profiling.annotate('estimate_cameras', frames=len(frames)):
            frames_dev = self._upload_all(frames)
            return self._cameras_fetch(self._cameras_dispatch(frames_dev),
                                       [f.shape[0] for f in frames_dev])

    def reset_camera_stream(self, stream: Optional[str] = None, *,
                            all_streams: bool = False) -> None:
        """Forget ``camcalib_every`` state so the next frame of ``stream``
        (None = the default anonymous stream) is a stage-1 keyframe;
        ``all_streams`` drops every stream."""
        if all_streams:
            self._cam_streams = None
        elif self._cam_streams is not None:
            self._cam_streams.pop('' if stream is None else str(stream),
                                  None)

    def _stream_state(self, stream: Optional[str]) -> dict:
        """The camcalib_every state of ``stream`` (created empty if new),
        LRU-evicting the stalest named stream past ``max_streams`` named
        ones; ephemeral streams are neither counted nor evicted."""
        if self._cam_streams is None:
            self._cam_streams = OrderedDict()
        streams = self._cam_streams
        key = '' if stream is None else str(stream)
        st = streams.get(key)
        if st is None:
            st = streams[key] = {'cam': None, 'h': 0, 'i': 0, 'sig': None}
            if not key.startswith(EPHEMERAL_PREFIX):
                named = [k for k in streams
                         if not k.startswith(EPHEMERAL_PREFIX)]
                excess = len(named) - max(1, int(self.max_streams))
                for k in named[:max(0, excess)]:
                    del streams[k]
        else:
            streams.move_to_end(key)
        return st

    # -- full pipeline ------------------------------------------------------

    def _stream_cameras(self, frames, frames_dev, stream):
        """Stage 1 under ``camcalib_every``: run CamCalib on the stream's
        keyframes only and reuse the latest keyframe camera in between.
        Returns (cameras, deferred stream update, stream state)."""
        n_frames = len(frames)
        st = self._stream_state(stream)
        thr = float(self.cut_threshold or 0.0)
        sel = KeyframeSelector(self.camcalib_every, thr, start_index=st['i'],
                               prev_sig=st.get('sig'))
        with profiling.annotate('predict/keyframes',
                                frames=n_frames if thr > 0.0 else 0):
            key_idx = [i for i in range(n_frames)
                       if sel.is_keyframe(frame_signature(frames[i])
                                          if thr > 0.0 else None)]
        update = {'sig': sel.prev_sig if thr > 0.0 else None}
        if n_frames and st['cam'] is None and (not key_idx
                                               or key_idx[0] != 0):
            key_idx.insert(0, 0)
        key_cams = []
        if key_idx:
            key_cams = self._cameras_fetch(
                self._cameras_dispatch([frames_dev[i] for i in key_idx]),
                [frames_dev[i].shape[0] for i in key_idx])
        cam, cam_h = st['cam'], st['h']
        cameras, ki = [], 0
        for i in range(n_frames):
            h = int(frames_dev[i].shape[0])
            if ki < len(key_idx) and key_idx[ki] == i:
                cam, cam_h = key_cams[ki], h
                ki += 1
            c = cam
            if h != cam_h:
                # f_pix is defined w.r.t. the frame height: rescale.
                c = dict(c)
                c['f_pix'] = float(h / (2.0 * np.tan(c['vfov'] / 2.0)))
            cameras.append(c)
        update.update(cam=cam, h=cam_h, i=st['i'] + n_frames)
        return cameras, update, st

    @torch.inference_mode()
    def predict(
        self,
        frames: Sequence[np.ndarray],
        boxes: Optional[Sequence[np.ndarray]] = None,
        cameras: Optional[Sequence[dict]] = None,
        stream: Optional[str] = None,
        return_cameras: bool = False,
    ):
        """Two-stage inference.

        frames: RGB images (HWC, uint8 or float in [0, 255]); boxes: per
        frame (N_i, 4) [cx, cy, w, h] person boxes (N_i may be 0), or
        None to run the predictor's detector (``detector='yolo'``);
        cameras: optional precomputed stage-1 outputs; stream: the
        ``camcalib_every`` stream of these frames (None = default);
        return_cameras: also return the per-frame cameras used.

        Returns per frame a list of per-person dicts of numpy arrays
        (smpl_vertices, smpl_joints3d, smpl_joints2d, pred_cam_t,
        pred_pose, pred_pose_6d, pred_shape, pred_cam) plus the frame's
        'camera'; with ``return_cameras``: ``(results, cameras)``.
        """
        if boxes is None and self.detector is None:
            raise ValueError(
                'predict(frames) without boxes needs an in-process '
                "detector — construct SpecPredictor(detector='yolo', "
                "yolo_weights=...) or pass per-frame boxes")
        with profiling.annotate('predict', frames=len(frames)) as span:
            results, cameras = self._predict(frames, boxes, cameras, stream)
            if span:
                span.count(persons=sum(len(r) for r in results))
        if return_cameras:
            return results, list(cameras)
        return results

    def _predict(self, frames, boxes, cameras, stream):
        """:meth:`predict`'s body, inside its root span: returns the
        results and the cameras used."""
        frames_dev = self._upload_all(frames)
        # Detection and stage 1 are independent: both are queued before
        # either is fetched, so the host's NMS overlaps stage 1.
        pending_det = None
        if boxes is None:
            with profiling.annotate('predict/detect'):
                pending_det = self.detector.detect_dispatch(frames_dev)
        # Stream-state writes are deferred to the end of the call, so a
        # call that raises leaves its stream exactly as it was.
        stream_update = st = cam_pending = None
        if cameras is None:
            if self.camcalib_every > 1:
                cameras, stream_update, st = self._stream_cameras(
                    frames, frames_dev, stream)
            else:
                cam_pending = self._cameras_dispatch(frames_dev)
        if pending_det is not None:
            with profiling.annotate('predict/detect'):
                boxes = self.detector.detect_fetch(pending_det)
        if cam_pending is not None:
            cameras = self._cameras_fetch(cam_pending,
                                          [f.shape[0] for f in frames_dev])

        results: List[List[dict]] = [[] for _ in frames]
        pending = [(chunk, n_valid, self._stage2(*inputs))
                   for chunk, n_valid, inputs
                   in self._stage2_batches(frames_dev, boxes, cameras)]
        for chunk, n_valid, out in pending:
            with profiling.annotate('predict/stage2_fetch'):
                out_np = {k: v.cpu().numpy() for k, v in out.items()}
            with profiling.annotate('predict/results', persons=n_valid):
                for bi in range(n_valid):
                    fi = chunk[bi][0]
                    person = {k: v[bi] for k, v in out_np.items()}
                    person['camera'] = cameras[fi]
                    results[fi].append(person)
        if stream_update is not None:
            st.update(stream_update)
        return results, cameras

    def _stage2_batches(self, frames_dev, boxes, cameras):
        """Flatten (frame, person) work items and cut them into chunks of
        ``batch_size``, each padded to a power of two: yields (work chunk,
        valid rows, stage 2's inputs: crops cut on the device and the
        camera and box columns uploaded)."""
        with profiling.annotate('predict/work_list') as span:
            work = self._work_list(frames_dev, boxes, cameras)
            span.count(persons=len(work))
        for s0 in range(0, len(work), self.batch_size):
            # a span per chunk: none stays open across the yield
            with profiling.annotate('predict/stage2_inputs') as span:
                chunk = work[s0:s0 + self.batch_size]
                n_valid = len(chunk)
                bp = self._padded(n_valid)
                span.count(rows=bp, valid=n_valid)
                chunk = chunk + [chunk[-1]] * (bp - n_valid)
                crops = self._crops(chunk, frames_dev)

                def col(k):
                    return torch.from_numpy(np.stack(
                        [np.asarray(c[k], np.float32) for c in chunk])).to(
                            self.device)

                inputs = (crops, col(3), col(4), col(2), col(1), col(5),
                          col(6))
            yield chunk, n_valid, inputs

    def _work_list(self, frames_dev, boxes, cameras) -> list:
        """One work item per (frame, person): (frame index, center,
        scale, rotation matrix, intrinsics, frame width and height, crop
        corners)."""
        boxes = [np.asarray(bx, np.float32).reshape(-1, 4) for bx in boxes]
        fis = [fi for fi, bx in enumerate(boxes) if len(bx)]
        if not fis:
            return []
        # The cameras of every frame with persons, in one batch.
        hw = [tuple(frames_dev[fi].shape[:2]) for fi in fis]
        rotmats = G.euler_to_rotmat(torch.tensor(
            [[cameras[fi]['pitch'], 0.0, cameras[fi]['roll']] for fi in fis],
            dtype=torch.float32)).numpy()
        Ks = G.build_cam_intrinsics(
            torch.tensor([cameras[fi]['f_pix'] for fi in fis],
                         dtype=torch.float32),
            torch.tensor([float(w) for _, w in hw]),
            torch.tensor([float(h) for h, _ in hw])).numpy()
        work = []
        for k, fi in enumerate(fis):
            h, w = hw[k]
            centers, scales = bbox_to_center_scale(boxes[fi])
            corners = spin_crop_corners(centers, scales, res=self.img_res)
            for pi in range(len(centers)):
                work.append((fi, centers[pi], scales[pi], rotmats[k], Ks[k],
                             w, h, corners[pi]))
        return work

    def _crops(self, chunk, frames_dev) -> torch.Tensor:
        """SPIN crops of one chunk, on the device, normalized (B, res,
        res, 3)."""
        return crop_boxes(frames_dev, [c[0] for c in chunk],
                          [c[7] for c in chunk], self.img_res)


def crop_boxes(frames_dev, frame_ids: Sequence, corners: Sequence,
               res: int) -> torch.Tensor:
    """SPIN crops on the device, normalized (B, res, res, 3): box b is
    cut from ``frames_dev[frame_ids[b]]`` (HWC frames on one device, a
    list or a dict) at the integer ``corners[b]`` (from
    ``spin_crop_corners``), with one crop call per frame size."""
    device = frames_dev[frame_ids[0]].device
    by_size: Dict[tuple, list] = defaultdict(list)
    for ci, fi in enumerate(frame_ids):
        by_size[tuple(frames_dev[fi].shape)].append(ci)
    parts = []
    for cis in by_size.values():
        fis = list(dict.fromkeys(frame_ids[ci] for ci in cis))
        slot = {fi: k for k, fi in enumerate(fis)}
        frames = torch.stack([frames_dev[fi] for fi in fis]).float()
        # Corners and each box's frame slot, in one upload.
        cf = torch.from_numpy(np.stack(
            [np.append(corners[ci], slot[frame_ids[ci]]) for ci in cis]
        ).astype(np.int32)).to(device)
        parts.append((cis, crop_resize_normalize(
            frames, cf[:, :4], res=res, frame_index=cf[:, 4])))
    if len(parts) == 1:
        return parts[0][1]               # every row, in order
    crops = torch.empty((len(frame_ids), res, res, 3), device=device)
    for cis, v in parts:
        crops[cis] = v
    return crops
