"""The SPEC evaluator's two passes (torch twin of
``spec_tpu/eval/evaluator.py``).

* :class:`MetricAccumulator` gathers the in-loop pass's per-sample rows
  (the reference trainer's ``evaluation_results`` dict) across batches.
* :func:`compute_error` is the offline headline pass: W-MPJPE, MPJPE,
  PA-MPJPE, W-PVE and PVE from the dumped predicted vertices, in chunks
  of 256 samples. Each chunk runs GT SMPL twice (world pose, camera
  pose) through the fused LBS kernel K1, the rotations to the camera
  frame and every metric but Procrustes as one CUDA graph replay on the
  card (``utils/graphs.StageGraph``); the Procrustes alignment of
  PA-MPJPE runs eagerly after it, because ``torch.linalg.svd`` on CUDA
  copies to the host and cannot be captured (the eval step splits the
  same way, ``eval/eval_loop.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.eval import metrics as M
from spec_tpu_torch.utils.graphs import StageGraph
from spec_tpu_torch.utils.precision import exact_fp32


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricAccumulator:
    """Per-sample eval rows across batches: mpjpe / pampjpe (B, 14),
    mpjpe_24 / pampjpe_24 (B, 24), v2v (B,), imgname, dataset_name, and
    with ``save_results`` pose / shape / cam / vertices, as the
    reference's ``evaluation_results`` dict holds them."""

    def __init__(self, save_results: bool = True):
        self.save_results = save_results
        self.reset()

    def reset(self):
        self.rows = {
            'mpjpe': [], 'pampjpe': [], 'mpjpe_24': [], 'pampjpe_24': [],
            'v2v': [], 'imgname': [], 'dataset_name': [],
        }
        if self.save_results:
            self.rows.update(
                {'pose': [], 'shape': [], 'cam': [], 'vertices': []})

    def add_batch(self, imgnames, dataset_names, j14: dict, j24: dict,
                  v2v, pred=None, valid_count: Optional[int] = None):
        """``j14`` / ``j24``: outputs of ``eval_mesh_j14`` /
        ``eval_joints_24``; ``valid_count`` drops the padding rows of a
        static-size batch."""
        n = valid_count if valid_count is not None else len(imgnames)
        rows = self.rows
        rows['mpjpe'] += to_numpy(j14['per_joint_mpjpe'])[:n].tolist()
        rows['pampjpe'] += to_numpy(j14['per_joint_pa'])[:n].tolist()
        rows['mpjpe_24'] += to_numpy(j24['per_joint_mpjpe'])[:n].tolist()
        rows['pampjpe_24'] += to_numpy(j24['per_joint_pa'])[:n].tolist()
        rows['v2v'] += to_numpy(v2v)[:n].tolist()
        rows['imgname'] += list(imgnames[:n])
        rows['dataset_name'] += list(dataset_names[:n])
        if self.save_results and pred is not None:
            rows['pose'] += to_numpy(pred['pred_pose'])[:n].tolist()
            rows['shape'] += to_numpy(pred['pred_shape'])[:n].tolist()
            rows['cam'] += to_numpy(pred['pred_cam'])[:n].tolist()
            rows['vertices'] += to_numpy(pred['smpl_vertices'])[:n].tolist()

    def summary(self) -> dict:
        """Means in mm (of the per-sample means)."""
        out = {}
        for k in ('mpjpe', 'pampjpe', 'mpjpe_24', 'pampjpe_24'):
            arr = np.asarray(self.rows[k])
            out[f'val_{k}'] = float(arr.mean(-1).mean() * 1000) if arr.size \
                else float('nan')
        v = np.asarray(self.rows['v2v'])
        out['val_v2v'] = float(v.mean() * 1000) if v.size else float('nan')
        return out

    def results_dict(self) -> dict:
        """The ``evaluation_results_{ds}`` payload (numpy arrays; names
        stay lists)."""
        return {k: (list(v) if k in ('imgname', 'dataset_name')
                    else np.asarray(v)) for k, v in self.rows.items()}


def _chunk_head(assets, j_reg_h36m, protocol, gt_pose, gt_pose_cam,
                gt_betas, gt_cam_rotmat, use_gt_cam_rotmat, pred_vertices,
                pred_cam_rotmat) -> tuple:
    """One chunk of the offline pass up to Procrustes: GT SMPL in the
    world and camera frames (spec-syn: the world mesh rotated by the GT
    camera), the predictions rotated by their camera, and every metric
    but PA-MPJPE; plus the world-frame protocol's head, which
    :func:`_chunk_tail` finishes. All tensors, so it can be captured."""

    def gt_mesh(pose):
        out = S.smpl_forward(
            assets, betas=gt_betas,
            body_pose=pose[:, 3:].reshape(-1, 23, 3),
            global_orient=pose[:, :3].reshape(-1, 1, 3),
            pose2rot=True, joint_set='native')
        return out.vertices, out.joints_native

    gt_verts_w, gt_j24_w = gt_mesh(gt_pose)
    gt_verts_c_pose, gt_j24_c_pose = gt_mesh(gt_pose_cam)
    sel = use_gt_cam_rotmat.float().reshape(1, 1, 1)
    gt_verts_c = (sel * M.rotate_points(gt_cam_rotmat, gt_verts_w)
                  + (1 - sel) * gt_verts_c_pose)
    gt_j24_c = (sel * M.rotate_points(gt_cam_rotmat, gt_j24_w)
                + (1 - sel) * gt_j24_c_pose)
    rot = torch.where(use_gt_cam_rotmat.reshape(1, 1, 1), gt_cam_rotmat,
                      pred_cam_rotmat)
    pred_verts_c = M.rotate_points(rot, pred_vertices)

    if protocol == 'j14':
        w = M.eval_mesh_j14_head(pred_vertices, gt_verts_w, j_reg_h36m)
        c = M.eval_mesh_j14_head(pred_verts_c, gt_verts_c, j_reg_h36m)
        wv2v, v2v = w['v2v'], c['v2v']
    else:
        with exact_fp32():
            pred_j24 = torch.einsum('jv,bvc->bjc', assets.j_regressor,
                                    pred_vertices.float())
            pred_j24_c = torch.einsum('jv,bvc->bjc', assets.j_regressor,
                                      pred_verts_c)
        w = M.eval_joints_24_head(pred_j24, gt_j24_w)
        c = M.eval_joints_24_head(pred_j24_c, gt_j24_c)
        # V2V always centres on the H36M pelvis (regressor row 0)
        pelvis = j_reg_h36m[0:1]
        wv2v = M.v2v_error(
            pred_vertices.float() - M.regress_h36m(pred_vertices, pelvis),
            gt_verts_w - M.regress_h36m(gt_verts_w, pelvis))
        v2v = M.v2v_error(
            pred_verts_c - M.regress_h36m(pred_verts_c, pelvis),
            gt_verts_c - M.regress_h36m(gt_verts_c, pelvis))
    return {'wmpjpe': w['mpjpe'], 'mpjpe': c['mpjpe'], 'wv2v': wv2v,
            'v2v': v2v}, w


def _chunk_tail(head) -> dict:
    """The chunk's metrics with PA-MPJPE of the world-frame protocol
    (eager: SVD)."""
    out, w = head
    return {**out, 'pampjpe': M.pa_tail(w)['pa_mpjpe']}


# Chunk graphs kept per (assets, regressor, protocol, device): each holds
# the assets' kernel operands and a CUDA graph per chunk shape.
_CHUNK_CACHE: dict = {}
_CHUNK_CACHE_MAX = 4


def _chunk_stage(assets, jreg, protocol: str, device) -> StageGraph:
    key = (id(assets), id(jreg), protocol, str(device))
    entry = _CHUNK_CACHE.get(key)
    if entry is None:
        while len(_CHUNK_CACHE) >= _CHUNK_CACHE_MAX:
            _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
        dev_assets = assets.to(device)
        if dev_assets.packed_lbs is None:
            dev_assets = S.with_packed_lbs(dev_assets)
        dev_jreg = torch.as_tensor(np.asarray(jreg), dtype=torch.float32,
                                   device=device)
        stage = StageGraph(f'compute_error {protocol}', functools.partial(
            _chunk_head, dev_assets, dev_jreg, protocol))
        # the entry holds the key's objects, so their ids stay theirs
        entry = _CHUNK_CACHE[key] = (stage, assets, jreg)
    return entry[0]


def compute_error(
    dataset_name: str,
    pred_vertices,                    # (N, V, 3)
    pred_cam_rotmat,                  # (N, 3, 3)
    gt_pose,                          # (N, 72) world pose
    gt_betas,                         # (N, 10)
    assets: S.SMPLAssets,
    j_regressor_h36m,                 # (17, V)
    gt_pose_cam=None,                 # (N, 72), 3dpw / mtp
    gt_cam_rotmat=None,               # (N, 3, 3), spec-syn
    chunk: int = 256,
    device='cuda',
) -> dict:
    """Offline headline metrics in mm, the reference's
    ``compute_error``: the 14-joint H36M protocol for 3dpw*, the 24
    native joints otherwise; W- = world frame, plain = camera frame (the
    prediction rotated by its own predicted camera, or by the GT camera
    for spec-syn). The last chunk is padded by repeating its last row,
    so every chunk has one shape. ``device``: 'cuda' (default) or 'cpu',
    which must be asked for."""
    device = torch.device(device)
    N = len(pred_vertices)
    protocol = 'j14' if dataset_name.startswith('3dpw') else 'j24'
    use_gt_rot = torch.tensor(dataset_name == 'spec-syn', device=device)
    if gt_pose_cam is None:
        gt_pose_cam = gt_pose
    if gt_cam_rotmat is None:
        gt_cam_rotmat = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    stage = _chunk_stage(assets, j_regressor_h36m, protocol, device)

    acc = {k: [] for k in ('wmpjpe', 'mpjpe', 'pampjpe', 'wv2v', 'v2v')}
    with torch.inference_mode():
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            pad = chunk - (e - s)

            def p(x):
                arr = np.asarray(x[s:e], np.float32)
                if pad:
                    arr = np.concatenate([arr, arr[-1:].repeat(pad, 0)], 0)
                return torch.from_numpy(arr).to(device)

            res = _chunk_tail(stage(
                p(gt_pose), p(gt_pose_cam), p(gt_betas), p(gt_cam_rotmat),
                use_gt_rot, p(pred_vertices), p(pred_cam_rotmat)))
            for k in acc:
                acc[k].append(to_numpy(res[k])[:e - s])

    out = {k: float(np.concatenate(v).mean() * 1000) for k, v in acc.items()}
    return {
        'W-MPJPE': out['wmpjpe'],
        'MPJPE': out['mpjpe'],
        'PA-MPJPE': out['pampjpe'],
        'W-PVE': out['wv2v'],
        'PVE': out['v2v'],
        'protocol': protocol,
    }
