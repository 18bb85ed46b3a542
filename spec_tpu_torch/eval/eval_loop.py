"""Batched SPEC evaluation loop (torch twin of
``spec_tpu/eval/eval_loop.py``).

One eval step per batch: ImageNet normalization of the crops, the HMR
forward with the neutral SMPL assets, GT SMPL (neutral, or male and
female blended per sample by gender), SMPL of the predicted parameters
for the 24 native joints, then the J14/J17 H36M protocol, J24 and V2V.
Every SMPL forward goes through the fused LBS kernel K1 on the card
(four launches a step with gendered GT, three without).

On the card the step is one CUDA graph replay (``utils/graphs.
StageGraph``, the counterpart of the reference's ``jax.jit(step)``) that
ends before Procrustes: ``torch.linalg.svd`` on CUDA copies to the host,
so a graph cannot capture it, and the Procrustes alignments of PA-MPJPE
run eagerly after each replay (:func:`_procrustes_tail`). That split is
the design, not a fallback: a capture that fails raises.

``save_images`` renders the first sample of every ``save_freq``-th batch
(input | overlay | side view, ``utils/renderer.render_image_group`` on
the host) to ``<logdir>/val_images/<dataset>_b<idx>.jpg``, with the
camera the metrics used. The in-the-wild sets (mpii, coco) have no 3D
GT: their pass is qualitative, its errors zero, and it needs
``save_images``. Not ported yet: ``mesh=`` (data-parallel eval, ROADMAP.md
§1 item 12) raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from spec_tpu_torch.core import constants as C
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.data.loader import device_prefetch
from spec_tpu_torch.eval import metrics as M
from spec_tpu_torch.eval.evaluator import MetricAccumulator
from spec_tpu_torch.utils.graphs import StageGraph, device_constant

# The step's inputs, in the order the graph takes them.
BATCH_KEYS = ('img', 'pose', 'betas', 'gender', 'scale', 'center',
              'orig_shape', 'cam_rotmat', 'cam_intrinsics')


def _gendered_gt_mesh(assets_by_gender, pose, betas, gender):
    """GT SMPL (vertices, 24 native joints). With 'male' and 'female'
    assets, both run and each sample takes the female mesh where
    ``gender == 1`` and the male one otherwise; else the neutral."""
    def fwd(assets):
        out = S.smpl_forward(
            assets, betas=betas,
            body_pose=pose[:, 3:].reshape(-1, 23, 3),
            global_orient=pose[:, :3].reshape(-1, 1, 3),
            pose2rot=True, joint_set='native')
        return out.vertices, out.joints_native

    if 'male' not in assets_by_gender or 'female' not in assets_by_gender:
        return fwd(assets_by_gender['neutral'])
    v_m, j_m = fwd(assets_by_gender['male'])
    v_f, j_f = fwd(assets_by_gender['female'])
    is_f = (gender == 1).float()[:, None, None]
    return is_f * v_f + (1 - is_f) * v_m, is_f * j_f + (1 - is_f) * j_m


def _step_head(model, assets_by_gender, jreg, use_gender, protocol, img,
               pose, betas, gender, scale, center, orig_shape, cam_rotmat,
               cam_intrinsics) -> tuple:
    """The step up to Procrustes: (the model's outputs, the J14 and the
    J24 protocol's heads, V2V)."""
    neutral = assets_by_gender['neutral']
    mean = device_constant(C.IMG_NORM_MEAN, img.device)
    std = device_constant(C.IMG_NORM_STD, img.device)
    img_h = orig_shape[:, 0].float()
    img_w = orig_shape[:, 1].float()
    out = model(neutral, (img - mean) / std, cam_rotmat, cam_intrinsics,
                scale, center, img_w, img_h)

    gt_verts, gt_j24 = _gendered_gt_mesh(
        assets_by_gender if use_gender else {'neutral': neutral},
        pose, betas, gender)
    pred_j24 = S.smpl_forward(
        neutral, betas=out['pred_shape'],
        body_pose=out['pred_pose'][:, 1:],
        global_orient=out['pred_pose'][:, 0:1],
        pose2rot=False, joint_set='native').joints_native

    verts = out['smpl_vertices']
    return (out, M.eval_mesh_j14_head(verts, gt_verts, jreg, subset=protocol),
            M.eval_joints_24_head(pred_j24, gt_j24),
            M.v2v_error(verts, gt_verts))


def _procrustes_tail(head):
    """-> (out, j14, j24, v2v) as the reference's step returns them, each
    protocol's PA-MPJPE computed here (eagerly: SVD)."""
    out, j14, j24, v2v = head
    return out, M.pa_tail(j14), M.pa_tail(j24), v2v


class EvalStep:
    """``step(batch) -> (out, j14, j24, v2v)`` over a dict of tensors on
    the model's device holding ``BATCH_KEYS``, in inference mode.
    ``head`` is the captured
    part (a :class:`StageGraph`); :meth:`eager` runs its body directly,
    for holding replays to it."""

    def __init__(self, head: StageGraph):
        self.head = head

    def __call__(self, batch: dict):
        with torch.inference_mode():
            return _procrustes_tail(
                self.head(*[batch[k] for k in BATCH_KEYS]))

    def eager(self, batch: dict):
        with torch.inference_mode():
            return _procrustes_tail(
                self.head.fn(*[batch[k] for k in BATCH_KEYS]))


def make_eval_step(model, assets_by_gender: dict, j_regressor_h36m,
                   use_gender: bool = False, protocol: str = 'j14',
                   mesh=None) -> EvalStep:
    """One eval step on the model's device (see the module docstring).

    ``protocol``: 'j14' (default) or 'j17' (mpi-inf-3dhp's 17 H36M
    joints). ``assets_by_gender``: 'neutral', and 'male' / 'female' for
    ``use_gender``; each is moved to the model's device with the fused
    kernel's operands attached."""
    if mesh is not None:
        raise NotImplementedError(
            'make_eval_step(mesh=...): data-parallel eval is not ported yet '
            '(ROADMAP.md §1 item 12)')
    device = next(model.parameters()).device
    model.eval()
    genders = ('neutral', 'male', 'female') if use_gender else ('neutral',)
    dev_assets = {g: S.fused_on(assets_by_gender[g], device)
                  for g in genders if g in assets_by_gender}
    jreg = torch.as_tensor(np.asarray(j_regressor_h36m), dtype=torch.float32,
                           device=device)
    return EvalStep(StageGraph('eval_step', functools.partial(
        _step_head, model, dev_assets, jreg, use_gender, protocol)))


# Memoized steps, first in first out: each holds the model, the assets
# on the device and a CUDA graph per batch shape.
_EVAL_STEP_CACHE: dict = {}
_EVAL_STEP_CACHE_MAX = 4


def evaluate_dataset(
    model,
    variables,
    loader,
    assets_by_gender: dict,
    j_regressor_h36m,
    use_gt_cam: bool = False,
    use_gender: bool = False,
    save_results: bool = True,
    save_images: bool = False,
    save_freq: int = 1,
    logdir: Optional[str] = None,
    dataset_name: str = '',
    mesh=None,
):
    """The in-loop eval pass over ``loader``'s batches on the model's
    device. Returns (the mm summary, the :class:`MetricAccumulator`);
    with ``logdir`` and ``save_results`` it also writes
    ``evaluation_results_{dataset_name}.pkl`` (joblib).

    ``variables``: a state_dict loaded into ``model`` once before the
    pass (one upload), or None for the model's own weights.
    ``use_gt_cam``: the GT camera (``cam_rotmat``, ``cam_int``) or
    CamCalib's (``pred_cam_rotmat``, ``pred_cam_int``). ``save_images``
    with ``logdir``: render the first sample of every ``save_freq``-th
    batch to ``val_images/`` (:func:`render_val_group`)."""
    protocol = 'j17' if dataset_name == 'mpi-inf-3dhp' else 'j14'
    qualitative = dataset_name in ('mpii', 'coco')
    if qualitative and not save_images:
        raise SystemExit(
            f'{dataset_name} is an in-the-wild dataset (no 3D GT): set '
            'TESTING.SAVE_IMAGES True — its evaluation is qualitative '
            'only (reference spec/trainer.py:262-269)')
    if mesh is not None:
        raise NotImplementedError(
            'evaluate_dataset(mesh=...): data-parallel eval is not ported '
            'yet (ROADMAP.md §1 item 12)')
    if variables is not None:
        model.load_state_dict(variables)
    device = next(model.parameters()).device

    key = (id(model), id(assets_by_gender), id(j_regressor_h36m),
           use_gender, protocol, str(device))
    entry = _EVAL_STEP_CACHE.get(key)
    if entry is None:
        while len(_EVAL_STEP_CACHE) >= _EVAL_STEP_CACHE_MAX:
            _EVAL_STEP_CACHE.pop(next(iter(_EVAL_STEP_CACHE)))
        step = make_eval_step(model, assets_by_gender, j_regressor_h36m,
                              use_gender=use_gender, protocol=protocol)
        # the entry holds the key's objects, so their ids stay theirs
        entry = _EVAL_STEP_CACHE[key] = (step, model, assets_by_gender,
                                         j_regressor_h36m)
    step = entry[0]
    acc = MetricAccumulator(save_results=save_results)

    cam_keys = (('cam_rotmat', 'cam_int') if use_gt_cam
                else ('pred_cam_rotmat', 'pred_cam_int'))
    keys = BATCH_KEYS[:-2] + cam_keys
    with torch.inference_mode():
        for batch_idx, batch in enumerate(
                device_prefetch(loader, device, tensor_keys=keys)):
            dev = {k: batch[k] for k in BATCH_KEYS[:-2]}
            dev['cam_rotmat'] = batch[cam_keys[0]]
            dev['cam_intrinsics'] = batch[cam_keys[1]]
            out, j14, j24, v2v = step(dev)
            if qualitative:
                # no 3D GT: zero errors; the pass exists for its renders
                B = len(batch['imgname'])
                j14 = {k: np.zeros((B, 14)) for k in ('per_joint_mpjpe',
                                                      'per_joint_pa')}
                j24 = {k: np.zeros((B, 24)) for k in ('per_joint_mpjpe',
                                                      'per_joint_pa')}
                v2v = np.zeros((B,))
            acc.add_batch(batch['imgname'], batch['dataset_name'], j14, j24,
                          v2v, pred=out,
                          valid_count=batch.get('_valid_count'))
            if save_images and logdir and batch_idx % save_freq == 0:
                vis_dir = os.path.join(logdir, 'val_images')
                os.makedirs(vis_dir, exist_ok=True)
                render_val_group(
                    batch, out, assets_by_gender['neutral'], cam_keys,
                    save_filename=os.path.join(
                        vis_dir, f'{dataset_name}_b{batch_idx:05d}.jpg'))

    summary = acc.summary()
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        if save_results:
            import joblib

            joblib.dump(
                acc.results_dict(),
                os.path.join(logdir, f'evaluation_results_{dataset_name}.pkl'))
    return summary, acc


def _host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.cpu().numpy()


def render_val_group(batch, out, assets, cam_keys, save_filename=None):
    """Input | overlay | 270-degree side view of the batch's first sample
    (float32 [0, 1], (res, 3 * res, 3)), rendered with the camera of the
    metrics pass (``cam_keys``: the GT's or CamCalib's rotation and
    intrinsics) over ``disp_img`` when the batch has it, else ``img``;
    written as a JPEG to ``save_filename`` when given (cv2). The
    full-image intrinsics are mapped through the SPIN crop, since the
    rendered image is the box-centred crop (``crop_intrinsics``)."""
    from spec_tpu_torch.utils.renderer import (
        crop_intrinsics,
        render_image_group,
    )

    img = _host(batch['disp_img'][0] if 'disp_img' in batch
                else batch['img'][0])
    focal, ctr = crop_intrinsics(
        _host(batch[cam_keys[1]][0]), _host(batch['center'][0]),
        _host(batch['scale'][0]), img.shape[0])
    return render_image_group(
        img,
        camera_translation=_host(out['pred_cam_t'][0]),
        vertices=_host(out['smpl_vertices'][0]),
        camera_rotation=_host(batch[cam_keys[0]][0]),
        focal_length=focal, camera_center=ctr,
        faces=_host(assets.faces), save_filename=save_filename)
