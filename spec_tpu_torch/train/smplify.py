"""In-loop SMPLify: fit SMPL pose, shape and translation to 2D keypoints
(torch twin of ``spec_tpu/train/smplify.py``).

Energy per sample, as the reference's: the Geman-McClure reprojection
error of the 49-joint set against the confidence-weighted keypoints,
an angle prior on knees and elbows, an L2 prior on betas and an L2
anchor of the body pose to its initial value. ``num_iters`` steps of
Adam (``optax.adam(lr)``: the moments, bias correction and eps 1e-8
outside the root, no weight decay; ``train/state.adam``'s foreach
update with its step count on the device) on the energy's gradient,
then a final forward.

On the card the whole fit is **one CUDA graph** per (B, ``num_iters``,
the weights): a ``utils/graphs.StageGraph`` over the fit's body, the
counterpart of the reference's ``lax.fori_loop`` inside one
``jax.jit``. The body builds no tensor from host data and reads nothing
back. With packed assets (``core/smpl.with_packed_lbs``) every SMPL
forward goes through the fused LBS kernel (K1) and its closed-form
backward, which computes the ``coeffs`` and ``rel_tf`` cotangents only:
``num_iters + 1`` K1 launches per fit. The projection runs under the
port's fp32 precision guard, and so does the whole body (TF32 off in
the backward too). On the CPU the body runs directly.

:func:`apply_smplify_update` is the acceptance rule; it runs on the
host after the fit, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from spec_tpu_torch.core.geometry import perspective_projection
from spec_tpu_torch.core.smpl import smpl_forward
from spec_tpu_torch.train.state import adam
from spec_tpu_torch.utils.graphs import StageGraph
from spec_tpu_torch.utils.precision import fp32_precision

# SMPL joints of the angle prior (knees L/R, elbows L/R) and the sign of
# their bending component (x for the knees, y for the elbows): SPIN's.
_BEND_JOINTS = (4, 5, 18, 19)
_BEND_SIGNS = (-1.0, -1.0, 1.0, -1.0)


def gmof(x: torch.Tensor, rho: float) -> torch.Tensor:
    """Geman-McClure robust error ``rho^2 x^2 / (x^2 + rho^2)``."""
    sq = x * x
    return (rho * rho) * sq / (sq + rho * rho)


def angle_prior(body_pose_aa: torch.Tensor) -> torch.Tensor:
    """``exp(sign * theta_bend)^2`` per bending joint: (B, 23, 3) axis-angle
    -> (B, 4); small in the valid bending direction, large under
    hyper-extension."""
    comps = []
    for j, sign in zip(_BEND_JOINTS, _BEND_SIGNS):
        c = 0 if j in (4, 5) else 1
        comps.append(torch.exp(body_pose_aa[:, j - 1, c] * sign))
    return torch.stack(comps, -1) ** 2


class SMPLifyResult(NamedTuple):
    global_orient: torch.Tensor   # (B, 1, 3) axis-angle
    body_pose: torch.Tensor       # (B, 23, 3) axis-angle
    betas: torch.Tensor           # (B, 10)
    cam_t: torch.Tensor           # (B, 3) camera-frame translation
    reproj_loss: torch.Tensor     # (B,) final per-sample reprojection loss
    vertices: torch.Tensor        # (B, V, 3) fitted mesh


def _reproj(assets, go, bp, betas, cam_t, conf, target, cam_rotmat, K,
            sigma, joint_set):
    out = smpl_forward(assets, betas, bp, go, pose2rot=True,
                       joint_set=joint_set)
    pix = perspective_projection(out.joints, cam_rotmat, cam_t, K)
    return (conf * gmof(pix - target, sigma).sum(-1)).sum(-1), out


def _fit_body(assets, go, bp, betas, cam_t, keypoints_2d, cam_rotmat, K, *,
              num_iters, lr, sigma, pose_prior_weight, shape_prior_weight,
              angle_prior_weight, joint_set):
    """The fit: tensors in, the :class:`SMPLifyResult` fields out."""
    with torch.inference_mode(False), torch.enable_grad(), fp32_precision():
        # Copies: the parameters are leaves of their own, and inputs made
        # under inference mode could not be saved for the backward.
        go, bp, betas, cam_t, keypoints_2d, cam_rotmat, K = (
            t.float().clone() for t in (go, bp, betas, cam_t, keypoints_2d,
                                        cam_rotmat, K))
        init_bp = bp
        conf = keypoints_2d[..., 2]
        target = keypoints_2d[..., :2]
        params = [t.clone().requires_grad_(True)
                  for t in (go, bp, betas, cam_t)]
        opt = adam(lr).init(params)
        for _ in range(num_iters):
            p_go, p_bp, p_betas, p_ct = params
            reproj, _ = _reproj(assets, p_go, p_bp, p_betas, p_ct, conf,
                                target, cam_rotmat, K, sigma, joint_set)
            total = (reproj
                     + pose_prior_weight ** 2
                     * ((p_bp - init_bp) ** 2).sum((-1, -2))
                     + shape_prior_weight ** 2 * (p_betas ** 2).sum(-1)
                     + angle_prior_weight ** 2
                     * angle_prior(p_bp).sum(-1))
            grads = torch.autograd.grad(total.sum(), params)
            opt.step(list(grads), True)
        with torch.no_grad():
            p_go, p_bp, p_betas, p_ct = (p.detach() for p in params)
            reproj, out = _reproj(assets, p_go, p_bp, p_betas, p_ct, conf,
                                  target, cam_rotmat, K, sigma, joint_set)
        return (p_go.clone(), p_bp.clone(), p_betas.clone(), p_ct.clone(),
                reproj, out.vertices)


# One StageGraph per assets object, first in first out; an entry holds
# its assets, so their id stays theirs.
_FIT_GRAPHS: dict = {}
_FIT_GRAPHS_MAX = 4


def _fit_graph(assets) -> StageGraph:
    entry = _FIT_GRAPHS.get(id(assets))
    if entry is None:
        while len(_FIT_GRAPHS) >= _FIT_GRAPHS_MAX:
            _FIT_GRAPHS.pop(next(iter(_FIT_GRAPHS)))
        entry = _FIT_GRAPHS[id(assets)] = (
            StageGraph('smplify_fit', functools.partial(_fit_body, assets)),
            assets)
    return entry[0]


def smplify_fit(
    assets,
    init_global_orient: torch.Tensor,   # (B, 1, 3) aa
    init_body_pose: torch.Tensor,       # (B, 23, 3) aa
    init_betas: torch.Tensor,           # (B, 10)
    init_cam_t: torch.Tensor,           # (B, 3)
    keypoints_2d: torch.Tensor,         # (B, 49, 3) pixel x, y, conf
    cam_rotmat: torch.Tensor,           # (B, 3, 3)
    cam_intrinsics: torch.Tensor,       # (B, 3, 3)
    num_iters: int = 100,
    lr: float = 1e-2,
    sigma: float = 100.0,
    pose_prior_weight: float = 4.78,
    shape_prior_weight: float = 5.0,
    angle_prior_weight: float = 15.2,
    joint_set: str = 'spin49',
    eager: bool = False,
) -> SMPLifyResult:
    """Fit SMPL to 2D keypoints on the tensors' device; on a card one
    graph replay per call (``eager`` runs the body without its graph,
    for holding replays to it). Returns the fitted axis-angle pose,
    betas, translation, the per-sample final reprojection loss
    (confidence-weighted GMoF summed over joints, comparable with
    ``TRAINING.SMPLIFY_THRESHOLD``) and the vertices."""
    fixed = dict(num_iters=int(num_iters), lr=float(lr),
                 sigma=float(sigma),
                 pose_prior_weight=float(pose_prior_weight),
                 shape_prior_weight=float(shape_prior_weight),
                 angle_prior_weight=float(angle_prior_weight),
                 joint_set=joint_set)
    args = (init_global_orient, init_body_pose, init_betas, init_cam_t,
            keypoints_2d, cam_rotmat, cam_intrinsics)
    if eager:
        out = _fit_body(assets, *args, **fixed)
    else:
        out = _fit_graph(assets)(*args, **fixed)
    return SMPLifyResult(*out)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def apply_smplify_update(batch: dict, result: SMPLifyResult,
                         threshold: float,
                         min_visible: float = 6.0) -> dict:
    """The acceptance rule of in-loop fitting, on the host: take the fit
    as SMPL supervision where (a) the sample has no genuine GT
    (``has_smpl`` 0: GT is never overwritten), (b) its reprojection loss
    per unit of keypoint confidence beats ``threshold`` and (c) at least
    ``min_visible`` confidence mass exists (without 2D evidence the fit
    is the network's own prediction pulled by priors).

    ``batch`` holds ``pose`` (B, 72 aa), ``betas`` (B, 10), ``has_smpl``
    (B,) and ``keypoints_orig`` (B, 49, 3), as numpy arrays or tensors.
    Returns a new dict whose ``pose``, ``betas`` and ``has_smpl`` are
    numpy arrays (the inputs are untouched)."""
    conf_mass = _np(batch['keypoints_orig'])[..., 2].sum(-1)
    n_vis = np.maximum(conf_mass, 1.0)
    per_joint = _np(result.reproj_loss) / n_vis
    has_smpl = _np(batch['has_smpl'])
    accept = ((per_joint < threshold) & (has_smpl < 0.5)
              & (conf_mass >= min_visible))

    pose_fit = np.concatenate(
        [_np(result.global_orient).reshape(-1, 3),
         _np(result.body_pose).reshape(len(accept), -1)], -1)
    out = dict(batch)
    m = accept[:, None].astype(np.float32)
    out['pose'] = m * pose_fit + (1 - m) * _np(batch['pose'])
    out['betas'] = m * _np(result.betas) + (1 - m) * _np(batch['betas'])
    out['has_smpl'] = np.maximum(has_smpl, accept.astype(np.float32))
    return out
