"""SMPL and SPEC's camera head in plain PyTorch float32: blendshapes,
joint regression, the kinematic chain and linear blend skinning as the
SMPL paper states them (Loper et al. 2015), SPIN's 49-joint set, and the
full-frame projection of SPEC."""

from __future__ import annotations

import torch

from benchmark.reference import geometry as G

# SMPL's kinematic tree (parent of each of the 24 joints).
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
           17, 18, 19, 20, 21)
# Surface landmarks appended to the 24 joints: 5 face, 6 feet, 10
# fingertips (SMPL vertex ids).
EXTRA_VERTEX_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617,
                    6624, 6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782,
                    5905, 6016, 6133)
# SPIN's 49 joints out of [24 SMPL joints | 21 landmarks | 9 regressed]:
# 25 OpenPose joints, then 24 dataset joints.
JOINT49 = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27,
           28, 29, 30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16,
           18, 20, 47, 48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27)


def lbs(assets: dict, betas: torch.Tensor, rotmats: torch.Tensor):
    """betas (B, 10), rotmats (B, 24, 3, 3) -> vertices (B, V, 3) and the
    24 posed joints (B, 24, 3). ``assets``: v_template (V, 3), shapedirs
    (10, 3V), posedirs (207, 3V), j_regressor (24, V), lbs_weights
    (V, 24)."""
    B, V = betas.shape[0], assets['v_template'].shape[0]
    v_shaped = assets['v_template'] + (betas @ assets['shapedirs']).reshape(
        B, V, 3)
    joints = torch.einsum('jv,bvc->bjc', assets['j_regressor'], v_shaped)
    eye = torch.eye(3, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + (pose_feat @ assets['posedirs']).reshape(B, V, 3)

    def tf(R, t):
        top = torch.cat([R, t[..., None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device)
        return torch.cat([top, bottom.expand(B, 1, 4)], dim=-2)

    world = [tf(rotmats[:, 0], joints[:, 0])]
    for j in range(1, 24):
        p = PARENTS[j]
        world.append(world[p] @ tf(rotmats[:, j], joints[:, j] - joints[:, p]))
    world = torch.stack(world, dim=1)                       # (B, 24, 4, 4)
    rel = world.clone()
    rel[..., :3, 3] -= torch.einsum('bjxy,bjy->bjx', world[..., :3, :3],
                                    joints)
    T = torch.einsum('vj,bjpq->bvpq', assets['lbs_weights'], rel)
    verts = torch.einsum('bvpq,bvq->bvp', T[..., :3, :3], v_posed) \
        + T[..., :3, 3]
    return verts, world[..., :3, 3]


def joints49(assets: dict, verts: torch.Tensor, joints24: torch.Tensor):
    extra = torch.einsum('jv,bvc->bjc', assets['j_regressor_extra'], verts)
    j54 = torch.cat([joints24, verts[:, list(EXTRA_VERTEX_IDS)], extra], 1)
    return j54[:, list(JOINT49)]


def cam_head(assets, hmr_out, cam_rotmat, focal, center, scale, img_w,
             img_h, crop_res):
    """SPEC's SMPL head: the mesh and 49 joints of the regressed pose and
    shape, the crop camera lifted into the full frame, and the joints
    projected with the frame's camera (rotation ``cam_rotmat``, focal
    length ``focal`` in pixels)."""
    verts, j24 = lbs(assets, hmr_out['pred_shape'], hmr_out['pred_pose'])
    j49 = joints49(assets, verts, j24)
    cam_t = G.full_translation(hmr_out['pred_cam'], center, scale, img_w,
                               img_h, focal, crop_res)
    j2d = G.project(j49, cam_rotmat, cam_t, focal, img_w, img_h)
    return {'smpl_vertices': verts, 'smpl_joints3d': j49,
            'smpl_joints2d': j2d, 'pred_cam_t': cam_t}
