"""The yardstick's arithmetic: one H100's published peaks, the work of
kernel K1 (SMPL blendshapes and skinning, ``csrc/lbs.cu``) and the least
time it could take, and the floating-point operations of the model steps
counted on the plain reference networks. A roofline or MFU then reads the
same work whatever implements the kernel or the step."""

from __future__ import annotations

import functools

import torch

# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): fp32 on
# the CUDA cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# K1's coefficient rows: 10 betas, 207 pose features, 1 for the template.
K1_COEFFS = 10 + 207 + 1
JOINTS = 24


def k1_work(batch: int, vertices: int) -> tuple[float, float]:
    """K1's operations and bytes for ``batch`` meshes of ``vertices``
    vertices: per vertex and mesh 218 x 3 blendshape products, 24 x 12
    skinning products and the 3 x 4 transform (two operations each); the
    blendshape and weight columns of the vertices read once, each mesh's
    coefficients and 24 transforms (3 x 4) read and its vertices
    written, all fp32."""
    flops = 2.0 * batch * vertices * (3 * K1_COEFFS + JOINTS * 12 + 12)
    nbytes = 4.0 * (3 * K1_COEFFS * vertices + JOINTS * vertices
                    + batch * K1_COEFFS + batch * JOINTS * 12
                    + batch * vertices * 3)
    return flops, nbytes


def bound_s(flops: float, nbytes: float,
            peak: float = PEAK_FP32_FLOPS) -> float:
    """The least time the card could take: operations at the peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def k1_bound_s(batch: int, vertices: int) -> float:
    return bound_s(*k1_work(batch, vertices))


def count_flops(fn, *args) -> float:
    """Floating-point operations of ``fn(*args)`` as PyTorch's flop
    counter counts them (matmuls and convolutions, two per
    multiply-add). Run it on meta tensors: nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


@functools.cache
def camcalib_flops(backbone: str, h: int, w: int) -> float:
    """One frame of CamCalib at the resized size h x w."""
    from benchmark.reference import nets

    with torch.device('meta'):
        model = nets.CamCalib(backbone)
        return count_flops(model, torch.empty(1, 3, h, w))


@functools.cache
def person_flops(backbone: str, res: int, vertices: int) -> float:
    """One person through the regressor (a res x res crop) and SMPL's
    blendshapes, joints and skinning."""
    from benchmark.reference import nets
    from benchmark.reference.smpl import lbs, joints49

    with torch.device('meta'):
        model = nets.HMR(backbone)
        assets = {'v_template': torch.empty(vertices, 3),
                  'shapedirs': torch.empty(10, vertices * 3),
                  'posedirs': torch.empty(207, vertices * 3),
                  'j_regressor': torch.empty(24, vertices),
                  'j_regressor_extra': torch.empty(9, vertices),
                  'lbs_weights': torch.empty(vertices, 24)}

        def step(x):
            out = model(x)
            verts, j24 = lbs(assets, out['pred_shape'], out['pred_pose'])
            return joints49(assets, verts, j24)

        return count_flops(step, torch.empty(1, 3, res, res))


@functools.cache
def train_crop_flops(backbone: str, res: int, vertices: int) -> float:
    """One crop of SPEC's train step: the regressor forward and backward,
    the ground-truth and the predicted SMPL, the loss."""
    from benchmark.reference import nets
    from benchmark.reference import train as RT

    with torch.device('meta'):
        model = nets.HMR(backbone)
        assets = {'v_template': torch.empty(vertices, 3),
                  'shapedirs': torch.empty(10, vertices * 3),
                  'posedirs': torch.empty(207, vertices * 3),
                  'j_regressor': torch.empty(24, vertices),
                  'j_regressor_extra': torch.empty(9, vertices),
                  'lbs_weights': torch.empty(vertices, 24)}
        batch = {'img': torch.empty(2, res, res, 3),
                 'pose': torch.empty(2, 72), 'betas': torch.empty(2, 10),
                 'pose_conf': torch.empty(2, 24),
                 'pose_3d': torch.empty(2, 24, 4),
                 'keypoints_orig': torch.empty(2, 49, 3),
                 'has_smpl': torch.empty(2), 'has_pose_3d': torch.empty(2),
                 'orig_shape': torch.empty(2, 2), 'scale': torch.empty(2),
                 'center': torch.empty(2, 2),
                 'cam_rotmat': torch.empty(2, 3, 3),
                 'cam_intrinsics': torch.empty(2, 3, 3)}

        def step():
            gt = RT.gt_vertices(assets, batch)
            RT.spec_loss(RT.forward(model, assets, batch, None), batch,
                         gt).backward()

        return count_flops(step) / 2
