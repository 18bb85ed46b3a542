"""Full-perspective reprojection of batched point sets: the wrapper of the
CUDA kernel ``csrc/projection.cu`` and its plain PyTorch twin.

Port of ``spec_tpu/ops/pallas/projection.py``. The camera (R, t, K)
collapses to one 3x4 matrix ``P = K' [R | t]`` per batch row, where K'
is K with its third row forced to [0, 0, 1] (the reference leaves it
unset: it divides by depth before applying K). Then per point
``w = max(P2 . [X, 1], 1e-8)`` and pixel ``(P0 . [X, 1], P1 . [X, 1])
* (1 / w)``: the same pixels as ``geometry.perspective_projection``.

:func:`project_points` launches the kernel for CUDA tensors and runs
:func:`project_points_plain` for CPU tensors; nothing falls back from
one to the other. ``LAUNCHES`` counts kernel launches. The kernel
collapses the camera itself, so a call on fp32 contiguous operands is
one device operation; :func:`camera_matrix` serves the plain version.
The model heads keep ``geometry.perspective_projection`` for their 49
joints, as the JAX heads do; this is the full-mesh primitive.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spec_tpu_torch.utils.precision import fp32_precision

# Kernel launches made by project_points in this process.
LAUNCHES = 0


def camera_matrix(rotation: torch.Tensor, translation: torch.Tensor,
                  cam_intrinsics: torch.Tensor) -> torch.Tensor:
    """-> P = K' [R | t] (B, 3, 4) float32, K' = K with row 2 = [0, 0, 1]
    (fp32, TF32 off)."""
    K = cam_intrinsics.float().clone()
    K[:, 2, :2] = 0.0
    K[:, 2, 2] = 1.0
    with fp32_precision():
        KR = K @ rotation.float()
        Kt = torch.einsum('bij,bj->bi', K, translation.float())
    return torch.cat([KR, Kt[:, :, None]], dim=-1).contiguous()


def _check_operands(points, rotation, translation, cam_intrinsics) -> None:
    """Raise on anything the kernel does not take, before any launch."""
    if points.dtype != torch.float32:
        raise TypeError(f'project_points: points must be float32, got '
                        f'{points.dtype}')
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError('project_points: points must be (B, V, 3), got '
                         f'{tuple(points.shape)}')
    if not points.is_contiguous():
        raise ValueError('project_points: points must be contiguous')
    B = points.shape[0]
    for name, t, shape in (('rotation', rotation, (B, 3, 3)),
                           ('translation', translation, (B, 3)),
                           ('cam_intrinsics', cam_intrinsics, (B, 3, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f'project_points: {name} must be {shape}, got '
                             f'{tuple(t.shape)}')
        if not t.is_floating_point():
            raise TypeError(f'project_points: {name} must be floating '
                            f'point, got {t.dtype}')
        if t.device != points.device:
            raise ValueError(f'project_points: {name} is on {t.device}, '
                             f'points on {points.device}')


def project_points_plain(points: torch.Tensor, rotation: torch.Tensor,
                         translation: torch.Tensor,
                         cam_intrinsics: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain PyTorch (fp32, TF32 off)."""
    P = camera_matrix(rotation, translation, cam_intrinsics)
    with fp32_precision():
        uvw = torch.einsum('bij,bvj->bvi', P[:, :, :3], points.float())
    uvw = uvw + P[:, None, :, 3]
    inv_w = 1.0 / uvw[..., 2:3].clamp_min(1e-8)
    return uvw[..., :2] * inv_w


def _fp32_contiguous(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself when it is float32 and contiguous, else a float32
    contiguous copy made by one device operation."""
    if a.dtype == torch.float32 and a.is_contiguous():
        return a
    return torch.empty(a.shape, dtype=torch.float32,
                       device=a.device).copy_(a)


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its argument types."""
    from spec_tpu_torch.ops.cuda_build import load_library

    fn = load_library('projection').spec_project_points
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def project_points(points: torch.Tensor, rotation: torch.Tensor,
                   translation: torch.Tensor,
                   cam_intrinsics: torch.Tensor) -> torch.Tensor:
    """-> (B, V, 2) pixels, ``x_pix = K (R X + t)`` perspective-divided.

    points (B, V, 3) float32 contiguous; rotation (B, 3, 3), translation
    (B, 3), cam_intrinsics (B, 3, 3) on the same device. CUDA tensors
    launch the kernel; CPU tensors run the plain version; any other
    device raises. The kernel takes R, t and K as fp32 contiguous
    tensors: one that is not is cast or copied first (one more device
    operation each).
    """
    global LAUNCHES
    _check_operands(points, rotation, translation, cam_intrinsics)
    if points.device.type == 'cpu':
        return project_points_plain(points, rotation, translation,
                                    cam_intrinsics)
    if points.device.type != 'cuda':
        raise ValueError('project_points runs on CUDA (kernel) or CPU '
                         f'(plain version), not {points.device}')
    fn = _kernel()
    B, V, _ = points.shape
    out = torch.empty((B, V, 2), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    R, t, K = (_fp32_contiguous(a)
               for a in (rotation, translation, cam_intrinsics))
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = fn(points.data_ptr(), R.data_ptr(), t.data_ptr(),
                 K.data_ptr(), out.data_ptr(), B, V, stream)
    if err != 0:
        raise RuntimeError(f'projection kernel launch failed with CUDA '
                           f'error {err}')
    LAUNCHES += 1
    return out
