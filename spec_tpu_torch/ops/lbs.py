"""Fused SMPL blendshape + linear-blend-skinning vertices: the wrapper of
the CUDA kernel ``csrc/lbs.cu`` and its plain PyTorch twin.

Port of ``spec_tpu/ops/pallas/lbs.py``. The operands are packed once
(:func:`pack_lbs_operands`, same layout as the JAX package):

* ``dirs`` (3, 218, Vp): per coordinate, [shapedirs | posedirs |
  v_template] stacked along the 218 coefficient rows;
* ``weights_t`` (24, Vp): skinning weights, transposed;
* the joint regressor pre-projected onto the shape blendshapes, so rest
  joints never need the mesh.

Then per call ``posed_c = coeffs @ dirs[c]`` with ``coeffs = [betas |
(R - I) pose features | 1]`` (:func:`lbs_coeffs`), the 12 blended
transform rows ``t_k = A_k @ weights_t``, and ``out_i = t_{i0} px +
t_{i1} py + t_{i2} pz + t_{i3}``, all in exact fp32.

:func:`fused_lbs_vertices` runs the custom op ``spec_tpu_torch::fused_lbs``
(:func:`fused_lbs`), which launches the kernel for CUDA tensors and runs
:func:`fused_lbs_vertices_plain` for CPU tensors; nothing falls back from
one to the other. The op has a fake implementation, so ``torch.export``
carries it into a program as one node, and the program runs the kernel or
the plain version by the device it is loaded on. Its backward, on both
devices, is the reference's closed form (:func:`fused_lbs_backward`).
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from spec_tpu_torch.utils.precision import fp32_precision

V_TILE = 512  # V is padded to a multiple of this (the JAX package's tile)
NUM_JOINTS = 24

# Kernel launches made by fused_lbs_vertices in this process.
LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PackedLBSOperands:
    """Kernel-ready SMPL tensors (see :func:`pack_lbs_operands`)."""

    dirs: torch.Tensor             # (3, 218, Vp) [shapedirs|posedirs|template]
    weights_t: torch.Tensor        # (24, Vp)
    joints_template: torch.Tensor  # (24, 3)
    shapedirs_j: torch.Tensor      # (10, 72) regressor-projected shape dirs
    num_vertices: int

    def to(self, device) -> 'PackedLBSOperands':
        return dataclasses.replace(
            self, dirs=self.dirs.to(device),
            weights_t=self.weights_t.to(device),
            joints_template=self.joints_template.to(device),
            shapedirs_j=self.shapedirs_j.to(device))


def pack_lbs_operands(assets) -> PackedLBSOperands:
    """Precompute the packed layout from ``SMPLAssets`` (one-time, numpy
    on the host; the result lies on the CPU)."""
    V = assets.num_vertices
    Vp = _round_up(V, V_TILE)
    J = assets.num_joints
    P = (J - 1) * 9

    shapedirs = assets.shapedirs.detach().cpu().numpy()      # (10, V*3)
    posedirs = assets.posedirs.detach().cpu().numpy()        # (207, V*3)
    v_template = assets.v_template.detach().cpu().numpy()    # (V, 3)
    jreg = assets.j_regressor.detach().cpu().numpy()         # (24, V)
    weights = assets.lbs_weights.detach().cpu().numpy()      # (V, 24)

    dirs = np.zeros((3, 10 + P + 1, Vp), np.float32)
    sd = shapedirs.reshape(10, V, 3)
    pd = posedirs.reshape(P, V, 3)
    for c in range(3):
        dirs[c, :10, :V] = sd[..., c]
        dirs[c, 10:10 + P, :V] = pd[..., c]
        dirs[c, 10 + P, :V] = v_template[:, c]

    weights_t = np.zeros((J, Vp), np.float32)
    weights_t[:, :V] = weights.T

    joints_template = jreg @ v_template                        # (24, 3)
    shapedirs_j = np.einsum('jv,kvc->kjc', jreg, sd).reshape(10, J * 3)

    return PackedLBSOperands(
        dirs=torch.from_numpy(dirs),
        weights_t=torch.from_numpy(weights_t),
        joints_template=torch.from_numpy(
            np.ascontiguousarray(joints_template, np.float32)),
        shapedirs_j=torch.from_numpy(
            np.ascontiguousarray(shapedirs_j, np.float32)),
        num_vertices=V,
    )


def lbs_coeffs(betas: torch.Tensor, rotmats: torch.Tensor) -> torch.Tensor:
    """[betas | (R - I) pose features | 1] -> (B, 218)."""
    B = betas.shape[0]
    eye = torch.eye(3, dtype=torch.float32, device=rotmats.device)
    pose_feat = (rotmats[:, 1:].float() - eye).reshape(B, -1)
    ones = torch.ones((B, 1), dtype=torch.float32, device=betas.device)
    return torch.cat([betas.float(), pose_feat, ones], dim=-1)


def _check_operands(packed: PackedLBSOperands, coeffs: torch.Tensor,
                    rel_tf: torch.Tensor) -> None:
    """Raise on anything the kernel does not take, before any launch."""
    named = {'dirs': packed.dirs, 'weights_t': packed.weights_t,
             'coeffs': coeffs, 'rel_tf': rel_tf}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f'fused_lbs_vertices: {name} must be float32, '
                            f'got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'fused_lbs_vertices: {name} must be '
                             'contiguous')
        if t.device != coeffs.device:
            raise ValueError(f'fused_lbs_vertices: {name} is on {t.device}, '
                             f'coeffs on {coeffs.device}')
    if packed.dirs.ndim != 3 or packed.dirs.shape[0] != 3:
        raise ValueError('fused_lbs_vertices: dirs must be (3, C, Vp), got '
                         f'{tuple(packed.dirs.shape)}')
    _, C, Vp = packed.dirs.shape
    # The kernel copies dirs rows and rel_tf in 16-byte vectors.
    if Vp % 4:
        raise ValueError(f'fused_lbs_vertices: dirs rows must hold a '
                         f'multiple of 4 vertices, got Vp = {Vp}')
    if not torch.compiler.is_exporting():   # fake tensors have no data
        _check_aligned(packed.dirs, rel_tf)
    if tuple(packed.weights_t.shape) != (NUM_JOINTS, Vp):
        raise ValueError(f'fused_lbs_vertices: weights_t must be '
                         f'({NUM_JOINTS}, {Vp}), got '
                         f'{tuple(packed.weights_t.shape)}')
    if not 0 < packed.num_vertices <= Vp:
        raise ValueError(f'fused_lbs_vertices: num_vertices '
                         f'{packed.num_vertices} outside (0, {Vp}]')
    if coeffs.ndim != 2 or coeffs.shape[1] != C:
        raise ValueError(f'fused_lbs_vertices: coeffs must be (B, {C}), got '
                         f'{tuple(coeffs.shape)}')
    B = coeffs.shape[0]
    if tuple(rel_tf.shape) != (B, NUM_JOINTS, 3, 4):
        raise ValueError(f'fused_lbs_vertices: rel_tf must be '
                         f'({B}, {NUM_JOINTS}, 3, 4), got '
                         f'{tuple(rel_tf.shape)}')


def _check_aligned(dirs: torch.Tensor, rel_tf: torch.Tensor) -> None:
    """The kernel copies dirs rows and rel_tf in 16-byte vectors."""
    for name, t in (('dirs', dirs), ('rel_tf', rel_tf)):
        if t.data_ptr() % 16:
            raise ValueError(f'fused_lbs_vertices: {name} must start on a '
                             '16-byte boundary')


def fused_lbs_vertices_plain(packed: PackedLBSOperands, coeffs: torch.Tensor,
                             rel_tf: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain PyTorch (einsums, fp32, TF32 off)."""
    return _plain(packed.dirs, packed.weights_t, coeffs, rel_tf,
                  packed.num_vertices)


def _plain(dirs, weights_t, coeffs, rel_tf, num_vertices: int):
    B = coeffs.shape[0]
    V = num_vertices
    with fp32_precision():
        posed = torch.einsum('bm,cmv->bvc', coeffs, dirs[:, :, :V])
        t = torch.einsum('bjk,jv->bvk', rel_tf.reshape(B, NUM_JOINTS, 12),
                         weights_t[:, :V]).reshape(B, V, 3, 4)
    return (t[..., 0] * posed[..., None, 0] + t[..., 1] * posed[..., None, 1]
            + t[..., 2] * posed[..., None, 2] + t[..., 3])


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its argument types."""
    from spec_tpu_torch.ops.cuda_build import load_library

    fn = load_library('lbs').spec_lbs_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(dirs: torch.Tensor, weights_t: torch.Tensor,
            coeffs: torch.Tensor, rel_tf: torch.Tensor,
            num_vertices: int) -> torch.Tensor:
    global LAUNCHES
    fn = _kernel()
    B = coeffs.shape[0]
    _, C, Vp = dirs.shape
    out = torch.empty((B, num_vertices, 3), dtype=torch.float32,
                      device=coeffs.device)
    if B == 0:
        return out
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        err = fn(dirs.data_ptr(), weights_t.data_ptr(), coeffs.data_ptr(),
                 rel_tf.data_ptr(), out.data_ptr(), B, C, num_vertices, Vp,
                 stream)
    if err != 0:
        raise RuntimeError(f'lbs kernel launch failed with CUDA error {err}')
    LAUNCHES += 1
    return out


def fused_lbs_backward(dirs: torch.Tensor, weights_t: torch.Tensor,
                       coeffs: torch.Tensor, rel_tf: torch.Tensor,
                       num_vertices: int, grad: torch.Tensor,
                       needs=(True, True, True, True)):
    """Closed-form cotangents of the vertex pipeline (the port of
    ``spec_tpu/ops/pallas/lbs.py:_fused_core_bwd``).

    The output is bilinear in (coeffs, rel_tf) given (dirs, weights_t):
    ``out_i = sum_k t_{ik} posed_k + t_{i3}`` with ``posed_c = coeffs @
    dirs[c]`` and ``t = A @ weights_t``. ``posed`` and ``t`` are
    recomputed here rather than saved by the forward. ``grad`` (B, V, 3)
    is zero-padded to Vp, so the packed operands' cotangents are zero on
    the padding. fp32 einsums with TF32 off. Returns (d dirs (3, C, Vp),
    d weights_t (24, Vp), d coeffs (B, C), d rel_tf (B, 24, 3, 4)); an
    entry whose ``needs`` flag is False is None and not computed (a train
    step differentiates coeffs and rel_tf only).
    """
    B = coeffs.shape[0]
    Vp = dirs.shape[-1]
    g = grad.new_zeros((3, B, Vp))
    g[:, :, :num_vertices] = grad.float().permute(2, 0, 1)
    a = rel_tf.reshape(B, NUM_JOINTS, 3, 4).permute(2, 3, 0, 1)  # (3,4,B,24)
    with fp32_precision():
        posed = torch.einsum('bm,cmv->cbv', coeffs, dirs)        # (3, B, Vp)
        t4 = torch.einsum('ikbj,jv->ikbv', a, weights_t)         # (3,4,B,Vp)
        # d posed_c = sum_i g_i t_{ic} (c < 3)
        dposed = torch.einsum('ibv,icbv->cbv', g, t4[:, :3])
        dcoeffs = (torch.einsum('cbv,cmv->bm', dposed, dirs)
                   if needs[2] else None)
        # d t_{ik} = g_i posed_k (k < 3); d t_{i3} = g_i
        dt4 = torch.cat([torch.einsum('ibv,kbv->ikbv', g, posed),
                         g[:, None]], dim=1)
        da = (torch.einsum('ikbv,jv->bjik', dt4, weights_t)     # (B,24,3,4)
              if needs[3] else None)
        ddirs = (torch.einsum('bm,cbv->cmv', coeffs, dposed)
                 if needs[0] else None)
        dwt = torch.einsum('ikbj,ikbv->jv', a, dt4) if needs[1] else None
    return ddirs, dwt, dcoeffs, da


# One op with an implementation per device, so that a program traced by
# ``torch.export`` on any device carries the op itself: it runs the plain
# version on the CPU and the kernel on a card.
@torch.library.custom_op('spec_tpu_torch::fused_lbs', mutates_args=(),
                         device_types='cpu')
def fused_lbs(dirs: torch.Tensor, weights_t: torch.Tensor,
              coeffs: torch.Tensor, rel_tf: torch.Tensor,
              num_vertices: int) -> torch.Tensor:
    """The packed operands' vertices (B, V, 3): the plain version on the
    CPU, the kernel (:func:`_launch`) on a CUDA device. Contiguous on
    both, as the fake implementation says."""
    out = _plain(dirs, weights_t, coeffs, rel_tf, num_vertices)
    return out.contiguous()


fused_lbs.register_kernel('cuda')(_launch)


@fused_lbs.register_fake
def _fake(dirs, weights_t, coeffs, rel_tf, num_vertices):
    return coeffs.new_empty((coeffs.shape[0], num_vertices, 3))


def _setup_context(ctx, inputs, output):
    dirs, weights_t, coeffs, rel_tf, num_vertices = inputs
    ctx.save_for_backward(dirs, weights_t, coeffs, rel_tf)
    ctx.num_vertices = num_vertices


def _backward(ctx, grad_out):
    """:func:`fused_lbs_backward` from the saved operands; no cotangent
    for ``num_vertices``."""
    dirs, weights_t, coeffs, rel_tf = ctx.saved_tensors
    return (*fused_lbs_backward(dirs, weights_t, coeffs, rel_tf,
                                ctx.num_vertices, grad_out,
                                ctx.needs_input_grad[:4]), None)


fused_lbs.register_autograd(_backward, setup_context=_setup_context)


def fused_lbs_vertices(packed: PackedLBSOperands, coeffs: torch.Tensor,
                       rel_tf: torch.Tensor) -> torch.Tensor:
    """-> vertices (B, V, 3).

    coeffs (B, 218) from :func:`lbs_coeffs`; rel_tf (B, 24, 3, 4) the
    rest-corrected joint transforms. Runs the op
    ``spec_tpu_torch::fused_lbs``: CUDA tensors launch the kernel, CPU
    tensors run the plain version; any other device raises.
    """
    _check_operands(packed, coeffs, rel_tf)
    if coeffs.device.type not in ('cpu', 'cuda'):
        raise ValueError('fused_lbs_vertices runs on CUDA (kernel) or CPU '
                         f'(plain version), not {coeffs.device}')
    return fused_lbs(packed.dirs, packed.weights_t, coeffs, rel_tf,
                     packed.num_vertices)
