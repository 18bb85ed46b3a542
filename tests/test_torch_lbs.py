"""spec_tpu_torch.ops.lbs (the fused LBS kernel's wrapper, its plain
twin and the operand packing) vs spec_tpu.ops.pallas.lbs.

On the CPU the wrapper runs the plain version; the JAX side runs the
Pallas kernel in interpret mode and the plain jnp ``lbs``. Budget: 1e-5 m
(the Pallas kernel's own budget, tests/test_pallas_lbs.py). The CUDA
kernel itself is compared with the plain version on a card by
tests/test_torch_cuda_lbs.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.core.geometry import rodrigues
from spec_tpu.ops.pallas import lbs as JL
from spec_tpu_torch.core import smpl as TS
from spec_tpu_torch.ops import lbs as TL


def _inputs(rng, B, V):
    assets = JS.create_test_assets(num_vertices=V)
    betas = rng.randn(B, 10).astype('f4') * 0.3
    rotmats = np.array(rodrigues(jnp.asarray(
        rng.randn(B, 24, 3).astype('f4') * 0.3)))
    return assets, betas, rotmats


def _kernel_operands(assets, betas, rotmats):
    """coeffs (B, 218) and rest-corrected rel_tf (B, 24, 3, 4), built by
    the JAX package: the exact inputs of its fused_lbs_vertices."""
    packed = JL.pack_lbs_operands(assets)
    jb, jr = jnp.asarray(betas), jnp.asarray(rotmats)
    B = betas.shape[0]
    joints_rest = packed.joints_template[None] + (
        jb @ packed.shapedirs_j).reshape(B, 24, 3)
    world = JS._rigid_transform_chain(jr, joints_rest, assets.parents)
    corr = jnp.einsum('bjxy,bjy->bjx', world[..., :3, :3], joints_rest)
    rel_tf = world.at[..., :3, 3].add(-corr)[..., :3, :]
    return packed, np.array(JL.lbs_coeffs(jb, jr)), np.array(rel_tf)


def test_pack_lbs_operands_equal():
    assets = JS.create_test_assets(num_vertices=333)
    ref = JL.pack_lbs_operands(assets)
    port = TL.pack_lbs_operands(TS.create_test_assets(num_vertices=333))
    assert port.num_vertices == ref.num_vertices == 333
    for name in ('dirs', 'weights_t', 'joints_template', 'shapedirs_j'):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_lbs_coeffs_equal(rng):
    _, betas, rotmats = _inputs(rng, 3, 64)
    np.testing.assert_allclose(
        TL.lbs_coeffs(torch.from_numpy(betas), torch.from_numpy(rotmats)),
        np.asarray(JL.lbs_coeffs(jnp.asarray(betas), jnp.asarray(rotmats))),
        atol=0)


# Besides the first three, the card test's edge shapes (the CUDA kernel's
# 16-row passes and 32-vertex tiles), so that its reference, the plain
# version, is held to Pallas at those shapes too.
@pytest.mark.parametrize('B,V', [(4, 640), (3, 333), (2, 6890), (1, 20),
                                 (17, 20), (2, 333), (33, 333), (64, 333),
                                 (6, 1000)])
def test_fused_vertices_match_jax(rng, B, V):
    assets, betas, rotmats = _inputs(rng, B, V)
    packed_j, coeffs, rel_tf = _kernel_operands(assets, betas, rotmats)
    ref_kernel = np.asarray(JL.fused_lbs_vertices(
        packed_j, jnp.asarray(coeffs), jnp.asarray(rel_tf), interpret=True))
    ref_plain = np.asarray(JS.lbs(assets, jnp.asarray(betas),
                                  jnp.asarray(rotmats))[0])

    before = TL.LAUNCHES
    port = TL.fused_lbs_vertices(
        TL.pack_lbs_operands(TS.create_test_assets(num_vertices=V)),
        torch.from_numpy(coeffs), torch.from_numpy(rel_tf)).numpy()
    assert port.shape == (B, V, 3)
    np.testing.assert_allclose(port, ref_kernel, atol=1e-5)
    np.testing.assert_allclose(port, ref_plain, atol=1e-5)
    assert TL.LAUNCHES == before == 0   # CPU tensors never launch


def _valid_operands(rng, B=2, V=100):
    assets, betas, rotmats = _inputs(rng, B, V)
    _, coeffs, rel_tf = _kernel_operands(assets, betas, rotmats)
    packed = TL.pack_lbs_operands(TS.create_test_assets(num_vertices=V))
    return packed, torch.from_numpy(coeffs), torch.from_numpy(rel_tf)


@pytest.mark.parametrize('dtype', [torch.float64, torch.bfloat16])
def test_wrong_dtype_raises(rng, dtype):
    packed, coeffs, rel_tf = _valid_operands(rng)
    before = TL.LAUNCHES
    with pytest.raises(TypeError, match='coeffs must be float32'):
        TL.fused_lbs_vertices(packed, coeffs.to(dtype), rel_tf)
    with pytest.raises(TypeError, match='rel_tf must be float32'):
        TL.fused_lbs_vertices(packed, coeffs, rel_tf.to(dtype))
    assert TL.LAUNCHES == before


def _off_16_bytes(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype)
    start = (-flat.data_ptr() // 4) % 4 + 1
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize('bad', ['coeffs_width', 'rel_tf_shape',
                                 'batch_mismatch', 'noncontiguous',
                                 'dirs_misaligned', 'rel_tf_misaligned',
                                 'rows_not_multiple_of_4'])
def test_wrong_shape_or_layout_raises(rng, bad):
    packed, coeffs, rel_tf = _valid_operands(rng)
    before = TL.LAUNCHES
    match = None
    if bad == 'coeffs_width':
        coeffs = coeffs[:, :-1].contiguous()
    elif bad == 'rel_tf_shape':
        rel_tf = torch.zeros(2, 24, 4, 4)
    elif bad == 'batch_mismatch':
        rel_tf = rel_tf[:1].contiguous()
    elif bad == 'noncontiguous':
        rel_tf = rel_tf.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == 'dirs_misaligned':
        packed = dataclasses.replace(packed, dirs=_off_16_bytes(packed.dirs))
        match = 'dirs must start on a 16-byte boundary'
    elif bad == 'rel_tf_misaligned':
        rel_tf = _off_16_bytes(rel_tf)
        match = 'rel_tf must start on a 16-byte boundary'
    else:
        packed = dataclasses.replace(
            packed, dirs=packed.dirs[..., :102].contiguous(),
            weights_t=packed.weights_t[:, :102].contiguous())
        match = 'multiple of 4 vertices'
    with pytest.raises(ValueError, match=match):
        TL.fused_lbs_vertices(packed, coeffs, rel_tf)
    assert TL.LAUNCHES == before


def _plain_grads(packed, coeffs, rel_tf, grad):
    """Autograd of the plain version: cotangents of dirs, weights_t,
    coeffs and rel_tf."""
    leaves = [packed.dirs.clone().requires_grad_(True),
              packed.weights_t.clone().requires_grad_(True),
              coeffs.clone().requires_grad_(True),
              rel_tf.clone().requires_grad_(True)]
    out = TL.fused_lbs_vertices_plain(
        dataclasses.replace(packed, dirs=leaves[0], weights_t=leaves[1]),
        leaves[2], leaves[3])
    return torch.autograd.grad(out, leaves, grad)


def _assert_rel_close(got, want, rtol, name):
    """max |got - want| <= rtol * max |want|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rtol * scale, (name, err, scale)


GRAD_NAMES = ('dirs', 'weights_t', 'coeffs', 'rel_tf')


def test_plain_version_is_differentiable_kernel_backward_raises(rng):
    """The op's CPU path is differentiable, and the backward registered
    with the op (both devices) is the closed form: called on the operands
    the forward saves, it gives the plain version's four cotangents (1e-4
    relative, the TPU_CHECKS_r05.json budget), zero on the Vp padding;
    a cotangent of the wrong shape raises."""
    import types

    packed, coeffs, rel_tf = _valid_operands(rng)
    coeffs.requires_grad_(True)
    TL.fused_lbs_vertices(packed, coeffs, rel_tf).sum().backward()
    assert coeffs.grad is not None and torch.isfinite(coeffs.grad).all()

    coeffs = coeffs.detach()
    V = packed.num_vertices
    grad = torch.from_numpy(rng.randn(2, V, 3).astype('f4'))
    ctx = types.SimpleNamespace(
        saved_tensors=(packed.dirs, packed.weights_t, coeffs, rel_tf),
        num_vertices=V, needs_input_grad=(True,) * 5)
    got = TL._backward(ctx, grad)
    assert len(got) == 5 and got[4] is None
    for name, g, w in zip(GRAD_NAMES, got, _plain_grads(packed, coeffs,
                                                         rel_tf, grad)):
        assert g.shape == w.shape, name
        _assert_rel_close(g, w, 1e-4, name)
    assert not got[0][..., V:].any() and not got[1][:, V:].any()
    # a train step differentiates coeffs and rel_tf only: the packed
    # operands' cotangents are skipped, the other two unchanged
    ctx.needs_input_grad = (False, False, True, True, False)
    part = TL._backward(ctx, grad)
    assert part[0] is None and part[1] is None
    for g, w in zip(part[2:4], got[2:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        TL._backward(ctx, grad[:, :-1])


@pytest.mark.parametrize('B,V', [(1, 333), (8, 640), (3, 6890)])
def test_closed_form_backward_matches_jax_vjp(rng, B, V):
    """fused_lbs_backward against jax.vjp of spec_tpu's
    fused_lbs_vertices (the Pallas kernel in interpret mode, with its
    custom VJP) and against autograd of the plain version: every
    cotangent within 1e-4 relative of the largest entry."""
    import jax

    assets, betas, rotmats = _inputs(rng, B, V)
    packed_j, coeffs, rel_tf = _kernel_operands(assets, betas, rotmats)
    grad = rng.randn(B, V, 3).astype('f4')

    def f(dirs, wt, c, r):
        import dataclasses as dc
        return JL.fused_lbs_vertices(
            dc.replace(packed_j, dirs=dirs, weights_t=wt), c, r,
            interpret=True)

    _, vjp = jax.vjp(f, packed_j.dirs, packed_j.weights_t,
                     jnp.asarray(coeffs), jnp.asarray(rel_tf))
    ref = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(grad))]

    packed = TL.pack_lbs_operands(TS.create_test_assets(num_vertices=V))
    c, r, g = (torch.from_numpy(x) for x in (coeffs, rel_tf, grad))
    got = TL.fused_lbs_backward(packed.dirs, packed.weights_t, c, r, V, g)
    plain = _plain_grads(packed, c, r, g)
    for name, x, want_j, want_p in zip(GRAD_NAMES, got, ref, plain):
        assert x.shape == want_j.shape == want_p.shape, name
        _assert_rel_close(x, want_j, 1e-4, f'{name} vs jax.vjp')
        _assert_rel_close(x, want_p, 1e-4, f'{name} vs autograd')
