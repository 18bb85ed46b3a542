"""Seeded weights and SMPL assets, made on the device in a few large
calls, and the plain reference networks that carry them.

Every tensor comes from one ``torch.randn`` over all of a network's
parameters, drawn by a ``torch.Generator`` on the device from the run's
seed, then scaled per tensor: convolutions He-normal, BatchNorm's scale
near the configuration's ``batchnorm_gamma`` (below one, as in trained
residual networks: the pooled features stay near 0.4 instead of growing
block by block) and its shift near 0, linear layers to the gains of the
configuration's ``init`` (so CamCalib's logits and the regressor's
deltas are of order one, not the near-constant outputs of a published
random init, and Adam's first steps at the published rate keep the
loss steady). BatchNorm's
running statistics are then measured by the reference network itself on
seeded frames of the cell's traffic, so every layer of the random
network sees inputs of order one, as a trained one does. Both sides get
the same state dict; the program gets it with ``load_state_dict``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from benchmark.reference import nets
from benchmark.reference.smpl import PARENTS

NUM_BETAS, NUM_JOINTS, NUM_POSE_DIRS = 10, 24, 207


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of the seed."""
    mixed = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 31 | int(mixed[1]) >> 1)


def smpl_assets(seed: int, vertices: int, device) -> dict:
    """Synthetic SMPL-shaped assets (the released model is licensed and
    not in the repository): template N(0, 0.3) m, shape directions
    N(0, 0.01), pose directions N(0, 0.001), joint and extra-joint
    regressors and skinning weights non-negative rows summing to one."""
    g = generator(seed, 1, device)
    V = vertices
    n = [V * 3, NUM_BETAS * V * 3, NUM_POSE_DIRS * V * 3]
    z = torch.randn(sum(n), generator=g, device=device)
    v, s, p = z.split(n)
    u = torch.rand((NUM_JOINTS + 9) * V + V * NUM_JOINTS, generator=g,
                   device=device)
    jr, jx, w = u.split([NUM_JOINTS * V, 9 * V, V * NUM_JOINTS])
    w = w.reshape(V, NUM_JOINTS) ** 4

    def rows(x):
        return x / x.sum(dim=-1, keepdim=True)

    return {'v_template': (0.3 * v).reshape(V, 3),
            'shapedirs': (0.01 * s).reshape(NUM_BETAS, V * 3),
            'posedirs': (0.001 * p).reshape(NUM_POSE_DIRS, V * 3),
            'j_regressor': rows(jr.reshape(NUM_JOINTS, V)),
            'j_regressor_extra': rows(jx.reshape(9, V)),
            'lbs_weights': rows(w)}


def write_smpl_npz(assets: dict, path) -> None:
    """The assets in the layout of a released SMPL file (``.npz`` keys of
    the smplx pickle), for the program to load as a deployment does."""
    V = assets['v_template'].shape[0]
    host = {k: v.cpu().numpy() for k, v in assets.items()}
    parents = np.maximum(np.array(PARENTS, np.int64), 0)
    tmp = f'{path}.tmp.npz'
    np.savez(tmp, v_template=host['v_template'],
             shapedirs=host['shapedirs'].T.reshape(V, 3, NUM_BETAS),
             posedirs=host['posedirs'].T.reshape(V, 3, NUM_POSE_DIRS),
             J_regressor=host['j_regressor'], weights=host['lbs_weights'],
             kintree_table=np.stack([parents, np.arange(NUM_JOINTS)]),
             f=np.zeros((1, 3), np.int32))
    os.replace(tmp, path)


def _scale(name: str, t: torch.Tensor, gains: dict) -> float:
    """Standard deviation of a parameter's draw (BatchNorm's scale: of its
    relative spread)."""
    leaf = name.rsplit('.', 1)[-1]
    owner = name.rsplit('.', 2)[-2] if name.count('.') else ''
    if t.ndim == 4:                                   # convolution
        return (2.0 / t[0].numel()) ** 0.5
    if t.ndim == 2:                                   # linear weight
        return gains.get(owner, 1.0) / t.shape[1] ** 0.5
    if leaf == 'bias' and owner in gains:
        return 0.0
    return 0.1                                        # BN affine, biases


def network_state(model: nn.Module, seed: int, stream: int, init: dict,
                  device) -> dict:
    """A state dict for ``model``'s parameters from one draw, scaled by
    ``init`` (a configuration's: ``linear_gains`` by layer name and
    ``batchnorm_gamma``); buffers (BatchNorm statistics, the regressor's
    mean parameters) are left as the model holds them."""
    gains = init['linear_gains']
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    z = torch.randn(total, generator=generator(seed, stream, device),
                    device=device)
    state, at = {}, 0
    for name, p in params.items():
        chunk = z[at:at + p.numel()].reshape(p.shape)
        at += p.numel()
        std = _scale(name, p, gains)
        if p.ndim == 1 and name.endswith('weight'):     # BatchNorm's scale
            state[name] = init['batchnorm_gamma'] * (1.0 + std * chunk)
        else:
            state[name] = std * chunk
    return state


@torch.no_grad()
def calibrated(model: nn.Module, state: dict, batch_nchw: torch.Tensor
               ) -> dict:
    """Load ``state`` and set every BatchNorm's running statistics to its
    batch statistics on ``batch_nchw`` (one train-mode forward, cumulative
    average). Returns the full state dict, buffers included."""
    model.load_state_dict(state, strict=False)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    model.train()
    model(batch_nchw)
    model.eval()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 0.1
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def mean_params(model: nets.HMR) -> None:
    """The regressor's starting point: identity rotations (6D), mean
    shape, and the crop camera SPIN starts from (s = 0.9)."""
    head = model.head
    head.init_pose.copy_(torch.tensor([1.0, 0, 0, 0, 1.0, 0]).repeat(24)[None])
    head.init_shape.zero_()
    head.init_cam.copy_(torch.tensor([[0.9, 0.0, 0.0]]))
