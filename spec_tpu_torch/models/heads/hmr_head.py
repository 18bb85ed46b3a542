"""HMR/SPIN iterative SMPL-parameter regressor head (torch twin of
``spec_tpu/models/heads/hmr_head.py``).

Input: the backbone feature map, global-avgpooled to (B, C). Learned
initial estimates ``init_pose`` (1, 144 = 24 x 6D), ``init_shape``
(1, 10) and ``init_cam`` (1, 3) are buffers, as in the reference
checkpoints. ``n_iter`` refinement steps: concat [features, pose, shape,
cam (+ flattened camera rotmat and vfov with ``use_cam_feats``)] -> fc1
-> dropout -> fc2 -> dropout -> three linear decoders adding deltas.
Output ``pred_pose`` is (B, 24, 3, 3) via 6D -> rotmat. With
``estimate_var`` two more linears, ``decpose_var`` and ``decshape_var``,
regress per-parameter log-variances from the last refinement's features:
``pred_pose_logvar`` (B, 144) and ``pred_shape_logvar`` (B, 10), the
inputs of ``losses/hmr.smpl_param_loss_uncertainty``.

In train mode dropout draws its masks from the ``generator`` the caller
passes (the counterpart of the JAX head's ``rngs={'dropout': key}``), or
from torch's default one. The init buffers train only when the trainer
makes them trainable (``train/state.create_train_state`` with
``freeze_buffers=False``, the JAX head's params).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from spec_tpu_torch.core.geometry import rot6d_to_rotmat
from spec_tpu_torch.utils.precision import compute_dtype

NPOSE = 24 * 6


def default_init_params() -> dict:
    """Identity-rotation mean params, used when no mean-params file is
    given (checkpoints carry the trained buffers anyway)."""
    pose = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24)[None]
    return {
        'init_pose': pose,                                   # (1, 144)
        'init_shape': np.zeros((1, 10), np.float32),
        'init_cam': np.array([[0.9, 0.0, 0.0]], np.float32),
    }


def load_smpl_mean_params(path: str) -> dict:
    """Read the SPIN-format mean params npz: pose (144,) 6D, shape (10,),
    cam (3,)."""
    data = np.load(path)
    return {
        'init_pose': np.asarray(data['pose'], np.float32).reshape(1, NPOSE),
        'init_shape': np.asarray(data['shape'], np.float32).reshape(1, 10),
        'init_cam': np.asarray(data['cam'], np.float32).reshape(1, 3),
    }


class HMRHead(nn.Module):
    """Iterative regressor head; ``dtype`` is the FC compute dtype."""

    def __init__(self, num_features: int, use_cam_feats: bool = False,
                 estimate_var: bool = False,
                 n_iter: int = 3, hidden_dim: int = 1024,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 mean_params: Optional[dict] = None):
        super().__init__()
        self.use_cam_feats = use_cam_feats
        self.estimate_var = estimate_var
        self.n_iter = n_iter
        self.dtype = dtype
        mean = mean_params or default_init_params()
        for name in ('init_pose', 'init_shape', 'init_cam'):
            self.register_buffer(name, torch.from_numpy(
                np.asarray(mean[name], np.float32).copy()))
        n_in = num_features + NPOSE + 10 + 3 + (10 if use_cam_feats else 0)
        self.dropout_rate = dropout_rate    # after fc1 and after fc2
        self.fc1 = nn.Linear(n_in, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.decpose = nn.Linear(hidden_dim, NPOSE)
        self.decshape = nn.Linear(hidden_dim, 10)
        self.deccam = nn.Linear(hidden_dim, 3)
        if estimate_var:
            self.decpose_var = nn.Linear(hidden_dim, NPOSE)
            self.decshape_var = nn.Linear(hidden_dim, 10)

    def forward(self, features: torch.Tensor,
                cam_rotmat: Optional[torch.Tensor] = None,
                cam_vfov: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """features: (B, C, H, W) backbone map or pre-pooled (B, C);
        cam_rotmat (B, 3, 3) and cam_vfov (B,) with ``use_cam_feats``;
        ``generator``: the train-mode dropout masks' source."""
        xf = features.mean(dim=(2, 3)) if features.ndim == 4 else features
        B = xf.shape[0]
        pred_pose = self.init_pose.expand(B, NPOSE)
        pred_shape = self.init_shape.expand(B, 10)
        pred_cam = self.init_cam.expand(B, 3)
        cam_feats = None
        if self.use_cam_feats:
            if cam_rotmat is None or cam_vfov is None:
                raise ValueError(
                    'use_cam_feats requires cam_rotmat and cam_vfov')
            cam_feats = torch.cat([cam_rotmat.reshape(B, 9).float(),
                                   cam_vfov.reshape(B, 1).float()], dim=-1)

        with compute_dtype(self.dtype, xf.device.type):
            for _ in range(self.n_iter):
                parts = [xf, pred_pose, pred_shape, pred_cam]
                if cam_feats is not None:
                    parts.append(cam_feats)
                xc = torch.cat([p.to(xf.dtype) for p in parts], dim=-1)
                xc = self._drop(self.fc1(xc), generator)
                xc = self._drop(self.fc2(xc), generator)
                pred_pose = self.decpose(xc) + pred_pose
                pred_shape = self.decshape(xc) + pred_shape
                pred_cam = self.deccam(xc) + pred_cam
            extra = {}
            if self.estimate_var:
                extra['pred_pose_logvar'] = self.decpose_var(xc).float()
                extra['pred_shape_logvar'] = self.decshape_var(xc).float()

        pred_pose = pred_pose.float()
        return {
            **extra,
            'pred_pose': rot6d_to_rotmat(pred_pose.reshape(B, 24, 6)),
            'pred_pose_6d': pred_pose,
            'pred_shape': pred_shape.float(),
            'pred_cam': pred_cam.float(),
        }

    def _drop(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """Inverted dropout at ``dropout_rate`` in train mode (flax's
        form: kept values divided by the keep rate, dropped ones 0)."""
        if not self.training or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator: fc1, fc2 and the
        variance linears torch's default Linear init; decoders
        xavier-uniform with gain 0.01 (the reference's), so a random
        model predicts about the mean params."""
        var = ((self.decpose_var, self.decshape_var) if self.estimate_var
               else ())
        for fc in (self.fc1, self.fc2) + var:
            bound = fc.in_features ** -0.5
            fc.weight.uniform_(-bound, bound, generator=generator)
            fc.bias.uniform_(-bound, bound, generator=generator)
        for dec in (self.decpose, self.decshape, self.deccam):
            nn.init.xavier_uniform_(dec.weight, gain=0.01,
                                    generator=generator)
            nn.init.zeros_(dec.bias)
