"""HMR 2.0's SMPL head: a transformer decoder over the trunk's tokens
(``hmr2/models/heads/smpl_head.py`` and
``hmr2/models/components/pose_transformer.py`` of 4D-Humans; no JAX
counterpart).

One query token: ``Linear(1, dim)`` on a zero token plus a learned
(1, 1, dim) position. ``depth`` pre-norm layers (LayerNorm eps 1e-5),
each ``x += SA(LN(x))``, ``x += CA(LN(x), context)``, ``x += FF(LN(x))``:

* self-attention, ``heads`` of ``dim_head``, ``to_qkv`` without a bias,
  ``to_out`` (heads * dim_head -> dim) with one. Over the one token the
  softmax of its single score is exactly 1, so the layer equals its
  value projection: the head computes ``to_out(v)`` from the value rows
  of ``to_qkv`` and skips the query, key and softmax;
* cross-attention: query ``to_q`` (no bias), keys and values ``to_kv``
  (context -> 2 * heads * dim_head, no bias) over the trunk's tokens,
  which are not normalized again; through ``ops.attention``;
* feed-forward ``dim -> mlp_dim -> dim`` with exact-erf GELU.

Then ``decpose`` (-> 144, 24 joints in 6D), ``decshape`` (-> 10) and
``deccam`` (-> 3) are added once to the mean-parameter buffers. The 6D
pose is read as HMR 2.0 reads it (``reshape(-1, 2, 3).permute(0, 2, 1)``:
the first three numbers are the first column), which is
``core.geometry.rot6d_to_rotmat``'s layout. Dropout is 0 in the
published configuration and is left out.

Parameter names are the published module graph's
(``transformer.to_token_embedding``, ``transformer.pos_embedding``,
``transformer.transformer.layers.<i>.<0|1|2>.norm`` / ``.fn...``,
``decpose``, ``decshape``, ``deccam``, the buffers ``init_body_pose``,
``init_betas``, ``init_cam``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from spec_tpu_torch.core.geometry import rot6d_to_rotmat
from spec_tpu_torch.models.heads.hmr_head import NPOSE, default_init_params
from spec_tpu_torch.ops.attention import attention
from spec_tpu_torch.utils.precision import compute_dtype

# Published decoder sizes (hmr_vit_transformer.yaml's TRANSFORMER_DECODER);
# the context width is the trunk's.
DECODER_SIZES = dict(dim=1024, depth=6, heads=8, dim_head=64, mlp_dim=1024)
LN_EPS = 1e-5


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, heads * d) -> (B, heads, N, d)."""
    B, N, _ = t.shape
    return t.reshape(B, N, heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, d) -> (B, N, heads * d)."""
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


class SelfAttention(nn.Module):
    """Self-attention over the decoder's one token: its value projection
    (the value rows of ``to_qkv``), then ``to_out``."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x):
        inner = self.to_out[0].in_features
        return self.to_out(x @ self.to_qkv.weight[2 * inner:].t())


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        inner = heads * dim_head
        self.to_kv = nn.Linear(context_dim, inner * 2, bias=False)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x, context):
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(context).chunk(2, dim=-1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(attention(q, k, v, self.scale)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # indices as published (dropout 0 at 2 and 4)
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.norm(x), **kwargs)


class _Layers(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim)),
        ]) for _ in range(depth)])

    def forward(self, x, context):
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = _Layers(dim, depth, heads, dim_head, mlp_dim,
                                   context_dim)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class TransformerDecoderHead(nn.Module):
    """(B, C, H, W) trunk map -> pred_pose (B, 24, 3, 3), pred_pose_6d
    (B, 144), pred_shape (B, 10), pred_cam (B, 3); ``dtype`` is the
    decoder's compute dtype; its sizes are :data:`DECODER_SIZES`."""

    def __init__(self, context_dim: int, dtype: torch.dtype = torch.float32,
                 mean_params: Optional[dict] = None):
        super().__init__()
        self.dtype = dtype
        self.transformer = TransformerDecoder(context_dim=context_dim,
                                              **DECODER_SIZES)
        dim = DECODER_SIZES['dim']
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        mean = mean_params or default_init_params()
        for name, key in (('init_body_pose', 'init_pose'),
                          ('init_betas', 'init_shape'),
                          ('init_cam', 'init_cam')):
            self.register_buffer(name, torch.from_numpy(
                np.asarray(mean[key], np.float32).copy()))

    def forward(self, features: torch.Tensor, **unused) -> dict:
        B = features.shape[0]
        context = features.flatten(2).transpose(1, 2)      # (B, HW, C)
        with compute_dtype(self.dtype, features.device.type):
            token = features.new_zeros(B, 1, 1)
            out = self.transformer(token, context)[:, 0]
            pose = self.decpose(out) + self.init_body_pose
            shape = self.decshape(out) + self.init_betas
            cam = self.deccam(out) + self.init_cam
        pose = pose.float()
        return {'pred_pose': rot6d_to_rotmat(pose.reshape(B, 24, 6)),
                'pred_pose_6d': pose, 'pred_shape': shape.float(),
                'pred_cam': cam.float()}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator: linear layers torch's
        default (Kaiming-uniform, a = sqrt 5), the query position
        standard normal, LayerNorm 1 / 0; decoders xavier-uniform with
        gain 0.01 and zero bias, so a random model predicts about the
        mean parameters (as ``HMRHead``)."""
        decoders = (self.decpose, self.decshape, self.deccam)
        for m in self.modules():
            if isinstance(m, nn.Linear) and m not in decoders:
                bound = m.in_features ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        self.transformer.pos_embedding.normal_(generator=generator)
        for dec in decoders:
            nn.init.xavier_uniform_(dec.weight, gain=0.01,
                                    generator=generator)
            nn.init.zeros_(dec.bias)
