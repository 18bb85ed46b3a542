"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023) in plain PyTorch: the
ViT-H/16 trunk and the transformer-decoder SMPL head of 4D-Humans
(``hmr2/models/backbones/vit.py``, ``hmr2/models/heads/smpl_head.py``,
``hmr2/models/components/pose_transformer.py``; sizes from
``hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml``).

Float32, NCHW, attention written out as ``softmax(q kᵀ · scale) v``
(:func:`attend`), no kernel, graph or cache; the caller decides TF32
(``benchmark.reference.predict.precision``). Parameter names are the
program's and the published graph's (``backbone.*``, ``head.*``), so one
state dict loads into both.

:class:`HMR2`'s ``forward`` takes the square ``res``² crop and keeps its
central three quarters of columns (256 x 192 of 256², the published
``x[:, :, :, 32:-32]``), so ``benchmark.reference.predict.persons`` runs
it as it runs the SPEC regressor. Departures from the published code:

* drop_path (0.55) and dropout act in training only and are left out;
* one IEF step, a zero query token, 6D pose (the published settings),
  without the published code's options for others;
* the mean parameters are buffers the caller fills (the published head
  reads SMPL's mean-parameter file);
* the crop it is given is SPEC's (the SPIN square on the box's longer
  side, ``image.spin_corners``), not 4D-Humans' aspect-ratio expansion,
  and its crop camera is lifted with CamCalib's camera by
  ``reference.smpl.cam_head``, not a fixed 5000-px focal length.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry as G

NPOSE = 24 * 6


def attend(q, k, v, scale: float):
    """(B, H, Lq, D) over (B, H, Lk, D): softmax(q kᵀ · scale) v."""
    return torch.softmax(q @ k.transpose(-2, -1) * scale, dim=-1) @ v


def positions(pos):
    """The trunk's positional term from its (1, 1 + N, C) table: the
    patch rows plus the class row (there is no class token)."""
    return pos[:, 1:] + pos[:, :1]


def context_tokens(tokens):
    """The decoder's keys and values read the trunk's tokens as they are
    (normalized once, by the trunk's last LayerNorm)."""
    return tokens


def split_heads(t, heads: int):
    B, N, _ = t.shape
    return t.reshape(B, N, heads, -1).transpose(1, 2)


def merge_heads(t):
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


# -- trunk -------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, stride=patch, padding=2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = (split_heads(t, self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        scale = q.shape[-1] ** -0.5
        return self.proj(merge_heads(attend(q, k, v, scale)))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = Mlp(width, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) -> (B, width, H', W'): patches (kernel = stride =
    ``patch``, padding 2), the positional term, pre-norm blocks, a last
    LayerNorm."""

    def __init__(self, size, patch: int, width: int, depth: int, heads: int,
                 mlp: int):
        super().__init__()
        self.patch_embed = PatchEmbed(patch, width)
        gh, gw = ((s + 4 - patch) // patch + 1 for s in size)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + 1, width))
        self.blocks = nn.ModuleList([Block(width, heads, mlp)
                                     for _ in range(depth)])
        self.last_norm = nn.LayerNorm(width, eps=1e-6)
        self.out_channels = width

    def forward(self, x):
        x = self.patch_embed.proj(x)
        B, C, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2) + positions(self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        return x.transpose(1, 2).reshape(B, C, gh, gw)


# -- head --------------------------------------------------------------------

class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x):
        q, k, v = (split_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        scale = q.shape[-1] ** -0.5
        return self.to_out(merge_heads(attend(q, k, v, scale)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head,
                               bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x, context):
        k, v = (split_heads(t, self.heads) for t in
                self.to_kv(context_tokens(context)).chunk(2, dim=-1))
        q = split_heads(self.to_q(x), self.heads)
        scale = q.shape[-1] ** -0.5
        return self.to_out(merge_heads(attend(q, k, v, scale)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class Layers(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp, context_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp)),
        ]) for _ in range(depth)])


class Decoder(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = Layers(dim, depth, heads, dim_head, mlp,
                                  context_dim)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        for sa, ca, ff in self.transformer.layers:
            x = sa(x) + x
            x = ca(x, context=context) + x
            x = ff(x) + x
        return x


class DecoderHead(nn.Module):
    """(B, C, H, W) -> the SPEC regressor's outputs: one zero query
    through the decoder over the H W tokens, the three linear readouts
    added once to the mean parameters."""

    def __init__(self, context_dim, dim, depth, heads, dim_head, mlp):
        super().__init__()
        self.transformer = Decoder(dim, depth, heads, dim_head, mlp,
                                   context_dim)
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        self.register_buffer('init_body_pose', torch.zeros(1, NPOSE))
        self.register_buffer('init_betas', torch.zeros(1, 10))
        self.register_buffer('init_cam', torch.zeros(1, 3))

    def forward(self, feats):
        B = feats.shape[0]
        context = feats.flatten(2).transpose(1, 2)
        token = torch.zeros(B, 1, 1, device=feats.device)
        out = self.transformer(token, context)[:, 0]
        pose = self.decpose(out) + self.init_body_pose
        shape = self.decshape(out) + self.init_betas
        cam = self.deccam(out) + self.init_cam
        return {'pred_pose': G.rot6d_to_rotmat(pose.reshape(B, 24, 6)),
                'pred_pose_6d': pose, 'pred_shape': shape, 'pred_cam': cam}


class HMR2(nn.Module):
    """The ViT trunk and the decoder head on a ``res``² crop, of which the
    trunk sees the central ``res`` x 3/4 ``res``. Sizes as the
    configuration's ``hmr.vit`` and ``hmr.decoder`` name them."""

    def __init__(self, res: int = 256, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_dim: int = 5120, dec_dim: int = 1024,
                 dec_depth: int = 6, dec_heads: int = 8,
                 dec_dim_head: int = 64, dec_mlp_dim: int = 1024):
        super().__init__()
        self.cols = res // 8
        self.backbone = ViT((res, res - 2 * self.cols), patch_size,
                            embed_dim, depth, num_heads, mlp_dim)
        self.head = DecoderHead(embed_dim, dec_dim, dec_depth, dec_heads,
                                dec_dim_head, dec_mlp_dim)

    @classmethod
    def from_config(cls, hmr: dict) -> 'HMR2':
        """From a configuration's ``hmr`` entry."""
        vit, dec = hmr['vit'], hmr['decoder']
        return cls(hmr['img_res'], vit['patch_size'], vit['embed_dim'],
                   vit['depth'], vit['num_heads'], vit['mlp_dim'],
                   dec['dim'], dec['depth'], dec['heads'], dec['dim_head'],
                   dec['mlp_dim'])

    def forward(self, x_nchw):
        x = x_nchw[..., self.cols:x_nchw.shape[-1] - self.cols]
        return self.head(self.backbone(x))
