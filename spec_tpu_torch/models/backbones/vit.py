"""ViT-H/16 trunk of HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023;
``hmr2/models/backbones/vit.py`` of 4D-Humans, ViTPose's ViT).

A 256 x 192 crop -> ``Conv2d(3, 1280, 16, stride 16, padding 2)``: a
16 x 12 grid of tokens, no class token; the positional table (1, 193,
1280) is added as ``pos[:, 1:] + pos[:, :1]``. Then 32 pre-norm blocks
``x += proj(MHA(LN(x)))`` (16 heads of 80, ``qkv`` with a bias, scale
80^-0.5) and ``x += fc2(GELU(fc1(LN(x))))`` (1280 -> 5120 -> 1280,
exact-erf GELU), LayerNorm eps 1e-6, a final LayerNorm, and the tokens
read back as a (B, 1280, 16, 12) map. drop_path acts in training only
and is not carried over. Attention runs through ``ops.attention``.

Parameter names are the published module graph's (``patch_embed.proj``,
``pos_embed``, ``blocks.<i>.norm1`` / ``attn.qkv`` / ``attn.proj`` /
``norm2`` / ``mlp.fc1`` / ``mlp.fc2``, ``last_norm``), so a released
state dict loads with a prefix map. The trunk's sizes come from
:data:`VIT_SIZES` by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from spec_tpu_torch.ops.attention import attention

# Published sizes by name: input (H, W), patch, width, depth, heads, MLP
# expansion.
VIT_SIZES = {
    'vit_h': dict(img_size=(256, 192), patch_size=16, embed_dim=1280,
                  depth=32, num_heads=16, mlp_ratio=4),
}
LN_EPS = 1e-6
PATCH_PADDING = 2


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size,
                              padding=PATCH_PADDING)

    def forward(self, x):
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2), x.shape[2:]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads,
                                  C // self.num_heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) crop (H, W = ``img_size``) -> (B, embed_dim, H', W')
    map of the last LayerNorm's tokens."""

    def __init__(self, img_size=(256, 192), patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32,
                 num_heads: int = 16, mlp_ratio: int = 4):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        grid = [(s + 2 * PATCH_PADDING - patch_size) // patch_size + 1
                for s in self.img_size]
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid[0] * grid[1] + 1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.out_channels = embed_dim

    def forward(self, x):
        B = x.shape[0]
        x, (hp, wp) = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        return x.permute(0, 2, 1).reshape(B, -1, hp, wp).contiguous()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The published init from an explicit generator: linear weights
        and the positional table normal with std 0.02 (the published
        ``trunc_normal_(std=.02)`` cuts at +-2, a hundred standard
        deviations: a plain normal), biases 0, LayerNorm scale 1 / shift
        0; the patch convolution torch's default (Kaiming-uniform,
        a = sqrt 5)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        conv = self.patch_embed.proj
        nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5),
                                 generator=generator)
        bound = conv.weight[0].numel() ** -0.5
        conv.bias.uniform_(-bound, bound, generator=generator)


def get_vit(name: str, remat: bool = False) -> ViT:
    if remat:
        raise ValueError(f'remat is not implemented for {name}')
    return ViT(**VIT_SIZES[name])
