"""R2Former-style global image descriptors for retrieval view selection.

Counterpart of diffmvs_tpu/tools/retrieval.py (the reference's
r2former.py): a DeiT-S/16 distilled ViT (embed 384, depth 12, 6 heads)
with cls and dist tokens; the descriptor is L2-normalize((head(cls) +
head_dist(dist)) / 2), 256-d. tools/colmap.py's --vggt mode scores view
pairs with it.

The modules carry timm's VisionTransformer key names (patch_embed.proj,
cls_token, dist_token, pos_embed, blocks.{i}.norm1 / attn.qkv / attn.proj
/ norm2 / mlp.fc1 / mlp.fc2, norm, head, head_dist), so an R2Former
checkpoint loads with load_state_dict once its "module." prefix is
stripped. Exact GELU, LayerNorm eps 1e-6, and attention as two products
and a softmax, as the JAX module computes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 256

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.matmul(q, k.transpose(-2, -1)) * head_dim ** -0.5
        attn = attn.softmax(dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)


class DistilledViT(nn.Module):
    """DeiT-distilled ViT emitting a unit-norm global descriptor. Random
    initialization: torch's defaults, zero cls / dist tokens and a
    normal position embedding (std 0.02) truncated at two deviations, as
    the JAX module's initializers."""

    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, cfg.num_patches + 2, d), std=0.02, a=-0.04,
            b=0.04))
        self.blocks = nn.ModuleList(
            [Block(d, cfg.num_heads, cfg.mlp_ratio)
             for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.head = nn.Linear(d, cfg.num_classes)
        self.head_dist = nn.Linear(d, cfg.num_classes)

    def forward(self, x):
        """x: [B, H, W, 3] (H = W = cfg.image_size), the JAX module's
        layout. Returns [B, num_classes]."""
        b = x.shape[0]
        patches = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1),
                            self.dist_token.expand(b, -1, -1), patches],
                           dim=1) + self.pos_embed
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        desc = (self.head(tokens[:, 0]) + self.head_dist(tokens[:, 1])) / 2.0
        return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True)


def compute_descriptors(model: DistilledViT, images: np.ndarray,
                        batch: int = 8) -> np.ndarray:
    """images: [N, H, W, 3] float32, resized to the ViT's input size with
    the ImageNet normalization applied by the caller. Runs on the model's
    device, `batch` images at a time. Returns [N, num_classes] float32."""
    dev = next(model.parameters()).device
    outs = []
    with torch.inference_mode():
        for i in range(0, images.shape[0], batch):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch])).to(dev)
            outs.append(model(x).float().cpu().numpy())
    return np.concatenate(outs)
