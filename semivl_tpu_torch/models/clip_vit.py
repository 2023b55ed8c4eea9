"""MaskCLIP vision transformer encoder (counterpart of
``semivl_tpu/models/clip_vit.py``).

A CLIP ViT-B/16 with a bias-free patch embedding, the cls token, a pre-LN
(``ln0``) and final norm (``ln1``, applied to both the tokens and the
MaskCLIP v-path), bicubic positional-embedding resize for other grids, and
the 512-d CLIP projection giving an L2-normalised dense embedding and a
global (cls-token) embedding (reference maskclip_vit.py:147-603).

Output: ``{'feats': tuple of NHWC grids, 'global_emb': (B, 512)}``: the
v-path grid for each ``out_index < num_layers`` followed by the dense CLIP
embedding when ``num_layers`` is in ``out_indices``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.layers import (
    LayerNorm,
    TransformerBlock,
    l2_normalize,
)
from semivl_tpu_torch.ops.resize import resize_longer_matrix


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels, dim, patch, bias):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, dim, patch, stride=patch,
                                    bias=bias)


class MaskClipViT(nn.Module):

    def __init__(self, img_size=(512, 512), patch_size=16, in_channels=3,
                 embed_dims=768, num_layers=12, num_heads=12, mlp_ratio=4,
                 out_indices=None, qkv_bias=True, patch_bias=False,
                 clip_dim=512, norm_eps=1e-6, dtype=torch.float32):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.num_layers = num_layers
        # reference maskclip_vit.py:288-289: None -> only the CLIP embedding
        self.out_indices = (tuple(out_indices) if out_indices is not None
                            else (num_layers,))
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(in_channels, embed_dims, patch_size,
                                       patch_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        pos_h, pos_w = (s // patch_size for s in self.img_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pos_h * pos_w + 1, embed_dims))
        self.ln0 = LayerNorm(embed_dims, norm_eps, dtype)
        self.ln1 = LayerNorm(embed_dims, norm_eps, dtype)
        self.layers = nn.ModuleList(
            TransformerBlock(embed_dims, num_heads, mlp_ratio * embed_dims,
                             norm_eps, qkv_bias, dtype)
            for _ in range(num_layers))
        # CLIP's visual projection, stored as a 1x1 conv like the reference
        self.proj = nn.Conv2d(embed_dims, clip_dim, 1, bias=False)

    def _project(self, x):
        w = self.proj.weight[:, :, 0, 0].to(x.dtype)
        return l2_normalize(F.linear(x, w), dim=-1)

    def forward(self, img):
        """img: (B, H, W, 3) float -> {'feats': ..., 'global_emb': ...}."""
        b, h, w, _ = img.shape
        p = self.patch_size
        x = img.permute(0, 3, 1, 2).to(self.dtype)
        # mmseg PatchEmbed padding='corner': zero-pad bottom/right
        x = F.pad(x, (0, (-w) % p, 0, (-h) % p))
        gh, gw = x.shape[2] // p, x.shape[3] // p
        x = F.conv2d(x, self.patch_embed.projection.weight.to(self.dtype),
                     None if self.patch_embed.projection.bias is None
                     else self.patch_embed.projection.bias.to(self.dtype),
                     stride=p)
        x = x.flatten(2).transpose(1, 2)                    # (B, gh*gw, C)
        c = x.shape[-1]
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), x],
                      dim=1)
        pos_hw = (self.img_size[0] // p, self.img_size[1] // p)
        pos = self.pos_embed
        if (gh, gw) != pos_hw:
            pos = resize_longer_matrix(pos, (gh, gw), pos_hw, mode='bicubic')
        x = self.ln0(x + pos.to(self.dtype))

        def to_grid(tokens):
            return tokens[:, 1:].reshape(b, gh, gw, tokens.shape[-1])

        feats = []
        for i, block in enumerate(self.layers):
            last = i == self.num_layers - 1
            x, v = block(x, return_v=last or i in self.out_indices)
            if last:
                x, v = self.ln1(x), self.ln1(v)
                clip_embed = self._project(to_grid(v))
            if i in self.out_indices:
                feats.append(to_grid(v))
        if self.num_layers in self.out_indices:
            feats.append(clip_embed)
        return {'feats': tuple(feats),
                'global_emb': self._project(x[:, 0])}
