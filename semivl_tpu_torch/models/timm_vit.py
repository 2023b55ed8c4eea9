"""timm-style ViT-B/16 encoder (counterpart of
``semivl_tpu/models/timm_vit.py``), the backbone of exp 41's
``vlm-dlv3p-bn11-sk4-ft-tvit-in1k``.

timm's ``vit_base_patch16_224`` as the reference wraps it (reference
model/backbone/timm_vit.py:28-81): a patch embedding with bias, the cls
token, a learned positional embedding at the training grid, pre-LN blocks
(``layers.TransformerBlock``, eps 1e-6: exact GELU, the attention through
``ops.attention.qkv_attention``, so heads of 64 take the packed kernels),
and one final ``norm`` applied to the tokens after each block in
``out_indices``. No v-path and no CLIP projection. An input of another size
than ``img_size`` is resized to it (bilinear) first.

Drop path: the config's ``drop_path_rate`` (0.1) acts in JAX only under
``stochastic=True``, which ``VLM.extract_feat`` never passes (JAX
``vlm.py:72-78``; the SemiVL grid runs with ``disable_dropout``), so this
encoder applies none.

Output: ``{'feats': (NHWC grid per out_index), 'global_emb': norm(cls)}``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.layers import LayerNorm, TransformerBlock
from semivl_tpu_torch.ops.resize import resize


class TIMMVisionTransformer(nn.Module):

    def __init__(self, img_size=(512, 512), patch_size=16, embed_dims=768,
                 num_layers=12, num_heads=12, mlp_ratio=4,
                 out_indices=(4, 11), norm_eps=1e-6, dtype=torch.float32):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, embed_dims, patch_size,
                                     stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        grid = (self.img_size[0] // patch_size) * (self.img_size[1]
                                                   // patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid + 1, embed_dims))
        self.layers = nn.ModuleList(
            TransformerBlock(embed_dims, num_heads, mlp_ratio * embed_dims,
                             norm_eps, True, dtype)
            for _ in range(num_layers))
        self.norm = LayerNorm(embed_dims, norm_eps, dtype)

    def forward(self, img):
        """img: (B, H, W, 3) float -> {'feats': ..., 'global_emb': ...}."""
        b, h, w, _ = img.shape
        if (h, w) != self.img_size:
            img = resize(img, self.img_size, mode='bilinear',
                         align_corners=False)
            h, w = self.img_size
        p = self.patch_size
        gh, gw = h // p, w // p
        x = F.conv2d(img.permute(0, 3, 1, 2).to(self.dtype),
                     self.patch_embed.weight.to(self.dtype),
                     self.patch_embed.bias.to(self.dtype), stride=p)
        x = x.flatten(2).transpose(1, 2)                    # (B, gh*gw, C)
        c = x.shape[-1]
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), x],
                      dim=1)
        x = x + self.pos_embed.to(self.dtype)
        feats = []
        for i, block in enumerate(self.layers):
            x, _ = block(x)
            if i in self.out_indices:
                feats.append(self.norm(x)[:, 1:].reshape(b, gh, gw, c))
        return {'feats': tuple(feats), 'global_emb': self.norm(x[:, 0])}
