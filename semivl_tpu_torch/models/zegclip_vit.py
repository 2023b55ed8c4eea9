"""ZegCLIP's CLIP vision transformers (counterpart of
``semivl_tpu/models/zegclip_vit.py``): the backbone of exp 41's
``vlm-zegclip-rd-pt-vitb``.

A CLIP ViT-B/16 (QuickGELU FFN, LayerNorms at eps 1e-5) whose cls
position gets ``class_embedding`` added and whose spatial position grid is
resized *bilinearly* when the input grid differs from
``input_resolution // patch_size``. ``VPTCLIPVisionTransformer`` adds
visual prompt tokens: ``num_tokens`` prompts, projected by
``prompt_proj``, go in right after the cls token at layer 0 and are
replaced from ``deep_prompt_embeddings`` before layers 1..``total_d_layer``;
at the end come ``prompt_norm`` (eps 1e-6), ``ln_post`` over every token and
the CLIP projection ``proj`` (reference clip_vpt_vit.py:114-204).

Output: ``{'feats': tuple of NHWC grids, 'global_emb': (B, output_dim)}``:
the raw tokens of each out index when there are several, else the dense
embedding (the last H*W tokens after the projection) L2-normalised; the
global embedding is the L2-normalised projected cls token. Every attention
goes through ``ops.attention.qkv_attention`` (heads of 64: the packed
kernels on the card, at L = 1 + num_tokens + H*W). Parameter names are the
flax scopes' (``class_embedding``, ``prompt_proj``, ``layers.<i>.ffn.fc1``,
...), so the prompt leaves carry ``prompt`` as the freeze rule's
``exclude_keys=['prompt']`` needs.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.layers import (
    LayerNorm,
    TransformerBlock,
    l2_normalize,
    linear,
    quick_gelu,
)
from semivl_tpu_torch.ops.resize import resize


class CLIPBlock(TransformerBlock):
    """CLIP's ResidualAttentionBlock: ``ln1``/attention, ``ln2``/QuickGELU
    FFN (``ffn.fc1``, ``ffn.fc2``), LayerNorms at eps 1e-5; ``return_v``
    adds the MaskCLIP v-path (out_proj(v) + x, then the FFN)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__(dim, num_heads, 4 * dim, 1e-5, True, dtype,
                         act=quick_gelu, mmcv_names=False)


class CLIPVisionTransformer(nn.Module):
    """The prompt-less ZegCLIP CLIP ViT (JAX :64-136); ``embed_v`` routes
    the MaskCLIP v-path of the last block through ``ln_post`` and the
    projection to make the dense embedding."""

    def __init__(self, input_resolution=512, patch_size=16, width=768,
                 layers=12, heads=12, output_dim=512, out_indices=(11,),
                 embed_v=False, dtype=torch.float32):
        super().__init__()
        self.input_resolution = input_resolution
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.embed_v = embed_v
        self.dtype = dtype
        sp = input_resolution // patch_size
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size,
                                     bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(sp * sp + 1, width))
        self.ln_pre = LayerNorm(width, 1e-5, dtype)
        self.layers = nn.ModuleList(CLIPBlock(width, heads, dtype)
                                    for _ in range(layers))
        self.ln_post = LayerNorm(width, 1e-5, dtype)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def _embed(self, img):
        """Patch tokens after the cls token, with the position embedding
        (the cls one plus ``class_embedding``, the grid resized bilinearly
        to the input's), then ``ln_pre``: (x (B, 1 + H*W, C), (gh, gw))."""
        b = img.shape[0]
        p = self.patch_size
        x = F.conv2d(img.permute(0, 3, 1, 2).to(self.dtype),
                     self.patch_embed.weight.to(self.dtype), stride=p)
        gh, gw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)                    # (B, gh*gw, C)
        c = x.shape[-1]
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1)
        sp = self.input_resolution // p
        pos = self.positional_embedding
        spatial = pos[1:].reshape(1, sp, sp, c)
        if (gh, gw) != (sp, sp):
            spatial = resize(spatial, (gh, gw), mode='bilinear',
                             align_corners=False)
        pos = torch.cat([(pos[0] + self.class_embedding)[None, None],
                         spatial.reshape(1, gh * gw, c)], dim=1)
        return self.ln_pre(x + pos.to(self.dtype)), (gh, gw)

    def _project(self, x):
        return x @ self.proj.to(x.dtype)

    def _outputs(self, feats, x, src, grid):
        """The global embedding from the cls token of ``x``, the dense one
        from the last H*W tokens of ``src`` (both projected)."""
        b = x.shape[0]
        gh, gw = grid
        visual = src[:, -gh * gw:].reshape(b, gh, gw, src.shape[-1])
        if len(self.out_indices) == 1:
            feats.append(l2_normalize(visual, dim=-1))
        return {'feats': tuple(feats),
                'global_emb': l2_normalize(x[:, 0], dim=-1)}

    def forward(self, img):
        """img: (B, H, W, 3) float -> {'feats': ..., 'global_emb': ...}."""
        x, (gh, gw) = self._embed(img)
        b = x.shape[0]
        feats, v = [], None
        for i, block in enumerate(self.layers):
            last = i == len(self.layers) - 1
            x, v = block(x, return_v=self.embed_v and last)
            if len(self.out_indices) > 1 and i in self.out_indices:
                feats.append(x[:, 1:].reshape(b, gh, gw, x.shape[-1]))
        x = self._project(self.ln_post(x))
        src = self._project(self.ln_post(v)) if self.embed_v else x
        return self._outputs(feats, x, src, (gh, gw))


class VPTCLIPVisionTransformer(CLIPVisionTransformer):
    """The CLIP ViT with shallow and deep visual prompts (JAX :139-232).
    ``drop_path_rate`` is taken and unused: the grid disables dropout, as
    JAX's module does."""

    def __init__(self, input_resolution=512, patch_size=16, width=768,
                 layers=12, heads=12, output_dim=512, num_tokens=10,
                 prompt_dim=768, total_d_layer=11, out_indices=(11,),
                 drop_path_rate=0.0, dtype=torch.float32):
        super().__init__(input_resolution, patch_size, width, layers, heads,
                         output_dim, out_indices, False, dtype)
        if prompt_dim != width:
            raise ValueError(f'VPTCLIPVisionTransformer: prompt_dim '
                             f'{prompt_dim} must equal width {width}')
        self.num_tokens = num_tokens
        self.total_d_layer = total_d_layer
        self.prompt_embeddings = nn.Parameter(
            torch.zeros(1, num_tokens, prompt_dim))
        self.deep_prompt_embeddings = nn.Parameter(
            torch.zeros(total_d_layer, num_tokens, prompt_dim))
        self.prompt_proj = nn.Linear(prompt_dim, prompt_dim)
        self.prompt_norm = LayerNorm(prompt_dim, 1e-6, dtype)

    def _prompts(self, embs, b):
        """(num_tokens, prompt_dim) embeddings -> projected (B, T, C)."""
        out = linear(embs.to(self.dtype), self.prompt_proj)
        return out[None].expand(b, -1, -1)

    def forward(self, img):
        x, (gh, gw) = self._embed(img)
        b, t = x.shape[0], self.num_tokens
        x = torch.cat([x[:, :1], self._prompts(self.prompt_embeddings[0], b),
                       x[:, 1:]], dim=1)
        feats = []
        for i, block in enumerate(self.layers):
            if 1 <= i <= self.total_d_layer:
                x = torch.cat([x[:, :1], self._prompts(
                    self.deep_prompt_embeddings[i - 1], b),
                    x[:, 1 + t:]], dim=1)
            x, _ = block(x)
            if len(self.out_indices) > 1 and i in self.out_indices:
                feats.append(x[:, -gh * gw:].reshape(b, gh, gw, x.shape[-1]))
        x = self._project(self.ln_post(self.prompt_norm(x)))
        return self._outputs(feats, x, x, (gh, gw))
