"""VLM segmentor, forward (counterpart of ``semivl_tpu/models/vlm.py``).

CLIP encoder + VLG decoder; text embeddings are arguments. Feature
perturbation and the frozen guidance encoder belong to training and are not
carried here.
"""

import torch
from torch import nn

from semivl_tpu_torch.models.clip_vit import MaskClipViT
from semivl_tpu_torch.models.vlg_head import VLGHead


def build_backbone(cfg, dtype):
    if cfg['type'] != 'MaskClipVisionTransformer':
        raise ValueError(f'Unknown backbone type {cfg["type"]!r}')
    keys = ('patch_size', 'in_channels', 'embed_dims', 'num_layers',
            'num_heads', 'mlp_ratio', 'out_indices', 'qkv_bias',
            'patch_bias', 'clip_dim', 'norm_eps')
    return MaskClipViT(img_size=tuple(cfg['img_size']), dtype=dtype,
                       **{k: cfg[k] for k in keys if k in cfg})


def build_head(cfg, dtype):
    if cfg['type'] != 'VLGHead':
        raise ValueError(f'Unknown head type {cfg["type"]!r}')
    keys = ('text_in_channels', 'text_channels', 'up_channels',
            'skip_in_channels', 'skip_channels', 'num_layers', 'num_heads',
            'channels', 'pool_size', 'conv1_ksize', 'align_corners')
    return VLGHead(img_size=cfg['img_size'], num_classes=cfg['num_classes'],
                   dtype=dtype, **{k: cfg[k] for k in keys if k in cfg})


class VLM(nn.Module):
    """``backbone`` and ``decode_head``, the reference's top-level names."""

    def __init__(self, backbone_cfg, decode_head_cfg, dtype=torch.float32):
        super().__init__()
        self.backbone = build_backbone(backbone_cfg, dtype)
        self.decode_head = build_head(decode_head_cfg, dtype)

    def extract_feat(self, img):
        """(feats tuple, global_emb) — reference vlm.py:112-123."""
        out = self.backbone(img)
        return out['feats'], out['global_emb']

    def forward(self, img, text_feats):
        """img: (B, H, W, 3) normalised float; text_feats: (N, 512).
        Returns float32 (B, num_classes, H, W) logits."""
        feats, _ = self.extract_feat(img)
        return self.decode_head(feats, text_feats,
                                output_size=tuple(img.shape[1:3]))
