"""VLM segmentor (counterpart of ``semivl_tpu/models/vlm.py``).

CLIP encoder + VLG decoder, plus the frozen MaskCLIP guidance encoder
(``clip_encoder``) of training. Text embeddings are arguments. Feature
perturbation (channel dropout on the encoder's feature maps) takes an
explicit ``torch.Generator``; ``need_fp`` runs one decoder pass over the
clean batch and the perturbed slice together (reference
model/builder.py:56-102).
"""

import torch
from torch import nn

from semivl_tpu_torch.models.clip_vit import MaskClipViT
from semivl_tpu_torch.models.vlg_head import VLGHead
from semivl_tpu_torch.ops.dropout import dropout2d
from semivl_tpu_torch.ops.resize import resize
from semivl_tpu_torch.text.embeddings import (
    aggregate_concept_predictions,
    get_class_to_concept_idxs,
)


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
    """``backbone``, ``decode_head`` and, for training with guidance labels,
    ``clip_encoder``: the reference's top-level names."""

    def __init__(self, backbone_cfg, decode_head_cfg, clip_encoder_cfg=None,
                 fp_rate=0.5, mcc_text_name='', dtype=torch.float32):
        super().__init__()
        self.decode_head_cfg = decode_head_cfg
        self.fp_rate = fp_rate
        self.mcc_text_name = mcc_text_name
        self.backbone = build_backbone(backbone_cfg, dtype)
        self.decode_head = build_head(decode_head_cfg, dtype)
        self.clip_encoder = (build_backbone(clip_encoder_cfg, dtype)
                             if clip_encoder_cfg else None)

    def extract_feat(self, img):
        """(feats tuple, global_emb) — reference vlm.py:112-123."""
        out = self.backbone(img)
        return out['feats'], out['global_emb']

    def forward(self, img, text_feats, need_fp=False, generator=None):
        """img: (B, H, W, 3) normalised float; text_feats: (N, 512).
        Returns float32 (B, num_classes, H, W) logits.

        ``need_fp``: also decode a perturbed copy of the second half of the
        batch (the unlabeled ``img_w``) with channel dropout on every
        feature map, in the same decoder pass; returns ``(logits,
        logits_fp)``. The reference perturbs the whole batch and drops the
        x half (builder.py:81-99 vs semivl.py:245-247); GroupNorm and
        LayerNorm are per sample, so the kept half is the same."""
        feats, _ = self.extract_feat(img)
        b = img.shape[0]
        if need_fp:
            feats = tuple(torch.cat([f, dropout2d(f[b // 2:], self.fp_rate,
                                                  generator)])
                          for f in feats)
        logits = self.decode_head(feats, text_feats,
                                  output_size=tuple(img.shape[1:3]))
        if need_fp:
            return logits[:b], logits[b:]
        return logits

    @torch.no_grad()
    def maskclip_probs(self, img, text_feats_mcc):
        """Class probabilities (B, H, W, num_classes) of the frozen CLIP
        encoder (reference vlm.py:90-110): the text embeddings as a 1x1
        conv over the dense CLIP embedding, concept logits max-aggregated
        to classes, a float32 bilinear resize to the image size, softmax of
        100x."""
        num_classes = self.decode_head_cfg['num_classes']
        h, w = img.shape[1:3]
        visual = self.clip_encoder(img)['feats'][-1]   # (B, h', w', 512)
        text = torch.as_tensor(text_feats_mcc).to(visual)
        dense = torch.einsum('bhwc,nc->bhwn', visual, text)
        if dense.shape[-1] != num_classes:
            cls2con = get_class_to_concept_idxs(self.mcc_text_name)
            dense = aggregate_concept_predictions(
                dense.permute(0, 3, 1, 2), cls2con).permute(0, 2, 3, 1)
        dense = resize(dense.float(), (h, w), mode='bilinear',
                       align_corners=self.decode_head_cfg.get(
                           'align_corners', False))
        return torch.softmax(100.0 * dense, dim=-1)

    def forward_maskclip(self, img, text_feats_mcc, conf_thresh):
        """Dense guidance labels: int64 (B, H, W) argmax of
        ``maskclip_probs``, 255 where the confidence is below
        ``conf_thresh``."""
        conf, label = self.maskclip_probs(img, text_feats_mcc).max(dim=-1)
        return torch.where(conf < conf_thresh, torch.full_like(label, 255),
                           label)
