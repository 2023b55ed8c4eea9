"""VLM segmentor (counterpart of ``semivl_tpu/models/vlm.py``).

CLIP encoder + VLG decoder, plus the frozen MaskCLIP guidance encoder
(``clip_encoder``) of training and, in the Cityscapes model, the ResNetV1c
skip encoder (``conv_encoder``); exp 41's ablation models put a DeepLabV3+
head (BatchNorm) on the MaskCLIP ViT or on a timm ViT, or ZegCLIP's ATM head
on its VPT CLIP ViT. Text embeddings are arguments; every head takes the
backbone's global (cls) embedding, which only the ATM head reads. Feature
perturbation (channel dropout on the encoder's feature maps) takes an
explicit ``torch.Generator``; ``need_fp`` runs one decoder
pass over the clean batch and the perturbed slice together (reference
model/builder.py:56-102). With ``renorm_clip_img`` the ViT and the guidance
encoder see the image renormalised from ImageNet to CLIP statistics; the
conv encoder sees it as given (reference vlm.py:69-78, 112-123).
"""

import numpy as np
import torch
from torch import nn

from semivl_tpu_torch.models.atm_head import ATMSingleHeadSeg
from semivl_tpu_torch.models.clip_vit import MaskClipViT
from semivl_tpu_torch.models.dlv3p_head import DLV3PHead
from semivl_tpu_torch.models.resnet import ResNetV1c
from semivl_tpu_torch.models.timm_vit import TIMMVisionTransformer
from semivl_tpu_torch.models.vlg_head import VLGHead
from semivl_tpu_torch.models.zegclip_vit import VPTCLIPVisionTransformer
from semivl_tpu_torch.ops.dropout import dropout2d
from semivl_tpu_torch.ops.resize import device_constant, resize
from semivl_tpu_torch.text.embeddings import (
    aggregate_concept_predictions,
    get_class_to_concept_idxs,
)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def renormalize_img_for_clip(img):
    """ImageNet-normalised -> CLIP-normalised NHWC image (reference
    vlm.py:69-78)."""
    def c(v):
        return device_constant(('renorm', v), lambda: np.asarray(v),
                               img.device, img.dtype)

    return (img * c(IMAGENET_STD) + c(IMAGENET_MEAN) - c(CLIP_MEAN)) \
        / c(CLIP_STD)


def build_backbone(cfg, dtype):
    if cfg['type'] == 'ResNetV1c':
        return ResNetV1c(depth=cfg.get('depth', 101),
                         num_stages=cfg.get('num_stages', 1),
                         out_indices=tuple(cfg.get('out_indices', (0,))),
                         dtype=dtype)
    if cfg['type'] == 'TIMMVisionTransformer':
        # drop_path_rate: JAX applies it only under stochastic=True, which
        # the VLM never passes (models/timm_vit.py)
        return TIMMVisionTransformer(
            img_size=(cfg['img_size'], cfg['img_size']),
            out_indices=tuple(cfg.get('out_indices', (4, 11))), dtype=dtype)
    if cfg['type'] == 'VPTCLIPVisionTransformer':
        # JAX's builder defaults (models/builder.py:69-84)
        return VPTCLIPVisionTransformer(
            input_resolution=cfg.get('input_resolution', 512),
            patch_size=cfg.get('patch_size', 16),
            width=cfg.get('width', 768), layers=cfg.get('layers', 12),
            heads=cfg.get('heads', 12), output_dim=cfg.get('output_dim', 512),
            num_tokens=cfg.get('num_tokens', 10),
            prompt_dim=cfg.get('prompt_dim', 768),
            total_d_layer=cfg.get('total_d_layer', 11),
            out_indices=tuple(cfg.get('out_indices', (11,))),
            drop_path_rate=cfg.get('drop_path_rate', 0.0), dtype=dtype)
    if cfg['type'] != 'MaskClipVisionTransformer':
        raise ValueError(f'Unknown backbone type {cfg["type"]!r}')
    keys = ('patch_size', 'in_channels', 'embed_dims', 'num_layers',
            'num_heads', 'mlp_ratio', 'out_indices', 'qkv_bias', 'pre_norm',
            'final_norm', 'return_clip_embed', 'return_qkv', 'skip_last_attn',
            'patch_bias', 'clip_dim', 'norm_eps')
    return MaskClipViT(img_size=tuple(cfg['img_size']), dtype=dtype,
                       **{k: cfg[k] for k in keys if k in cfg})


def build_head(cfg, dtype):
    if cfg['type'] == 'DLV3PHead':
        keys = ('in_channels', 'channels', 'c1_in_channels', 'c1_channels',
                'dilations', 'align_corners')
        return DLV3PHead(img_size=cfg['img_size'],
                         num_classes=cfg['num_classes'], dtype=dtype,
                         **{k: cfg[k] for k in keys if k in cfg})
    if cfg['type'] == 'ATMSingleHeadSeg':
        # JAX's builder defaults (models/builder.py:123-138): use_proj True
        return ATMSingleHeadSeg(
            img_size=cfg['img_size'], num_classes=cfg['num_classes'],
            in_channels=cfg.get('in_channels', 512),
            embed_dims=cfg.get('embed_dims', 512),
            num_layers=cfg.get('num_layers', 3),
            num_heads=cfg.get('num_heads', 8),
            use_stages=cfg.get('use_stages', 1),
            use_proj=cfg.get('use_proj', True), use_rd=cfg.get('use_rd', True),
            align_corners=cfg.get('align_corners', False),
            text_embedding_name=cfg.get('text_embedding_name', ''),
            dtype=dtype)
    if cfg['type'] != 'VLGHead':
        raise ValueError(f'Unknown head type {cfg["type"]!r}')
    keys = ('text_in_channels', 'text_channels', 'up_channels',
            'skip_in_channels', 'skip_channels', 'skip_from_conv_feat',
            'num_layers', 'num_heads', 'channels', 'pool_size',
            'conv1_ksize', 'align_corners', 'decoder_bwd',
            'text_embedding_name')
    return VLGHead(img_size=cfg['img_size'], num_classes=cfg['num_classes'],
                   dtype=dtype, **{k: cfg[k] for k in keys if k in cfg})


def _check_clip_embed(cfg, role):
    """Refuse a ViT config whose dense CLIP embedding the VLM reads but
    ``return_clip_embed=False`` drops: the decode head takes it as the last
    feature map when ``num_layers`` is in ``out_indices``; the guidance
    encoder's labels always come from it."""
    if cfg is None or cfg['type'] != 'MaskClipVisionTransformer' \
            or cfg.get('return_clip_embed', True):
        return
    num_layers = cfg.get('num_layers', 12)
    if role == 'clip_encoder' or num_layers in (cfg.get('out_indices')
                                                or (num_layers,)):
        raise ValueError(f'{role}: return_clip_embed=False drops the dense '
                         'CLIP embedding that the VLM reads')


class VLM(nn.Module):
    """``backbone``, ``decode_head``, for training with guidance labels
    ``clip_encoder`` and for the Cityscapes model ``conv_encoder``: the
    reference's top-level names."""

    def __init__(self, backbone_cfg, decode_head_cfg, clip_encoder_cfg=None,
                 conv_encoder_cfg=None, renorm_clip_img=False, fp_rate=0.5,
                 mcc_text_name='', dtype=torch.float32):
        super().__init__()
        _check_clip_embed(backbone_cfg, 'backbone')
        _check_clip_embed(clip_encoder_cfg, 'clip_encoder')
        self.decode_head_cfg = decode_head_cfg
        self.renorm_clip_img = renorm_clip_img
        self.fp_rate = fp_rate
        self.mcc_text_name = mcc_text_name
        self.backbone = build_backbone(backbone_cfg, dtype)
        self.decode_head = build_head(decode_head_cfg, dtype)
        self.conv_encoder = (build_backbone(conv_encoder_cfg, dtype)
                             if conv_encoder_cfg else None)
        self.clip_encoder = (build_backbone(clip_encoder_cfg, dtype)
                             if clip_encoder_cfg else None)

    def _renorm(self, img):
        return renormalize_img_for_clip(img) if self.renorm_clip_img else img

    def extract_feat(self, img, train=False):
        """(feats tuple, global_emb, conv_feats) — reference
        vlm.py:112-123; ``train`` puts the conv encoder's BatchNorm in
        train mode (the backbone has no train mode: JAX never passes it
        ``stochastic``)."""
        out = self.backbone(self._renorm(img))
        conv_feats = None
        if self.conv_encoder is not None:
            conv_feats = self.conv_encoder(img, train=train)
        return out['feats'], out['global_emb'], conv_feats

    def forward(self, img, text_feats, need_fp=False, generator=None,
                train=False):
        """img: (B, H, W, 3) normalised float; text_feats: (N, 512).
        Returns float32 (B, num_classes, H, W) logits.

        ``need_fp``: also decode a perturbed copy of the second half of the
        batch (the unlabeled ``img_w``) with channel dropout on every
        feature map (the ViT's, then the conv encoder's), in the same
        decoder pass, its global embedding repeated unperturbed (JAX
        vlm.py:126-129); returns ``(logits, logits_fp)``. The reference
        perturbs the whole batch and drops the x half (builder.py:81-99 vs
        semivl.py:245-247); GroupNorm and LayerNorm are per sample, so the
        kept half is the same. ``train``: BatchNorm of the conv encoder
        normalises with batch statistics and updates its running ones (the
        student passes); otherwise it uses the running ones."""
        feats, global_emb, conv_feats = self.extract_feat(img, train)
        b = img.shape[0]
        if need_fp:
            feats = tuple(torch.cat([f, dropout2d(f[b // 2:], self.fp_rate,
                                                  generator)])
                          for f in feats)
            if conv_feats is not None:
                conv_feats = [torch.cat([f, dropout2d(
                    f[b // 2:], self.fp_rate, generator)])
                    for f in conv_feats]
            if global_emb is not None:
                global_emb = torch.cat([global_emb, global_emb[b // 2:]])
        logits = self.decode_head(feats, text_feats, conv_feats,
                                  output_size=tuple(img.shape[1:3]),
                                  train=train, global_emb=global_emb)
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
        visual = self.clip_encoder(self._renorm(img))['feats'][-1]
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
