"""Model architecture configs (counterpart of
``semivl_tpu/configs/models.py``).

Plain dicts mirroring the reference's mmseg config files; carried here are
the flagship SemiVL model (VOC, COCO, ADE20K), its Cityscapes variant with
the ResNet skip encoder, exp 41's three DeepLabV3+ ablation models and its
ZegCLIP model, the frozen MaskCLIP guidance encoder, and the JAX package's
tiny VLM family (``tiny-vlm-test`` and its guidance encoder
``tiny-mcvit-test``), whose heads of 16 and 32 take the head-split
attention kernels.
"""

import copy


def _maskclip_vitb16(img_size, out_indices):
    """CLIP ViT-B/16 backbone (reference
    configs/_base_/models/vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb.py:21-48)."""
    return dict(
        type='MaskClipVisionTransformer',
        img_size=(img_size, img_size),
        patch_size=16,
        patch_bias=False,
        in_channels=3,
        embed_dims=768,
        num_layers=12,
        num_heads=12,
        mlp_ratio=4,
        out_indices=out_indices,
        qkv_bias=True,
        norm_eps=1e-6,
        clip_dim=512,
    )


def _vlg_head(img_size, skip_in_channels, skip_channels,
              skip_from_conv_feat=False):
    """VLG decoder (reference vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb.py:49-66).
    ``decoder_bwd`` routes the backward of the fused Up stages: 'whole'
    (whole-plane kernels) or 'banded' (the three-pass kernels that take the
    forward's GroupNorm statistics); the JAX package chooses by its VMEM
    gate and ``SEMIVL_FORCE_BANDED_BWD``."""
    return dict(
        type='VLGHead',
        img_size=img_size,
        num_classes=21,  # overridden by build_model
        text_in_channels=512,
        text_channels=128,
        up_channels=(64, 32),
        skip_in_channels=skip_in_channels,
        skip_channels=skip_channels,
        skip_from_conv_feat=skip_from_conv_feat,
        num_layers=2,
        num_heads=4,
        channels=128,
        pool_size=(4, 4),
        conv1_ksize=7,
        align_corners=False,
        decoder_bwd='whole',
    )


def _vlm_vlg_sk04(img_size=512):
    """SemiVL flagship: VLG head, skips from ViT layers 0 and 4 (reference
    configs/_base_/models/vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb.py)."""
    return dict(
        img_size=img_size,
        model=dict(
            type='VLM',
            backbone=_maskclip_vitb16(img_size, out_indices=[0, 4, 12]),
            decode_head=_vlg_head(img_size, skip_in_channels=(768, 768),
                                  skip_channels=(32, 16)),
            freeze_backbone=True,
            exclude_keys=['attn', 'pos_embed'],
        ),
    )


def _vlm_vlg_skr04(img_size=512):
    """Cityscapes variant (exp 44): VLG skips from ViT layer 4 and from the
    first stage of a ResNetV1c-101 (1 stage, BatchNorm) that sees the
    ImageNet-normalised image (reference
    configs/_base_/models/vlm-vlg-aspp-s2p4-skr04-ftap-mcvitb.py)."""
    return dict(
        img_size=img_size,
        model=dict(
            type='VLM',
            backbone=_maskclip_vitb16(img_size, out_indices=[4, 12]),
            conv_encoder=dict(type='ResNetV1c', depth=101, num_stages=1,
                              out_indices=[0]),
            decode_head=_vlg_head(img_size, skip_in_channels=(768, 256),
                                  skip_channels=(32, 32),
                                  skip_from_conv_feat=True),
            freeze_backbone=True,
            exclude_keys=['attn', 'pos_embed'],
        ),
    )


def _vlm_dlv3p(img_size=512, freeze=True, timm=False):
    """The DeepLabV3+ head ablations of exp 41 (reference
    configs/_base_/models/vlm-dlv3p-bn12-sk4-ft{ap}-mcvitb.py and
    vlm-dlv3p-bn11-sk4-ft-tvit-in1k.py; JAX
    ``semivl_tpu/configs/models.py:104-141``): the head on the MaskCLIP
    ViT's layer-4 map and dense CLIP embedding (``ftap``: only attention and
    positional embedding train; ``ft``: the whole backbone) or on a timm
    ViT-B/16's layer-4 and layer-11 maps."""
    if timm:
        backbone = dict(
            type='TIMMVisionTransformer',
            variant='vit_base_patch16_224',
            timm_load_pretrained=True,
            drop_path_rate=0.1,
            img_size=img_size,
            out_indices=[4, 11],
            pretrained='pretrained/timm_vitb16_in21k',
        )
        in_channels = 768
    else:
        backbone = _maskclip_vitb16(img_size, out_indices=[4, 12])
        in_channels = 512
    return dict(
        img_size=img_size,
        model=dict(
            type='VLM',
            pretrained=None if timm else 'pretrained/clip_vitb16_backbone',
            backbone=backbone,
            decode_head=dict(
                type='DLV3PHead',
                img_size=img_size,
                in_channels=in_channels,
                channels=256,
                c1_in_channels=768,
                c1_channels=48,
                dilations=(6, 12, 18),
                num_classes=21,
                align_corners=False,
            ),
            freeze_backbone=freeze,
            exclude_keys=['attn', 'pos_embed'] if freeze else None,
        ),
    )


def _vlm_zegclip(img_size=512):
    """ZegCLIP ablation of exp 41: the VPT CLIP ViT-B/16 (10 prompt tokens,
    deep prompts before layers 1-11) and the ATM head (3 layers, 8 heads,
    width 512, the relationship descriptor, no input projection), its
    SegLossPlus criterion, only the prompts of the backbone trained
    (reference configs/_base_/models/vlm-zegclip-rd-pt-vitb.py; JAX
    ``semivl_tpu/configs/models.py:144-183``)."""
    return dict(
        img_size=img_size,
        model=dict(
            type='VLM',
            pretrained='pretrained/clip_vitb16',
            backbone=dict(
                type='VPTCLIPVisionTransformer',
                patch_size=16,
                width=768,
                output_dim=512,
                get_embeddings=True,
                drop_path_rate=0.1,
                layers=12,
                input_resolution=img_size,
                num_tokens=10,
                prompt_dim=768,
                total_d_layer=11,
                out_indices=[11],
            ),
            decode_head=dict(
                type='ATMSingleHeadSeg',
                img_size=img_size,
                in_channels=512,
                channels=512,
                num_classes=21,
                num_layers=3,
                num_heads=8,
                use_proj=False,
                use_stages=1,
                embed_dims=512,
                align_corners=False,
                loss_decode=dict(
                    type='SegLossPlus', num_classes=21, dec_layers=3,
                    mask_weight=20.0, dice_weight=1.0, loss_weight=1.0),
            ),
            freeze_backbone=True,
            exclude_keys=['prompt'],
        ),
    )


def _mcvit16(img_size=512):
    """Frozen MaskCLIP guidance encoder (reference
    configs/_base_/models/mcvit16.py): out_indices None -> only the dense
    CLIP embedding."""
    return dict(img_size=img_size,
                backbone=_maskclip_vitb16(img_size, out_indices=None))


def _tiny_vit(img_size, out_indices):
    """The tiny family's ViT: 2 layers of width 64, 4 heads of 16, in the
    512-d CLIP space (JAX ``semivl_tpu/configs/models.py:199-236``)."""
    return dict(
        type='MaskClipVisionTransformer',
        img_size=(img_size, img_size), patch_size=16, patch_bias=False,
        embed_dims=64, num_layers=2, num_heads=4, mlp_ratio=2, clip_dim=512,
        out_indices=out_indices, pre_norm=True, final_norm=True,
        return_clip_embed=True, return_qkv=True)


def _tiny_vlm_test(img_size=64):
    """Miniature VLM of the JAX package's smoke tests and demo: the
    flagship's structure at tiny widths (VLG with channels 32, one semantic
    layer of 2 heads of 32, up (32, 16), skips (16, 16)). Not a reference
    model."""
    return dict(
        img_size=img_size,
        model=dict(
            type='VLM',
            backbone=_tiny_vit(img_size, out_indices=[0, 1, 2]),
            decode_head=dict(
                type='VLGHead', img_size=img_size, num_classes=21,
                text_in_channels=512, text_channels=32, up_channels=(32, 16),
                skip_in_channels=(64, 64), skip_channels=(16, 16),
                skip_from_conv_feat=False, num_layers=1, num_heads=2,
                channels=32, pool_size=(2, 2), conv1_ksize=3,
                align_corners=False),
            freeze_backbone=True,
            exclude_keys=['attn', 'pos_embed'],
        ),
    )


_MODEL_CONFIGS = {
    'tiny-vlm-test': _tiny_vlm_test,
    'tiny-mcvit-test': lambda img_size=64: dict(
        img_size=img_size, backbone=_tiny_vit(img_size, out_indices=None)),
    'vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb': _vlm_vlg_sk04,
    'vlm-vlg-aspp-s2p4-skr04-ftap-mcvitb': _vlm_vlg_skr04,
    'vlm-dlv3p-bn12-sk4-ftap-mcvitb':
        lambda img_size=512: _vlm_dlv3p(img_size, freeze=True),
    'vlm-dlv3p-bn12-sk4-ft-mcvitb':
        lambda img_size=512: _vlm_dlv3p(img_size, freeze=False),
    'vlm-dlv3p-bn11-sk4-ft-tvit-in1k':
        lambda img_size=512: _vlm_dlv3p(img_size, freeze=False, timm=True),
    'vlm-zegclip-rd-pt-vitb': _vlm_zegclip,
    'mcvit16': _mcvit16,
}


def get_model_config(name, img_size=512):
    """A deep copy of the named model architecture config."""
    name = name.replace('mmseg.', '')
    if name not in _MODEL_CONFIGS:
        raise ValueError(f'Unknown model config {name!r}; '
                         f'known: {sorted(_MODEL_CONFIGS)}')
    return copy.deepcopy(_MODEL_CONFIGS[name](img_size=img_size))
