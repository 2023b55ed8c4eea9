"""Model architecture configs (counterpart of
``semivl_tpu/configs/models.py``).

Plain dicts mirroring the reference's mmseg config files; only the flagship
SemiVL model is carried here.
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


def _vlg_head(img_size, skip_in_channels, skip_channels):
    """VLG decoder (reference vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb.py:49-66)."""
    return dict(
        type='VLGHead',
        img_size=img_size,
        num_classes=21,  # overridden by build_model
        text_in_channels=512,
        text_channels=128,
        up_channels=(64, 32),
        skip_in_channels=skip_in_channels,
        skip_channels=skip_channels,
        num_layers=2,
        num_heads=4,
        channels=128,
        pool_size=(4, 4),
        conv1_ksize=7,
        align_corners=False,
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


_MODEL_CONFIGS = {
    'vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb': _vlm_vlg_sk04,
}


def get_model_config(name, img_size=512):
    """A deep copy of the named model architecture config."""
    name = name.replace('mmseg.', '')
    if name not in _MODEL_CONFIGS:
        raise ValueError(f'Unknown model config {name!r}; '
                         f'known: {sorted(_MODEL_CONFIGS)}')
    return copy.deepcopy(_MODEL_CONFIGS[name](img_size=img_size))
