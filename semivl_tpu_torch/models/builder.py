"""Model factory (counterpart of ``semivl_tpu/models/builder.py``), for the
VLGHead / MaskClipViT family (the flagship on VOC, COCO and ADE20K, the
Cityscapes model with its ResNetV1c skip encoder and the tiny test VLM),
exp 41's DeepLabV3+ models (on the MaskCLIP ViT or a timm ViT) and its
ZegCLIP model (the ATM head on the VPT CLIP ViT), the frozen guidance
encoder, and the UniMatch DeepLabV3+ baselines (``model =
'deeplabv3plus'``: ``dlv3p-r101``, ``dlv3p-xc65``). JAX's builder also
clones a VLG model into a forward-only variant for its fused Pallas
decoder (builder.py:240-259); the port's kernels serve both directions
from one module, so it builds one model for every head."""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from semivl_tpu_torch.configs.models import get_model_config
from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.models.deeplabv3plus import DeepLabV3Plus
from semivl_tpu_torch.models.layers import set_attention_impl
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.text.embeddings import (
    load_text_embedding,
    text_embedding_path,
)


@dataclasses.dataclass
class ModelBundle:
    """What inference and training need about the model."""
    model: VLM
    text_feats: np.ndarray            # (N, 512) decoder text embedding
    freeze_backbone: bool = False
    exclude_keys: Optional[list] = None
    mcc_text_feats: Optional[np.ndarray] = None  # guidance-label text


def is_trainable(name, freeze_backbone, exclude_keys):
    """The freeze rule of JAX ``train/optim.py::trainable_mask`` on a
    parameter name: ``clip_encoder.*`` is always frozen; with
    ``freeze_backbone`` (the ``ftap`` models), ``backbone.*`` is frozen
    unless one of ``exclude_keys`` occurs in the name (reference
    vlm.py:80-93); without it (``ft``) everything else trains."""
    if name.startswith('clip_encoder'):
        return False
    if freeze_backbone and name.startswith('backbone'):
        return bool(exclude_keys) and any(k in name for k in exclude_keys)
    return True


EMBEDDINGS = ('cls_token', 'pos_embed', 'class_embedding',
              'positional_embedding', 'prompt_embeddings')


def init_weights(model, generator):
    """Seeded random weights: every matrix or kernel U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) (torch's default bound), the cls token, class, position
    and prompt embeddings N(0, 0.02), norm scales 1 and biases 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(EMBEDDINGS):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif p.ndim >= 2:
                bound = 1.0 / math.sqrt(p[0].numel())
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                        * bound)
            elif name.endswith('bias'):
                p.zero_()
            else:
                p.fill_(1.0)


def build_model(cfg, dtype=torch.float32, device=None, seed=0):
    """Run-config dict -> ``ModelBundle`` with the model on ``device``.

    Resolves the named model config, takes num_classes and img_size from
    the run config and the text embedding from dataset + variant, whose
    asset path the decode head gets as ``text_embedding_name`` (a concept
    text is aggregated to classes by its list; reference
    model/builder.py:104-159). With ``cfg['clip_encoder']`` (the
    training configs) it adds the frozen guidance encoder and its text.
    The weights are random from ``seed`` (load trained ones with
    ``convert.load_jax_params``); parameters are float32, computation runs
    in ``dtype``; frozen parameters have ``requires_grad=False``; the
    BatchNorm running statistics of the conv encoder and of a DeepLabV3+
    head are buffers (the JAX ``batch_stats`` collection) and their
    parameters stay trainable.
    ``cfg['model_args']['renorm_clip_img']`` renormalises the ViT inputs to
    CLIP statistics, ``cfg['decoder_bwd']`` ('whole' or 'banded') routes
    the decoder backward and ``cfg['attention_impl']`` ('auto', 'xla' or
    'pallas') every attention layer (JAX sets it globally in
    ``train/loop.py:245-247``; here the model carries it). With
    ``cfg['mcc_fix_resize_pos']`` the guidance encoder is built at the crop
    size, else at 512 (its positional grid resized). A set
    ``cfg['model_args']['maskclip_class_filter']``, a dead option of the
    reference, is refused by name, as JAX asserts it off (builder.py:224).
    ``model = 'deeplabv3plus'`` builds the UniMatch baseline from
    ``backbone``, ``replace_stride_with_dilation`` and ``dilations``, with
    zeros (nclass, 1) as its unused text, no guidance encoder and nothing
    frozen (JAX builder.py:171-193). ``device`` defaults to the CUDA card
    and raises without one."""
    model_args = cfg.get('model_args') or {}
    if model_args.get('maskclip_class_filter') is not None:
        raise ValueError('model_args.maskclip_class_filter is a dead option '
                         'of the reference; JAX refuses it (set it to None)')
    device = resolve_device(device)
    model_type = cfg['model']
    if model_type == 'deeplabv3plus':
        return _build_deeplabv3plus(cfg, dtype, device, seed)
    if not model_type.startswith('mmseg.'):
        raise ValueError(model_type)
    mcfg = get_model_config(model_type, img_size=cfg['crop_size'])
    model_cfg = mcfg['model']
    model_cfg['decode_head']['num_classes'] = cfg['nclass']
    if 'decoder_bwd' in cfg:
        model_cfg['decode_head']['decoder_bwd'] = cfg['decoder_bwd']
    if cfg.get('pl_text', cfg['text_embedding_variant']) != \
            cfg['text_embedding_variant']:
        # reference vlm.py:42: pseudo-label text == decoder text
        raise ValueError('pl_text must equal text_embedding_variant')
    text_path = text_embedding_path(cfg['dataset'],
                                    cfg['text_embedding_variant'])
    model_cfg['decode_head']['text_embedding_name'] = text_path
    text_feats = load_text_embedding(text_path)
    clip_cfg, mcc_text, mcc_name = None, None, ''
    if cfg.get('clip_encoder'):
        clip_cfg = get_model_config(
            cfg['clip_encoder'],
            img_size=(cfg['crop_size'] if cfg.get('mcc_fix_resize_pos')
                      else 512))['backbone']
        mcc_name = text_embedding_path(cfg['dataset'], cfg['mcc_text'])
        mcc_text = load_text_embedding(mcc_name)

    model = VLM(model_cfg['backbone'], model_cfg['decode_head'],
                clip_encoder_cfg=clip_cfg,
                conv_encoder_cfg=model_cfg.get('conv_encoder'),
                renorm_clip_img=bool(model_args.get('renorm_clip_img')),
                fp_rate=cfg.get('fp_rate', 0.5), mcc_text_name=mcc_name,
                dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    set_attention_impl(model, cfg.get('attention_impl', 'auto'))
    freeze = model_cfg.get('freeze_backbone', False)
    exclude = model_cfg.get('exclude_keys')
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name, freeze, exclude))
    return ModelBundle(
        model=model.to(device).eval(),
        text_feats=text_feats,
        freeze_backbone=freeze,
        exclude_keys=exclude,
        mcc_text_feats=mcc_text)


def _build_deeplabv3plus(cfg, dtype, device, seed):
    model = DeepLabV3Plus(
        cfg['nclass'], backbone=cfg['backbone'],
        replace_stride_with_dilation=tuple(cfg.get(
            'replace_stride_with_dilation', (False, False, True))),
        dilations=tuple(cfg.get('dilations', (6, 12, 18))),
        fp_rate=cfg.get('fp_rate', 0.5), dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return ModelBundle(model=model.to(device).eval(),
                       text_feats=np.zeros((cfg['nclass'], 1), np.float32))
