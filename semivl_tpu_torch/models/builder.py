"""Model factory (counterpart of ``semivl_tpu/models/builder.py``), for the
VLGHead / MaskClipViT flagship family."""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from semivl_tpu_torch.configs.models import get_model_config
from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.text.embeddings import (
    load_text_embedding,
    text_embedding_path,
)


@dataclasses.dataclass
class ModelBundle:
    """What inference (and later training) needs about the model."""
    model: VLM
    text_feats: np.ndarray            # (N, 512) decoder text embedding
    freeze_backbone: bool = False
    exclude_keys: Optional[list] = None


def init_weights(model, generator):
    """Seeded random weights: every matrix or kernel U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) (torch's default bound), the cls token and positional
    embedding N(0, 0.02), norm scales 1 and biases 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(('cls_token', 'pos_embed')):
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
    the run config and the text embedding from dataset + variant
    (reference model/builder.py:104-159). The weights are random from
    ``seed`` (load trained ones with ``convert.load_jax_params``);
    parameters are float32, computation runs in ``dtype``. ``device``
    defaults to the CUDA card and raises without one."""
    device = resolve_device(device)
    model_type = cfg['model']
    if not model_type.startswith('mmseg.'):
        raise ValueError(model_type)
    mcfg = get_model_config(model_type, img_size=cfg['crop_size'])
    model_cfg = mcfg['model']
    model_cfg['decode_head']['num_classes'] = cfg['nclass']
    if cfg.get('pl_text', cfg['text_embedding_variant']) != \
            cfg['text_embedding_variant']:
        # reference vlm.py:42: pseudo-label text == decoder text
        raise ValueError('pl_text must equal text_embedding_variant')
    text_feats = load_text_embedding(
        text_embedding_path(cfg['dataset'], cfg['text_embedding_variant']))

    model = VLM(model_cfg['backbone'], model_cfg['decode_head'], dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return ModelBundle(
        model=model.to(device).eval(),
        text_feats=text_feats,
        freeze_backbone=model_cfg.get('freeze_backbone', False),
        exclude_keys=model_cfg.get('exclude_keys'))
