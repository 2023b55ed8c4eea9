"""Standalone checkpoint evaluation (counterpart of
``semivl_tpu/tools/eval.py``; reference third_party/unimatch/eval.py).

Builds the run config's model without the guidance encoder, loads a
checkpoint, evaluates the val set in the config's mode (``eval_mode``, else
``sliding_window`` for Cityscapes and ``original`` otherwise, as the
reference's eval.py), logs per-class IoU and mIoU, and optionally writes
paletted PNG predictions and the raw (1, C, H, W) float32 logits
(``.npy``, from ``Evaluator.predict(..., return_logits=True)``).

``--save-path`` takes a port run slot (``exp/.../ckpt/best`` or
``latest``; ``--ema`` reads its parameter EMA where it has one), an npz of
a converted tree (``tools.convert_reference_ckpt``'s or JAX's), a
reference ``.pth`` (``module.`` stripped, ``--ema``: its ``ema_model``) or
``none`` (the seeded random weights). Runs on the card unless ``--device
cpu`` is given.

    python -m semivl_tpu_torch.tools.eval --config <cfg.yaml> \\
        --save-path exp/.../ckpt/best [--ema] [--pred-path out/preds] \\
        [--logit-path out/logits] [--device cpu]
"""

import argparse
import logging
import os
import pprint

import numpy as np
import torch
import yaml
from PIL import Image


def load_checkpoint(model, path, ema, logger):
    """``path`` (see the module's docstring) into the evaluation ``model``."""
    from semivl_tpu_torch.convert import load_flax_npz, load_jax_params
    if path.endswith('.npz'):
        tree = load_flax_npz(path)
        load_jax_params(model, tree['params'], tree.get('batch_stats'))
        logger.info('Loaded converted tree %s', path)
    elif path.endswith(('.pth', '.pt')):
        from semivl_tpu_torch.tools.convert_reference_ckpt import (
            load_reference_into)
        epoch = load_reference_into(model, path, ema)
        logger.info('Loaded reference checkpoint (epoch %s)', epoch)
    else:
        payload = torch.load(path, map_location='cpu', weights_only=True)
        sd = payload['model']
        if ema and 'ema' in payload:
            sd = {**sd, **payload['ema']}
            logger.info('Using EMA params')
        own = model.state_dict()
        missing = sorted(set(own) - set(sd))
        if missing:
            raise ValueError(f'{path}: the slot lacks {missing[:4]}')
        # the training model's guidance encoder is not built here
        model.load_state_dict({k: sd[k] for k in own}, strict=True)
        logger.info('Loaded checkpoint at iteration %s',
                    payload.get('iteration'))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--save-path', type=str, required=True,
                        help="a run slot, a converted .npz, a reference "
                             ".pth, or 'none' for the seeded weights")
    parser.add_argument('--ema', action='store_true')
    parser.add_argument('--pred-path', default=None, type=str)
    parser.add_argument('--logit-path', default=None, type=str)
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             'for the plain path)')
    args = parser.parse_args(argv)

    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.datasets.classes import CLASSES
    from semivl_tpu_torch.datasets.palettes import get_palette
    from semivl_tpu_torch.device import resolve_device
    from semivl_tpu_torch.evaluation.metrics import (intersection_and_union,
                                                     miou_from_histograms)
    from semivl_tpu_torch.evaluation.predict import Evaluator
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.train.loop import model_dtype
    from semivl_tpu_torch.utils.logging_utils import init_log

    device = resolve_device(args.device)
    logger = init_log('global', logging.INFO)
    with open(args.config) as f:
        cfg = yaml.load(f, Loader=yaml.Loader)
    # legacy configs, and no guidance encoder at evaluation (eval.py:90-93)
    cfg.setdefault('text_embedding_variant', 'single')
    cfg.setdefault('pl_text', cfg['text_embedding_variant'])
    cfg['clip_encoder'] = None
    logger.info('%s\n', pprint.pformat({**cfg, **vars(args)}))

    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device)
    if args.save_path != 'none':
        load_checkpoint(bundle.model, args.save_path, args.ema, logger)
    else:
        logger.info('************ WARNING: NO CHECKPOINT SPECIFIED')

    valset = SemiDataset(cfg, 'val', id_path=cfg.get('val_id_path'))
    evaluator = Evaluator(bundle.model, bundle.text_feats, cfg, device)
    eval_mode = cfg.get('eval_mode') or (
        'sliding_window' if cfg['dataset'] == 'cityscapes' else 'original')
    palette = get_palette(cfg['dataset'])

    inter_sum = np.zeros(cfg['nclass'], np.int64)
    union_sum = np.zeros(cfg['nclass'], np.int64)
    for i in range(len(valset)):
        sample = valset.get(i)
        mask = sample['mask']
        out = evaluator.predict(sample['img'][None], mask.shape, eval_mode,
                                return_logits=bool(args.logit_path))
        pred, logits = out if args.logit_path else (out, None)
        lbl_name = sample['id'].split(' ')[1].split('/')[-1]
        if args.logit_path:
            os.makedirs(args.logit_path, exist_ok=True)
            np.save(os.path.join(args.logit_path,
                                 lbl_name.replace('.png', '.npy')), logits)
        if args.pred_path:
            os.makedirs(args.pred_path, exist_ok=True)
            img = Image.fromarray(pred[0].astype(np.uint8)).convert('P')
            img.putpalette(palette.reshape(-1).tolist())
            img.save(os.path.join(args.pred_path, lbl_name))
        inter, union, _ = intersection_and_union(pred[0], mask,
                                                 cfg['nclass'])
        inter_sum += inter
        union_sum += union

    miou, iou_class = miou_from_histograms(inter_sum, union_sum)
    for cls_idx, iou in enumerate(iou_class):
        logger.info('***** Evaluation ***** >>>> Class [%d %s] IoU: %.2f',
                    cls_idx, CLASSES[cfg['dataset']][cls_idx], iou)
    logger.info('***** Evaluation %s ***** >>>> MeanIoU: %.2f\n',
                eval_mode, miou)
    return miou, (inter_sum, union_sum)


if __name__ == '__main__':
    main()
