"""Confidence weighting of unlabeled CE loss maps (counterpart of
``semivl_tpu/losses/conf_weight.py``; reference utils/train_utils.py:30-49).
"""

import torch


def confidence_weighted_loss(loss_map, conf_map, ignore_mask, conf_mode,
                             conf_thresh):
    """loss_map/conf_map: (B, H, W) float; ignore_mask: (B, H, W) integer.

    Returns a scalar. Modes:
      - pixelwise: zero low-confidence pixels, mean over valid pixels;
      - pixelratio: scale each sample's loss by its high-confidence fraction;
      - pixelavg: scale the summed loss by each sample's mean confidence
        (replicated literally, including the reference's scalar-broadcast
        quirk at train_utils.py:45).
    """
    loss_map, conf_map = loss_map.float(), conf_map.float()
    valid = ignore_mask != 255
    valid_f = valid.float()
    total_valid = valid_f.sum().clamp(min=1.0)
    if conf_mode == 'pixelwise':
        kept = (conf_map >= conf_thresh) & valid
        return (loss_map * kept).sum() / total_valid
    if conf_mode == 'pixelratio':
        per = ((conf_map >= conf_thresh) & valid).float()
        ratio = (per.sum(dim=(1, 2), keepdim=True)
                 / valid_f.sum(dim=(1, 2), keepdim=True).clamp(min=1.0))
        return (loss_map * ratio).sum() / total_valid
    if conf_mode == 'pixelavg':
        avg_conf = ((conf_map * valid_f).sum(dim=(1, 2))
                    / valid_f.sum(dim=(1, 2)).clamp(min=1.0))
        # reference: loss.sum() * avg_conf -> (B,) -> .sum() / valid.sum()
        return loss_map.sum() * avg_conf.sum() / total_valid
    raise ValueError(conf_mode)
