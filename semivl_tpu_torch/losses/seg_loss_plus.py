"""MaskFormer-style segmentation loss of the ATM head, SegLossPlus
(counterpart of ``semivl_tpu/losses/seg_loss_plus.py``; reference
third_party/zegclip/losses/atm_loss.py, atm_criterion.py).

- per-class binary target masks from the label map, 255 all-zero (ignore
  pixels count as background in both terms, as in the reference);
- sigmoid focal loss (alpha .25, gamma 2) over all B*C masks, the mean over
  pixels, summed and divided by ``num_masks``;
- dice loss over the classes present in each image only;
- ``num_masks``: the number of present (image, class) pairs, inside a
  process group averaged over its ranks (JAX's ``pmean(num_masks,
  'data')``; the count carries no gradient), then at least 1;
- deep supervision: the same loss on each ``aux_masks`` entry.

All of it in float32.
"""

import torch

from semivl_tpu_torch.ops.resize import resize_hw
from semivl_tpu_torch.parallel import dist


def binary_targets(labels, num_classes):
    """(B, H, W) integer labels -> (B, C, H, W) float one-hot; 255 (and any
    label outside [0, C)) all-zero."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes[None, :, None, None]).float()


def _sigmoid_focal(pred, target, alpha=0.25, gamma=2.0):
    """Per-mask focal loss, the mean over pixels: (B, C)."""
    pred = pred.float()
    ce = (torch.clamp(pred, min=0) - pred * target
          + torch.log1p(torch.exp(-pred.abs())))
    prob = torch.sigmoid(pred)
    p_t = prob * target + (1 - prob) * (1 - target)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * target + (1 - alpha) * (1 - target)
    return (alpha_t * loss).mean(dim=(2, 3))


def _dice(pred, target):
    """Per-mask dice loss: (B, C)."""
    prob = torch.sigmoid(pred.float())
    num = 2 * (prob * target).sum(dim=(2, 3))
    den = prob.sum(dim=(2, 3)) + target.sum(dim=(2, 3))
    return 1 - (num + 1) / (den + 1)


def seg_loss_plus(pred_masks, labels, num_classes, aux_masks=None,
                  mask_weight=20.0, dice_weight=1.0, loss_weight=1.0):
    """pred_masks: (B, C, H, W) logits, resized bilinearly to the labels'
    size when it differs; labels: (B, h, w) integer, 255 ignored;
    aux_masks: logits at the labels' size. Returns the summed scalar loss
    (the reference's ``_parse_losses`` sums the loss dict)."""
    targets = binary_targets(labels, num_classes)
    if pred_masks.shape[-2:] != targets.shape[-2:]:
        pred_masks = resize_hw(pred_masks.float(), targets.shape[-2:],
                               'bilinear', False)
    present = (targets > 0).any(dim=3).any(dim=2)            # (B, C)
    num_masks = present.float().sum()
    if dist.active():
        dist.mean_over_ranks_([num_masks])
    num_masks = num_masks.clamp(min=1.0)

    def one_level(pm):
        focal = _sigmoid_focal(pm, targets).sum() / num_masks
        dice = (_dice(pm, targets) * present).sum() / num_masks
        return mask_weight * focal + dice_weight * dice

    loss = one_level(pred_masks)
    for aux in aux_masks or ():
        loss = loss + one_level(aux)
    return loss_weight * loss
