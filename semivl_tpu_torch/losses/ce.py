"""Cross-entropy (counterpart of ``semivl_tpu/losses/ce.py``).

Parity with ``torch.nn.CrossEntropyLoss(ignore_index=255)`` (reference
semivl.py:142-164) and its OHEM variant (third_party/unimatch/util/
ohem.py:8-57). Logits are (B, C, H, W) float; labels (B, H, W) integer
with 255 = ignore. All reductions in float32.
"""

import torch

# The 19 Cityscapes class weights of the reference OHEM's ``use_weight``
# branch (third_party/unimatch/util/ohem.py:17-20), the port's own copy.
CITYSCAPES_OHEM_WEIGHT = (
    0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
    0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
    1.0865, 1.1529, 1.0507)


def _per_pixel_ce(logits, labels, ignore_index=255):
    """Per-pixel CE map (0 at ignored pixels) and the valid mask."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=1)
    picked = torch.gather(logits, 1, safe[:, None])[:, 0]
    return torch.where(valid, logz - picked, torch.zeros_like(logz)), valid


def cross_entropy(logits, labels, ignore_index=255, reduction='mean'):
    """reduction: 'mean' (over valid pixels, torch parity) | 'none' | 'sum'."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_index)
    if reduction == 'none':
        return ce
    if reduction == 'sum':
        return ce.sum()
    if reduction == 'mean':
        return ce.sum() / valid.sum().clamp(min=1)
    raise ValueError(reduction)


def ohem_cross_entropy(logits, labels, ignore_index=255, thresh=0.7,
                       min_kept=200000, weight=None):
    """Online hard example mining CE (reference ohem.py:8-57, JAX
    ``ohem_cross_entropy``): the valid pixels whose softmax probability of
    the true class is at most the threshold, which is ``thresh`` raised to
    the ``min_kept``-th smallest of those probabilities (invalid pixels
    count as 1.0; at most the pixel count), ties at it kept. ``weight``: the
    (C,) class weights, the loss then normalised by the kept pixels'
    summed weights as torch's weighted mean is; 0 when no pixel is
    valid."""
    logits32 = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    with torch.no_grad():
        true_prob = torch.gather(torch.softmax(logits32, dim=1), 1,
                                 safe[:, None])[:, 0]
        true_prob = torch.where(valid, true_prob,
                                torch.ones_like(true_prob))
        flat = true_prob.reshape(-1)
        k = max(min(min_kept, flat.numel()) - 1, 0)
        kth = torch.kthvalue(flat, k + 1).values
        keep = valid & (true_prob <= torch.clamp(kth, min=thresh))
    ce, _ = _per_pixel_ce(logits, labels, ignore_index)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=logits.device)[safe]
        zero = torch.zeros_like(ce)
        loss = torch.where(keep, ce * w, zero).sum()
        denom = torch.where(keep, w, zero).sum().clamp(min=1e-12)
    else:
        loss = torch.where(keep, ce, torch.zeros_like(ce)).sum()
        denom = keep.sum().clamp(min=1)
    return torch.where(valid.any(), loss / denom, torch.zeros_like(loss))
