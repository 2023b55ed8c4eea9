"""Cross-entropy (counterpart of ``semivl_tpu/losses/ce.py``).

Parity with ``torch.nn.CrossEntropyLoss(ignore_index=255)`` (reference
semivl.py:142-164). Logits are (B, C, H, W) float; labels (B, H, W) integer
with 255 = ignore. All reductions in float32.
"""

import torch


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
