"""The plain reference of ``zegclip_sliding_window`` evaluation (the
reference repository's ``third_party/unimatch/supervised.py:69-102``) and
of the intersection / union histograms (``supervised.py:135-164``)."""

import numpy as np
import torch

from portbench.reference import model as M


def window_coords(h, w, crop, stride):
    """Top-left corners of the edge-aligned window grid."""
    hg = max(h - crop + stride - 1, 0) // stride + 1
    wg = max(w - crop + stride - 1, 0) // stride + 1
    return [(max(min(i * stride + crop, h) - crop, 0),
             max(min(j * stride + crop, w) - crop, 0))
            for i in range(hg) for j in range(wg)]


@torch.no_grad()
def score_map(P, arch, text, img_u8, crop, stride, q, device):
    """The (C, H, W) float32 score map of one uint8 (H, W, 3) image: window
    logits averaged by visit count, resized to the image with bilinear
    ``align_corners=True`` (the label map has the image's size here)."""
    img = torch.as_tensor(img_u8, device=device).float() / 255.0
    img = (img - torch.tensor(M.IMAGENET_MEAN, device=device)) \
        / torch.tensor(M.IMAGENET_STD, device=device)
    h, w = img.shape[:2]
    text = torch.as_tensor(text, device=device).float()
    canvas = count = None
    for y, x in window_coords(h, w, crop, stride):
        logits = M.vlm_forward(P, {}, arch, img[None, y:y + crop,
                                                 x:x + crop], text, q)[0]
        if canvas is None:
            canvas = torch.zeros((logits.shape[0], h, w), device=device)
            count = torch.zeros((h, w), device=device)
        canvas[:, y:y + crop, x:x + crop] += logits
        count[y:y + crop, x:x + crop] += 1
    return M.resize_hw(canvas / count, (h, w), 'bilinear', True)


def histograms(pred, mask, nclass):
    """(intersection, union, target) per class of a label map against a
    label map with 255 ignored."""
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    mask = np.asarray(mask).reshape(-1).astype(np.int64)
    valid = mask != 255
    pred, mask = pred[valid], mask[valid]
    inter = np.bincount(pred[pred == mask], minlength=nclass)[:nclass]
    area_p = np.bincount(pred, minlength=nclass)[:nclass]
    area_t = np.bincount(mask, minlength=nclass)[:nclass]
    return np.stack([inter, area_p + area_t - inter, area_t])
