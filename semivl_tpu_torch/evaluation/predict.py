"""Sliding-window inference and evaluation (counterpart of
``semivl_tpu/evaluation/predict.py``), two modes.

``zegclip_sliding_window`` (VOC): windows lie on an edge-aligned grid
(crop, stride); their logits are averaged by visit count, resized to the
label size with bilinear ``align_corners=True`` and reduced by argmax
(reference third_party/unimatch/supervised.py:69-102). Images whose short
side is at least the crop stay on the device from upload to argmax; a
smaller image takes the host route, which feeds each window at its clipped
size as the reference does.

``sliding_window`` (Cityscapes): windows start every int(crop * 2 / 3)
pixels from the top-left corner, the ones at the bottom and right edges
clipped to the image and fed at that natural size; the softmax
probabilities of every window are summed on the device and reduced by
argmax at image size (reference supervised.py:104-117; JAX
``_sliding_device``). A 1024x2048 image at crop 801 gives 8 windows of
4 shapes (801^2, 801x446, 490x801, 490x446).

Crops of one shape run through the model in exact power-of-two batches of
at most 32.
"""

import numpy as np
import torch

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.evaluation.metrics import (
    intersection_and_union,
    miou_from_histograms,
)
from semivl_tpu_torch.models.vlm import IMAGENET_MEAN, IMAGENET_STD
from semivl_tpu_torch.ops.resize import _axis_weights, axis_weights


def _np_resize_bilinear(x, out_hw, align_corners):
    """Host bilinear resize of a (B, C, H, W) numpy array."""
    wh = _axis_weights(out_hw[0], x.shape[2], 'bilinear', align_corners,
                       'float32')
    ww = _axis_weights(out_hw[1], x.shape[3], 'bilinear', align_corners,
                       'float32')
    return np.matmul(np.matmul(wh[None, None], x), ww.T[None, None])


def _chunk_sizes(n, max_chunk=32):
    """n as descending power-of-two chunk sizes (each <= max_chunk), e.g.
    7 -> [4, 2, 1], 33 -> [32, 1]: exact, no padded crops."""
    sizes = []
    while n > 0:
        c = min(max_chunk, 1 << (n.bit_length() - 1))
        sizes.append(c)
        n -= c
    return sizes


class Evaluator:
    """Runs ``model`` (a ``models.vlm.VLM`` on ``device``) over windows."""

    def __init__(self, model, text_feats, cfg, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.text = torch.as_tensor(np.asarray(text_feats, np.float32),
                                    device=self.device)
        self.cfg = cfg
        self.nclass = cfg['nclass']

    def _to_model_input(self, x):
        """uint8 crops are normalised on the device (/255, then ImageNet
        mean/std); float crops pass through as already normalised."""
        if x.dtype != torch.uint8:
            return x
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return (x.float() / 255.0 - mean) / std

    @torch.no_grad()
    def _forward(self, crops):
        """(n, h, w, 3) crops on the device -> (n, C, h, w) float32 logits,
        in exact power-of-two chunks."""
        outs, off = [], 0
        for c in _chunk_sizes(crops.shape[0]):
            x = self._to_model_input(crops[off:off + c])
            outs.append(self.model(x, self.text).float())
            off += c
        return torch.cat(outs)

    def use_device(self, img, mode):
        """Whether ``mode`` on this geometry keeps the canvas on the device
        (the small-image zegclip route runs on the host)."""
        return (mode == 'zegclip_sliding_window'
                and min(img.shape[1:3]) >= self.cfg['crop_size'])

    def predict(self, img, mask_shape, mode):
        """img: (1, H, W, 3) numpy, uint8 or normalised float. Returns the
        (1, h_mask, w_mask) int64 prediction."""
        if mode == 'sliding_window':
            return self._sliding_device(img, mask_shape)
        if mode != 'zegclip_sliding_window':
            raise NotImplementedError(f'eval mode {mode!r} is not ported')
        if self.use_device(img, mode):
            return self._zegclip_sliding_device(img, mask_shape)
        return self._zegclip_sliding(img, mask_shape)

    def _zegclip_coords(self, h_img, w_img):
        crop = self.cfg['crop_size']
        stride = self.cfg['stride']
        h_grids = max(h_img - crop + stride - 1, 0) // stride + 1
        w_grids = max(w_img - crop + stride - 1, 0) // stride + 1
        coords = []
        for hi in range(h_grids):
            for wi in range(w_grids):
                y1 = min(hi * stride + crop, h_img) - crop
                x1 = min(wi * stride + crop, w_img) - crop
                coords.append((max(y1, 0), max(x1, 0)))
        return coords

    def _zegclip_sliding_device(self, img, mask_shape):
        """Upload once; slice windows, accumulate the canvas, divide by the
        visit count, resize and take the argmax on the device; only the
        label map comes back."""
        crop = self.cfg['crop_size']
        _, h_img, w_img, _ = img.shape
        coords = self._zegclip_coords(h_img, w_img)
        img_dev = torch.from_numpy(np.ascontiguousarray(img[0])).to(
            self.device)
        crops = torch.stack([img_dev[y:y + crop, x:x + crop]
                             for y, x in coords])
        logits = self._forward(crops)
        canvas = torch.zeros((self.nclass, h_img, w_img), device=self.device)
        count = torch.zeros((h_img, w_img), device=self.device)
        for i, (y, x) in enumerate(coords):
            canvas[:, y:y + crop, x:x + crop] += logits[i]
            count[y:y + crop, x:x + crop] += 1
        canvas /= count
        wh = axis_weights(mask_shape[0], h_img, 'bilinear', True, self.device)
        ww = axis_weights(mask_shape[1], w_img, 'bilinear', True, self.device)
        final = torch.matmul(torch.matmul(wh, canvas), ww.t())
        return final.argmax(dim=0)[None].cpu().numpy()

    def sliding_windows(self, h, w):
        """{(crop h, crop w): [(y, x), ...]} of ``sliding_window`` mode, in
        the reference's row-major order."""
        grid = self.cfg['crop_size']
        stride = int(grid * 2 / 3)
        shapes = {}
        for y in range(0, h, stride):
            for x in range(0, w, stride):
                shape = (min(h, y + grid) - y, min(w, x + grid) - x)
                shapes.setdefault(shape, []).append((y, x))
        return shapes

    def _sliding_device(self, img, mask_shape):
        """Upload once; per window shape, run the crops, add their softmax
        probabilities into the canvas, take the argmax on the device."""
        _, h, w, _ = img.shape
        if tuple(mask_shape) != (h, w):
            raise ValueError(f'sliding_window predicts at image size {(h, w)}'
                             f', the label is {tuple(mask_shape)}')
        img_dev = torch.from_numpy(np.ascontiguousarray(img[0])).to(
            self.device)
        canvas = torch.zeros((self.nclass, h, w), device=self.device)
        for (ch, cw), coords in self.sliding_windows(h, w).items():
            crops = torch.stack([img_dev[y:y + ch, x:x + cw]
                                 for y, x in coords])
            probs = torch.softmax(self._forward(crops), dim=1)
            for i, (y, x) in enumerate(coords):
                canvas[:, y:y + ch, x:x + cw] += probs[i]
        return canvas.argmax(dim=0)[None].cpu().numpy()

    def _zegclip_sliding(self, img, mask_shape):
        """Host route: windows at their clipped size, canvas in numpy."""
        crop = self.cfg['crop_size']
        _, h_img, w_img, _ = img.shape
        coords = self._zegclip_coords(h_img, w_img)
        crops = np.concatenate([img[:, y:y + crop, x:x + crop]
                                for y, x in coords])
        logits = self._forward(torch.from_numpy(crops).to(self.device))
        logits = logits.cpu().numpy()
        preds = np.zeros((1, self.nclass, h_img, w_img), np.float32)
        count = np.zeros((1, 1, h_img, w_img), np.float32)
        for i, (y, x) in enumerate(coords):
            preds[0, :, y:y + crop, x:x + crop] += logits[i]
            count[0, :, y:y + crop, x:x + crop] += 1
        preds /= count
        final = _np_resize_bilinear(preds, mask_shape, align_corners=True)
        return final.argmax(axis=1)


def evaluate(evaluator, dataset, mode, cfg):
    """mIoU and per-class IoU over ``dataset`` (``len`` and ``get(i)``
    giving ``{'img': (H, W, 3), 'mask': (H, W)}``), summing the
    intersection/union histograms over images (reference
    supervised.py:135-164)."""
    inter_sum = np.zeros(cfg['nclass'], np.float64)
    union_sum = np.zeros(cfg['nclass'], np.float64)
    for i in range(len(dataset)):
        sample = dataset.get(i)
        mask = sample['mask']
        pred = evaluator.predict(sample['img'][None], mask.shape, mode)
        inter, union, _ = intersection_and_union(pred[0], mask,
                                                 cfg['nclass'])
        inter_sum += inter
        union_sum += union
    return miou_from_histograms(inter_sum, union_sum)
