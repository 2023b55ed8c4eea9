"""The one generator of the benchmark's traffic: it reads a mix's
parameters (``traffic/<mix>.json``) and makes its inputs from the seed.

Two kinds:

- ``semi_train``: a ring of ``ring`` distinct SemiVL batches of
  ``labeled`` + ``unlabeled`` crops, made on the device. Images are
  uniform uint8 pixels normalised with ImageNet's statistics (the
  loader's output), label maps are random classes on square cells with a
  share of ignored (255) cells, the unlabeled ignore maps mark a padded
  band at the bottom and right as the loader's padding does, and the
  CutMix boxes are drawn as the reference loader draws them.
- ``eval_images``: ``distinct`` uint8 images with label maps, kept in host
  memory. Their sizes are the same multiset for every seed (after the
  keep-ratio resize: ``short_side`` by ``long_side``, ``portrait_share``
  of them upright); the seed draws the pixels, the labels and the order.
"""

import numpy as np
import torch

from portbench.harness.weights import sub_seed

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

IMAGE_KEYS = ('img_x', 'img_w', 'img_s1', 'img_s2', 'img_w_other',
              'img_s1_other', 'img_s2_other')


def cutmix_box_coords(size, rs, p=0.5, size_min=0.02, size_max=0.4,
                      ratio_1=0.3, ratio_2=1 / 0.3):
    """(y, x, h, w) of a CutMix box, (0, 0, 0, 0) for none: the reference
    loader's draws in its order (UniMatch ``transform.py:66-84``)."""
    if rs.random_sample() > p:
        return [0, 0, 0, 0]
    area = rs.uniform(size_min, size_max) * size * size
    while True:
        ratio = rs.uniform(ratio_1, ratio_2)
        w = int(np.sqrt(area / ratio))
        h = int(np.sqrt(area * ratio))
        x = rs.randint(0, size)
        y = rs.randint(0, size)
        if x + w <= size and y + h <= size:
            return [y, x, h, w]


def _labels(gen, b, size, cell, nclass, ignore_share, device):
    """Random classes on ``cell``-pixel squares, a share of them ignored."""
    n = -(-size // cell)
    lab = torch.randint(0, nclass, (b, n, n), generator=gen, device=device)
    ign = torch.rand((b, n, n), generator=gen, device=device) < ignore_share
    lab = torch.where(ign, torch.full_like(lab, 255), lab)
    lab = lab.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    return lab[:, :size, :size].contiguous()


def _image(gen, b, size, device):
    u8 = torch.randint(0, 256, (b, size, size, 3), generator=gen,
                       device=device, dtype=torch.uint8)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return (u8.float() / 255.0 - mean) / std


def _pad_band(gen, b, size, band_max, device):
    out = torch.zeros((b, size, size), dtype=torch.long, device=device)
    bands = torch.randint(0, band_max + 1, (b, 2), generator=gen,
                          device=device).tolist()
    for i, (bh, bw) in enumerate(bands):
        if bh:
            out[i, size - bh:] = 255
        if bw:
            out[i, :, size - bw:] = 255
    return out


def train_batches(mix, nclass, seed, device):
    """The mix's ring of batches: a list of dicts of tensors on
    ``device`` as ``make_semivl_train_step`` takes them."""
    b, size = mix['labeled'], mix['crop']
    if mix['unlabeled'] != b:
        raise ValueError('the SemiVL step takes as many unlabeled crops as '
                         'labeled ones')
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 'inputs'))
    rs = np.random.RandomState(sub_seed(seed, 'cutmix') % 2 ** 32)
    ring = []
    for _ in range(mix['ring']):
        batch = {k: _image(gen, b, size, device) for k in IMAGE_KEYS}
        batch['mask_x'] = _labels(gen, b, size, mix['label_cell'], nclass,
                                  mix['label_ignore_share'], device)
        batch['ignore_mask'] = _pad_band(gen, b, size, mix['pad_band_max'],
                                         device)
        batch['ignore_mask_other'] = _pad_band(gen, b, size,
                                               mix['pad_band_max'], device)
        for k in ('cutmix_box1', 'cutmix_box2'):
            batch[k] = torch.tensor(
                [cutmix_box_coords(size, rs, **mix['cutmix'])
                 for _ in range(b)], dtype=torch.int32, device=device)
        ring.append(batch)
    return ring


def eval_sizes(mix):
    """The (h, w) of the mix's distinct images, the same for every seed:
    ``short_side`` by ``long_side``, ``portrait_share`` of them upright."""
    n, short, long = mix['distinct'], mix['short_side'], mix['long_side']
    upright = int(round(mix['portrait_share'] * n))
    return [(long, short)] * upright + [(short, long)] * (n - upright)


def eval_images(mix, nclass, seed):
    """The mix's distinct images in this seed's order: a list of
    ``{'img': (h, w, 3) uint8, 'mask': (h, w) uint8}``."""
    rng = np.random.default_rng(sub_seed(seed, 'images'))
    sizes = eval_sizes(mix)
    order = rng.permutation(len(sizes))
    cell = mix['label_cell']
    items = []
    for i in order:
        h, w = sizes[i]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cells = rng.integers(0, nclass, (-(-h // cell), -(-w // cell)))
        cells[rng.random(cells.shape) < mix['label_ignore_share']] = 255
        mask = np.repeat(np.repeat(cells, cell, 0), cell, 1)[:h, :w]
        items.append({'img': img, 'mask': mask.astype(np.uint8)})
    return items


class CycledImages:
    """The dataset the evaluator reads: ``get(i)`` is image ``i`` modulo
    the distinct ones; ``asked[i]`` the host clock when it was asked for."""

    def __init__(self, items, length, clock):
        self.items, self.length, self.clock = items, length, clock
        self.asked = {}

    def __len__(self):
        return self.length

    def get(self, i):
        self.asked[i] = self.clock()
        return self.items[i % len(self.items)]
