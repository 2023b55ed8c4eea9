"""Color palettes for prediction visualisation / PNG export.

Parity: reference datasets/palettes.py. The VOC palette is generated by the
standard Pascal VOC bit-interleaving algorithm; Cityscapes uses the official
cityscapesScripts colors; COCO/ADE tables are loaded from a bundled data
asset (they are fixed dataset constants). A copy of
``semivl_tpu/datasets/palettes.py`` with its own copy of the asset.
"""

import functools
import os

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'assets')


def _voc_colormap(n=256):
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _voc_palette():
    # 21 class colors, white for unused ids, and the VOC "void" color at 255.
    cmap = _voc_colormap()
    pal = np.full((256, 3), 255, dtype=np.uint8)
    pal[:21] = cmap[:21]
    pal[255] = (224, 224, 192)
    return pal


CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
    [0, 80, 100], [0, 0, 230], [119, 11, 32]], dtype=np.uint8)

VOC_PALETTE = _voc_palette()


@functools.lru_cache(maxsize=None)
def _load_palette_asset(name):
    with np.load(os.path.join(_ASSET_DIR, 'palettes.npz')) as f:
        return f[name]


def get_palette(dataset):
    if dataset == 'pascal':
        return VOC_PALETTE
    if dataset == 'cityscapes':
        return CITYSCAPES_PALETTE
    if dataset == 'coco':
        return _load_palette_asset('coco')
    if dataset == 'ade':
        return _load_palette_asset('ade')
    raise ValueError(dataset)
