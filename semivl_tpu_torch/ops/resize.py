"""Separable image resizing with ``F.interpolate`` semantics, as products.

Counterpart of ``semivl_tpu/ops/resize.py``: per-axis interpolation
matrices are computed on the host with numpy (bilinear with and without
``align_corners``, bicubic with A=-0.75, legacy nearest) and applied as two
float32 matrix products. The products are plain ``torch`` matrix products.
"""

import functools

import numpy as np
import torch


def _source_coords(out_size, in_size, align_corners):
    """Source coordinate for each output index (PyTorch convention)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1, dtype=np.float64)
        return i * (in_size - 1) / (out_size - 1)
    scale = in_size / out_size
    return i * scale + 0.5 * scale - 0.5


def _linear_weights(out_size, in_size, align_corners):
    src = _source_coords(out_size, in_size, align_corners)
    if not align_corners:
        # PyTorch clamps negative source coords to 0 for linear interpolation.
        src = np.clip(src, 0.0, None)
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, np.clip(x0, 0, in_size - 1)), 1.0 - frac)
    np.add.at(w, (rows, np.clip(x0 + 1, 0, in_size - 1)), frac)
    return w


def _cubic_kernel(x, a=-0.75):
    """Cubic convolution kernel with PyTorch's A=-0.75."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1
    m2 = (x > 1) & (x < 2)
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


def _cubic_weights(out_size, in_size, align_corners):
    src = _source_coords(out_size, in_size, align_corners)
    x0 = np.floor(src).astype(np.int64)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for t in (-1, 0, 1, 2):
        idx = x0 + t
        # border: PyTorch clamps the access index (replicate padding)
        np.add.at(w, (rows, np.clip(idx, 0, in_size - 1)),
                  _cubic_kernel(src - idx))
    return w


@functools.lru_cache(maxsize=256)
def _axis_weights(out_size, in_size, mode, align_corners, dtype_name):
    """Numpy (out, in) interpolation weights (cached)."""
    if out_size == in_size:
        w = np.eye(out_size)
    elif mode == 'bilinear':
        w = _linear_weights(out_size, in_size, align_corners)
    elif mode == 'bicubic':
        w = _cubic_weights(out_size, in_size, align_corners)
    elif mode == 'nearest':
        # PyTorch 'nearest' (legacy): floor(i * in/out).
        idx = np.minimum(
            (np.arange(out_size) * (in_size / out_size)).astype(np.int64),
            in_size - 1)
        w = np.zeros((out_size, in_size))
        w[np.arange(out_size), idx] = 1.0
    else:
        raise ValueError(mode)
    return w.astype(np.dtype(dtype_name))


def axis_weights(out_size, in_size, mode, align_corners, device):
    """float32 (out, in) weight matrix as a tensor on ``device``."""
    return torch.from_numpy(_axis_weights(
        int(out_size), int(in_size), mode, bool(align_corners),
        'float32')).to(device)


def resize_hw(x, out_hw, mode='bilinear', align_corners=False):
    """Resize the last two dims of ``x`` (e.g. NCHW) to ``out_hw``.

    Computed in float32 whatever the input type, cast back at the end."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = axis_weights(out_h, in_h, mode, align_corners, x.device)
    ww = axis_weights(out_w, in_w, mode, align_corners, x.device)
    y = torch.matmul(torch.matmul(wh, x.float()), ww.t())
    return y.to(x.dtype)


def resize(x, out_hw, mode='bilinear', align_corners=False):
    """Resize NHWC (or NHW) ``x`` to ``out_hw``, as the JAX ``resize``."""
    if x.ndim == 3:
        return resize_hw(x, out_hw, mode, align_corners)
    y = resize_hw(x.permute(0, 3, 1, 2), out_hw, mode, align_corners)
    return y.permute(0, 2, 3, 1)


def resize_longer_matrix(pos_embed, new_hw, old_hw, mode='bicubic'):
    """Resize a flattened (1, 1+H*W, C) positional embedding grid, keeping
    the cls token (reference maskclip_vit.py:462-490)."""
    cls_tok = pos_embed[:, :1]
    c = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, old_hw[0], old_hw[1], c)
    grid = resize(grid, new_hw, mode=mode, align_corners=False)
    grid = grid.reshape(1, new_hw[0] * new_hw[1], c)
    return torch.cat([cls_tok, grid], dim=1)
