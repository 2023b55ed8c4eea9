"""On-device photometric augmentation (counterpart of
``semivl_tpu/ops/augment.py``), plain tensor arithmetic, no kernel: the
JAX package computes it in plain ``jnp`` too.

The strong views of the unlabeled crops (reference semi.py:85-97) and the
labeled crops' photometric distortion (semi.py:79-82) are computed on the
card from one uint8 crop each (``strong_aug_on_device``):

- ``strong_augment``: ColorJitter(0.5, 0.5, 0.5, 0.25) in one of the 24
  op orders (``PERMS``, ``itertools.permutations(range(4))`` in its order)
  with p = 0.8, grayscale (ITU-R 601 luma) with p = 0.2, a 13-tap
  separable Gaussian blur (sigma in [0.1, 2], edge padding) with p = 0.5,
  then the ImageNet normalisation;
- ``photometric_distortion``: mmseg's PhotoMetricDistortion in [0, 1]
  scale (brightness delta 32/255, contrast [0.5, 1.5] before or after the
  saturation and hue pair, saturation [0.5, 1.5], hue 18/360), each op
  with p = 0.5;
- ``normalize_imagenet``.

Each is split into *draws*, the random factors, gates, permutation index
and sigma of every image as tensors drawn from a ``torch.Generator`` on
the images' device (``strong_draws``, ``photometric_draws``), and *apply*,
a pure function of the images (B, H, W, 3) in [0, 1] and the draws
(``apply_strong``, ``apply_photometric``), whose arithmetic is JAX's op for
op. Given JAX's draws, the apply functions give JAX's views.
"""

import itertools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PERMS = list(itertools.permutations(range(4)))   # 24 op orders
BLUR_TAPS = 13


def _luma(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]


def _per_image(v):
    """(B,) -> (B, 1, 1, 1), to broadcast over (B, H, W, 3)."""
    return v[:, None, None, None]


def _adjust_contrast(x, f):
    mean = torch.mean(_luma(x), dim=(-3, -2, -1), keepdim=True)
    return (x - mean) * f + mean


def _adjust_saturation(x, f):
    g = _luma(x)
    return (x - g) * f + g


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.amax(x, dim=-1)
    minc = torch.amin(x, dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    def chan(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


def _adjust_hue(x, f):
    h, s, v = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + f[..., 0], 1.0), s, v)


def _uniform(n, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def strong_draws(n, generator, device):
    """The random choices of ``strong_augment`` for ``n`` images: the
    jitter factors (brightness, contrast, saturation in [0.5, 1.5], hue in
    [-0.25, 0.25]), the op order's index into ``PERMS``, the jitter,
    grayscale and blur gates and the blur's sigma."""
    def u(lo, hi):
        return _uniform(n, lo, hi, generator, device)

    return dict(
        factors=torch.stack([u(0.5, 1.5), u(0.5, 1.5), u(0.5, 1.5),
                             u(-0.25, 0.25)], dim=1),
        perm=torch.randint(0, len(PERMS), (n,), generator=generator,
                           device=device),
        jitter=u(0.0, 1.0) < 0.8, gray=u(0.0, 1.0) < 0.2,
        sigma=u(0.1, 2.0), blur=u(0.0, 1.0) < 0.5)


def _color_jitter(x, factors, perm):
    """Four stages, each taking per image the output of the op its order
    names at that stage (JAX ``_color_jitter_one``)."""
    fb, fc, fs, fh = (_per_image(factors[:, i]) for i in range(4))
    order = torch.as_tensor(np.asarray(PERMS, np.int64),
                            device=x.device)[perm]
    for stage in range(4):
        outs = torch.stack([
            torch.clamp(x * fb, 0.0, 1.0),
            torch.clamp(_adjust_contrast(x, fc), 0.0, 1.0),
            torch.clamp(_adjust_saturation(x, fs), 0.0, 1.0),
            _adjust_hue(x, fh)])
        pick = order[:, stage]
        x = outs[pick, torch.arange(x.shape[0], device=x.device)]
    return x


def _gaussian_blur(x, sigma, taps=BLUR_TAPS):
    """Separable Gaussian blur of each image (B, H, W, 3) at its sigma,
    edge padding, rows then columns (JAX ``_gaussian_blur_one``)."""
    half = taps // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=x.device)
    w = torch.exp(-0.5 * (offs[None] / sigma[:, None]) ** 2)
    w = w / torch.sum(w, dim=1, keepdim=True)

    def blur_axis(y, axis):
        n = y.shape[axis]
        idx = torch.clamp(torch.arange(-half, n + half, device=y.device),
                          0, n - 1)
        yp = torch.index_select(y, axis, idx)
        out = torch.zeros_like(y)
        for k in range(taps):
            out = out + _per_image(w[:, k]) * yp.narrow(axis, k, n)
        return out

    return blur_axis(blur_axis(x, 1), 2)


def apply_strong(imgs, draws):
    """(B, H, W, 3) [0, 1] images and ``strong_draws`` -> the
    ImageNet-normalised strong views (JAX ``strong_augment``)."""
    x = imgs
    jittered = _color_jitter(x, draws['factors'], draws['perm'])
    x = torch.where(_per_image(draws['jitter']), jittered, x)
    gray = torch.broadcast_to(_luma(x), x.shape)
    x = torch.where(_per_image(draws['gray']), gray, x)
    blurred = _gaussian_blur(x, draws['sigma'])
    x = torch.where(_per_image(draws['blur']), blurred, x)
    return normalize_imagenet(x)


def strong_augment(imgs, generator):
    """Strong views of (B, H, W, 3) [0, 1] images, the draws from
    ``generator`` (on the images' device)."""
    return apply_strong(imgs, strong_draws(imgs.shape[0], generator,
                                           imgs.device))


def photometric_draws(n, generator, device):
    """The random choices of ``photometric_distortion`` for ``n`` images:
    the brightness delta and gate, contrast first or last, its factor and
    gate, the saturation factor and gate, the hue shift and gate."""
    def u(lo, hi):
        return _uniform(n, lo, hi, generator, device)

    def coin():
        return u(0.0, 1.0) < 0.5

    return dict(delta=u(-32 / 255, 32 / 255), bright=coin(),
                contrast_last=coin(), alpha=u(0.5, 1.5), contrast=coin(),
                sat_factor=u(0.5, 1.5), sat=coin(),
                hue_shift=u(-18 / 360, 18 / 360), hue=coin())


def apply_photometric(imgs, d):
    """(B, H, W, 3) [0, 1] images and ``photometric_draws`` -> the
    distorted images in [0, 1] (JAX ``photometric_distortion``)."""
    x = imgs
    x = torch.where(_per_image(d['bright']),
                    torch.clamp(x + _per_image(d['delta']), 0.0, 1.0), x)
    alpha = _per_image(d['alpha'])
    first = _per_image(d['contrast'] & ~d['contrast_last'])
    x = torch.where(first, torch.clamp(x * alpha, 0.0, 1.0), x)
    x = torch.where(_per_image(d['sat']), torch.clamp(
        _adjust_saturation(x, _per_image(d['sat_factor'])), 0.0, 1.0), x)
    x = torch.where(_per_image(d['hue']),
                    _adjust_hue(x, _per_image(d['hue_shift'])), x)
    last = _per_image(d['contrast'] & d['contrast_last'])
    return torch.where(last, torch.clamp(x * alpha, 0.0, 1.0), x)


def photometric_distortion(imgs, generator):
    """Distorted (B, H, W, 3) [0, 1] images, the draws from ``generator``."""
    return apply_photometric(imgs, photometric_draws(imgs.shape[0],
                                                     generator, imgs.device))


def normalize_imagenet(imgs):
    mean = torch.tensor(IMAGENET_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, dtype=imgs.dtype, device=imgs.device)
    return (imgs - mean) / std


def to_unit(x):
    """uint8 transport -> float32 [0, 1]; float passes through."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x
