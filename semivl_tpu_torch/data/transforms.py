"""Host-side image augmentations (numpy/PIL).

Re-implements the reference's data augs with matching distributions:

- weak: scale-jittered resize (mmseg ``Resize`` semantics or plain long-side
  resize), pad-to-crop with ignore fill, random crop, hflip
  (reference third_party/unimatch/dataset/{semi.py:62-76, transform.py:9-56});
- strong (unlabeled only): ColorJitter(0.5,0.5,0.5,0.25) p=0.8, grayscale
  p=0.2, Gaussian blur sigma in [0.1,2] p=0.5, CutMix box p=0.5
  (semi.py:85-97, transform.py:59-84);
- ImageNet normalisation (transform.py:32-40).

All randomness flows through an explicit ``np.random.RandomState``. A copy
of ``semivl_tpu/data/transforms.py``: the same draws in the same order.
"""

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img):
    """PIL/uint8 HWC -> float32 HWC, ImageNet-normalised."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def _rescale_size(w, h, scale):
    """mmcv.imrescale keep-ratio sizing: returns (new_w, new_h)."""
    factor = min(max(scale) / max(h, w), min(scale) / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


def mmseg_resize(img, mask, img_scale, ratio_range, rs):
    """mmseg ``Resize(img_scale, ratio_range)`` keep-ratio resize
    (reference semi.py:62-69; mmseg random_sample_ratio + imrescale)."""
    lo, hi = ratio_range
    ratio = rs.random_sample() * (hi - lo) + lo
    scale = (int(img_scale[0] * ratio), int(img_scale[1] * ratio))
    nw, nh = _rescale_size(img.size[0], img.size[1], scale)
    img = img.resize((nw, nh), Image.BILINEAR)
    if mask is not None:
        mask = mask.resize((nw, nh), Image.NEAREST)
    return img, mask


def mmseg_resize_val(img, img_scale, min_size):
    """mmseg ``Resize(img_scale, min_size)`` val resize (semi.py:53-58):
    shorter side becomes max(min(img_scale), min_size), keep ratio."""
    new_short = max(min(img_scale), min_size)
    w, h = img.size
    # mmseg keeps the derived long-edge target as a FLOAT (Resize._resize_img
    # computes new_short * h / w without rounding) and only rounds once, in
    # mmcv's _scale_size (int(x * factor + 0.5)). Truncating the long edge
    # to int here made it the binding constraint and yielded a 511-px short
    # side for e.g. 333x500 inputs (mmseg: 512x769) — one pixel off parity,
    # and below crop_size, which silently rerouted those val images to the
    # slow host predict path.
    if h > w:
        scale = (new_short * h / w, new_short)
    else:
        scale = (new_short, new_short * w / h)
    nw, nh = _rescale_size(w, h, scale)
    return img.resize((nw, nh), Image.BILINEAR)


def resize_long_side(img, mask, ratio_range, rs):
    """Plain long-side resize (reference transform.py:43-56)."""
    w, h = img.size
    long_side = rs.randint(int(max(h, w) * ratio_range[0]),
                           int(max(h, w) * ratio_range[1]) + 1)
    if h > w:
        oh, ow = long_side, int(1.0 * w * long_side / h + 0.5)
    else:
        ow, oh = long_side, int(1.0 * h * long_side / w + 0.5)
    img = img.resize((ow, oh), Image.BILINEAR)
    mask = mask.resize((ow, oh), Image.NEAREST)
    return img, mask


def pad_and_crop(img, mask, size, ignore_value, rs):
    """Pad right/bottom to crop size then random crop
    (reference transform.py:9-22)."""
    w, h = img.size
    padw = size - w if w < size else 0
    padh = size - h if h < size else 0
    if padw or padh:
        img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
        mask = ImageOps.expand(mask, border=(0, 0, padw, padh),
                               fill=ignore_value)
    w, h = img.size
    x = rs.randint(0, w - size + 1)
    y = rs.randint(0, h - size + 1)
    return (img.crop((x, y, x + size, y + size)),
            mask.crop((x, y, x + size, y + size)))


def hflip(img, mask, rs, p=0.5):
    if rs.random_sample() < p:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    return img, mask


def _adjust_hue(img, factor):
    """torchvision F.adjust_hue parity: shift H channel of HSV by factor."""
    if factor == 0:
        return img
    h, s, v = img.convert('HSV').split()
    h_arr = np.asarray(h, np.uint8)
    h_arr = (h_arr.astype(np.int16) + int(factor * 255)) % 256
    h = Image.fromarray(h_arr.astype(np.uint8), 'L')
    return Image.merge('HSV', (h, s, v)).convert('RGB')


def color_jitter(img, rs, brightness=0.5, contrast=0.5, saturation=0.5,
                 hue=0.25):
    """torchvision ColorJitter parity: 4 ops in random order, uniform factors
    (reference semi.py:88,94)."""
    ops = []
    b = rs.uniform(max(0, 1 - brightness), 1 + brightness)
    ops.append(lambda im: ImageEnhance.Brightness(im).enhance(b))
    c = rs.uniform(max(0, 1 - contrast), 1 + contrast)
    ops.append(lambda im: ImageEnhance.Contrast(im).enhance(c))
    s = rs.uniform(max(0, 1 - saturation), 1 + saturation)
    ops.append(lambda im: ImageEnhance.Color(im).enhance(s))
    hf = rs.uniform(-hue, hue)
    ops.append(lambda im: _adjust_hue(im, hf))
    for i in rs.permutation(4):
        img = ops[i](img)
    return img


def random_grayscale(img, rs, p=0.2):
    if rs.random_sample() < p:
        g = img.convert('L')
        img = Image.merge('RGB', (g, g, g))
    return img


def random_blur(img, rs, p=0.5):
    if rs.random_sample() < p:
        sigma = rs.uniform(0.1, 2.0)
        img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
    return img


def obtain_cutmix_box_coords(img_size, rs, p=0.5, size_min=0.02,
                             size_max=0.4, ratio_1=0.3, ratio_2=1 / 0.3):
    """Sample CutMix box coords (y, x, h, w) — same draws in the same order
    as the reference mask sampler (transform.py:66-84), so the distribution
    (and the per-sample RNG stream) is identical. (0, 0, 0, 0) = no box."""
    if rs.random_sample() > p:
        return np.zeros(4, np.int32)
    size = rs.uniform(size_min, size_max) * img_size * img_size
    while True:
        ratio = rs.uniform(ratio_1, ratio_2)
        cutmix_w = int(np.sqrt(size / ratio))
        cutmix_h = int(np.sqrt(size * ratio))
        x = rs.randint(0, img_size)
        y = rs.randint(0, img_size)
        if x + cutmix_w <= img_size and y + cutmix_h <= img_size:
            break
    return np.asarray([y, x, cutmix_h, cutmix_w], np.int32)


def obtain_cutmix_box(img_size, rs, p=0.5, size_min=0.02, size_max=0.4,
                      ratio_1=0.3, ratio_2=1 / 0.3):
    """Sample a CutMix box mask (reference transform.py:66-84)."""
    y, x, h, w = obtain_cutmix_box_coords(img_size, rs, p, size_min,
                                          size_max, ratio_1, ratio_2)
    mask = np.zeros((img_size, img_size), dtype=np.float32)
    mask[y:y + h, x:x + w] = 1
    return mask


def photometric_distortion(img, rs):
    """mmseg PhotoMetricDistortion parity (applied BGR-flipped in the
    reference, semi.py:79-82): brightness delta 32, contrast [0.5,1.5],
    saturation [0.5,1.5], hue delta 18 (out of 360/2 HSV scale).
    Channel order is irrelevant for these ops except hue direction, which is
    symmetric in distribution."""
    arr = np.asarray(img, np.float32)
    if rs.randint(0, 2):
        arr = np.clip(arr + rs.uniform(-32, 32), 0, 255)
    contrast_last = rs.randint(0, 2)
    if not contrast_last and rs.randint(0, 2):
        arr = np.clip(arr * rs.uniform(0.5, 1.5), 0, 255)
    im = Image.fromarray(arr.astype(np.uint8))
    if rs.randint(0, 2):  # saturation
        im = ImageEnhance.Color(im).enhance(rs.uniform(0.5, 1.5))
    if rs.randint(0, 2):  # hue
        im = _adjust_hue(im, rs.uniform(-18, 18) / 360.0)
    arr = np.asarray(im, np.float32)
    if contrast_last and rs.randint(0, 2):
        arr = np.clip(arr * rs.uniform(0.5, 1.5), 0, 255)
    return Image.fromarray(arr.astype(np.uint8))
