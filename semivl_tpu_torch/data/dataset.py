"""Semi-supervised dataset (host pipeline).

Equivalent of the reference ``SemiDataset``
(third_party/unimatch/dataset/semi.py:16-110) returning numpy arrays:

- ``train_l``: (img, mask) with the labeled list oversampled to the
  unlabeled epoch length;
- ``train_u``: weak view, two strong views, ignore mask (254-padding ->
  255-ignore conversion) and two CutMix boxes;
- ``val``: (img, mask, id) with the VOC min-512 resize.

Randomness is an explicit per-sample RandomState derived from
(seed, epoch, index) so multi-host sharding stays deterministic. A copy of
``semivl_tpu/data/dataset.py`` (with its own copy of the Pascal,
Cityscapes, COCO and ADE20K split lists under ``assets/splits/``; COCO's
carry only the labeled lists, as JAX's do, so a COCO run names its
``unlabeled_id_path``): the same samples, bit for bit.
"""

import math
import os

import numpy as np
from PIL import Image

from semivl_tpu_torch.data import transforms as T

_ASSET_SPLITS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             'assets', 'splits')


def split_path(dataset, split, kind):
    """Bundled split list path; ``kind`` in {labeled, unlabeled, val}."""
    if kind == 'val':
        return os.path.join(_ASSET_SPLITS, dataset, 'val.txt')
    return os.path.join(_ASSET_SPLITS, dataset, str(split), f'{kind}.txt')


def read_ids(path):
    with open(path) as f:
        return f.read().splitlines()


class SemiDataset:
    def __init__(self, cfg, mode, id_path=None, nsample=None, seed=0):
        self.name = cfg['dataset']
        self.root = os.path.expandvars(os.path.expanduser(cfg['data_root']))
        self.mode = mode
        self.size = cfg['crop_size']
        self.img_scale = cfg.get('img_scale')
        if isinstance(self.img_scale, list):
            self.img_scale = tuple(self.img_scale)
        self.scale_ratio_range = tuple(cfg.get('scale_ratio_range',
                                               (0.5, 2.0)))
        self.reduce_zero_label = cfg.get('reduce_zero_label', False)
        self.labeled_photometric_distortion = cfg.get(
            'labeled_photometric_distortion', False)
        # strong photometric augs on device (ops/augment.py) instead of PIL
        self.strong_aug_on_device = cfg.get('strong_aug_on_device', False)
        # val images as uint8; Evaluator normalises on device
        self.uint8_transport = cfg.get('eval_uint8_transport', True)
        # native (libjpeg/libpng) decode path, PIL fallback
        self.native_decode = cfg.get('native_decode', False)
        if self.native_decode:
            from semivl_tpu_torch.native import native_available
            self.native_decode = native_available()
        self.seed = seed

        if mode in ('train_l', 'train_u'):
            if id_path is None:
                kind = 'labeled' if mode == 'train_l' else 'unlabeled'
                id_path = split_path(self.name, cfg['split'], kind)
            self.ids = read_ids(id_path)
            if mode == 'train_l' and nsample is not None:
                # oversample to the unlabeled epoch length (semi.py:33-35)
                self.ids = (self.ids
                            * math.ceil(nsample / len(self.ids)))[:nsample]
        else:
            if id_path is None:
                id_path = split_path(self.name, None, 'val')
            self.ids = read_ids(id_path)

    def __len__(self):
        return len(self.ids)

    def _load(self, item):
        sample_id = self.ids[item]
        img_rel, mask_rel = sample_id.split(' ')
        if self.native_decode:
            from semivl_tpu_torch.native import decode_image
            with open(os.path.join(self.root, img_rel), 'rb') as f:
                img = Image.fromarray(decode_image(f.read(), channels=3))
            with open(os.path.join(self.root, mask_rel), 'rb') as f:
                mask = decode_image(f.read(), channels=1)
        else:
            img = Image.open(os.path.join(self.root, img_rel)).convert('RGB')
            mask = np.array(Image.open(os.path.join(self.root, mask_rel)))
        if self.reduce_zero_label:  # ADE remap (semi.py:46-51)
            mask = mask.astype(np.int16)
            mask[mask == 0] = 256
            mask = mask - 1
            mask[mask == 254] = 255  # original 255 ignore stays ignore
            mask = mask.astype(np.uint8)
        return sample_id, img, Image.fromarray(mask)

    def get(self, item, epoch=0, variant=0):
        """Fetch one augmented sample as a dict of numpy arrays."""
        sample_id, img, mask = self._load(item)
        return self._augment(sample_id, img, mask, epoch, item, variant)

    def get_pair(self, item, epoch=0):
        """Two independently-augmented views of the same sample.

        The reference zips two iterators of the unlabeled loader
        (semivl.py:203-207), which yields the *same image order* with
        independent augmentation randomness; decoding once and augmenting
        twice halves host decode cost.
        """
        sample_id, img, mask = self._load(item)
        return (self._augment(sample_id, img, mask, epoch, item, 0),
                self._augment(sample_id, img, mask, epoch, item, 1))

    def _augment(self, sample_id, img, mask, epoch, item, variant):
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 7919 + item * 2 + variant)
            % (2**32))

        if self.mode == 'val':
            if self.img_scale is not None:
                img = T.mmseg_resize_val(img, self.img_scale, min_size=512)
            # uint8 transport: 4x less host->device traffic; the Evaluator
            # applies the ImageNet normalisation on device (the train path
            # already ships uint8 + normalises on device)
            if self.uint8_transport:
                return dict(id=sample_id,
                            img=np.asarray(img, np.uint8),
                            mask=np.asarray(mask, np.int32))
            return dict(id=sample_id,
                        img=T.normalize(img),
                        mask=np.asarray(mask, np.int32))

        if self.img_scale is not None:
            img, mask = T.mmseg_resize(img, mask, self.img_scale,
                                       self.scale_ratio_range, rs)
        else:
            img, mask = T.resize_long_side(img, mask, self.scale_ratio_range,
                                           rs)
        ignore_value = 254 if self.mode == 'train_u' else 255
        img, mask = T.pad_and_crop(img, mask, self.size, ignore_value, rs)
        img, mask = T.hflip(img, mask, rs)

        if self.mode == 'train_l':
            if self.strong_aug_on_device:
                # uint8 transport (image AND label — class ids fit a byte);
                # normalisation/int32 cast happen in-graph. Photometric
                # distortion is applied ON DEVICE in this mode
                # (train/step.py) — applying it here too would double the
                # jitter.
                return dict(img_u8=np.asarray(img, np.uint8),
                            mask=np.asarray(mask, np.uint8))
            if self.labeled_photometric_distortion:
                img = T.photometric_distortion(img, rs)
            return dict(img=T.normalize(img), mask=np.asarray(mask, np.int32))

        # train_u: weak + 2 strong views (semi.py:85-107)
        mask_np_early = np.asarray(mask, np.int32)
        if self.strong_aug_on_device:
            # compact transport: one uint8 crop (4x less host->device
            # traffic than fp32), a uint8 ignore map, and CutMix boxes as
            # (y, x, h, w) coords rasterised in-graph; the fused step
            # derives both strong views and all normalisations on device
            # (ops/augment.py, train/step.py)
            return dict(
                img_raw=np.asarray(img, np.uint8),
                ignore_mask=np.where(mask_np_early == 254, 255, 0)
                .astype(np.uint8),
                cutmix_box1=T.obtain_cutmix_box_coords(self.size, rs),
                cutmix_box2=T.obtain_cutmix_box_coords(self.size, rs))

        img_s1, img_s2 = img, img
        if rs.random_sample() < 0.8:
            img_s1 = T.color_jitter(img_s1, rs)
        img_s1 = T.random_grayscale(img_s1, rs)
        img_s1 = T.random_blur(img_s1, rs)
        box1 = T.obtain_cutmix_box(self.size, rs)

        if rs.random_sample() < 0.8:
            img_s2 = T.color_jitter(img_s2, rs)
        img_s2 = T.random_grayscale(img_s2, rs)
        img_s2 = T.random_blur(img_s2, rs)
        box2 = T.obtain_cutmix_box(self.size, rs)

        mask_np = np.asarray(mask, np.int32)
        ignore_mask = np.where(mask_np == 254, 255, 0).astype(np.int32)

        return dict(img_w=T.normalize(img),
                    img_s1=T.normalize(img_s1),
                    img_s2=T.normalize(img_s2),
                    ignore_mask=ignore_mask,
                    cutmix_box1=box1,
                    cutmix_box2=box2)
