"""The port's host data pipeline against the JAX package's on the CPU: the
transforms case by case, ``SemiDataset`` in its three modes and
``ShardedLoader`` (with ``start_step``) over whole epochs of the on-disk
fixture of ``tests/synth_data.py``, the native decode, and the bundled
split lists. Every comparison is exact (``np.array_equal``): the port's
modules are copies that draw the same numbers in the same order."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from semivl_tpu.data import transforms as JT
from semivl_tpu.data.dataset import SemiDataset as JaxSemiDataset
from semivl_tpu.data.dataset import split_path as jax_split_path
from semivl_tpu.data.loader import ShardedLoader as JaxShardedLoader
from semivl_tpu.data.loader import epoch_permutation as jax_permutation
from semivl_tpu_torch.data import transforms as T
from semivl_tpu_torch.data.dataset import SemiDataset, read_ids, split_path
from semivl_tpu_torch.data.loader import ShardedLoader, epoch_permutation

from synth_data import make_synth_dataset, synth_cfg


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torchsynth'))
    return root, make_synth_dataset(root, n_labeled=3, n_unlabeled=6,
                                    n_val=3)


def _equal(a, b):
    """Two samples (dicts of arrays and strings) hold equal values."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _image(rs, w=37, h=29):
    return Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8))


def _mask(rs, w=37, h=29):
    return Image.fromarray(rs.randint(0, 21, (h, w)).astype(np.uint8))


# (name, call on a module and a RandomState) -> its result as arrays
TRANSFORMS = {
    'normalize': lambda m, rs: m.normalize(_image(rs)),
    'mmseg_resize': lambda m, rs: m.mmseg_resize(
        _image(rs), _mask(rs), (2048, 512), (0.5, 2.0), rs),
    'mmseg_resize_val 333x500': lambda m, rs: m.mmseg_resize_val(
        _image(rs, 500, 333), (2048, 512), 512),
    'mmseg_resize_val 500x333': lambda m, rs: m.mmseg_resize_val(
        _image(rs, 333, 500), (2048, 512), 512),
    'resize_long_side': lambda m, rs: m.resize_long_side(
        _image(rs), _mask(rs), (0.5, 2.0), rs),
    'pad_and_crop': lambda m, rs: m.pad_and_crop(
        _image(rs), _mask(rs), 48, 254, rs),
    'hflip': lambda m, rs: m.hflip(_image(rs), _mask(rs), rs, p=0.7),
    'color_jitter': lambda m, rs: m.color_jitter(_image(rs), rs),
    'random_grayscale': lambda m, rs: m.random_grayscale(_image(rs), rs,
                                                         p=0.6),
    'random_blur': lambda m, rs: m.random_blur(_image(rs), rs, p=0.9),
    'cutmix_box_coords': lambda m, rs: m.obtain_cutmix_box_coords(64, rs),
    'cutmix_box': lambda m, rs: m.obtain_cutmix_box(64, rs),
    'photometric_distortion': lambda m, rs: m.photometric_distortion(
        _image(rs), rs),
}


def _arrays(out):
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize('name', list(TRANSFORMS))
def test_transforms_match_jax(name):
    """Each transform, over 8 seeds, gives arrays equal to JAX's and
    leaves the RandomState at the same point."""
    for seed in range(8):
        rs, jrs = np.random.RandomState(seed), np.random.RandomState(seed)
        got, want = TRANSFORMS[name](T, rs), TRANSFORMS[name](JT, jrs)
        for a, b in zip(_arrays(got), _arrays(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, seed)
        assert rs.randint(1 << 30) == jrs.randint(1 << 30), (name, seed)
    assert np.array_equal(T.IMAGENET_MEAN, JT.IMAGENET_MEAN)
    assert np.array_equal(T.IMAGENET_STD, JT.IMAGENET_STD)


def _datasets(root, paths, mode, img_scale=None, **extra):
    cfg = dict(synth_cfg(root, img_scale=img_scale), **extra)
    kind = {'train_l': 'labeled', 'train_u': 'unlabeled', 'val': 'val'}[mode]
    kw = dict(id_path=paths[kind], seed=3)
    if mode == 'train_l':
        kw['nsample'] = 7
    return SemiDataset(cfg, mode, **kw), JaxSemiDataset(cfg, mode, **kw)


@pytest.mark.parametrize('mode,img_scale', [
    ('train_l', None), ('train_l', (128, 96)), ('train_u', None),
    ('val', None), ('val', (128, 96))])
def test_dataset_matches_jax(synth_root, mode, img_scale):
    """``SemiDataset`` in each mode (the labeled list oversampled to 7, the
    unlabeled pair of views, val as uint8 and as normalised float), every
    sample of two epochs, equal to JAX's."""
    root, paths = synth_root
    transports = (True, False) if mode == 'val' else (True,)
    for uint8 in transports:
        ds, jds = _datasets(root, paths, mode, img_scale,
                            eval_uint8_transport=uint8)
        assert ds.ids == jds.ids and len(ds) == len(jds)
        for epoch in (0, 1):
            for i in range(len(ds)):
                if mode == 'train_u':
                    for a, b in zip(ds.get_pair(i, epoch),
                                    jds.get_pair(i, epoch)):
                        _equal(a, b)
                else:
                    _equal(ds.get(i, epoch), jds.get(i, epoch))


def test_reduce_zero_label_matches_jax(synth_root):
    """ADE's label remap (0 -> ignore, the rest down by one)."""
    root, paths = synth_root
    for mode in ('val', 'train_l'):
        ds, jds = _datasets(root, paths, mode, reduce_zero_label=True)
        for i in range(len(ds)):
            _equal(ds.get(i), jds.get(i))


@pytest.mark.parametrize('pair,start_step', [(False, 0), (True, 0),
                                             (True, 1), (False, 2)])
def test_sharded_loader_matches_jax(synth_root, pair, start_step):
    """``ShardedLoader`` over two epochs (one process, world 1 and 2,
    batch 2): the same permutation, the same batches from ``start_step``
    on, the paired loader's ``_other`` views included."""
    root, paths = synth_root
    mode = 'train_u' if pair else 'train_l'
    ds, jds = _datasets(root, paths, mode)
    for world in (1, 2):
        got = ShardedLoader(ds, 1 if world == 2 else 2, world, seed=5,
                            pair=pair, num_threads=2)
        want = JaxShardedLoader(jds, 1 if world == 2 else 2, world, seed=5,
                                pair=pair, num_threads=2)
        assert len(got) == len(want)
        for epoch in (0, 1):
            a = list(got.epoch(epoch, start_step=start_step))
            b = list(want.epoch(epoch, start_step=start_step))
            assert len(a) == len(b) == max(len(want) - start_step, 0)
            for x, y in zip(a, b):
                _equal(x, y)
    for n, epoch, world in ((7, 0, 1), (7, 3, 2), (10, 1, 4)):
        assert np.array_equal(epoch_permutation(n, epoch, world, 5),
                              jax_permutation(n, epoch, world, 5))


def test_bundled_splits_match_jax():
    """The port's copies of the Pascal and Cityscapes split lists equal
    the JAX package's, file for file."""
    from semivl_tpu_torch.data import dataset
    for name in ('pascal', 'cityscapes'):
        root = os.path.join(dataset._ASSET_SPLITS, name)
        splits = sorted(d for d in os.listdir(root)
                        if os.path.isdir(os.path.join(root, d)))
        assert splits
        for split in splits:
            for kind in ('labeled', 'unlabeled'):
                assert read_ids(split_path(name, split, kind)) == read_ids(
                    jax_split_path(name, split, kind))
        for f in os.listdir(root):   # val.txt and any other list
            if f.endswith('.txt'):
                jax_root = os.path.dirname(jax_split_path(name, None, 'val'))
                assert read_ids(os.path.join(root, f)) == read_ids(
                    os.path.join(jax_root, f))


def test_native_decode_matches_jax():
    """The native decode (``native/image_core.cpp`` built into ``_build/``)
    equals JAX's on a JPEG, an RGB PNG and an index PNG, and the dataset's
    native mode gives the samples of its PIL mode. Skipped by name where
    the library does not build (no g++, libjpeg or libpng)."""
    from semivl_tpu import native as jn
    from semivl_tpu_torch import native
    if not (native.native_available() and jn.native_available()):
        pytest.skip('the native image core does not build on this host')
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (33, 45, 3), np.uint8)
    mask = rs.randint(0, 21, (33, 45)).astype(np.uint8)
    for arr, fmt, ch in ((img, 'JPEG', 3), (img, 'PNG', 3),
                         (mask, 'PNG', 1)):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        data = buf.getvalue()
        got = native.decode_image(data, channels=ch)
        assert np.array_equal(got, jn.decode_image(data, channels=ch))
    for oh, ow in ((17, 60), (66, 90)):
        assert np.array_equal(native.resize_bilinear(img, oh, ow),
                              jn.resize_bilinear(img, oh, ow))
        assert np.array_equal(native.resize_nearest(mask, oh, ow),
                              jn.resize_nearest(mask, oh, ow))
    assert np.array_equal(native.normalize_imagenet(img),
                          jn.normalize_imagenet(img))
