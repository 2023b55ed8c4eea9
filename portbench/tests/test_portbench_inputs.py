"""The traffic generator and the seeded weights repeat exactly for a seed
and differ across seeds; the evaluation mix keeps one multiset of sizes
for every seed."""

import numpy as np
import pytest
import torch

from portbench.harness import spec, traffic, weights
from portbench.tests import tiny

SEEDS = (1, 2 ** 31 + 11)


def _train(seed):
    return traffic.train_batches(tiny.load('tiny-train'), 21, seed, 'cpu')


def test_train_batches_repeat_for_a_seed():
    for a, b in zip(_train(SEEDS[1]), _train(SEEDS[1])):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_batches_differ_across_seeds_and_rows():
    a, b = _train(SEEDS[0]), _train(SEEDS[1])
    assert not torch.equal(a[0]['img_x'], b[0]['img_x'])
    rows = torch.cat([r['img_x'] for r in a]).flatten(1)
    assert len({tuple(r[:16].tolist()) for r in rows}) == rows.shape[0]


def test_train_batch_contents():
    mix = tiny.load('tiny-train')
    for batch in _train(SEEDS[0]):
        assert batch['img_x'].shape == (mix['labeled'], mix['crop'],
                                        mix['crop'], 3)
        labels = batch['mask_x'].unique().tolist()
        assert 255 in labels and max(x for x in labels if x != 255) < 21
        assert set(batch['ignore_mask'].unique().tolist()) <= {0, 255}
        y, x, h, w = batch['cutmix_box1'].T
        assert bool(((y + h <= mix['crop']) & (x + w <= mix['crop'])).all())


def test_cutmix_draws_are_the_reference_loaders():
    """The loader's draws in its order: the port's copy gives the same."""
    from semivl_tpu_torch.data.transforms import obtain_cutmix_box_coords
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(50):
        assert traffic.cutmix_box_coords(801, a) == \
            obtain_cutmix_box_coords(801, b).tolist()


@pytest.mark.parametrize('mix', ['ade-val-512'])
def test_eval_sizes_are_the_same_multiset_for_every_seed(mix):
    m = spec.traffic(mix)
    sizes = [sorted(it['img'].shape[:2] for it in traffic.eval_images(
        dict(m, distinct=8), 150, s)) for s in SEEDS]
    assert sizes[0] == sizes[1]
    assert min(min(s) for s in sizes[0]) == m['short_side']


def test_eval_images_repeat_and_differ():
    m = tiny.load('tiny-eval')
    a, b, c = (traffic.eval_images(m, 21, s) for s in
               (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert all(np.array_equal(x['img'], y['img'])
               and np.array_equal(x['mask'], y['mask'])
               for x, y in zip(a, b))
    assert not all(x['img'].shape == y['img'].shape
                   and np.array_equal(x['img'], y['img'])
                   for x, y in zip(a, c))


def test_weights_repeat_and_differ():
    shapes = {'backbone.a.weight': (4, 3), 'backbone.pos_embed': (1, 5, 3),
              'decode_head.b.bias': (4,), 'decode_head.n.weight': (4,)}
    scales = {'backbone': 0.5, 'decode_head': 1.0}
    a, b, c = (weights.make(shapes, s, scales, 'cpu') for s in
               (SEEDS[1], SEEDS[1], SEEDS[0]))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['backbone.a.weight'], c['backbone.a.weight'])
    assert float(a['backbone.a.weight'].abs().max()) <= 0.5 / 3 ** 0.5
    assert torch.equal(a['decode_head.b.bias'], torch.zeros(4))
    assert torch.equal(a['decode_head.n.weight'], torch.ones(4))

