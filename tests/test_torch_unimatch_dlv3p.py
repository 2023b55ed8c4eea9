"""The UniMatch DeepLabV3+ on the dilated ResNet-50 in the port against the
JAX package on the CPU, float32 on both sides, weights and BatchNorm
statistics from a seed carried by ``semivl_tpu_torch.convert``: forward,
feature perturbation, one UniMatch step with the ``original`` SGD, and the
``original``, ``center_crop`` and ``padded_sliding_window`` eval modes,
JAX's host ``_sliding`` route and ``return_logits`` on it.

Tolerances: forwards and score maps 1e-5 relative L2; the step's loss
terms 1e-4 relative, gradients and SGD updates 1e-3 of each leaf's own
scale and the running statistics' moves 1e-4, each bound or twice JAX's
own float32 distance from the float64 step (the port's), whichever is
larger, both frameworks' ReLUs sharing JAX's masks (``SharedReluMasks``:
a random ResNet-50's maps at 5 x 5 have ReLU inputs within float32
rounding of zero, and one that passes gradient on one side only moves a
layer's gradient by tens of per cent).
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import make_semivl_train_step

from torch_parity import (MARGIN, InjectedDropout, PortBundle,
                          SharedReluMasks, rel_err, semivl_step_pair)
from torch_unimatch import (NCLS, as_tensor, dlv3p_keeps, dlv3p_setup,
                            dlv3p_step_inputs, rel_l2)

TOTAL = 100


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """This file's torch work on 2 threads: the suite runs several test
    processes on one host, and torch's default of one thread a core
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dlv3p():
    return dlv3p_setup('resnet50')


def test_dlv3p_forward_matches_jax(dlv3p):
    """Eval-mode logits (B, NCLS, H, W) within 1e-5; the names JAX's
    optimizer rule reads: no leaf starts with ``backbone``."""
    d = dlv3p
    x = np.random.RandomState(52).randn(2, d['img'], d['img'], 3).astype(
        np.float32)
    want = np.asarray(d['apply'](
        {'params': d['params'], 'batch_stats': d['stats']}, x))
    pm = d['make']()
    with torch.no_grad():
        got = pm(as_tensor(x), np.zeros((NCLS, 1), np.float32)).numpy()
    assert got.shape == (2, NCLS, d['img'], d['img'])
    assert rel_l2(got, want) <= 1e-5
    names = [n for n, _ in pm.named_parameters()]
    assert not any(n.startswith('backbone') for n in names)
    assert {n.split('.')[0] for n in names} == {
        'encoder', 'head', 'reduce', 'fuse1', 'fuse2', 'classifier'}


@pytest.mark.parametrize('what', ['need_fp', 'only_fp'])
def test_dlv3p_feature_perturbation_matches_jax(dlv3p, what):
    """``need_fp``: the clean logits of the batch and the perturbed ones of
    its second half from one decode; ``only_fp``: the perturbed logits of
    the whole batch. Both sides drop the same channels of c1 and c4
    (``InjectedDropout``, c1's mask first); eval mode, within 1e-5."""
    d = dlv3p
    x = np.random.RandomState(53).randn(4, d['img'], d['img'], 3).astype(
        np.float32)
    rows = 2 if what == 'need_fp' else 4
    keeps = dlv3p_keeps(d, rows, 54)
    fake = InjectedDropout(keeps)
    v = {'params': d['params'], 'batch_stats': d['stats']}
    kw = {what: True}
    with mock.patch('semivl_tpu.models.deeplabv3plus.dropout2d', fake.jax):
        want = jax.jit(functools.partial(d['local'].apply, **kw))(
            v, x, rngs={'fp': jax.random.PRNGKey(0)})
    fake_t = InjectedDropout(keeps)
    with torch.no_grad(), mock.patch(
            'semivl_tpu_torch.models.deeplabv3plus.dropout2d', fake_t.torch):
        got = d['make']()(as_tensor(x), None, **kw)
    assert fake.calls == fake_t.calls == 2
    if what == 'need_fp':
        (clean, pert), (jclean, jpert) = got, want
        assert pert.shape == (2, NCLS, d['img'], d['img'])
        assert rel_l2(clean.numpy(), jclean) <= 1e-5
        assert rel_l2(pert.numpy(), jpert) <= 1e-5
        assert rel_l2(pert.numpy(), clean[2:].numpy()) > 1e-2
    else:
        assert rel_l2(got.numpy(), want) <= 1e-5


@pytest.fixture(scope='module')
def dlv3p_step():
    """One UniMatch step of the ResNet-50 DeepLabV3+ in JAX and in the
    port, the perturbation masks and the ReLU masks shared, and the port's
    step at float64 (module docstring)."""
    d = dlv3p_setup('resnet50')
    batch, keeps, pm, cfg = dlv3p_step_inputs(d)
    relu = SharedReluMasks()
    text = np.zeros((NCLS, 1), np.float32)
    s = semivl_step_pair(d['jm'], d['params'], pm, None, text, batch, cfg,
                         keeps, TOTAL, stats=d['stats'],
                         freeze_backbone=False, exclude_keys=None,
                         relu_masks=relu, module='deeplabv3plus')
    # the same step at float64 through JAX's ReLU masks: the reference
    # that measures JAX's own float32 gap
    relu64 = SharedReluMasks()
    relu64.inputs = relu.inputs
    pm64 = d['make'](torch.float64)
    opt, _ = optim.build_optimizer(cfg, pm64, TOTAL)
    step = make_semivl_train_step(PortBundle(pm64, text, None), cfg, opt,
                                  TOTAL, device='cpu')
    fake = InjectedDropout(keeps)
    with mock.patch('semivl_tpu_torch.models.deeplabv3plus.dropout2d',
                    fake.torch), \
            mock.patch.object(torch.nn.functional, 'relu', relu64.torch):
        s['metrics64'] = {k: float(v) for k, v in step(batch).items()}
    s['grads64'] = {n: p.grad.numpy() for n, p in pm64.named_parameters()}
    s['after64'] = {k: v.numpy() for k, v in pm64.state_dict().items()}
    return s, relu


def test_dlv3p_unimatch_step_matches_jax(dlv3p_step):
    """Loss terms within 1e-4 relative, every leaf's gradient and SGD
    update within 1e-3 of its scale, the running statistics' moves within
    1e-4 of JAX's, each bound or twice JAX's own float32 distance from
    the float64 step, whichever is larger; the ReLU masks shared (module
    docstring), the flipped inputs within 1e-3 of their call's scale (the
    train-mode forwards' own float32 spread in the deep layers, as the
    BatchNorm bound reads it)."""
    s, relu = dlv3p_step
    jm, pm, ref = s['jmetrics'], s['pmetrics'], s['metrics64']
    assert set(pm) == set(jm) == set(ref)
    for k in pm:
        tol = max(1e-4 * abs(jm[k]), 2 * abs(jm[k] - ref[k]))
        assert abs(pm[k] - jm[k]) <= tol, (k, pm[k], jm[k], ref[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp'):
        assert pm[k] > 0, k
    assert max(relu.flips, default=0.0) <= 1e-3
    assert len(s['trainable']) == len(s['grads64'])
    for name in s['trainable']:
        for side, ref in (('port_grads', 'grads64'), ('after', 'after64')):
            want = s['jax_grads' if side == 'port_grads' else 'jax_new'][name]
            tol = max(1e-3, 2 * rel_err(want, s[ref][name]))
            assert rel_err(s[side][name], want) <= tol, (name, side)
    n_stats = 0
    for k, after in s['after'].items():
        if k.endswith(('running_mean', 'running_var')):
            old = s['before'][k].numpy()
            want = s['jax_new'][k] - old
            tol = max(1e-4, 2 * rel_err(want, s['after64'][k] - old))
            assert rel_err(after - old, want) <= tol, k
            n_stats += 1
    assert n_stats > 20


# ---------------------------------------------------------- eval modes

@pytest.fixture(scope='module')
def eval_pair():
    """JAX's and the port's evaluators on the ResNet-50 DeepLabV3+ (crop
    32, stride 24)."""
    from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator

    from semivl_tpu_torch.evaluation.predict import Evaluator
    d = dlv3p_setup('resnet50')
    cfg = dict(crop_size=32, stride=24, nclass=NCLS)
    text = np.zeros((NCLS, 1), np.float32)
    jev = JaxEvaluator(d['local'], {'params': d['params'],
                                    'batch_stats': d['stats']}, text, cfg)
    return jev, Evaluator(d['make'](), text, cfg, device='cpu')


@pytest.mark.parametrize('mode,hw', [
    ('original', (40, 40)), ('center_crop', (40, 40)),
    ('center_crop', (20, 26)), ('padded_sliding_window', (40, 40)),
    ('sliding_window', (32, 40))],
    ids=['original', 'center_crop', 'center_crop_small', 'padded_uint8',
         'sliding_host'])
def test_eval_mode_matches_jax(eval_pair, mode, hw):
    """``predict(..., return_logits=True)`` of a uint8 image: the score map
    within 1e-5 relative L2 of JAX's, the prediction equal at every pixel
    whose top two scores lie farther apart than the frameworks' float32
    spread (all but a few); ``center_crop`` on an image smaller than the
    crop keeps the reference's edge sliver; ``padded_sliding_window``
    normalises on the host before it pads; ``sliding_window`` with
    ``return_logits`` takes JAX's host route."""
    jev, pev = eval_pair
    img = np.random.RandomState(63).randint(0, 256, (1,) + hw + (3,),
                                            np.uint8)
    jpred, jlog = jev.predict(img, hw, mode, return_logits=True)
    pred, logits = pev.predict(img, hw, mode, return_logits=True)
    jlog = np.asarray(jlog)
    assert logits.shape == jlog.shape and pred.shape == np.shape(jpred)
    assert rel_l2(logits, jlog) <= 1e-5
    top2 = np.sort(jlog, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(pred[clear], np.asarray(jpred)[clear])
    if mode == 'center_crop' and hw == (20, 26):
        assert logits.shape[2:] == (6, 3)   # rows 14-19, columns 23-25
    if mode == 'padded_sliding_window':
        np.testing.assert_array_equal(pev.predict(img, hw, mode), pred)
