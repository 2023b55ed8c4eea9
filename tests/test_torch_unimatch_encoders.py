"""The UniMatch baselines' encoders in the port against the JAX package on
the CPU, float32 on both sides, weights and BatchNorm statistics from a
seed carried by ``semivl_tpu_torch.convert``: the dilated ResNet-50 with
the UniMatch stem, Xception-65, and the Xception-65 DeepLabV3+ (forward,
feature perturbation, and its UniMatch step on the port alone: JAX's
trace and compile of that step take 60-90 s here).

Tolerances: eval-mode forwards 1e-5 relative L2; train-mode forwards and
the moves of the running statistics in one call within
``torch_unimatch.bn_tol`` (the larger of 1e-5 and twice JAX's own float32
distance from the float64 forward).
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from semivl_tpu.models.resnet import ResNetV1c as JaxResNet
from semivl_tpu.models.xception import Xception65 as JaxXception
from semivl_tpu_torch import convert
from semivl_tpu_torch.models.resnet import ResNetV1c
from semivl_tpu_torch.models.xception import Xception65
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import make_semivl_train_step

from torch_parity import InjectedDropout, PortBundle
from torch_unimatch import (NCLS, as_tensor, bn_tol, dlv3p_keeps,
                            dlv3p_setup, dlv3p_step_inputs, encoder_readings,
                            jax_tree, port_encoder, rel_l2, stats_vectors)

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


@pytest.fixture(scope='module', params=[(False, False, True),
                                        (False, True, True)],
                ids=['FFT', 'FTT'])
def resnet(request):
    """The UniMatch ResNet-50 (stem 64, 64, 128; c1 and c4) with the given
    dilation, both frameworks on one 2 x 65^2 batch."""
    kw = dict(depth=50, num_stages=4, out_indices=(0, 3),
              replace_stride_with_dilation=request.param,
              stem_widths=(64, 64, 128))
    jm = JaxResNet(axis_name=None, **kw)
    params, stats = jax_tree(jm, 31, 65)
    x = np.random.RandomState(32).randn(2, 65, 65, 3).astype(np.float32)
    r, upd = encoder_readings(
        jm, params, stats, lambda dt: port_encoder(
            ResNetV1c, convert.export_resnet_v1c, params, stats, dt, **kw),
        x)
    sd = {}
    convert.export_resnet_v1c(sd, params, upd, prefix='')
    before = {}
    convert.export_resnet_v1c(before, params, stats, prefix='')
    return r, sd, stats_vectors(before), request.param


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_resnet_v1c_dilated_matches_jax(resnet, mode):
    """c1 (256 channels, stride 4) and c4 (2048, stride 16 at (F, F, T),
    8 at (F, T, T)) in eval mode within 1e-5, in train mode with the
    running statistics after the call within the BatchNorm bound."""
    r, jax_stats, before, dilation = resnet
    c4 = 65 // 4 // (2 if dilation[1] else 4) + 1
    assert r['port_eval'][1].shape == (2, c4, c4, 2048)
    assert r['port_eval'][0].shape == (2, 17, 17, 256)
    if mode == 'eval':
        for got, want in zip(r['port_eval'], r['jax_eval']):
            assert rel_l2(got, want) <= 1e-5
        return
    for got, want, ref in zip(r['port_train'], r['jax_train'],
                              r['port64_train']):
        assert rel_l2(got, want) <= bn_tol(want, ref)
    for got, want, ref, old in zip(r['port_stats'], stats_vectors(jax_stats),
                                   r['port64_stats'], before):
        assert rel_l2(got - old, want - old) <= bn_tol(want - old, ref - old)
        assert not np.array_equal(got, old)


@pytest.fixture(scope='module')
def xception():
    """Xception-65 (output stride 16) on one 2 x 33^2 batch."""
    jm = JaxXception(axis_name=None)
    params, stats = jax_tree(jm, 41, 33)
    x = np.random.RandomState(42).randn(2, 33, 33, 3).astype(np.float32)
    r, upd = encoder_readings(
        jm, params, stats, lambda dt: port_encoder(
            Xception65, convert.export_xception, params, stats, dt), x)
    sd, before = {}, {}
    convert.export_xception(sd, params, upd, prefix='')
    convert.export_xception(before, params, stats, prefix='')
    return r, sd, stats_vectors(before)


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_xception65_matches_jax(xception, mode):
    """c1 (block 2's hook, 256 channels) and c4 (2048 at stride 16) in
    eval mode within 1e-5; in train mode, and the running statistics at
    momentum 0.0003 after the call, within the BatchNorm bound."""
    r, jax_stats, before = xception
    assert r['port_eval'][0].shape == (2, 9, 9, 256)
    assert r['port_eval'][1].shape == (2, 3, 3, 2048)
    if mode == 'eval':
        for got, want in zip(r['port_eval'], r['jax_eval']):
            assert rel_l2(got, want) <= 1e-5
        return
    for got, want, ref in zip(r['port_train'], r['jax_train'],
                              r['port64_train']):
        assert rel_l2(got, want) <= bn_tol(want, ref)
    for got, want, ref, old in zip(r['port_stats'], stats_vectors(jax_stats),
                                   r['port64_stats'], before):
        # the statistics move by 0.0003 of the way: compare the moves
        assert rel_l2(got - old, want - old) <= bn_tol(want - old, ref - old)
        assert not np.array_equal(got, old)


@pytest.fixture(scope='module')
def dlv3p():
    return dlv3p_setup('xception')


def test_dlv3p_xception_forward_matches_jax(dlv3p):
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
def test_dlv3p_xception_feature_perturbation_matches_jax(dlv3p, what):
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


def test_dlv3p_xception_unimatch_step_trains():
    """The Xception-65 DeepLabV3+ through the same UniMatch step and SGD
    on the CPU (its forward and feature perturbation are held against JAX
    above; JAX's trace of this step takes longer than this file's
    budget): finite loss terms, every leaf moved and in the ``lr_multi``
    group, every running statistic moved, the moves of the statistics of
    the first BatchNorm (at momentum 0.0003) 0.0003 of the way to the
    batch's."""
    d = dlv3p_setup('xception')
    batch, keeps, pm, cfg = dlv3p_step_inputs(d)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    assert [g['lr_mult'] for g in opt.param_groups] == [10.0]
    step = make_semivl_train_step(PortBundle(pm, np.zeros((NCLS, 1)), None),
                                  cfg, opt, TOTAL, device='cpu')
    fake = InjectedDropout(keeps)
    with mock.patch('semivl_tpu_torch.models.deeplabv3plus.dropout2d',
                    fake.torch):
        metrics = {k: float(v) for k, v in step(batch).items()}
    assert fake.calls == 2
    assert all(np.isfinite(v) for v in metrics.values())
    assert min(metrics['loss_s1'], metrics['loss_s2'],
               metrics['loss_fp']) > 0
    for k, v in pm.state_dict().items():
        assert not torch.equal(v, before[k]), k
