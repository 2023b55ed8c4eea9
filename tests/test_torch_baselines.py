"""The baselines SemiVL is compared with, in the port against the JAX
package on the CPU, float32 on both sides, same numpy-seeded inputs and
weights carried by ``semivl_tpu_torch.convert``: the supervised and
UniMatch steps, OHEM, the ``original`` SGD, the on-device augmentation on
shared draws, the loop's supervised epoch and a UniMatch run of the CLI,
and the ``maskclip_class_filter`` refusal. The UniMatch DeepLabV3+ and its
encoders are in tests/test_torch_unimatch_encoders.py and
test_torch_unimatch_dlv3p.py.

Tolerances:
- the augmentation 1e-5 of the output scale; OHEM's loss 1e-6 relative
  with its kept set equal; the SGD's parameters after 3 steps 1e-6 of
  each leaf's scale;
- the tiny VLM's steps (no BatchNorm): loss terms 1e-4 relative,
  gradients 1e-4 of each leaf's scale (a leaf whose gradient vanishes in
  exact arithmetic, the head's bias, to 1e-6 of the largest on both
  sides), the updated parameters 1e-3 of it (the bound of
  tests/test_torch_train.py: the first AdamW step moves a parameter by
  about lr x lr_mult x sign(g), so the sign of a vanishing gradient
  component shows there).
"""

import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.losses.ce import ohem_cross_entropy as jax_ohem
from semivl_tpu.train import optim as jax_optim
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs import flagship_train_cfg
from semivl_tpu_torch.configs.experiments import config_from_vars
from semivl_tpu_torch.losses.ce import (CITYSCAPES_OHEM_WEIGHT,
                                        ohem_cross_entropy)
from semivl_tpu_torch.ops import augment
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import make_supervised_train_step

import torch_parity
from torch_parity import (MARGIN, PortBundle, confident_threshold,
                          gap_threshold, rel_err, semivl_batch,
                          semivl_step_pair, step_mismatches, text_embedding,
                          tiny_train_vlm)
from torch_unimatch import as_tensor, dlv3p_setup

from synth_data import make_synth_dataset

IMG, TOTAL = torch_parity.IMG, 100


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """This file's torch work on 2 threads: the suite runs several test
    processes on one host, and torch's default of one thread a core
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def grad_mismatches(s, tol):
    """The trainable leaves whose gradient lies farther than ``tol`` of its
    scale from JAX's, but those whose JAX gradient vanishes (|g| <= 1e-6
    of the largest: ``step_mismatches`` holds them to that on both
    sides)."""
    top = max(np.abs(g).max() for g in s['jax_grads'].values())
    return [(n, rel_err(s['port_grads'][n], s['jax_grads'][n]))
            for n, t in s['trainable'].items()
            if t and np.abs(s['jax_grads'][n]).max() > 1e-6 * top
            and rel_err(s['port_grads'][n], s['jax_grads'][n]) > tol]


# ------------------------------------------------------------ the guard

@pytest.mark.parametrize('which', [1, 2])
def test_build_model_refuses_maskclip_class_filter(which):
    """A config with ``maskclip_class_filter`` (a dead option of the
    reference, which JAX's builder asserts off) is refused by name, before
    any device is touched."""
    from semivl_tpu_torch.models.builder import build_model
    cfg = config_from_vars(exp_id=99, maskclip_class_filter=which,
                           model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb',
                           criterion='CELoss', criterion_u='CELoss')
    assert cfg['model_args']['maskclip_class_filter'] is not None
    with pytest.raises(ValueError, match='maskclip_class_filter'):
        build_model(cfg)


# ------------------------------------------------------------------ OHEM

def _ohem_case(name):
    """(logits, labels, kwargs) of an OHEM case."""
    rs = np.random.RandomState(11)
    logits = (2 * rs.randn(2, 19, 12, 14)).astype(np.float32)
    labels = rs.randint(0, 19, (2, 12, 14)).astype(np.int32)
    labels[:, :2] = 255
    kw = dict(thresh=0.05, min_kept=150)
    if name == 'weighted':
        kw['weight'] = CITYSCAPES_OHEM_WEIGHT
    elif name == 'min_kept_above_valid':
        kw['min_kept'] = 10 ** 6
    elif name == 'all_ignored':
        labels[:] = 255
    elif name == 'ties':
        # 40 pixels of one true-class probability, the hardest of the
        # batch: the 25th smallest is theirs, and all 40 are kept
        logits[:, :, 4:6, :10] = logits[0, :, 4, 0][None, :, None, None]
        labels[:, 4:6, :10] = 3
        logits[:, 3, 4:6, :10] = -20.0
        kw = dict(thresh=0.0, min_kept=25)
    return logits, labels, kw


@pytest.mark.parametrize('case', ['plain', 'weighted',
                                  'min_kept_above_valid', 'all_ignored',
                                  'ties'])
def test_ohem_matches_jax(case):
    """The same kept set (the pixels whose logits get gradient) and the
    loss within 1e-6; 0 and no gradient where no pixel is valid."""
    logits, labels, kw = _ohem_case(case)
    want, jgrad = jax.value_and_grad(
        lambda x: jax_ohem(x, jnp.asarray(labels), **kw))(
            jnp.asarray(logits))
    x = as_tensor(logits).requires_grad_()
    got = ohem_cross_entropy(x, as_tensor(labels).long(), **kw)
    got.backward()
    jkept = np.abs(np.asarray(jgrad)).sum(axis=1) > 0
    pkept = x.grad.abs().sum(dim=1).numpy() > 0
    np.testing.assert_array_equal(pkept, jkept)
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-6 * max(abs(float(want)), 1e-6)
    valid = labels != 255
    if case == 'all_ignored':
        assert got == 0.0 and not pkept.any()
    elif case == 'min_kept_above_valid':
        np.testing.assert_array_equal(pkept, valid)
    elif case == 'ties':
        assert pkept[:, 4:6, :10].all() and pkept.sum() == 40
    else:
        assert 0 < pkept.sum() < valid.sum()


# ------------------------------------------------- the tiny VLM's steps

@pytest.fixture(scope='module')
def tiny():
    return tiny_train_vlm(seed=3, logit_scale=30.0)


def _jax_supervised_step(jm, params, text, batch, cfg, stats=None,
                         freeze_backbone=True,
                         exclude_keys=('attn', 'pos_embed'),
                         names=convert.vlm_state_dict):
    """JAX's supervised step on a 1-device mesh: the metrics, the gradients
    and the updated parameters and statistics under the port's names."""
    from jax.sharding import Mesh

    from semivl_tpu.models.builder import ModelBundle as JaxBundle
    from semivl_tpu.train.step import (TrainState,
                                       make_supervised_train_step as jstep,
                                       replicate, shard_batch)
    exclude_keys = list(exclude_keys) if exclude_keys else None
    bundle = JaxBundle(module=jm, text_feats=text, mcc_text_feats=None,
                       num_classes=text.shape[0],
                       img_size=batch['mask'].shape[1], model_cfg={},
                       freeze_backbone=freeze_backbone,
                       exclude_keys=exclude_keys)
    tx, _, mask = jax_optim.build_optimizer(
        cfg, params, TOTAL, freeze_backbone=freeze_backbone,
        exclude_keys=exclude_keys)
    variables = {'params': params}
    if stats is not None:
        variables['batch_stats'] = stats
    state = TrainState(params=variables, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    fn = jstep(bundle, cfg, tx, mesh, mask)
    new_state, metrics = fn(replicate(state, mesh), shard_batch(batch, mesh),
                            replicate(jax.random.PRNGKey(0), mesh))
    new = jax.tree.map(np.asarray, new_state.params)
    return dict(jmetrics={k: float(v) for k, v in metrics.items()},
                jax_new=names(new['params'], new.get('batch_stats')),
                jax_grads=names(torch_parity.masked_grads(
                    new_state.opt_state, params)))


def _supervised_cfg(criterion, pm, text, batch):
    """Exp 40's config as the supervised baseline. OHEM's ``thresh`` lies
    in a gap of this batch's true-class probabilities (a pixel within
    float32 rounding of it would be kept on one side only) and its
    ``min_kept`` below the pixels under it, so the threshold decides."""
    cfg = dict(flagship_train_cfg(IMG), method='supervised',
               criterion=dict(name=criterion, kwargs=dict(ignore_index=255)))
    if criterion == 'OHEM':
        mask = batch['mask']
        with torch.no_grad():
            probs = torch.softmax(pm(as_tensor(batch['img']),
                                     as_tensor(text)), 1).numpy()
        safe = np.where(mask == 255, 0, mask)
        true = np.take_along_axis(probs, safe[:, None], 1)[:, 0]
        thresh, margin = gap_threshold(true[mask != 255], 0.3, 0.7)
        assert margin > MARGIN
        cfg['criterion']['kwargs'].update(thresh=thresh, min_kept=100)
    return cfg


@pytest.mark.parametrize('criterion', ['CELoss', 'OHEM'])
def test_supervised_step_matches_jax(tiny, criterion):
    """The supervised step (one train-mode pass over the labeled batch, its
    labeled loss, one AdamW update) against ``make_supervised_train_step``:
    ``loss_all`` and ``loss_x`` within 1e-4 relative, every trainable
    leaf's gradient and updated value within 1e-4 of its scale, frozen
    leaves unchanged on both sides."""
    jm, params, pm, _ = tiny
    text = text_embedding()
    b = semivl_batch(21, 2, IMG)
    batch = dict(img=b['img_x'], mask=b['mask_x'])
    cfg = _supervised_cfg(criterion, pm, text, batch)
    out = _jax_supervised_step(jm, params, text, batch, cfg)
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    try:
        opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
        step = make_supervised_train_step(PortBundle(pm, text, None), cfg,
                                          opt, TOTAL, device='cpu')
        pmetrics = {k: float(v) for k, v in step(batch).items()}
        s = dict(out, pmetrics=pmetrics, before=state,
                 after={k: v.numpy().copy()
                        for k, v in pm.state_dict().items()},
                 port_grads={n: (p.grad.numpy() if p.grad is not None
                                 else np.zeros(p.shape, np.float32))
                             for n, p in pm.named_parameters()},
                 trainable={n: p.requires_grad
                            for n, p in pm.named_parameters()})
    finally:
        pm.load_state_dict(state)
    assert set(pmetrics) == {'loss_all', 'loss_x'} == set(out['jmetrics'])
    for k, v in pmetrics.items():
        assert abs(v - out['jmetrics'][k]) <= 1e-4 * abs(out['jmetrics'][k])
    assert pmetrics['loss_all'] == pmetrics['loss_x'] > 0
    assert grad_mismatches(s, 1e-4) == []
    bad, n_checked = step_mismatches(s, tol=1e-3)
    assert bad == [] and n_checked > 20


@pytest.fixture(scope='module')
def unimatch_pair(tiny):
    """One UniMatch step (the SemiVL step at λ 0, no guidance encoder) in
    JAX and in the port, the feature-perturbation masks shared."""
    jm, params, pm, _ = tiny
    text = text_embedding()
    batch = semivl_batch(22, 2, IMG)
    rs = np.random.RandomState(23)
    keeps = [rs.rand(2, 1, 1, c) < 0.5 for c in (128, 128, 512)]
    cfg = dict(flagship_train_cfg(IMG), method='unimatch',
               maskclip_consistency_lambda=0, clip_encoder=None,
               conf_thresh=confident_threshold(pm, text, batch, keeps))
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    try:
        return semivl_step_pair(jm, params, pm, None, text, batch, cfg,
                                keeps, TOTAL)
    finally:
        pm.load_state_dict(state)


def test_unimatch_step_losses_match_jax(unimatch_pair):
    jm, pm = unimatch_pair['jmetrics'], unimatch_pair['pmetrics']
    assert set(pm) == set(jm) == {'loss_x', 'loss_s1', 'loss_s2', 'loss_fp',
                                  'loss_all'}
    for k in pm:
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp'):
        assert pm[k] > 0, k   # the threshold keeps some pixels


def test_unimatch_step_grads_and_update_match_jax(unimatch_pair):
    assert grad_mismatches(unimatch_pair, 1e-4) == []
    bad, n_checked = step_mismatches(unimatch_pair, tol=1e-3)
    assert bad == [] and n_checked > 20


def _sgd_cfg(kind):
    """The ``original`` SGD's keys on exp 40's VLM config, or the
    DeepLabV3+ baseline's generated config; lr_multi 10."""
    if kind == 'vlm':
        cfg = dict(flagship_train_cfg(IMG), lr=1e-3, lr_multi=10.0)
        cfg.pop('optimizer')
        return cfg
    return config_from_vars(exp_id=99, model='dlv3p-r101', opt='original',
                            lr=1e-3, criterion='CELoss',
                            criterion_u='CELoss', crop_size=65,
                            img_scale=None)


@pytest.mark.parametrize('kind', ['vlm', 'dlv3p'])
def test_sgd_original_matches_optax(tiny, kind):
    """Three steps of the ``original`` SGD (momentum 0.9, weight decay 1e-4
    before the momentum, the poly schedule on ``lr``) against JAX's optax
    chain on the same gradients: every parameter within 1e-6 of its
    scale. The groups are JAX's: on the VLM the trainable ``backbone``
    leaves at the base rate and the rest at ``lr_multi``; on the
    DeepLabV3+ every leaf, its encoder's too, at ``lr_multi`` (no name
    starts with ``backbone``)."""
    import copy

    import optax
    cfg = _sgd_cfg(kind)
    if kind == 'vlm':
        jm, params, pm, _ = tiny
        pm, freeze, exclude = copy.deepcopy(pm), True, ['attn', 'pos_embed']
        names = convert.vlm_state_dict
    else:
        d = dlv3p_setup('resnet50')
        params, pm = d['params'], d['make']()
        freeze, exclude, names = False, None, convert.dlv3p_state_dict
    tx, sched, mask = jax_optim.build_optimizer(
        cfg, params, TOTAL, freeze_backbone=freeze, exclude_keys=exclude)
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    step = make_supervised_train_step(PortBundle(pm, np.zeros((1, 1)), None),
                                      dict(cfg, criterion_u='CELoss'), opt,
                                      TOTAL, device='cpu')
    paths = jax.tree_util.tree_leaves(jax_optim.param_path_strings(params))
    trainable = dict(zip(paths, jax.tree_util.tree_leaves(mask)))
    prm = dict(pm.named_parameters())
    rs = np.random.RandomState(57)
    state, jparams = tx.init(params), params
    update = jax.jit(tx.update)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p, t: (rs.randn(*np.shape(p)).astype(np.float32) if t
                          else np.zeros(np.shape(p), np.float32)),
            params, mask)
        for n, g in names(grads).items():
            if n in prm and prm[n].requires_grad:
                prm[n].grad = as_tensor(g).clone()
        step.update({})
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = names(jax.tree.map(np.asarray, jparams))
    group_of = {id(p): g['lr_mult'] for g in opt.param_groups
                for p in g['params']}
    n_backbone = 0
    for name, p in prm.items():
        assert rel_err(p.detach().numpy(), want[name]) <= 1e-6, name
        if p.requires_grad:
            mult = 1.0 if name.startswith('backbone') else 10.0
            assert group_of[id(p)] == mult, name
            n_backbone += mult == 1.0
    assert step.iteration == 3
    assert (n_backbone > 0) == (kind == 'vlm')
    assert sum(trainable.values()) == sum(p.requires_grad
                                          for p in prm.values())


# ------------------------------------------------ on-device augmentation

def _jax_strong_draws(rng, n):
    """JAX ``strong_augment``'s draws, by its key splits
    (ops/augment.py:88-102, :147-156)."""
    def one(r):
        k_cj, k_cjp, _, k_gsp, k_bl, k_blp = jax.random.split(r, 6)
        kb, kc, ks, kh, kp = jax.random.split(k_cj, 5)
        u = jax.random.uniform
        return dict(
            factors=jnp.stack([u(kb, (), minval=0.5, maxval=1.5),
                               u(kc, (), minval=0.5, maxval=1.5),
                               u(ks, (), minval=0.5, maxval=1.5),
                               u(kh, (), minval=-0.25, maxval=0.25)]),
            perm=jax.random.randint(kp, (), 0, 24),
            jitter=u(k_cjp) < 0.8, gray=u(k_gsp) < 0.2,
            sigma=u(k_bl, (), minval=0.1, maxval=2.0), blur=u(k_blp) < 0.5)

    draws = jax.jit(jax.vmap(one))(jax.random.split(rng, n))
    return {k: as_tensor(np.asarray(v)) for k, v in draws.items()}


def _jax_photometric_draws(rng, n):
    """JAX ``photometric_distortion``'s draws (ops/augment.py:172-191)."""
    def one(r):
        ks = jax.random.split(r, 9)
        u, coin = jax.random.uniform, jax.random.bernoulli
        return dict(delta=u(ks[0], (), minval=-32 / 255, maxval=32 / 255),
                    bright=coin(ks[1]), contrast_last=coin(ks[2]),
                    alpha=u(ks[3], (), minval=0.5, maxval=1.5),
                    contrast=coin(ks[4]),
                    sat_factor=u(ks[5], (), minval=0.5, maxval=1.5),
                    sat=coin(ks[6]),
                    hue_shift=u(ks[7], (), minval=-18 / 360,
                                maxval=18 / 360),
                    hue=coin(ks[8]))

    draws = jax.jit(jax.vmap(one))(jax.random.split(rng, n))
    return {k: as_tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize('which', ['strong', 'photometric'])
def test_augment_apply_matches_jax_on_its_draws(which):
    """The port's apply functions on JAX's draws against JAX's own
    ``strong_augment`` / ``photometric_distortion`` on 256 small images
    (every one of the 24 jitter orders drawn), within 1e-5 of the output
    scale; every gate both open and shut. The port's own draws have the
    same fields, on the images' device."""
    from semivl_tpu.ops import augment as jax_augment
    n = 256
    imgs = np.random.RandomState(61).rand(n, 6, 7, 3).astype(np.float32)
    key = jax.random.PRNGKey(62)
    if which == 'strong':
        draws = _jax_strong_draws(key, n)
        want = np.asarray(jax.jit(jax_augment.strong_augment)(
            key, jnp.asarray(imgs)))
        got = augment.apply_strong(as_tensor(imgs), draws).numpy()
        assert set(draws['perm'].tolist()) == set(range(24))
        gates = ('jitter', 'gray', 'blur')
        port = augment.strong_draws(4, torch.Generator().manual_seed(0),
                                    'cpu')
    else:
        draws = _jax_photometric_draws(key, n)
        want = np.asarray(jax.jit(jax_augment.photometric_distortion)(
            key, jnp.asarray(imgs)))
        got = augment.apply_photometric(as_tensor(imgs), draws).numpy()
        gates = ('bright', 'contrast_last', 'contrast', 'sat', 'hue')
        port = augment.photometric_draws(4, torch.Generator().manual_seed(0),
                                         'cpu')
    for g in gates:
        assert 0 < draws[g].float().mean() < 1, g
    assert set(port) == set(draws)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------- the loop

@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('baselines'))
    return root, make_synth_dataset(root, n_labeled=2, n_unlabeled=4,
                                    n_val=1, size=(72, 88))


def _loop_cfg(synth, **kw):
    root, paths = synth
    cfg = config_from_vars(
        exp_id=99, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=1, img_scale=None, criterion='CELoss', criterion_u='CELoss',
        eval_mode='zegclip_sliding_window', **kw)
    cfg.update(stride=48, data_root=root, labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'], debug_images=False)
    cfg.pop('img_scale')
    return cfg


@pytest.fixture
def no_tensorboard(monkeypatch):
    from semivl_tpu_torch.train import loop
    monkeypatch.setattr(loop, 'MetricWriter', functools.partial(
        loop.MetricWriter, use_tensorboard=False))


def test_supervised_epoch_is_labeled_batches(synth, tmp_path, monkeypatch,
                                             no_tensorboard):
    """``method='supervised'``: an epoch of ``len(loader_l)`` steps, each on
    a labeled batch alone (``img``, ``mask``), ``1 x bs`` images an
    iteration in the throughput (JAX loop.py:296-297, :420-425, :499)."""
    from semivl_tpu_torch.train import loop
    from semivl_tpu_torch.train.step import SupervisedStep
    monkeypatch.chdir(tmp_path)
    seen, ipi = [], []
    real_backward = SupervisedStep.backward
    real_window = loop._log_window

    def backward(self, batch, generator=None):
        seen.append(sorted(batch))
        return real_backward(self, batch, generator)

    def window(keys, pending, times, t0, imgs_per_iter, *a):
        ipi.append(imgs_per_iter)
        return real_window(keys, pending, times, t0, imgs_per_iter, *a)

    cfg = _loop_cfg(synth, method='supervised')
    with mock.patch.object(SupervisedStep, 'backward', backward), \
            mock.patch.object(loop, '_log_window', window):
        best, path = loop.train(cfg, device='cpu')
    # the labeled list is oversampled to the unlabeled one's length
    assert seen == [['img', 'mask']] * 4 and ipi == [1]
    state = torch.load(os.path.join(path, 'ckpt', 'latest'),
                       weights_only=True)
    assert state['iteration'] == 4 and 0.0 <= best <= 100.0


def test_unimatch_cli_on_device_augmentation_resumes(synth, tmp_path,
                                                     monkeypatch,
                                                     no_tensorboard):
    """The CLI on a UniMatch config with ``strong_aug_on_device`` and
    ``labeled_photometric_distortion`` (uint8 transport, the views made by
    the step from its generator): finite losses, and a run preempted after
    step 0 and resumed ends ``torch.equal`` to the straight run."""
    import yaml

    from semivl_tpu_torch.tools import train as cli
    monkeypatch.chdir(tmp_path)
    cfg = _loop_cfg(synth, method='unimatch',
                    labeled_photometric_distortion=True)
    cfg['strong_aug_on_device'] = True

    def run(extra, *args):
        with open('cfg.yaml', 'w') as f:
            yaml.dump(dict(cfg, **extra), f)
        return cli.main(['--config', 'cfg.yaml', '--device', 'cpu', *args])

    _, straight = run({})
    _, cut = run({'preempt_at_step': 0})
    _, resumed = run({}, '--resume-from', cut)
    assert resumed == cut

    def state(path):
        return torch.load(os.path.join(path, 'ckpt', 'latest'),
                          weights_only=True)

    a, b = state(straight), state(resumed)
    assert a['iteration'] == b['iteration'] == 4
    for k in a['model']:
        assert torch.equal(a['model'][k], b['model'][k]), k
    with open(os.path.join(straight, 'metrics.jsonl')) as f:
        losses = [v for line in f for k, v in json.loads(
            line).items() if k.startswith('train/loss')]
    assert losses and all(np.isfinite(losses))
