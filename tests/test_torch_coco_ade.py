"""The paper's COCO (exp 42, 81 classes) and ADE20K (exp 43, 150 classes)
runs through the port against the JAX package on the CPU: the bundled split
lists and text embeddings, the generated configs and the run configs, the
datasets' samples (COCO: 640x480 JPEGs, masks 0-80 and 255; ADE: short
side 512, masks 0-150 with ``reduce_zero_label``), the VLG model at N = 81
and 150 (logits and gradients), one SemiVL step at N = 150, COCO's
small-image evaluation route at N = 81, and exp 43's config through the
trainer's CLI at tiny size, preempted and resumed.

Tolerances: the VLM's logits within the full-scale parity bound of
tests/test_torch_models.py (max 2e-3 of the logit scale, mean 2e-4), its
gradients and the step's within 1e-3 of each leaf's scale and the step's
loss terms 1e-4 relative (tests/test_torch_train.py); samples, assets and
configs exactly; predictions identical but at near-ties of the JAX logits
(1e-4, tests/test_torch_eval.py).
"""

import filecmp
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from semivl_tpu.configs import experiments as jax_experiments
from semivl_tpu.data.dataset import SemiDataset as JaxSemiDataset
from semivl_tpu.data.dataset import split_path as jax_split_path
from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator
from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu.text.embeddings import text_embedding_path as jax_text_path
from semivl_tpu_torch.configs import (ade_cfg, ade_train_cfg, coco_cfg,
                                      coco_train_cfg, experiments)
from semivl_tpu_torch.convert import load_jax_params, vlm_state_dict
from semivl_tpu_torch.data.dataset import SemiDataset, split_path
from semivl_tpu_torch.evaluation.predict import Evaluator
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.text.embeddings import (load_text_embedding,
                                              text_embedding_path)
from semivl_tpu_torch.train import loop

from synth_data import make_synth_dataset
from torch_parity import (BACKBONE, HEAD, SharedReluMasks, init_params,
                          pseudo_label_thresholds, rel_err,
                          resolved_step_mismatches, semivl_batch,
                          semivl_step_pair, tiny_train_vlm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, TOTAL = 64, 100
NCLASS = {42: 81, 43: 150}
DATASET = {42: 'coco', 43: 'ade'}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------- assets

@pytest.mark.parametrize('dataset', ['coco', 'ade'])
def test_split_lists_and_text_match_jax(dataset):
    """The port's copies of the dataset's split lists (every split's lists
    and val.txt) and of its ``single`` text embedding are byte-equal to the
    JAX package's; the embedding has a row per class."""
    mine = os.path.dirname(split_path(dataset, None, 'val'))
    ref = os.path.dirname(jax_split_path(dataset, None, 'val'))
    cmp = filecmp.dircmp(mine, ref, ignore=['__pycache__'])
    assert cmp.left_only == cmp.right_only == [] and cmp.diff_files == []
    n_files = 0
    for split in sorted(cmp.common_dirs):
        sub = cmp.subdirs[split]
        assert sub.left_only == sub.right_only == sub.diff_files == []
        for f in sub.common_files:
            assert filecmp.cmp(os.path.join(mine, split, f),
                               os.path.join(ref, split, f), shallow=False)
            n_files += 1
    assert filecmp.cmp(os.path.join(mine, 'val.txt'),
                       os.path.join(ref, 'val.txt'), shallow=False)
    assert n_files == {'coco': 5, 'ade': 10}[dataset]
    path = text_embedding_path(dataset, 'single')
    assert filecmp.cmp(path, jax_text_path(dataset, 'single'), shallow=False)
    emb = load_text_embedding(path)
    assert emb.shape == ({'coco': 81, 'ade': 150}[dataset], 512)


# -------------------------------------------------------------- configs

@pytest.mark.parametrize('exp_id', [41, 42, 43])
def test_generated_configs_and_yaml_match_jax(exp_id, tmp_path):
    """The grid equals JAX's, its YAML files are byte-equal to JAX's, and
    ``tools.experiments --exp N --list`` writes them."""
    cfgs = experiments.generate_experiment_cfgs(exp_id)
    assert cfgs == jax_experiments.generate_experiment_cfgs(exp_id)
    _, files = experiments.save_experiment_cfgs(exp_id, str(tmp_path / 'a'))
    _, jfiles = jax_experiments.save_experiment_cfgs(exp_id,
                                                     str(tmp_path / 'b'))
    for a, b in zip(files, jfiles):
        assert os.path.basename(a) == os.path.basename(b)
        assert filecmp.cmp(a, b, shallow=False)
    out = subprocess.run(
        [sys.executable, '-m', 'semivl_tpu_torch.tools.experiments',
         '--exp', str(exp_id), '--list'], cwd=tmp_path, check=True,
        capture_output=True, text=True,
        env={**os.environ, 'PYTHONPATH': ROOT}).stdout
    assert len(out.splitlines()) == len(cfgs) == {41: 12, 42: 5, 43: 5}[
        exp_id]
    assert sorted(os.listdir(tmp_path / 'configs' / 'generated'
                             / f'exp-{exp_id}')) == sorted(
        os.path.basename(f) for f in files)


@pytest.mark.parametrize('exp_id,make', [(42, coco_train_cfg),
                                         (43, ade_train_cfg)])
def test_run_configs_are_the_generated_values(exp_id, make):
    """``coco_train_cfg``/``ade_train_cfg`` (and the inference configs they
    extend) hold the generated configs' values for every key they set,
    but the port's own ``decoder_bwd`` (the whole-plane kernels)."""
    ref = make()
    for split_cfg in experiments.generate_experiment_cfgs(exp_id):
        for k, v in ref.items():
            if k == 'decoder_bwd':
                assert v == 'whole'
                continue
            got = split_cfg[k]
            if isinstance(v, (list, tuple)):
                v, got = list(v), list(got)
            assert got == v, (exp_id, k)
    infer = (coco_cfg if exp_id == 42 else ade_cfg)()
    assert {k: ref[k] for k in infer} == infer
    assert ref['nclass'] == NCLASS[exp_id] and ref['batch_size'] == 1
    assert ref.get('reduce_zero_label', False) == (exp_id == 43)


# ------------------------------------------------------------- datasets

def _write_geometry(root, exp_id, n=2, seed=0):
    """Synthetic images of the dataset's geometry in its list layout:
    COCO 640x480 JPEGs with masks 0-80 and 255, ADE images of short side
    512 with masks 0-150 (0 is "other"); returns the list path."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'img'), exist_ok=True)
    os.makedirs(os.path.join(root, 'mask'), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = (480, 640) if exp_id == 42 else (512, 683 + 40 * i)
        img = rs.randint(0, 256, (h, w, 3), np.uint8)
        mask = rs.randint(0, NCLASS[exp_id] + (exp_id == 43),
                          (h // 8, w // 8)).astype(np.uint8)
        mask = np.kron(mask, np.ones((8, 8), np.uint8))[:h, :w]
        if exp_id == 42:
            mask[:16, :16] = 255
        Image.fromarray(img).save(os.path.join(root, 'img', f'{i}.jpg'),
                                  quality=90)
        Image.fromarray(mask).save(os.path.join(root, 'mask', f'{i}.png'))
        lines.append(f'img/{i}.jpg mask/{i}.png')
    path = os.path.join(root, 'list.txt')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize('exp_id', [42, 43])
@pytest.mark.parametrize('mode', ['train_l', 'train_u', 'val'])
def test_samples_match_jax(exp_id, mode, tmp_path):
    """``SemiDataset`` under exp 42's / 43's generated config (COCO: no
    ``img_scale``; ADE: (2048, 512) and ``reduce_zero_label``), crop 512,
    every sample of two epochs equal to JAX's."""
    ids = _write_geometry(str(tmp_path), exp_id)
    cfg = dict(experiments.generate_experiment_cfgs(exp_id)[0],
               data_root=str(tmp_path))
    kw = dict(id_path=ids, seed=3)
    if mode == 'train_l':
        kw['nsample'] = 3
    ds, jds = SemiDataset(cfg, mode, **kw), JaxSemiDataset(cfg, mode, **kw)
    for epoch in (0, 1):
        for i in range(len(ds)):
            if mode == 'train_u':
                for a, b in zip(ds.get_pair(i, epoch), jds.get_pair(i, epoch)):
                    _equal(a, b)
            else:
                _equal(ds.get(i, epoch), jds.get(i, epoch))
    if mode == 'val':
        got = ds.get(0)['mask']
        if exp_id == 42:   # no resize: the label as written
            assert got.shape == (480, 640) and got.max() == 255
        else:              # 0 -> ignore, 1..150 -> 0..149
            assert got.min() == 0 and got.max() == 255
            assert set(np.unique(got)) <= set(range(150)) | {255}


def test_reduce_zero_label_on_every_label_matches_jax(tmp_path):
    """ADE's remap on a label map holding 0, each of 1-150 and 255: 0 and
    255 to 255, k to k - 1, as JAX's."""
    labels = np.concatenate([np.arange(151), [255]]).astype(np.uint8)
    mask = np.tile(labels, (4, 1))
    os.makedirs(tmp_path / 'd')
    Image.fromarray(np.zeros((4, 152, 3), np.uint8)).save(tmp_path / 'd' /
                                                          'i.png')
    Image.fromarray(mask).save(tmp_path / 'd' / 'm.png')
    with open(tmp_path / 'l.txt', 'w') as f:
        f.write('d/i.png d/m.png\n')
    cfg = dict(ade_cfg(), data_root=str(tmp_path), img_scale=None,
               eval_uint8_transport=True)
    got = SemiDataset(cfg, 'val', id_path=str(tmp_path / 'l.txt')).get(0)
    want = JaxSemiDataset(cfg, 'val', id_path=str(tmp_path / 'l.txt')).get(0)
    _equal(got, want)
    expect = np.concatenate([[255], np.arange(150), [255]])
    assert np.array_equal(got['mask'][0], expect)


# ------------------------------------------------------- the VLG model

def _vlm(nclass, seed):
    head = dict(HEAD, num_classes=nclass)
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=head)
    params = init_params(jm, seed, jnp.zeros((1, IMG, IMG, 3)),
                         jnp.zeros((nclass, 512)))
    pm = load_jax_params(VLM(BACKBONE, head), params).eval()
    return jm, params, pm


def _relu_flips(pm, jm, params, img, text):
    """ReLU inputs whose sign differs between the port's forward and JAX's
    (the head's ReLUs, in call order; NHWC read as NCHW): each would pass
    gradient on one side only. Returns their count per call."""
    import flax.linen as nn

    import semivl_tpu.models.vlg_head as jax_vlg
    mine, ref = [], []
    relu, jax_relu = torch.nn.functional.relu, nn.relu

    def record(x, *a, **k):
        mine.append(x.detach().numpy().copy())
        return relu(x, *a, **k)

    def record_jax(x):
        ref.append(np.asarray(x))
        return jax_relu(x)

    with mock.patch.object(torch.nn.functional, 'relu', record), \
            torch.no_grad():
        pm(_t(img), _t(text))
    with mock.patch.object(jax_vlg.nn, 'relu', record_jax), \
            jax.disable_jit():
        jm.apply({'params': params}, jnp.asarray(img), jnp.asarray(text))
    assert len(mine) == len(ref) > 10
    flips = []
    for a, b in zip(mine, ref):
        b = b.transpose(0, 3, 1, 2) if b.ndim == 4 else b
        assert a.shape == b.shape
        flips.append(int(((a > 0) != (b > 0)).sum()))
    return flips


@pytest.mark.parametrize('exp_id', [42, 43])
def test_vlg_model_at_81_and_150_classes_matches_jax(exp_id):
    """The flagship-shaped VLM on the dataset's own text (81 or 150 class
    planes a sample; the SemanticTransformer attends along 81 or 150
    classes): logits, and the gradients of a random projection of them in
    every parameter. The frameworks' float32 forwards differ by ~1e-6, so
    a ReLU input that close to zero can pass gradient on one side only,
    which moves every gradient upstream of it by ~1e-3 (one flip in stage
    2's last GroupNorm+ReLU does, found at 82 classes); the test first
    asserts that no ReLU of the head flips sign between the two forwards."""
    n = NCLASS[exp_id]
    jm, params, pm = _vlm(n, seed=5)
    text = load_text_embedding(text_embedding_path(DATASET[exp_id],
                                                   'single'))
    rs = np.random.RandomState(5)
    img = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    cot = rs.randn(2, n, IMG, IMG).astype(np.float32)
    assert sum(_relu_flips(pm, jm, params, img, text)) == 0

    def loss(p):
        out = jm.apply({'params': p}, jnp.asarray(img), jnp.asarray(text))
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got = pm(_t(img), _t(text))
    (got * _t(cot)).sum().backward()
    got = got.detach().numpy()
    assert got.shape == want.shape == (2, n, IMG, IMG)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() < 2e-3 * scale
    assert np.abs(got - want).mean() < 2e-4
    want_g = vlm_state_dict(jax.tree.map(np.asarray, grads))
    top = max(np.abs(g).max() for g in want_g.values())
    prm = dict(pm.named_parameters())
    assert set(want_g) == set(prm)
    for name, g in want_g.items():
        mine = prm[name].grad.numpy()
        if np.abs(g).max() <= 1e-6 * top:   # the head's bias (vanishing)
            assert np.abs(mine).max() <= 1e-6 * top, name
        else:
            assert rel_err(mine, g) < 1e-3, name


# ------------------------------------------------------ one whole step

@pytest.fixture(scope='module')
def ade_step_pair():
    """One exp-43 step (150 classes, the ``ade_single`` text for the
    decoder and the guidance labels) in JAX (1-device mesh) and in the
    port, from the same weights, batch (2 + 2 crops of 150-class labels),
    boxes and feature-perturbation masks, the VLG head's ReLUs passing
    gradient where JAX's do (``SharedReluMasks``)."""
    head = dict(HEAD, num_classes=150)
    jm, params, pm, mcc = tiny_train_vlm(seed=3, logit_scale=30.0, head=head,
                                         mcc_text=('ade', 'single'))
    text = load_text_embedding(text_embedding_path('ade', 'single'))
    batch = semivl_batch(7, 2, IMG, nclass=150)
    conf_thresh, mcc_thresh = pseudo_label_thresholds(pm, text, mcc, batch)
    cfg = dict(ade_train_cfg(IMG), conf_thresh=conf_thresh,
               mcc_conf_thresh=mcc_thresh, log_grad_norm=True)
    rs = np.random.RandomState(8)
    keeps = [rs.rand(2, 1, 1, c) < 0.5 for c in (128, 128, 512)]
    masks = SharedReluMasks()
    out = semivl_step_pair(jm, params, pm, mcc, text, batch, cfg, keeps,
                           TOTAL, relu_masks=masks)
    return dict(out, cfg=cfg, masks=masks)


def test_ade_step_matches_jax(ade_step_pair):
    """Loss terms within 1e-4; every ReLU input whose sign differs between
    the frameworks lies within 1e-5 of its call's scale of zero (a float32
    rounding, not a divergence); through JAX's ReLU masks every trainable
    leaf's gradient within 1e-3 of its scale, its updated value within
    1e-3 wherever that gradient fixes the first Adam step's sign
    (``resolved_step_mismatches``), frozen leaves unchanged."""
    s = ade_step_pair
    jm, pm = s['jmetrics'], s['pmetrics']
    assert set(jm) == set(pm)
    for k, v in pm.items():
        assert np.isfinite(v) and abs(v - jm[k]) <= 1e-4 * abs(jm[k]), k
    for k in ('loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1', 'loss_mc_fp'):
        assert pm[k] > 0, k
    assert max(s['masks'].flips, default=0.0) < 1e-5, s['masks'].flips
    bad, n_checked, _ = resolved_step_mismatches(s, s['cfg'])
    assert bad == [] and n_checked > 20


# ------------------------------------------- COCO's small-image route

def test_coco_small_image_route_matches_jax():
    """Exp 42 keeps val images at their size (``img_scale`` None), so one
    shorter than the crop takes the evaluator's host route (windows at
    their clipped size): 81 classes, a 48x100 image at crop 64, the
    predictions and IoU histograms as JAX's."""
    from semivl_tpu.evaluation import metrics as jax_metrics
    from semivl_tpu_torch.evaluation import metrics
    jm, params, pm = _vlm(81, seed=11)
    text = load_text_embedding(text_embedding_path('coco', 'single'))
    cfg = dict(coco_cfg(IMG), stride=48)
    jev = JaxEvaluator(jm, {'params': params}, text, cfg)
    ev = Evaluator(pm, text, cfg, device='cpu')
    hw = (48, 100)
    img = (np.random.RandomState(1).rand(1, *hw, 3) * 255).astype(np.uint8)
    assert not ev.use_device(img, 'zegclip_sliding_window')
    with mock.patch.object(ev, '_zegclip_sliding',
                           wraps=ev._zegclip_sliding) as host:
        got = ev.predict(img, hw, 'zegclip_sliding_window')
    assert host.call_count == 1
    want, logits = jev.predict(img, hw, 'zegclip_sliding_window',
                               return_logits=True)
    top2 = np.sort(logits[0], axis=0)[-2:]
    tie = (top2[1] - top2[0]) < 1e-4
    assert got.shape == want.shape == (1,) + hw
    assert ((got == want) | tie[None]).all() and tie.mean() < 0.1
    mask = np.random.RandomState(2).randint(0, 81, hw)
    mask[:4] = 255
    for a, b in zip(metrics.intersection_and_union(got[0], mask, 81),
                    jax_metrics.intersection_and_union(want[0], mask, 81)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- the trainer's CLI

@pytest.fixture
def no_tensorboard(monkeypatch):
    """The metric stream without TensorBoard, whose import takes seconds."""
    monkeypatch.setattr(loop, 'MetricWriter', functools.partial(
        loop.MetricWriter, use_tensorboard=False))


def _state(path):
    return torch.load(os.path.join(path, 'ckpt', 'latest'),
                      weights_only=True)


def test_exp43_cli_preempted_and_resumed(tmp_path, monkeypatch,
                                         no_tensorboard):
    """Exp 43's generated config (ADE: 150 classes, ``reduce_zero_label``,
    the ``ade_single`` text for the decoder and the guidance labels)
    through the CLI on the CPU, cut to the tiny VLM and a fixture with
    labels 0-150: two steps and an evaluation; then a run preempted after
    its first step and resumed (``--resume-from``) ends ``torch.equal`` to
    the uninterrupted one, parameters, optimizer state and iteration."""
    from semivl_tpu_torch.tools import train as cli
    monkeypatch.chdir(tmp_path)
    paths = make_synth_dataset(str(tmp_path / 'ade'), n_labeled=1,
                               n_unlabeled=2, n_val=1, num_classes=151,
                               size=(72, 88))
    cfg = dict(experiments.generate_experiment_cfgs(43)[0],
               model='mmseg.tiny-vlm-test', crop_size=IMG, stride=48,
               clip_encoder='tiny-mcvit-test', data_root=str(tmp_path / 'ade'),
               labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'], img_scale=None, epochs=1,
               debug_images=False)
    assert cfg['nclass'] == 150 and cfg['reduce_zero_label']
    for name, extra in (('straight', {}), ('cut', {'preempt_at_step': 0})):
        with open(f'{name}.yaml', 'w') as f:
            yaml.dump(dict(cfg, **extra), f)
    _, straight = cli.main(['--config', 'straight.yaml', '--device', 'cpu'])
    _, cut = cli.main(['--config', 'cut.yaml', '--device', 'cpu'])
    assert _state(cut)['iteration'] == 1
    cli.main(['--config', 'straight.yaml', '--device', 'cpu',
              '--resume-from', cut])
    a, b = _state(straight), _state(cut)
    assert a['iteration'] == b['iteration'] == 2
    for k in a['model']:
        assert torch.equal(a['model'][k], b['model'][k]), k
    for i in a['optimizer']['state']:
        for k in a['optimizer']['state'][i]:
            assert torch.equal(a['optimizer']['state'][i][k],
                               b['optimizer']['state'][i][k]), (i, k)
    with open(os.path.join(straight, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert any('eval/mIoU' in r for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
