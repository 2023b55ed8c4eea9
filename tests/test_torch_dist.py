"""The port's data-parallel training and evaluation (``parallel.dist``, the
step's reductions, cross-rank BatchNorm, the loop's ranks, the strided
evaluation) on the CPU: ranks are processes launched as torchrun launches
them (``tests/torch_dist_worker.py``), gloo between them, against JAX's
``shard_map`` step on a 2-device CPU mesh (conftest's virtual devices).

Tolerances are those of the one-device parity tests: the step's loss terms
1e-4 relative, every trainable gradient and updated leaf 1e-3 of its own
scale (``step_mismatches``), the conv encoder's gradients 5e-2 and the
BatchNorm running statistics 1e-5 (tests/test_torch_cityscapes.py says
why); the Cityscapes step's gradients are held at the port's cross-rank
BatchNorm statistics, which are held to JAX's on their own (1e-5 mean,
5e-5 variance: the test says why). Between ranks, between two ranks on
the same rows and one process, and between a resumed run and an
uninterrupted one, everything is ``torch.equal``; histograms are
integer-equal.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from semivl_tpu.data.loader import ShardedLoader as JaxLoader
from semivl_tpu.evaluation import metrics as jax_metrics
from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator
from semivl_tpu.evaluation.predict import evaluate as jax_evaluate
from semivl_tpu_torch.configs import cityscapes_train_cfg, flagship_train_cfg
from semivl_tpu_torch.configs.experiments import config_from_vars
from semivl_tpu_torch.data.dataset import SemiDataset
from semivl_tpu_torch.data.loader import ShardedLoader
from semivl_tpu_torch.evaluation.predict import Evaluator, evaluate_histograms
from semivl_tpu_torch.parallel import dist
from semivl_tpu_torch.train.step import LOSS_KEYS

import torch_dist_worker
from synth_data import make_synth_dataset
from test_multihost import _is_connect_flake
from torch_parity import (ZEG_IMG, ZEG_NCLS, ZEG_OUT, confident_threshold,
                          jax_step_on_mesh, pseudo_label_thresholds,
                          rel_err, semivl_batch, step_mismatches,
                          text_embedding, tiny_train_vlm, tiny_vlm,
                          zegclip_batch, zegclip_step_mismatches,
                          zegclip_vlm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = 100


def launch(task, spec, out, **kw):
    """``torch_dist_worker.launch``, retrying gloo's connect timeouts."""
    return torch_dist_worker.launch(task, spec, out,
                                    retry_if=_is_connect_flake, **kw)


def _assert_ranks_equal(results, keys=('state',)):
    for key in keys:
        a = results[0][key]
        for other in results[1:]:
            assert a.keys() == other[key].keys()
            for k in a:
                assert torch.equal(a[k], other[key][k]), (key, k)


def _port_side(results, pm_before, trainable):
    r = results[0]
    return dict(pmetrics=r['metrics'],
                port_grads={n: (r['grads'][n].numpy() if n in r['grads']
                                else np.zeros(p.shape, np.float32))
                            for n, p in pm_before.items()
                            if n in trainable},
                before=pm_before,
                after={k: v.numpy() for k, v in r['state'].items()},
                trainable=trainable)


def _losses_match(jm, pm, extra=('grad_norm',)):
    assert set(LOSS_KEYS) | {'grad_norm', 'preempt_count'} == set(pm)
    assert pm['preempt_count'] == 0.0
    for k in LOSS_KEYS + tuple(extra):
        assert np.isfinite(pm[k]), k
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])


# ------------------------------------------------- (1) the VOC step

@pytest.fixture(scope='module')
def voc_pair(tmp_path_factory):
    """The flagship-shaped tiny VLM: one step on two gloo ranks (one row
    of the 2 + 2 batch each) and JAX's step on a 2-device mesh."""
    jm, params, pm, mcc = tiny_train_vlm(seed=3, logit_scale=30.0)
    text = text_embedding()
    batch = semivl_batch(7, 2)
    conf_thresh, mcc_thresh = pseudo_label_thresholds(pm, text, mcc, batch)
    cfg = dict(flagship_train_cfg(64), conf_thresh=conf_thresh,
               mcc_conf_thresh=mcc_thresh, log_grad_norm=True)
    rs = np.random.RandomState(8)
    keeps = [rs.rand(2, 1, 1, c) < 0.5 for c in (128, 128, 512)]
    want = jax_step_on_mesh(jm, params, mcc, text, batch, cfg, keeps, TOTAL,
                            n_devices=2)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    trainable = {n: p.requires_grad for n, p in pm.named_parameters()}
    got = launch('step', dict(model=pm, text=text, mcc=mcc, cfg=cfg,
                              batch=batch, keeps=keeps, total=TOTAL),
                 str(tmp_path_factory.mktemp('voc_step')))
    return want, got, before, trainable


def test_voc_step_on_two_ranks_matches_jax_mesh_losses(voc_pair):
    """The rank-averaged loss terms and the global gradient norm (after
    the mean) against JAX's ``pmean``-ed metrics; every rank reads the
    same, and no rank was preempted."""
    want, got, _, _ = voc_pair
    _losses_match(want['jmetrics'], got[0]['metrics'])
    assert got[0]['metrics'] == got[1]['metrics']
    for k in ('loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1', 'loss_mc_fp'):
        assert got[0]['metrics'][k] > 0, k


def test_voc_step_on_two_ranks_matches_jax_mesh_grads(voc_pair):
    """Only trainable leaves carry gradients; their rank mean and the
    update against JAX's (``step_mismatches``); the ranks' states and
    gradients ``torch.equal``."""
    want, got, before, trainable = voc_pair
    _assert_ranks_equal(got, ('state', 'grads'))
    assert all(trainable[n] for n in got[0]['grads'])
    s = dict(want, **_port_side(got, before, trainable))
    s['port_grads'].update({n: np.zeros(before[n].shape, np.float32)
                            for n, t in trainable.items() if not t})
    bad, n_checked = step_mismatches(s)
    assert bad == [] and n_checked > 20


# ------------------------------------ (2) the Cityscapes step, SyncBN

@pytest.fixture(scope='module')
def cityscapes_pair(tmp_path_factory):
    """The exp-44 tiny model (ResNetV1c skip encoder, BatchNorm in train
    mode): one step on two gloo ranks (1 + 1 crops each); JAX's step on a
    2-device mesh, whose BatchNorm takes ``axis_name='data'``; and that
    step again with the values of its BatchNorm statistics replaced by
    the port's (their gradients JAX's own)."""
    from test_torch_cityscapes import (CLIP_DIM, EMB, IMG, NCLS, _batch,
                                       _label_margins, _models, _unit)
    jm, params, stats, pm, mcc = _models(seed=3)
    text = _unit(NCLS, CLIP_DIM, 6)
    one, two = _batch(7), _batch(10)
    batch = {k: np.concatenate([one[k], two[k]]) for k in one}
    rs = np.random.RandomState(8)
    keeps = [rs.rand(2, 1, 1, c) < 0.5 for c in (EMB, CLIP_DIM, 256)]
    # the margins over the global batch (train-mode BatchNorm there takes
    # the statistics the two ranks share); the second crop's seed is the
    # first after 7 whose labels sit at no near-tie
    mcc_thresh = _label_margins(pm, text, mcc, batch, keeps)
    cfg = dict(cityscapes_train_cfg(IMG), mcc_conf_thresh=mcc_thresh,
               log_grad_norm=True)
    want = jax_step_on_mesh(jm, params, mcc, text, batch, cfg, keeps, TOTAL,
                            n_devices=2, stats=stats)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    trainable = {n: p.requires_grad for n, p in pm.named_parameters()}
    spec = dict(model=pm, text=text, mcc=mcc, cfg=cfg, batch=batch,
                keeps=keeps, total=TOTAL)
    got = launch('step', spec, str(tmp_path_factory.mktemp('cs_step')))
    held = jax_step_on_mesh(jm, params, mcc, text, batch, cfg, keeps, TOTAL,
                            n_devices=2, stats=stats,
                            bn_batch_stats=got[0]['bn_batch_stats'])
    return want, held, got, before, trainable, spec


def test_cityscapes_step_on_two_ranks_matches_jax_mesh_losses(
        cityscapes_pair):
    """The rank-averaged loss terms against JAX's 2-device step; the
    ranks read the same metrics, ``grad_norm`` that of the averaged
    gradients."""
    want, _, got, _, _, _ = cityscapes_pair
    _losses_match(want['jmetrics'], got[0]['metrics'], extra=())
    assert got[0]['metrics'] == got[1]['metrics']
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in got[0]['grads'].values()]))
    assert abs(got[0]['metrics']['grad_norm'] - float(norm)) <= 1e-6 * norm


def test_cityscapes_step_on_two_ranks_matches_jax_mesh_grads_and_stats(
        cityscapes_pair):
    """Cross-rank BatchNorm. Its statistics: each train-mode call's mean
    and variance, the same on both ranks, within 1e-5 and 5e-5 of JAX's
    ``pmean``-ed ones (float32 sums in another order; the variance
    E[x^2] - E[x]^2 loses up to 30x of that to cancellation, as in the
    fixture's 64-channel stem), and the running statistics after both
    student passes within 1e-5. Its backward and the rest of the step:
    every trainable gradient and update against JAX's 2-device step at
    the port's values of the statistics (JAX's transpose of ``pmean``
    carries their gradients), within the one-device test's limits: the
    conv encoder's gradients 5e-2 (median 1e-2), the rest 1e-3.

    Why at the port's values: the two frameworks' statistics differ by up
    to 2e-6 of their scale, which moves this model's logits (scale 21) by
    about 5e-5, and pixels of rank 0's weak view keep pseudo-label margins
    of 2.5e-5: such a pseudo-label flips between the two forwards, and
    rank 0's decoder gradients move with it by up to 2e-2 (measured on
    this fixture: JAX's step on rank 0's crop at its own statistics
    against the same step at the port's). No seed of the second crop up
    to 39 keeps every weak-view margin above 2e-4."""
    want, held, got, before, trainable, _ = cityscapes_pair
    _assert_ranks_equal(got, ('state', 'grads'))
    assert len(got[0]['bn_batch_stats']) == len(want['bn_batch_stats']) == 26
    for (m, v), (m1, v1), (jm_, jv) in zip(got[0]['bn_batch_stats'],
                                           got[1]['bn_batch_stats'],
                                           want['bn_batch_stats']):
        assert np.array_equal(m, m1) and np.array_equal(v, v1)
        assert rel_err(m, jm_) < 1e-5 and rel_err(v, jv) < 5e-5
    after = {k: v.numpy() for k, v in got[0]['state'].items()}
    top = max(np.abs(g).max() for g in held['jax_grads'].values())
    bad, encoder = [], []
    for name, t in trainable.items():
        if not t:
            np.testing.assert_array_equal(after[name], before[name].numpy())
            continue
        in_encoder = name.startswith('conv_encoder')
        want_g = held['jax_grads'][name]
        got_g = (got[0]['grads'][name].numpy() if name in got[0]['grads']
                 else np.zeros_like(want_g))
        if in_encoder:
            encoder.append(rel_err(got_g, want_g))
        if np.abs(want_g).max() <= 1e-6 * top:
            if np.abs(got_g).max() > 1e-6 * top:
                bad.append((name, 'vanishing'))
        elif rel_err(got_g, want_g) > (5e-2 if in_encoder else 1e-3):
            bad.append((name, 'grad', rel_err(got_g, want_g)))
        if rel_err(after[name], held['jax_new'][name]) > 1e-3:
            bad.append((name, 'update', rel_err(after[name],
                                                held['jax_new'][name])))
    running = [k for k in after if k.endswith(('running_mean',
                                               'running_var'))]
    for k in running:
        if rel_err(after[k], want['jax_new'][k]) > 1e-5:
            bad.append((k, 'stats', rel_err(after[k], want['jax_new'][k])))
        assert not np.array_equal(after[k], before[k].numpy()), k
    assert bad == [] and len(running) == 26 and len(encoder) == 39
    assert sorted(encoder)[len(encoder) // 2] < 1e-2


def test_mean_over_ranks_transposes_as_jax_pmean(tmp_path):
    """BatchNorm's cross-rank mean and its backward against JAX's
    ``pmean`` under ``shard_map(check_vma=False)``: per-rank losses
    c_r * mean(x) give every rank the gradient mean(c), on both sides."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    x = np.array([[1.0, 2.0, 3.0], [5.0, 7.0, 11.0]], np.float32)
    c = np.array([[1.0, 2.0, 3.0], [3.0, 2.0, -1.0]], np.float32)

    def per_device(x, c):
        return jax.grad(lambda x: (jax.lax.pmean(x, 'data') * c).sum())(x)

    mesh = Mesh(np.array(jax.devices()[:2]), ('data',))
    want = np.asarray(jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=(P('data'), P('data')),
        out_specs=P('data'), check_vma=False))(x, c))
    got = launch('probe', dict(x=x.tolist(), c=c.tolist()), str(tmp_path))
    np.testing.assert_array_equal(want, np.tile(c.mean(0), (2, 1)))
    for r in (0, 1):
        np.testing.assert_array_equal(got[r]['grad'].numpy(), want[r])


def test_cityscapes_duplicate_ranks_equal_one_process(cityscapes_pair,
                                                      tmp_path):
    """Two ranks that each hold the same two crops take the step that one
    process takes on them, bit for bit: cross-rank statistics equal to
    one rank's, their backward's cotangent mean, the gradient mean of two
    equal gradients and the metrics' mean all leave it as it is."""
    spec = cityscapes_pair[-1]
    two = {k: np.concatenate([v, v]) for k, v in spec['batch'].items()}
    keeps = [np.concatenate([k, k]) for k in spec['keeps']]
    ranks = launch('step', dict(spec, batch=two, keeps=keeps),
                   str(tmp_path / 'two'))
    [alone] = launch('step', spec, str(tmp_path / 'one'), world=1,
                     torchrun=False)
    for r in ranks:
        for key in ('state', 'grads'):
            assert r[key].keys() == alone[key].keys()
            for k in r[key]:
                assert torch.equal(r[key][k], alone[key][k]), (key, k)
        assert {k: v for k, v in r['metrics'].items()
                if k != 'preempt_count'} == alone['metrics']


# ---------------------------------- (2b) exp 41's ZegCLIP step, mmseg

@pytest.fixture(scope='module')
def zegclip_pair(tmp_path_factory):
    """The small ZegCLIP VLM under exp 41's generated config ('mmseg' for
    both criteria: SegLossPlus, whose mask count JAX averages over the
    devices, and the unlabeled terms scaled by each device's own kept
    fraction): one step on two gloo ranks (one row of the 2 + 2 batch
    each) and JAX's step on a 2-device mesh. Rank 0's labels hold 2 of the
    5 classes, rank 1's all 5; the pseudo-labels' kept fractions differ by
    rank too, so a summed count or a global fraction would not match."""
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    jm, params, pm, text = zegclip_vlm(seed=5, logit_scale=100.0)
    batch = zegclip_batch(8)
    batch['mask_x'][0] = np.where(batch['mask_x'][0] == 255, 255,
                                  batch['mask_x'][0] % 2)
    keeps = [np.random.RandomState(8).rand(2, 1, 1, ZEG_OUT) < 0.5]
    cfg = next(c for c in generate_experiment_cfgs(41)
               if 'zegclip' in c['model'])
    cfg = dict(cfg, crop_size=ZEG_IMG, nclass=ZEG_NCLS, log_grad_norm=True,
               conf_thresh=confident_threshold(pm, text, batch, keeps))
    want = jax_step_on_mesh(jm, params, None, text, batch, cfg, keeps, TOTAL,
                            n_devices=2, exclude_keys=['prompt'])
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    trainable = {n: p.requires_grad for n, p in pm.named_parameters()}
    with torch.no_grad():   # each rank's kept fraction of loss_fp
        pred_w = pm(torch.from_numpy(np.concatenate(
            [batch['img_x'], batch['img_w']])), torch.from_numpy(text))[2:]
    conf = torch.softmax(pred_w, 1).amax(1).numpy()
    valid = batch['ignore_mask'] != 255
    kept = [((conf[r] >= cfg['conf_thresh']) & valid[r]).sum()
            / valid[r].sum() for r in range(2)]
    present = [len(set(np.unique(batch['mask_x'][r])) - {255})
               for r in range(2)]
    got = launch('step', dict(model=pm, text=text, mcc=None, cfg=cfg,
                              batch=batch, keeps=keeps, total=TOTAL),
                 str(tmp_path_factory.mktemp('zegclip_step')))
    return want, got, before, trainable, cfg, kept, present


def test_zegclip_step_on_two_ranks_matches_jax_mesh(zegclip_pair):
    """The ranks' present-class counts (2 and 5) and kept fractions differ;
    the rank-averaged loss terms and the gradient norm within 1e-4 of
    JAX's 2-device step; the ranks' states and gradients ``torch.equal``;
    every trainable leaf's averaged gradient and update against JAX's
    within 1e-3 (``zegclip_step_mismatches``: the leaves whose gradient is
    zero in exact arithmetic held to a first AdamW step), the rest of the
    backbone unchanged."""
    want, got, before, trainable, cfg, kept, present = zegclip_pair
    assert present == [2, 5]
    assert 0 < min(kept) and abs(kept[0] - kept[1]) > 0.01, kept
    jm, pm = want['jmetrics'], got[0]['metrics']
    keys = ('loss_x', 'loss_s1', 'loss_s2', 'loss_fp', 'loss_all',
            'grad_norm')
    assert set(pm) == set(keys) | {'preempt_count'}
    assert pm['preempt_count'] == 0.0
    for k in keys:
        assert np.isfinite(pm[k]), k
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp'):
        assert pm[k] > 0, k
    assert got[0]['metrics'] == got[1]['metrics']
    _assert_ranks_equal(got, ('state', 'grads'))
    s = dict(want, **_port_side(got, before, trainable))
    s['port_grads'].update({n: np.zeros(before[n].shape, np.float32)
                            for n, t in trainable.items() if not t})
    bad, n_checked, _, unreached = zegclip_step_mismatches(s, cfg)
    assert bad == [] and n_checked == 40 and len(unreached) == 12


# ----------------------------------------------------- (3) loader shards

@pytest.mark.parametrize('pair', [False, True])
def test_loader_shards_match_jax_rows(tmp_path, pair):
    """Each rank's batches (``process_index=rank, process_count=2``) are
    the matching rows of JAX's one-process global batches at ``world=2``,
    over two epochs, a resumed epoch included."""
    root = str(tmp_path)
    paths = make_synth_dataset(root, n_labeled=2, n_unlabeled=5, n_val=1,
                               size=(72, 88))
    cfg = dict(dataset='pascal', data_root=root, crop_size=64, nclass=21)
    from semivl_tpu.data.dataset import SemiDataset as JaxDataset
    mode, ids = ('train_u', paths['unlabeled']) if pair else (
        'train_l', paths['labeled'])
    kw = dict(nsample=5) if not pair else {}
    ds, jds = (cls(cfg, mode, id_path=ids, seed=3, **kw)
               for cls in (SemiDataset, JaxDataset))
    for epoch, start in ((0, 0), (1, 1)):
        want = list(JaxLoader(jds, 1, 2, seed=3, pair=pair).epoch(
            epoch, start_step=start))
        for rank in (0, 1):
            got = list(ShardedLoader(ds, 1, 2, seed=3, pair=pair,
                                     process_index=rank, process_count=2)
                       .epoch(epoch, start_step=start))
            assert len(got) == len(want) == 3 - start
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    rows = w[k][rank:rank + 1]
                    if isinstance(g[k], list):
                        assert g[k] == list(rows), k
                    else:
                        assert np.array_equal(g[k], rows), k


# ---------------------------------------------- (4) strided evaluation

def test_strided_evaluation_matches_one_rank_and_jax(tmp_path):
    """Two ranks, each its stride of test_torch_eval's five images (one on
    the host route), sum integer histograms equal to the one-rank
    ``evaluate_histograms`` and to those JAX's ``evaluate`` sums on the
    same weights; each rank saw its own stride."""
    from test_torch_eval import _SplitDS
    jm, params, pm = tiny_vlm(seed=11)
    text = text_embedding()
    cfg = dict(nclass=21, crop_size=64, stride=48,
               eval_mode='zegclip_sliding_window')
    items = [(s['img'], s['mask'])
             for s in map(_SplitDS().get, range(len(_SplitDS())))]
    got = launch('eval', dict(model=pm, text=text, cfg=cfg, items=items),
                 str(tmp_path / 'eval'))
    assert [r['images'] for r in got] == [[0, 2, 4], [1, 3]]
    one = evaluate_histograms(Evaluator(pm, text, cfg, device='cpu'),
                              _SplitDS(), cfg['eval_mode'], cfg)
    seen = []
    real = jax_metrics.miou_from_histograms
    with mock.patch.object(jax_metrics, 'miou_from_histograms',
                           lambda i, u: seen.append((i, u)) or real(i, u)):
        jax_evaluate(JaxEvaluator(jm, {'params': params}, text, cfg),
                     _SplitDS(), cfg['eval_mode'], cfg)
    for r in got:
        for a, b, j in zip((r['inter'], r['union']), one, seen[0]):
            assert a.dtype == np.int64 and np.array_equal(a, b)
            assert np.array_equal(a, np.asarray(j).astype(np.int64))
    assert one[1].sum() > 0


def test_strided_evaluation_refuses_indices():
    """Given ``indices`` and ``process_count`` > 1 every rank would count
    those images and the ranks' sum would count them ``process_count``
    times: refused by name before any image is read."""
    with pytest.raises(ValueError, match='indices'):
        evaluate_histograms(None, [], 'zegclip_sliding_window',
                            dict(nclass=21), indices=[0], process_index=0,
                            process_count=2)


# ------------------------------------------------------- (5) the loop

@pytest.fixture(scope='module')
def loop_cfg(tmp_path_factory):
    """Exp 40's structure on the tiny VLM: batch 1 a rank, 4 unlabeled
    images (2 steps an epoch on 2 ranks), 2 epochs, an evaluation each
    epoch, the preemption flags read every step."""
    root = str(tmp_path_factory.mktemp('distloop'))
    paths = make_synth_dataset(root, n_labeled=2, n_unlabeled=4, n_val=3,
                               size=(72, 88))
    cfg = config_from_vars(
        exp_id=99, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=2, img_scale=None, criterion='CELoss', criterion_u='CELoss',
        maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
        mcc_text='concept4_single', mcc_loss_reduce='mean_all',
        eval_mode='zegclip_sliding_window')
    cfg = dict(cfg, model='mmseg.tiny-vlm-test', stride=48,
               clip_encoder='tiny-mcvit-test', data_root=root,
               labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'], preempt_check_every=1)
    cfg.pop('img_scale', None)
    return cfg


@pytest.fixture(scope='module')
def loop_runs(loop_cfg, tmp_path_factory):
    """Three two-rank runs in one working directory: straight; rank 0
    alone preempted at step 0; that run resumed."""
    work = str(tmp_path_factory.mktemp('distloop_runs'))
    straight = launch('loop', dict(cfg=loop_cfg), os.path.join(work, 'a'),
                      cwd=work)
    cut = launch('loop', dict(cfgs=[dict(loop_cfg, preempt_at_step=0),
                                    loop_cfg]),
                 os.path.join(work, 'b'), cwd=work)
    resumed = launch('loop', dict(cfg=loop_cfg, resume_from=cut[0]['path']),
                     os.path.join(work, 'c'), cwd=work)
    return work, straight, cut, resumed


def test_two_rank_loop_writes_one_run_dir_from_rank_0(loop_runs):
    """Both ranks name one run dir (rank 0's name); the metric stream, the
    code archive, the debug grid and every checkpoint save come from rank
    0 alone; ``all_args.yaml`` records the world."""
    work, straight, cut, _ = loop_runs
    runs = sorted(os.listdir(os.path.join(work, 'exp', 'exp-99')))
    assert len(runs) == 2   # the straight and the preempted run
    for result in (straight, cut):
        assert result[0]['path'] == result[1]['path']
        assert result[0]['world'] == result[1]['world'] == 2
        w0, w1 = result[0]['writes'], result[1]['writes']
        assert all(v == 0 for v in w1.values()), w1
        assert w0['metric_writer'] == w0['code_archive'] == 1
    assert straight[0]['writes']['ckpt_save'] >= 2
    path = os.path.join(work, straight[0]['path'])
    for name in ('all_args.yaml', 'config.yaml', 'metrics.jsonl',
                 'debug.log', 'ckpt/latest', 'ckpt/best'):
        assert os.path.isfile(os.path.join(path, name)), name
    with open(os.path.join(path, 'all_args.yaml')) as f:
        assert yaml.load(f, Loader=yaml.Loader)['n_devices'] == 2
    _assert_ranks_equal(straight, ('state',))
    assert straight[0]['iteration'] == 4


def test_two_rank_preempt_stops_every_rank_at_one_step(loop_runs):
    """Rank 0 alone is preempted at step 0: the summed flag stops both
    ranks after that step, rank 0 saving one mid-epoch ``latest``, which
    the resumed run starts from."""
    work, _, cut, _ = loop_runs
    assert cut[0]['iteration'] == cut[1]['iteration'] == 1
    _assert_ranks_equal(cut, ('state',))
    assert cut[0]['writes']['ckpt_save'] == 1
    with open(os.path.join(work, cut[0]['path'], 'debug.log')) as f:
        assert 'Resumed at epoch 0, epoch step 1' in f.read()


def test_two_rank_resume_equals_uninterrupted(loop_runs):
    """The preempted run, resumed on two ranks, ends ``torch.equal`` to
    the straight run: parameters, optimizer state, iteration, on both
    ranks and in the checkpoint."""
    work, straight, _, resumed = loop_runs
    assert resumed[0]['iteration'] == resumed[1]['iteration'] == 4
    for r in (0, 1):
        a, b = straight[r], resumed[r]
        for k in a['state']:
            assert torch.equal(a['state'][k], b['state'][k]), k
        sa, sb = a['optimizer']['state'], b['optimizer']['state']
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert resumed[0]['best'] == straight[0]['best']


def test_two_rank_preempt_waits_for_the_check_cadence(loop_cfg, tmp_path):
    """With ``preempt_check_every=2``, rank 0 alone preempted at step 1:
    the ranks read the summed flags at steps 0 and 2 only, so both stop
    after step 2, the first multiple of the cadence at or after the
    flag."""
    cfg = dict(loop_cfg, preempt_check_every=2, debug_images=False)
    cut = launch('loop', dict(cfgs=[dict(cfg, preempt_at_step=1), cfg]),
                 str(tmp_path / 'run'), cwd=str(tmp_path))
    assert cut[0]['iteration'] == cut[1]['iteration'] == 3
    assert cut[0]['path'] == cut[1]['path']
    _assert_ranks_equal(cut, ('state',))
    with open(os.path.join(str(tmp_path), cut[0]['path'], 'ckpt',
                           'latest.extra.json')) as f:
        assert json.load(f)['epoch_step'] == 1   # step 2: epoch 1, step 0


def test_one_rank_group_equals_no_group(loop_cfg, tmp_path):
    """``WORLD_SIZE=1`` (``torchrun --nproc-per-node 1``) makes a process
    group of one, and its run, reductions included, is ``torch.equal`` to
    the run without one; ``respect_n_gpus`` with ``n_gpus=4`` takes a world
    of 1, as JAX takes ``min(devices, n_gpus)``."""
    cfg = dict(loop_cfg, respect_n_gpus=True, n_gpus=4, epochs=1,
               debug_images=False)
    spec = dict(cfg=cfg, max_iters=2)
    grouped = launch('loop', spec, str(tmp_path / 'one'), world=1)[0]
    alone = launch('loop', spec, str(tmp_path / 'alone'), world=1,
                   torchrun=False)[0]
    assert (grouped['world'], alone['world']) == (1, 1)
    assert grouped['iteration'] == alone['iteration'] == 2
    for k, v in alone['state'].items():
        assert torch.equal(grouped['state'][k], v), k


# ------------------------------------------------ (6) the refusals

@pytest.mark.parametrize('env,cfg,error,words', [
    (dict(WORLD_SIZE='8', RANK='0', MASTER_ADDR='localhost',
          MASTER_PORT='1'), dict(respect_n_gpus=True, n_gpus=4), ValueError,
     'respect_n_gpus'),
    (dict(WORLD_SIZE='2', RANK='0', MASTER_PORT='1'), None, RuntimeError,
     'MASTER_ADDR')])
def test_setup_distributed_refuses_by_name(monkeypatch, env, cfg, error,
                                           words):
    """A world larger than ``respect_n_gpus`` allows, and a torchrun
    environment without ``MASTER_ADDR``, raise by name before any group is
    made."""
    for k in dist.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error, match=words):
        dist.setup_distributed(cfg, device='cpu')
    assert not dist.active()


# ------------------------------------------------------ (7) the dry run

def test_dryrun_multichip_two_ranks(tmp_path):
    """``tools/dryrun_multichip.py`` at 2 ranks: one flagship step at crop
    64, an evaluation forward on each rank's share, a checkpoint round
    trip, one ``ok`` line."""
    env = {k: v for k, v in os.environ.items() if k not in dist.ENV_KEYS}
    out = subprocess.run(
        [sys.executable, '-m', 'semivl_tpu_torch.tools.dryrun_multichip',
         '--ranks', '2', '--device', 'cpu'], cwd=str(tmp_path),
        capture_output=True, text=True,
        timeout=torch_dist_worker.RANK_TIMEOUT,
        env=dict(env, PYTHONPATH=ROOT, OMP_NUM_THREADS='2'))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith('dryrun_multichip(2): ok'), last
