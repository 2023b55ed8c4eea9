"""The port's CPU-scale demos (``tools.semi_effect_demo``,
``tools.pseudo_label_quality``) against JAX's on the CPU: the blob data
byte for byte, ``_precision_coverage``, ``_dilate4``, ``unseen_class_iou``
(which reads the run's dataset in the port), one guidance-pretraining
step on the same weights and crops, and one tiny run of each demo through
the port's trainer, its output parsed.

Tolerances: the data and the numpy metrics exactly; the pretraining
step's loss 1e-5 relative and its gradients 1e-4 of each leaf's scale
(float32 through two ViT blocks), its Adam update 1e-3 of the scale where
the gradient fixes the step's sign (the first Adam step is lr x sign(g))."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from semivl_tpu.configs.models import get_model_config as jax_model_config
from semivl_tpu.models.builder import build_backbone as jax_build_backbone
from semivl_tpu.tools import pseudo_label_quality as jplq
from semivl_tpu.tools import semi_effect_demo as jdemo
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs.models import get_model_config
from semivl_tpu_torch.models.vlm import build_backbone
from semivl_tpu_torch.tools import pseudo_label_quality as plq
from semivl_tpu_torch.tools import semi_effect_demo as demo
from semivl_tpu_torch.train import loop

from torch_parity import init_params, rel_err
from torch_parity import few_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The demos' runs write their metric stream without TensorBoard,
    whose import takes seconds."""
    monkeypatch.setattr(loop, 'MetricWriter', functools.partial(
        loop.MetricWriter, use_tensorboard=False))


def test_blob_dataset_equals_jax_bytes(tmp_path):
    """The same seed writes the same PNG files and split lists."""
    jpaths = jdemo.make_blob_dataset(str(tmp_path / 'jax'), 2, 3, 2, seed=4)
    ppaths = demo.make_blob_dataset(str(tmp_path / 'port'), 2, 3, 2, seed=4)
    for kind in ('labeled', 'unlabeled', 'val'):
        with open(jpaths[kind]) as f, open(ppaths[kind]) as g:
            lines = f.read()
            assert lines == g.read()
        for line in lines.split():
            with open(tmp_path / 'jax' / line, 'rb') as f, \
                    open(tmp_path / 'port' / line, 'rb') as g:
                assert f.read() == g.read(), line


def test_metric_helpers_equal_jax():
    """``_precision_coverage`` (whole and restricted) and ``_dilate4``."""
    rs = np.random.RandomState(0)
    gt = rs.randint(0, 5, (3, 16, 16))
    label = np.where(rs.rand(3, 16, 16) < 0.7, gt, rs.randint(0, 5, gt.shape))
    conf = rs.rand(3, 16, 16).astype(np.float32)
    sel = rs.rand(3, 16, 16) < 0.3
    for s in (None, sel):
        got = plq._precision_coverage(label, conf, gt, s)
        want = jplq._precision_coverage(label, conf, gt, s)
        assert got.keys() == want.keys()
        for t in want:
            np.testing.assert_array_equal(got[t], want[t])
    box = rs.rand(2, 12, 12) < 0.05
    for k in (1, 2, 3):
        np.testing.assert_array_equal(plq._dilate4(box, k),
                                      jplq._dilate4(box, k))


@pytest.mark.parametrize('dataset', ['pascal', 'cityscapes'])
def test_unseen_class_iou_reads_the_runs_dataset(tmp_path, dataset):
    """On a pascal run the port gives JAX's answer; on another dataset it
    reads that dataset's class names, where JAX's reads pascal's."""
    from semivl_tpu_torch.datasets.classes import CLASSES
    names = CLASSES[dataset]
    recs = [{'step': 0, 'eval/mIoU': 10.0}, {'step': 1, 'eval/mIoU': 30.0},
            {'step': 1, f'eval/{names[3]}_IoU': 12.0},
            {'step': 1, f'eval/{names[4]}_IoU': 20.0},
            {'step': 0, f'eval/{names[3]}_IoU': 90.0}]
    with open(tmp_path / 'metrics.jsonl', 'w') as f:
        f.write('\n'.join(json.dumps(dict(r, t=0.0)) for r in recs) + '\n')
    with open(tmp_path / 'config.yaml', 'w') as f:
        yaml.dump({'dataset': dataset}, f)
    got = demo.unseen_class_iou(str(tmp_path), (3, 4))
    assert got == 16.0
    assert demo.unseen_class_iou(str(tmp_path), (3, 4), dataset) == got
    if dataset == 'pascal':
        assert jdemo.unseen_class_iou(str(tmp_path), (3, 4)) == got


def test_guidance_pretraining_step_matches_jax():
    """One guidance-pretraining step (the dense embedding x text logits
    against the nearest-resized label map, Adam 1e-3) on the same encoder
    weights, text and crops as JAX's ``loss_fn`` and ``_pretrain_step``."""
    rs = np.random.RandomState(1)
    text = rs.randn(21, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    img = rs.randn(4, 64, 64, 3).astype(np.float32)
    mask = rs.randint(0, 5, (4, 64, 64)).astype(np.int32)
    enc = jax_build_backbone(jax_model_config(
        'tiny-mcvit-test', img_size=64)['backbone'], jnp.float32)
    params = init_params(enc, 2, jnp.zeros((1, 64, 64, 3)))
    text_j = jnp.asarray(text)

    def loss_fn(p, im, ms):   # JAX's pretrain_guidance.loss_fn
        emb = enc.apply({'params': p}, im)['feats'][-1]
        logits = jnp.einsum('bhwc,nc->bhwn', emb, text_j) * 100.0
        hh, ww = logits.shape[1:3]
        tgt = jax.image.resize(ms.astype(jnp.float32), (ms.shape[0], hh, ww),
                               'nearest').astype(jnp.int32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(tgt, 21) * logp, axis=-1))

    tx = optax.adam(1e-3)

    @jax.jit
    def jax_step(p, im, ms):
        new, _, lv = jdemo._pretrain_step(p, tx.init(p), im, ms, loss_fn, tx)
        return jax.grad(loss_fn)(p, im, ms), new, lv

    grads, new, want_loss = jax_step(params, jnp.asarray(img),
                                     jnp.asarray(mask))

    pm = build_backbone(get_model_config('tiny-mcvit-test', img_size=64)
                        ['backbone'], torch.float32)

    def port_names(tree):
        sd = {}
        convert.export_maskclip_vit(sd, jax.tree.map(np.asarray, tree), '')
        return sd

    pm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in port_names(params).items()}, strict=True)
    opt = torch.optim.Adam(pm.parameters(), lr=1e-3)
    loss = demo.guidance_loss(pm, torch.from_numpy(text),
                              torch.from_numpy(img),
                              torch.from_numpy(mask).long())
    loss.backward()
    got_grads = {n: p.grad.numpy().copy() for n, p in pm.named_parameters()}
    opt.step()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_grads, want_new = port_names(grads), port_names(new)
    after = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for n, g in want_grads.items():
        assert rel_err(got_grads[n], g) < 1e-4, n
        resolved = np.abs(g) > 1e-3 * np.abs(g).max()
        diff = np.abs(after[n] - want_new[n])[resolved]
        assert diff.max(initial=0) <= 1e-3 * np.abs(want_new[n]).max(), n


def test_demos_run_and_report(tmp_path, capsys):
    """Each demo once at its smallest setting on the CPU: the semi-effect
    demo's three methods (one epoch and an evaluation each) and its JSON
    summary; the pseudo-label quality tool's table, ``summary.json`` and
    its JSON line, the CutMix identity holding."""
    out = demo.main(['--out-root', str(tmp_path / 'semi'), '--n-labeled',
                     '2', '--n-unlabeled', '2', '--n-val', '1',
                     '--sup-epochs', '1', '--semi-epochs', '1',
                     '--eval-every', '1', '--seeds', '1',
                     '--pretrain-steps', '2', '--device', 'cpu'])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out))
    assert set(out) == {'supervised', 'unimatch', 'semivl'}
    for m in out.values():
        assert 0.0 <= m['miou_mean'] <= 100.0
        assert np.isfinite(m['unseen_mean'])
    assert 'gain' in out['semivl'] and 'gain' not in out['supervised']

    root = str(tmp_path / 'plq')
    summary = plq.main(['--out-root', root, '--seeds', '1',
                        '--warmup-steps', '2', '--pretrain-steps', '2',
                        '--device', 'cpu'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['cutmix_identity_ok'] is True
    assert line['chance'] == summary['chance']
    with open(os.path.join(root, 'summary.json')) as f:
        assert len(json.load(f)['rows']) == len(plq.THRESHOLDS)
