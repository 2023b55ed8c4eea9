"""The port's evaluation CLI (``tools.eval``) and ``tools.parity_check`` on
the CPU, with the tiny VLM on ``tests/synth_data.py``'s fixture: a run
slot (with and without ``--ema``), the npz ``convert_reference_ckpt``
writes and the reference ``.pth`` ``convert_to_torch`` writes, each held
to ``evaluate_histograms`` on the same weights (the evaluator is held
against JAX's in tests/test_torch_eval.py); the PNGs and logits it
writes; the config defaults JAX's CLI applies.

Exact comparisons: the histograms are integer counts of one float32
computation on each side."""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from semivl_tpu_torch.configs.experiments import config_from_vars
from semivl_tpu_torch.data.dataset import SemiDataset
from semivl_tpu_torch.evaluation.predict import (Evaluator,
                                                 evaluate_histograms)
from semivl_tpu_torch.models.builder import build_model
from semivl_tpu_torch.tools import convert_reference_ckpt, convert_to_torch
from semivl_tpu_torch.tools import eval as eval_cli
from semivl_tpu_torch.tools import parity_check
from semivl_tpu_torch.train.checkpoint import CheckpointManager

from torch_parity import few_threads  # noqa: F401 (autouse)

from synth_data import make_synth_dataset


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A tiny training config on the fixture, written to ``cfg.yaml``, and
    a run slot of its training model (guidance encoder included) with a
    parameter EMA."""
    tmp = tmp_path_factory.mktemp('evalcli')
    root = str(tmp / 'data')
    paths = make_synth_dataset(root, n_labeled=1, n_unlabeled=1, n_val=2,
                               size=(72, 88))
    cfg = config_from_vars(
        exp_id=99, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=1, img_scale=None, criterion='CELoss', criterion_u='CELoss',
        maskclip_consistency_lambda=[0.1, 0], mcc_text='concept4_single',
        eval_mode='zegclip_sliding_window')
    cfg = dict(cfg, stride=48, clip_encoder='tiny-mcvit-test',
               data_root=root, val_id_path=paths['val'])
    cfg.pop('img_scale', None)
    with open(tmp / 'cfg.yaml', 'w') as f:
        yaml.dump(cfg, f)
    model = build_model(cfg, device='cpu', seed=3).model
    opt = torch.optim.AdamW(model.parameters())
    ema = {n: p.detach() * 0.5 for n, p in model.named_parameters()}
    CheckpointManager(str(tmp)).save('best', model, opt, 2, {'epoch': 4},
                                     ema)
    return dict(tmp=tmp, cfg=cfg, yaml=str(tmp / 'cfg.yaml'),
                slot=str(tmp / 'ckpt' / 'best'), sd=model.state_dict(),
                ema=ema)


def _histograms(run, weights):
    """``evaluate_histograms`` of the evaluation model (no guidance
    encoder) carrying ``weights``."""
    cfg = dict(run['cfg'], clip_encoder=None)
    bundle = build_model(cfg, device='cpu')
    own = bundle.model.state_dict()
    bundle.model.load_state_dict({k: weights[k] for k in own})
    valset = SemiDataset(cfg, 'val', id_path=cfg['val_id_path'])
    return evaluate_histograms(
        Evaluator(bundle.model, bundle.text_feats, cfg, 'cpu'), valset,
        cfg['eval_mode'], cfg)


def _cli(run, save_path, *extra):
    return eval_cli.main(['--config', run['yaml'], '--save-path', save_path,
                          '--device', 'cpu', *extra])


def test_eval_cli_on_a_slot_writes_predictions_and_logits(run):
    """A run slot: the histograms ``evaluate`` counts on its weights, a
    paletted PNG and a (1, C, H, W) float32 logit map per image, the PNG
    the logits' argmax."""
    preds, logits = str(run['tmp'] / 'preds'), str(run['tmp'] / 'logits')
    miou, hist = _cli(run, run['slot'], '--pred-path', preds,
                      '--logit-path', logits)
    want = _histograms(run, run['sd'])
    for got, w in zip(hist, want):
        np.testing.assert_array_equal(got, w)
    assert 0.0 <= miou <= 100.0
    names = sorted(os.listdir(preds))
    assert names == ['v0.png', 'v1.png']
    for name in names:
        png = Image.open(os.path.join(preds, name))
        assert png.mode == 'P' and png.size == (88, 72)
        lg = np.load(os.path.join(logits, name.replace('.png', '.npy')))
        assert lg.dtype == np.float32 and lg.shape == (1, 21, 72, 88)
        np.testing.assert_array_equal(np.asarray(png), lg[0].argmax(0))


def test_eval_cli_ema_reads_the_slots_ema(run):
    _, hist = _cli(run, run['slot'], '--ema')
    want = _histograms(run, {**run['sd'], **run['ema']})
    for got, w in zip(hist, want):
        np.testing.assert_array_equal(got, w)
    assert not all(np.array_equal(a, b) for a, b in
                   zip(hist, _histograms(run, run['sd'])))


def test_eval_cli_on_a_reference_pth_and_its_npz(run, tmp_path):
    """The slot through ``convert_to_torch`` (a reference ``.pth``) and on
    through ``convert_reference_ckpt`` (an npz): both evaluate as the slot
    does; ``parity_check`` on the ``.pth`` reports the same mIoU and, on
    the CLI's own logit dumps, zero difference."""
    pth, npz = str(tmp_path / 'best.pth'), str(tmp_path / 'best.npz')
    convert_to_torch.main(['--run-dir', str(run['tmp']), '--out', pth])
    convert_reference_ckpt.main(['--src', pth, '--out', npz])
    logits = str(tmp_path / 'logits')
    miou_slot, want = _cli(run, run['slot'], '--logit-path', logits)
    for path in (pth, npz):
        miou, hist = _cli(run, path)
        assert miou == miou_slot
        for got, w in zip(hist, want):
            np.testing.assert_array_equal(got, w)
    summary = parity_check.main(['--config', run['yaml'], '--ckpt', pth,
                                 '--ref-logits', logits, '--device', 'cpu'])
    assert summary['images'] == 2 and summary['miou'] == miou_slot
    assert summary['maxdiff_p95'] == 0.0 and summary['argmax_agreement'] == 1


def test_eval_cli_applies_jaxs_config_defaults(run, tmp_path, monkeypatch):
    """No guidance encoder (``clip_encoder`` None), the text defaults of a
    legacy config, and the mode: ``eval_mode`` if set, else
    ``sliding_window`` for Cityscapes and ``original`` otherwise."""
    seen = {}
    real = Evaluator.predict

    def spy(self, img, mask_shape, mode, **kw):
        seen.setdefault('modes', set()).add(mode)
        seen['clip'] = self.cfg['clip_encoder']
        seen['pl_text'] = self.cfg['pl_text']
        return real(self, img, mask_shape, mode, **kw)

    monkeypatch.setattr(Evaluator, 'predict', spy)
    cfg = dict(run['cfg'])
    for k in ('eval_mode', 'pl_text'):
        cfg.pop(k, None)
    path = str(tmp_path / 'legacy.yaml')
    with open(path, 'w') as f:
        yaml.dump(cfg, f)
    eval_cli.main(['--config', path, '--save-path', 'none', '--device',
                   'cpu'])
    assert seen == {'modes': {'original'}, 'clip': None,
                    'pl_text': cfg['text_embedding_variant']}
