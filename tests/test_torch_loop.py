"""The port's trainer entry point (``semivl_tpu_torch.train.loop.train`` and
its CLI) on the CPU, with the tiny VLM on ``tests/synth_data.py``'s on-disk
fixture: the batches its step receives against JAX's loaders and batch
mapping, a preempted and resumed run against an uninterrupted one
(``torch.equal``), the run directory, an exp-44 config, the step's
generator and what the loop refuses."""

import functools
import glob
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from semivl_tpu_torch.configs.experiments import (config_from_vars,
                                                  generate_experiment_cfgs)
from semivl_tpu_torch.train import loop

from synth_data import make_synth_dataset


def _tiny(cfg, root, paths):
    """A generated config cut to the tiny VLM and the fixture."""
    cfg = dict(cfg, model='mmseg.tiny-vlm-test', crop_size=64, stride=48,
               clip_encoder='tiny-mcvit-test', data_root=root,
               labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'])
    cfg.pop('img_scale', None)
    return cfg


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The metric stream without TensorBoard, whose import takes seconds."""
    monkeypatch.setattr(loop, 'MetricWriter', functools.partial(
        loop.MetricWriter, use_tensorboard=False))


@pytest.fixture(scope='module')
def loop_cfg(tmp_path_factory):
    """Exp 40's structure on the tiny VLM: batch 1, 2 steps an epoch, 2
    epochs (4 steps), an evaluation each epoch."""
    root = str(tmp_path_factory.mktemp('torchloop'))
    paths = make_synth_dataset(root, n_labeled=2, n_unlabeled=2, n_val=2,
                               size=(72, 88))
    cfg = config_from_vars(
        exp_id=99, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=2, img_scale=None, criterion='CELoss', criterion_u='CELoss',
        maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
        mcc_text='concept4_single', mcc_loss_reduce='mean_all',
        eval_mode='zegclip_sliding_window')
    return _tiny(cfg, root, paths)


def _final_state(save_path):
    return torch.load(os.path.join(save_path, 'ckpt', 'latest'),
                      weights_only=True)


def _assert_states_equal(a, b):
    assert a['iteration'] == b['iteration']
    assert a['model'].keys() == b['model'].keys()
    for k in a['model']:
        assert torch.equal(a['model'][k], b['model'][k]), k
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_preempt_resume_equals_uninterrupted(loop_cfg, tmp_path,
                                             monkeypatch):
    """A run preempted right after its first step (``preempt_at_step=0``:
    ``latest`` saved mid-epoch, epoch step 1) and resumed from its run dir
    ends with parameters, optimizer state and iteration ``torch.equal`` to
    an uninterrupted run's; the run dir holds ``all_args.yaml``,
    ``config.yaml``, ``metrics.jsonl`` (with the windowed throughput),
    ``ckpt/latest``, ``ckpt/best`` and the debug grid."""
    monkeypatch.chdir(tmp_path)
    best_a, path_a = loop.train(loop_cfg, seed=0, device='cpu')
    cut = dict(loop_cfg, preempt_at_step=0)
    _, path_b = loop.train(cut, seed=0, device='cpu')
    with open(os.path.join(path_b, 'ckpt', 'latest.extra.json')) as f:
        assert json.load(f) == {'epoch': 0.0, 'epoch_step': 1.0,
                                'previous_best': 0.0}
    assert _final_state(path_b)['iteration'] == 1
    best_b, path_b2 = loop.train(loop_cfg, seed=0, device='cpu',
                                 resume_from=path_b)
    assert path_b2 == path_b and best_b == best_a
    _assert_states_equal(_final_state(path_a), _final_state(path_b))
    for name in ('all_args.yaml', 'config.yaml', 'metrics.jsonl',
                 'debug.log', 'ckpt/latest', 'ckpt/best'):
        assert os.path.isfile(os.path.join(path_a, name)), name
    assert glob.glob(os.path.join(path_a, 'debug', '*.png'))
    with open(os.path.join(path_a, 'all_args.yaml')) as f:
        args = yaml.load(f, Loader=yaml.Loader)
    assert args['nclass'] == 21 and args['device'] == 'cpu'
    with open(os.path.join(path_a, 'metrics.jsonl')) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {'train/imgs_per_sec_per_chip', 'train/loss_all',
            'eval/mIoU'} <= keys


def _jax_batches(cfg, seed, n_steps):
    """The batches JAX's ``train`` hands its step: its loaders and its
    ``to_device`` mapping (loop.py:406-418), with the device upload and the
    step replaced by recorders, on one device."""
    import jax.numpy as jnp
    from semivl_tpu.parallel import mesh as jmesh
    from semivl_tpu.train import loop as jloop
    seen = []

    def fake_step_factory(*a, **k):
        def step(state, batch, rng):
            seen.append({key: np.asarray(v) for key, v in batch.items()})
            return state, {'loss_all': jnp.zeros(())}
        return step

    with mock.patch.object(jmesh, 'global_batch_to_device',
                           lambda b, mesh: b), \
            mock.patch.object(jloop, 'make_semivl_train_step',
                              fake_step_factory), \
            mock.patch.object(jloop, 'evaluate',
                              lambda *a, **k: (0.0, np.zeros(21))):
        jloop.train(dict(cfg, respect_n_gpus=True, n_gpus=1,
                         debug_images=False), seed=seed,
                    max_iters_override=n_steps)
    return seen


def test_loop_batches_match_jax(loop_cfg, tmp_path, monkeypatch):
    """A recording step receives, step by step, the batches (keys and
    arrays) that JAX's loaders and batch mapping give for the same seed
    over two epochs, less JAX's ``preempt`` entry (its multi-process
    preemption flag)."""
    monkeypatch.chdir(tmp_path)
    seen = []

    class Recorder:
        iteration = 0

        def __call__(self, batch, generator, preempt=False):
            seen.append({k: v.numpy() for k, v in batch.items()})
            self.iteration += 1
            return {'loss_all': torch.zeros(())}

    with mock.patch.object(loop, 'make_semivl_train_step',
                           lambda *a, **k: Recorder()), \
            mock.patch.object(loop, 'evaluate',
                              lambda *a, **k: (0.0, np.zeros(21))):
        loop.train(dict(loop_cfg, debug_images=False), seed=7, device='cpu')
    want = _jax_batches(loop_cfg, 7, 4)
    assert len(seen) == len(want) == 4
    for got, ref in zip(seen, want):
        ref = {k: v for k, v in ref.items() if k != 'preempt'}
        assert got.keys() == ref.keys()
        for k in got:
            assert got[k].dtype == ref[k].dtype, k
            assert np.array_equal(got[k], ref[k]), k


def test_exp44_generated_config_trains(tmp_path, monkeypatch):
    """Exp 44's generated config (Cityscapes: 19 classes, the
    ``conceptavg3_single`` text, ``pixelavg`` confidence, ``iters`` in
    place of epochs, ``sliding_window`` evaluation) through the CLI on the
    CPU, cut to the tiny VLM and the fixture with 19 classes: two steps
    (``--max-iters 2``), then an evaluation."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / 'cs')
    paths = make_synth_dataset(root, n_labeled=1, n_unlabeled=2, n_val=1,
                               num_classes=19, size=(64, 80))
    cfg = _tiny(generate_experiment_cfgs(44)[0], root, paths)
    cfg.update(batch_size=1, eval_every_n_epochs=1, debug_images=False)
    assert cfg['eval_mode'] == 'sliding_window' and cfg['iters'] == 83760
    with open('cfg.yaml', 'w') as f:
        yaml.dump(cfg, f)
    from semivl_tpu_torch.tools import train as cli
    evals = []
    real = loop.evaluate

    def counted(*a, **k):
        evals.append(a[2])
        return real(*a, **k)

    with mock.patch.object(loop, 'evaluate', counted):
        best, path = cli.main(['--config', 'cfg.yaml', '--max-iters', '2',
                               '--device', 'cpu'])
    assert evals == ['sliding_window'] and 0.0 <= best <= 100.0
    assert _final_state(path)['iteration'] == 2


def test_step_generator_is_a_function_of_the_step():
    """The feature-perturbation generator of a step depends only on (seed,
    global step)."""
    a = torch.rand(4, generator=loop.step_generator(0, 5, 'cpu'))
    b = torch.rand(4, generator=loop.step_generator(0, 5, 'cpu'))
    c = torch.rand(4, generator=loop.step_generator(0, 6, 'cpu'))
    d = torch.rand(4, generator=loop.step_generator(1, 5, 'cpu'))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)


@pytest.mark.parametrize('change,words', [
    (dict(ema_decay=0.999), 'ema_decay')])
def test_loop_refuses_unported(loop_cfg, tmp_path, monkeypatch, change,
                               words):
    """What the loop does not run yet raises, by name, before it writes
    anything."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=words):
        loop.train(dict(loop_cfg, **change), device='cpu')
    assert not os.path.exists('exp')


def test_param_overrides_merge_after_init(loop_cfg, tmp_path):
    """``init_param_overrides``: an npz of state-dict names merged into the
    built model before the optimizer is made; a name the model lacks, or
    a shape it does not have, is refused by name."""
    from semivl_tpu_torch.models.builder import build_model
    bundle = build_model(loop_cfg, device='cpu', seed=0)
    sd = bundle.model.state_dict()
    key = next(k for k in sd if k.startswith('clip_encoder.'))
    value = np.full(tuple(sd[key].shape), 0.5, np.float32)
    path = str(tmp_path / 'over.npz')
    np.savez(path, **{key: value})
    loop.init_state(bundle, dict(loop_cfg, init_param_overrides=path), 4)
    assert torch.equal(bundle.model.state_dict()[key],
                       torch.from_numpy(value))
    for bad in ({'nope.weight': value}, {key: value[..., :1]}):
        np.savez(path, **bad)
        with pytest.raises(ValueError, match='init_param_overrides'):
            loop.init_state(bundle, dict(loop_cfg, init_param_overrides=path),
                            4)


@pytest.mark.parametrize('exp_id', [40, 41, 42, 43, 44])
def test_generated_configs_run_or_are_refused_by_name(exp_id):
    """Every generated config either passes what the port's loop, model
    builder and step check before any work (every config of exps 40-44,
    exp 41's VLG, DeepLabV3+ and ZegCLIP ablations among them, the step's
    criteria checked against the config's decode head) or is refused,
    naming what the port lacks."""
    from semivl_tpu_torch.configs.models import get_model_config
    from semivl_tpu_torch.models.builder import ModelBundle
    from semivl_tpu_torch.train.step import make_semivl_train_step
    ran = 0
    for cfg in generate_experiment_cfgs(exp_id):
        try:
            loop._refuse_unported(cfg)
            model = torch.nn.Identity()
            model.decode_head_cfg = get_model_config(
                cfg['model'], img_size=cfg['crop_size'])['model'][
                    'decode_head']
            bundle = ModelBundle(model=model, text_feats=np.zeros((21, 512)),
                                 mcc_text_feats=np.zeros((98, 512)))
            make_semivl_train_step(bundle, cfg, None, 10, device='cpu')
            ran += 1
        except (NotImplementedError, ValueError) as exc:
            named = (cfg['dataset'], cfg['model'].replace('mmseg.', ''),
                     repr(cfg['criterion_u']))
            assert any(n in str(exc) for n in named), (cfg['name'], exc)
    assert ran == {40: 5, 41: 12, 42: 5, 43: 5, 44: 5}[exp_id]


def test_profile_window_writes_a_trace(loop_cfg, tmp_path, monkeypatch):
    """``profile_dir``: a ``torch.profiler`` trace from step
    ``profile_start_step`` for ``profile_steps`` steps, as a Chrome trace."""
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / 'trace'
    loop.train(dict(loop_cfg, profile_dir=str(trace), profile_start_step=1,
                    profile_steps=2, debug_images=False), device='cpu')
    assert [p.name for p in trace.iterdir()] == ['trace_1-3.json']
