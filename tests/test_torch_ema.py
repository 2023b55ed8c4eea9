"""The parameter EMA of the port's steps (``ema_decay``) on the CPU: its
arithmetic against JAX's ``_ema_update``, the checkpoint slot that carries
it and a loop run preempted and resumed with it. One SemiVL and one
supervised step with the EMA are held against JAX's in
tests/test_torch_train.py (``test_semivl_step_ema_matches_jax``) and
tests/test_torch_baselines.py (``test_supervised_step_matches_jax``), on
the step pairs those files make already.

Tolerances: the EMA's arithmetic is JAX's (two float32 products, one sum),
so it is held bit for bit."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.train.step import _ema_update as jax_ema_update
from semivl_tpu_torch.configs.experiments import config_from_vars
from semivl_tpu_torch.train import loop
from semivl_tpu_torch.train.checkpoint import CheckpointManager
from semivl_tpu_torch.train.step import ema_update_, init_ema

from torch_parity import few_threads  # noqa: F401 (autouse)

from synth_data import make_synth_dataset


def _module(seed=0):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(7, 5), torch.nn.LayerNorm(5),
                            torch.nn.Linear(5, 3))
    m[1].weight.requires_grad_(False)   # a frozen leaf: it never moves
    return m


@pytest.mark.parametrize('decay', [0.999, 0.9])
def test_ema_update_matches_jax(decay):
    """Three updates of the port's EMA equal JAX's ``_ema_update`` on the
    same parameters bit for bit, the frozen leaf (its EMA drifting by the
    float32 rounding of d e + (1 - d) e alone) too."""
    m = _module()
    ema = init_ema(m)
    # copies: JAX may alias a numpy buffer, and the port's EMA is updated
    # in place
    want = {k: jnp.array(v.numpy(), copy=True) for k, v in ema.items()}
    rs = np.random.RandomState(1)
    for _ in range(3):
        with torch.no_grad():
            for p in m.parameters():
                if p.requires_grad:
                    p.add_(torch.from_numpy(
                        rs.randn(*p.shape).astype(np.float32)))
        ema_update_(ema, m, decay)
        want = jax_ema_update(
            want, {k: jnp.array(p.detach().numpy(), copy=True)
                   for k, p in m.named_parameters()}, decay)
    for k, v in ema.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), k)


def test_checkpoint_carries_the_ema(tmp_path):
    """A slot saved with an EMA restores it; a slot without one restores
    the model and leaves the caller's EMA as it was, as JAX's restore keeps
    the state's."""
    m = _module()
    opt = torch.optim.AdamW(p for p in m.parameters() if p.requires_grad)
    ema = {k: v + 1.0 for k, v in init_ema(m).items()}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save('latest', m, opt, 3, {'epoch': 0}, ema)
    ckpt.save('best', m, opt, 3, {'epoch': 0})
    got = {k: torch.zeros_like(v) for k, v in ema.items()}
    assert ckpt.restore('latest', m, opt, got)[0] == 3
    for k in ema:
        assert torch.equal(got[k], ema[k]), k
    kept = {k: v.clone() for k, v in got.items()}
    assert ckpt.restore('best', m, opt, got)[0] == 3
    for k in kept:
        assert torch.equal(got[k], kept[k]), k
    assert 'ema' not in torch.load(os.path.join(tmp_path, 'ckpt', 'best'),
                                   weights_only=True)
    with pytest.raises(ValueError, match='EMA names'):
        ckpt.restore('latest', m, opt, {'nope': torch.zeros(1)})


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(loop, 'MetricWriter', functools.partial(
        loop.MetricWriter, use_tensorboard=False))


def test_loop_ema_preempted_and_resumed(tmp_path, monkeypatch):
    """The tiny VLM for one epoch of 2 steps with ``ema_decay``: the slots
    carry the EMA; a run preempted after step 0 and resumed ends with
    model, optimizer state and EMA ``torch.equal`` to the straight run's,
    and the EMA differs from the live parameters."""
    root = str(tmp_path / 'data')
    paths = make_synth_dataset(root, n_labeled=2, n_unlabeled=2, n_val=1,
                               size=(72, 88))
    cfg = config_from_vars(
        exp_id=99, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=1, img_scale=None, criterion='CELoss', criterion_u='CELoss',
        maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
        mcc_text='concept4_single', eval_mode='zegclip_sliding_window')
    cfg = dict(cfg, stride=48, clip_encoder='tiny-mcvit-test',
               data_root=root, labeled_id_path=paths['labeled'],
               unlabeled_id_path=paths['unlabeled'],
               val_id_path=paths['val'], ema_decay=0.9,
               debug_images=False)
    cfg.pop('img_scale', None)
    monkeypatch.chdir(tmp_path)
    _, path_a = loop.train(cfg, seed=0, device='cpu')
    _, path_b = loop.train(dict(cfg, preempt_at_step=0), seed=0,
                           device='cpu')
    loop.train(cfg, seed=0, device='cpu', resume_from=path_b)

    def state(path):
        return torch.load(os.path.join(path, 'ckpt', 'latest'),
                          weights_only=True)

    a, b = state(path_a), state(path_b)
    assert a['iteration'] == b['iteration'] == 2
    assert a['ema'].keys() == b['ema'].keys()
    for k in a['ema']:
        assert torch.equal(a['ema'][k], b['ema'][k]), k
        assert torch.equal(a['model'][k], b['model'][k]), k
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    moved = [k for k in a['ema']
             if not torch.equal(a['ema'][k], a['model'][k])]
    assert len(moved) > len(a['ema']) // 2
