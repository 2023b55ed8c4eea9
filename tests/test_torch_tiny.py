"""The tiny VLM family (``tiny-vlm-test`` with its guidance encoder
``tiny-mcvit-test``) under ``attention_impl = 'pallas'`` against the JAX
package on the CPU, float32 on both sides.

Every attention of these models takes the head-split route (the ViT's 4
heads of 16, the semantic transformer's 2 heads of 32): on the JAX side the
Pallas ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode, on the port's
the head-split plain versions through the dispatcher. Tolerances: the
forward within 1e-5 of the output scale; one SemiVL step's loss terms
within 1e-4 relative and every trainable leaf's gradient and update within
1e-3 of its scale (as ``tests/test_torch_train.py`` holds the flagship
structure).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.configs.models import get_model_config as jax_model_config
from semivl_tpu.ops import attention as jax_attention
from semivl_tpu_torch.configs import get_model_config, tiny_cfg, tiny_train_cfg
from semivl_tpu_torch.models.builder import build_model
from semivl_tpu_torch.models.layers import Attention, set_attention_impl
from semivl_tpu_torch.ops import attention, flash_attention
from semivl_tpu_torch.train.step import LOSS_KEYS

from torch_parity import (pseudo_label_thresholds, semivl_batch,
                          semivl_step_pair, step_mismatches, text_embedding,
                          tiny_train_vlm)

IMG, TOTAL = 64, 100


def _configs():
    model = get_model_config('tiny-vlm-test', IMG)['model']
    clip = get_model_config('tiny-mcvit-test', IMG)['backbone']
    return model['backbone'], model['decode_head'], clip


@pytest.fixture(scope='module')
def jax_pallas():
    """JAX's attention on its kernels for this module (the run config's
    ``attention_impl``, as ``train/loop.py`` sets it)."""
    jax_attention.set_default_impl('pallas')
    yield
    jax_attention.set_default_impl('auto')


@pytest.fixture(scope='module')
def tiny(jax_pallas):
    backbone, head, clip = _configs()
    jm, params, pm, mcc = tiny_train_vlm(seed=11, img=IMG, logit_scale=30.0,
                                         backbone=backbone, head=head,
                                         clip=clip)
    set_attention_impl(pm, 'pallas')
    return jm, params, pm, mcc


@pytest.mark.parametrize('name', ['tiny-vlm-test', 'tiny-mcvit-test'])
@pytest.mark.parametrize('img', [64, 96])
def test_tiny_configs_match_jax(name, img):
    assert get_model_config(name, img) == jax_model_config(name, img)


def test_build_model_applies_attention_impl_and_guidance_size():
    """``attention_impl`` reaches every attention layer; with
    ``mcc_fix_resize_pos`` the guidance encoder is built at the crop size,
    without it at 512."""
    bundle = build_model(tiny_train_cfg(), device='cpu')
    layers = [m for m in bundle.model.modules() if isinstance(m, Attention)]
    assert len(layers) == 2 + 1 + 2   # ViT, semantic layer, guidance ViT
    assert {m.impl for m in layers} == {'pallas'}
    assert bundle.model.clip_encoder.pos_embed.shape == (1, 17, 64)
    cfg = dict(tiny_train_cfg(), mcc_fix_resize_pos=False)
    del cfg['attention_impl']
    bundle = build_model(cfg, device='cpu')
    assert bundle.model.clip_encoder.pos_embed.shape == (1, 1025, 64)
    assert {m.impl for m in bundle.model.modules()
            if isinstance(m, Attention)} == {'auto'}
    cfg = tiny_cfg()
    assert (cfg['crop_size'], cfg['stride'], cfg['attention_impl'],
            cfg['eval_mode']) == (64, 48, 'pallas', 'zegclip_sliding_window')
    with pytest.raises(ValueError, match='attention_impl'):
        build_model(dict(cfg, attention_impl='flash'), device='cpu')


def test_tiny_routes_every_attention_to_the_head_split_kernels(tiny):
    _, _, pm, _ = tiny
    for m in pm.modules():
        if isinstance(m, Attention):
            c = m.attn.in_proj_weight.shape[1]
            assert attention.route(21, 21, c, m.num_heads, m.impl,
                                   True) == 'heads'


def test_tiny_forward_matches_jax(tiny):
    jm, params, pm, _ = tiny
    img = np.random.RandomState(12).randn(2, IMG, IMG, 3).astype(np.float32)
    text = text_embedding()
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(img),
                               jnp.asarray(text)))
    before = flash_attention.heads_launches
    with torch.no_grad():
        got = pm(torch.from_numpy(img), torch.from_numpy(text)).numpy()
    assert flash_attention.heads_launches == before   # CPU: plain versions
    assert got.shape == want.shape == (2, 21, IMG, IMG)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope='module')
def step_pair(tiny):
    """One tiny SemiVL step (batch 1 + 1) in JAX and in the port."""
    jm, params, pm, mcc = tiny
    text = text_embedding()
    batch = semivl_batch(13, 1, IMG)
    conf_thresh, mcc_thresh = pseudo_label_thresholds(pm, text, mcc, batch)
    cfg = dict(tiny_train_cfg(IMG), conf_thresh=conf_thresh,
               mcc_conf_thresh=mcc_thresh, log_grad_norm=True)
    rs = np.random.RandomState(14)
    keeps = [rs.rand(1, 1, 1, c) < 0.5 for c in (64, 64, 512)]
    return semivl_step_pair(jm, params, pm, mcc, text, batch, cfg, keeps,
                            TOTAL)


def test_tiny_step_losses_match_jax(step_pair):
    jm, pmet = step_pair['jmetrics'], step_pair['pmetrics']
    for k in LOSS_KEYS + ('grad_norm',):
        assert np.isfinite(pmet[k]), k
        assert abs(pmet[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pmet[k], jm[k])
    assert pmet['loss_x'] > 0 and pmet['loss_mc_s1'] > 0


def test_tiny_step_grads_and_update_match_jax(step_pair):
    bad, n_checked = step_mismatches(step_pair)
    assert bad == []
    assert n_checked > 10
