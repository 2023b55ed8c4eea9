"""The port's training path against the JAX package on the CPU, float32 on
both sides, same numpy-seeded inputs and weights: losses, dropout,
CutMix, the MaskCLIP guidance labels, the freeze mask / optimizer groups /
schedule, and one whole SemiVL train step.

Tolerances: loss values 1e-5 relative and the step's loss terms 1e-4
relative (float32 sums in other orders); gradients and updated parameters
1e-3 of each leaf's own scale (two float32 frameworks through ~20 layers;
the first Adam step moves a parameter by about lr * lr_mult * sign(g), so
a sign flip of a vanishing gradient component would show there, not a
rounding difference). Random streams cannot match across frameworks, so the
step test injects the same feature-perturbation channel masks on both
sides, and it asserts that no pixel whose pseudo-label or guidance label
counts sits within a margin of a confidence threshold or of an argmax tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.losses.ce import cross_entropy as jax_ce
from semivl_tpu.losses.conf_weight import confidence_weighted_loss as jax_cwl
from semivl_tpu.ops.dropout import dropout2d as jax_dropout2d
from semivl_tpu.train import optim as jax_optim
from semivl_tpu.train.step import (cutmix_box_from_coords as jax_boxes,
                                   cutmix_image as jax_cutmix_image)
from semivl_tpu_torch.configs import flagship_train_cfg
from semivl_tpu_torch.losses.ce import cross_entropy
from semivl_tpu_torch.losses.conf_weight import confidence_weighted_loss
from semivl_tpu_torch.ops.dropout import dropout2d
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import (LOSS_KEYS, cutmix_box_from_coords,
                                         cutmix_image)

import torch_parity
from torch_parity import (MARGIN, gap_threshold, leaf_names,
                          pseudo_label_thresholds, rel_err, semivl_batch,
                          semivl_step_pair, step_mismatches, text_embedding,
                          tiny_train_vlm)

B, IMG, TOTAL = 2, torch_parity.IMG, 100


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- losses

def _logits_labels(seed=0):
    rs = np.random.RandomState(seed)
    logits = (3 * rs.randn(2, 21, 9, 11)).astype(np.float32)
    labels = rs.randint(0, 21, (2, 9, 11)).astype(np.int32)
    labels[:, :2] = 255
    return logits, labels


@pytest.mark.parametrize('reduction', ['mean', 'none', 'sum'])
def test_cross_entropy_matches_jax(reduction):
    logits, labels = _logits_labels()
    want = np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                             reduction=reduction))
    got = cross_entropy(_t(logits), _t(labels).long(), reduction=reduction)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('mode', ['pixelwise', 'pixelratio', 'pixelavg'])
def test_confidence_weighted_loss_matches_jax(mode):
    rs = np.random.RandomState(1)
    loss = rs.rand(2, 9, 11).astype(np.float32)
    conf = rs.rand(2, 9, 11).astype(np.float32)
    ign = np.where(rs.rand(2, 9, 11) < 0.2, 255, 0).astype(np.int32)
    want = float(jax_cwl(jnp.asarray(loss), jnp.asarray(conf),
                         jnp.asarray(ign), mode, 0.6))
    got = float(confidence_weighted_loss(_t(loss), _t(conf), _t(ign), mode,
                                         0.6))
    assert abs(got - want) <= 1e-5 * abs(want)


# ------------------------------------------------------------ dropout

def test_dropout2d_statistics():
    """Whole channels of each sample dropped at the rate, survivors scaled
    by 1/(1-rate): the JAX op's semantics (its random bits differ)."""
    x = torch.rand(8, 3, 5, 256) + 0.5
    y = dropout2d(x, 0.5, torch.Generator().manual_seed(0))
    kept = (y != 0)
    assert (kept.all(dim=(1, 2)) | (~kept).any(dim=(1, 2))).all()
    per_channel = kept[:, 0, 0]
    assert torch.equal(kept, per_channel[:, None, None].expand_as(kept))
    torch.testing.assert_close(y[kept], (x * 2)[kept])
    frac = per_channel.float().mean().item()       # 2048 channels
    assert abs(frac - 0.5) < 4 * (0.25 / 2048) ** 0.5
    jy = np.asarray(jax_dropout2d(jax.random.PRNGKey(0),
                                  jnp.asarray(x.numpy()), 0.5))
    jkept = jy[:, 0, 0] != 0
    assert abs(jkept.mean() - 0.5) < 4 * (0.25 / 2048) ** 0.5
    assert dropout2d(x, 0.0) is x


# ------------------------------------------------------------- cutmix

def test_cutmix_matches_jax():
    coords = np.array([[10, 5, 20, 35], [0, 0, 64, 16], [60, 60, 9, 9]],
                      np.int32)
    want = np.asarray(jax_boxes(jnp.asarray(coords), 64))
    got = cutmix_box_from_coords(_t(coords), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    rs = np.random.RandomState(2)
    a, b = (rs.randn(3, 64, 64, 3).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        cutmix_image(_t(a), _t(b), got).numpy(),
        np.asarray(jax_cutmix_image(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(want))))


# -------------------------------------------------- the guidance labels

@pytest.fixture(scope='module')
def tiny():
    return tiny_train_vlm(seed=3, logit_scale=30.0)


def test_forward_maskclip_matches_jax(tiny):
    """The frozen encoder's guidance labels with the real ``concept4``
    text (98 concepts max-aggregated to 21 classes)."""
    jm, params, pm, mcc = tiny
    img = np.random.RandomState(4).randn(2, IMG, IMG, 3).astype(np.float32)
    probs = pm.maskclip_probs(_t(img), mcc).numpy()
    top2 = np.sort(probs, axis=-1)[..., -2:]
    conf = top2[..., 1]
    thresh, margin = gap_threshold(conf)
    assert margin > MARGIN
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(img),
                               jnp.asarray(mcc), thresh,
                               method='forward_maskclip'))
    got = pm.forward_maskclip(_t(img), mcc, thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 255).mean() < 1


# ------------------------------------------------ mask, groups, schedule

def test_trainable_mask_and_param_groups_match_jax(tiny):
    jm, params, pm, _ = tiny
    cfg = flagship_train_cfg()
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    names = leaf_names(params)
    jmask = dict(zip(
        jax.tree_util.tree_leaves(jax_optim.param_path_strings(params)),
        jax.tree_util.tree_leaves(jax_optim.trainable_mask(
            params, True, ['attn', 'pos_embed']))))
    pmask = optim.trainable_mask(names.values(), True, ['attn', 'pos_embed'])
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    group_of = {id(p): g for g in opt.param_groups for p in g['params']}
    prm = dict(pm.named_parameters())
    n_trainable = 0
    for jpath, name in names.items():
        assert pmask[name] == jmask[jpath], (jpath, name)
        assert prm[name].requires_grad == jmask[jpath], name
        lr_mult, decay_mult = jax_optim._custom_key_mults(keys, jpath)
        assert optim.custom_key_mults(keys, name) == (lr_mult, decay_mult)
        if jmask[jpath]:
            n_trainable += 1
            g = group_of[id(prm[name])]
            assert g['lr_mult'] == lr_mult
            assert g['weight_decay'] == pytest.approx(0.01 * decay_mult)
        else:
            assert id(prm[name]) not in group_of
    assert 0 < n_trainable < len(names)
    assert any(n.startswith('clip_encoder') for n in names.values())


@pytest.mark.parametrize('warmup', [0, 7])
def test_poly_schedule_matches_jax(warmup):
    want = jax_optim.make_poly_schedule(1e-4, 50, warmup, 1e-6)
    got = optim.make_poly_schedule(1e-4, 50, warmup, 1e-6)
    for step in (0, 1, 3, 6, 7, 8, 25, 49, 50, 60):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)


# ------------------------------------------------------ one whole step

@pytest.fixture(scope='module')
def step_pair(tiny):
    """One SemiVL step in JAX (1-device mesh) and in the port, from the same
    weights, batch, boxes and feature-perturbation masks."""
    jm, params, pm, mcc = tiny
    text = text_embedding()
    batch = semivl_batch(7, B, IMG)
    conf_thresh, mcc_thresh = pseudo_label_thresholds(pm, text, mcc, batch)
    cfg = dict(flagship_train_cfg(IMG), conf_thresh=conf_thresh,
               mcc_conf_thresh=mcc_thresh, log_grad_norm=True)
    rs = np.random.RandomState(8)
    keeps = [rs.rand(B, 1, 1, c) < 0.5 for c in (128, 128, 512)]
    return semivl_step_pair(jm, params, pm, mcc, text, batch, cfg, keeps,
                            TOTAL)


def test_semivl_step_losses_match_jax(step_pair):
    jm, pmet = step_pair['jmetrics'], step_pair['pmetrics']
    assert set(LOSS_KEYS) | {'grad_norm'} == set(pmet)
    for k in LOSS_KEYS + ('grad_norm',):
        assert np.isfinite(pmet[k]), k
        assert abs(pmet[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pmet[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1', 'loss_mc_fp'):
        assert pmet[k] > 0, k   # the thresholds keep some pixels


def test_semivl_step_grads_and_update_match_jax(step_pair):
    """Every trainable leaf's gradient and updated value within 1e-3 of its
    own scale. A leaf whose gradient vanishes in exact arithmetic (the
    head's bias: it is shared by the class planes, over which each pixel's
    softmax-CE gradient sums to zero) is held to |g| <= 1e-6 of the largest
    gradient on both sides instead: what is left there is rounding."""
    bad, n_checked = step_mismatches(step_pair)
    assert bad == []
    assert n_checked > 20
