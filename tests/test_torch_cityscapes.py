"""The port's Cityscapes model (exp 44: ViT + a ResNetV1c skip encoder with
BatchNorm, ``renorm_clip_img``, ``concept3`` guidance text, ``pixelavg``,
the banded decoder backward, ``sliding_window`` evaluation) against the
JAX package on the CPU, float32 on both sides, at a small size: 64-px
crops, the ``tiny_model`` ViT, the real ResNetV1c-101 first stage, and the
19 Cityscapes classes (``concept3`` aggregates its 54 concepts to them).

Tolerances: modules 1e-5 of the output scale; the step's loss terms 1e-4
relative, every trainable gradient and updated parameter 1e-3 of its own
scale, the BatchNorm running statistics 1e-5 (the bounds of
tests/test_torch_train.py); predictions identical but at near-ties of the
JAX scores (1e-4). The conv encoder's gradients are held to 5e-2 of their
scale (median 1e-2): the skip gradient reaching it is a sum over the 19
class planes of terms that nearly cancel (each pixel's CE gradient sums to
zero over classes), and its BatchNorm backward removes most of what is
left, so float32 cannot resolve it finer. Measured at this geometry with
the JAX step itself run once in float32 and once in float64: its float32
gradients lie up to 2.3e-2 (median 4.5e-3) from its float64 ones on these
leaves (and the port's float32 ResNetV1c alone lies within 1e-5 of its
float64 one).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator
from semivl_tpu.models.builder import ModelBundle as JaxBundle
from semivl_tpu.models.resnet import ResNetV1c as JaxResNet
from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu.train import optim as jax_optim
from semivl_tpu.train.step import TrainState, make_semivl_train_step as jax_step
from semivl_tpu.train.step import replicate, shard_batch
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs import cityscapes_cfg, cityscapes_train_cfg
from semivl_tpu_torch.evaluation import metrics
from semivl_tpu_torch.evaluation.predict import Evaluator
from semivl_tpu_torch.models.builder import is_trainable
from semivl_tpu_torch.models.vlm import VLM, build_backbone
from semivl_tpu_torch.ops import fused_decoder_banded as fdb
from semivl_tpu_torch.text.embeddings import get_class_to_concept_idxs
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import LOSS_KEYS, make_semivl_train_step

from tiny_model import CLIP_DIM, EMB, tiny_backbone_cfg
from torch_parity import (InjectedDropout, PortBundle, gap_threshold,
                          leaf_names, masked_grads, random_tree, rel_err)

IMG, NCLS, TOTAL = 64, 19, 100
MARGIN = 1e-5
MCC_NAME = 'cityscapes_concept3_single'
CONV = dict(type='ResNetV1c', depth=101, num_stages=1, out_indices=[0])
HEAD = dict(type='VLGHead', img_size=IMG, num_classes=NCLS,
            text_in_channels=CLIP_DIM, text_channels=32,
            up_channels=(32, 16), skip_in_channels=(EMB, 256),
            skip_channels=(16, 16), skip_from_conv_feat=True, num_layers=1,
            num_heads=2, channels=32, pool_size=(2, 2), conv1_ksize=3,
            align_corners=False, decoder_bwd='banded')
BACKBONE = tiny_backbone_cfg(IMG, [1, 2])
CLIP = tiny_backbone_cfg(IMG, None)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_stats(shapes, seed):
    """BatchNorm running statistics: means N(0, 0.1), variances in
    [0.5, 1.5]."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if jax.tree_util.keystr(path).endswith("'var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _unit(n, dim, seed):
    t = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


# ------------------------------------------------------------- ResNetV1c

def test_resnet_v1c_matches_jax():
    """Eval mode (running statistics) and train mode (batch statistics,
    with the flax running-statistic update: biased variance, momentum
    0.9)."""
    jm = JaxResNet(depth=101, num_stages=1, out_indices=(0,), axis_name=None)
    img = np.random.RandomState(1).randn(2, IMG, IMG, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, IMG, IMG, 3))))
    params = random_tree(shapes['params'], 2)
    stats = _random_stats(shapes['batch_stats'], 3)
    variables = {'params': params, 'batch_stats': stats}
    want_eval = jm.apply(variables, jnp.asarray(img))
    want_train, upd = jm.apply(variables, jnp.asarray(img), train=True,
                               mutable=['batch_stats'])

    pm = build_backbone(CONV, torch.float32)
    sd = {}
    convert.export_resnet_v1c(sd, params, stats, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got_eval = pm(_t(img))
        got_train = pm(_t(img), train=True)
    assert got_eval[0].shape == want_eval[0].shape == (2, 16, 16, 256)
    assert rel_err(got_eval[0].numpy(), want_eval[0]) < 1e-5
    assert rel_err(got_train[0].numpy(), want_train[0]) < 1e-5
    new = {}
    convert.export_resnet_v1c(new, params, upd['batch_stats'], prefix='')
    running = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert len(running) == 2 * 13     # stem 3 + 3 blocks x 3 + downsample
    for k in running:
        got = pm.state_dict()[k].numpy()
        assert rel_err(got, new[k]) < 1e-5, k
        assert not np.allclose(got, sd[k]), k


# ------------------------------------------------------------ the model

def _models(seed=0, logit_scale=20.0):
    """The skr04-shaped JAX VLM with its variables (random parameters and
    running statistics) and the port model carrying them."""
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=HEAD,
                conv_encoder_cfg=CONV, clip_encoder_cfg=CLIP,
                renorm_clip_img=True, mcc_text_embedding_name=MCC_NAME)
    mcc = _unit(54, CLIP_DIM, 9)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        jnp.zeros((NCLS, CLIP_DIM)), jnp.asarray(mcc),
        method='init_variables'))
    params = random_tree(shapes['params'], seed)
    head = params['decode_head']['head']
    head['kernel'] = head['kernel'] * np.float32(logit_scale)
    head['bias'] = head['bias'] * np.float32(logit_scale)
    stats = _random_stats(shapes['batch_stats'], seed + 1)
    pm = VLM(BACKBONE, HEAD, clip_encoder_cfg=CLIP, conv_encoder_cfg=CONV,
             renorm_clip_img=True, mcc_text_name=MCC_NAME)
    convert.load_jax_params(pm, params, stats)
    for name, p in pm.named_parameters():
        p.requires_grad_(is_trainable(name, True, ['attn', 'pos_embed']))
    return jm, params, stats, pm.eval(), mcc


@pytest.fixture(scope='module')
def models():
    return _models()


def test_vlm_forward_with_fp_and_maskclip_match_jax(models):
    """``renorm_clip_img``, skips from the conv encoder and feature
    perturbation of the w half (the same channel masks on both sides, in
    the JAX order: ViT maps, then the conv encoder's); the guidance labels
    with ``concept3`` (54 concepts max-aggregated to 19 classes)."""
    jm, params, stats, pm, mcc = models
    variables = {'params': params, 'batch_stats': stats}
    rs = np.random.RandomState(4)
    img = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    text = _unit(NCLS, CLIP_DIM, 5)
    keeps = [rs.rand(1, 1, 1, c) < 0.5 for c in (EMB, CLIP_DIM, 256)]
    fake = InjectedDropout(keeps)
    with mock.patch('semivl_tpu.models.vlm.dropout2d', fake.jax):
        want, want_fp = jax.jit(lambda v, x, t: jm.apply(
            v, x, t, need_fp=True, rngs={'fp': jax.random.PRNGKey(0)}))(
                variables, jnp.asarray(img), jnp.asarray(text))
    assert fake.calls == 3
    fake.calls = 0
    with mock.patch('semivl_tpu_torch.models.vlm.dropout2d', fake.torch), \
            torch.no_grad():
        got, got_fp = pm(_t(img), _t(text), need_fp=True)
    assert fake.calls == 3
    assert got.shape == want.shape == (2, NCLS, IMG, IMG)
    assert got_fp.shape == want_fp.shape == (1, NCLS, IMG, IMG)
    assert rel_err(got.numpy(), want) < 1e-5
    assert rel_err(got_fp.numpy(), want_fp) < 1e-5

    probs = pm.maskclip_probs(_t(img), mcc).numpy()
    assert probs.shape == (2, IMG, IMG, NCLS)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    thresh, margin = gap_threshold(top2[..., 1])
    assert margin > MARGIN and (top2[..., 1] - top2[..., 0]).min() > MARGIN
    want = np.asarray(jax.jit(lambda v, x, t: jm.apply(
        v, x, t, thresh, method='forward_maskclip'))(
            variables, jnp.asarray(img), jnp.asarray(mcc)))
    got = pm.forward_maskclip(_t(img), mcc, thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 255).mean() < 1
    assert sorted(i for v in get_class_to_concept_idxs(MCC_NAME).values()
                  for i in v) == list(range(54))


# --------------------------------------------------------- one whole step

def _batch(seed, b=1):
    rs = np.random.RandomState(seed)

    def img():
        return rs.randn(b, IMG, IMG, 3).astype(np.float32)

    ign = np.zeros((b, IMG, IMG), np.int32)
    ign[:, :, :3] = 255
    ign_o = ign.copy()
    ign_o[:, -4:] = 255
    mask = rs.randint(0, NCLS, (b, IMG, IMG)).astype(np.int32)
    mask[:, :2] = 255
    return dict(
        img_x=img(), mask_x=mask, img_w=img(), img_s1=img(), img_s2=img(),
        ignore_mask=ign, img_w_other=img(), img_s1_other=img(),
        img_s2_other=img(), ignore_mask_other=ign_o,
        cutmix_box1=np.array([[10, 5, 20, 35]], np.int32),
        cutmix_box2=np.array([[32, 32, 30, 30]], np.int32))


def _label_margins(pm, text, mcc, batch, keeps):
    """The guidance-label threshold for this batch, after checking that no
    label that counts sits within MARGIN of a tie: the teacher's (BatchNorm
    in eval mode), the student's w half (train mode, the running
    statistics restored after) and the guidance encoder's."""
    fake = InjectedDropout(keeps)
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad(), mock.patch(
            'semivl_tpu_torch.models.vlm.dropout2d', fake.torch):
        teacher = pm(_t(batch['img_w_other']), _t(text))
        student = pm(_t(np.concatenate([batch['img_x'], batch['img_w']])),
                     _t(text), need_fp=True, train=True)[0][1:]
        mc = pm.maskclip_probs(_t(np.concatenate(
            [batch['img_w'], batch['img_w_other']])), mcc).numpy()
    for k, v in pm.named_buffers():
        v.copy_(buffers[k])
    for logits in (teacher, student):
        top2 = np.sort(logits.numpy(), axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    thresh, margin = gap_threshold(mc.max(axis=-1))
    top2 = np.sort(mc, axis=-1)[..., -2:]
    kept = top2[..., 1] >= thresh
    assert margin > MARGIN and 0 < kept.mean() < 1
    assert (top2[..., 1] - top2[..., 0])[kept].min() > MARGIN
    return thresh


@pytest.fixture(scope='module')
def step_pair():
    """One exp-44 step in JAX (1-device mesh) and in the port, from the same
    variables, batch (1 labeled + 1 unlabeled), boxes and perturbation
    masks; the port's decoder backward takes the banded route."""
    jm, params, stats, pm, mcc = _models(seed=3)
    text = _unit(NCLS, CLIP_DIM, 6)
    batch = _batch(7)
    rs = np.random.RandomState(8)
    keeps = [rs.rand(1, 1, 1, c) < 0.5 for c in (EMB, CLIP_DIM, 256)]
    mcc_thresh = _label_margins(pm, text, mcc, batch, keeps)
    cfg = dict(cityscapes_train_cfg(IMG), mcc_conf_thresh=mcc_thresh,
               log_grad_norm=True)
    fake = InjectedDropout(keeps)

    bundle = JaxBundle(module=jm, text_feats=text, mcc_text_feats=mcc,
                       num_classes=NCLS, img_size=IMG, model_cfg={},
                       freeze_backbone=True,
                       exclude_keys=['attn', 'pos_embed'])
    tx, _, mask = jax_optim.build_optimizer(
        cfg, params, TOTAL, freeze_backbone=True,
        exclude_keys=['attn', 'pos_embed'])
    state = TrainState(params={'params': params, 'batch_stats': stats},
                       opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:1]), ('data',))
    with mock.patch('semivl_tpu.models.vlm.dropout2d', fake.jax):
        fn = jax_step(bundle, cfg, tx, mesh, TOTAL, mask)
        new_state, jmetrics = fn(replicate(state, mesh),
                                 shard_batch(batch, mesh),
                                 replicate(jax.random.PRNGKey(0), mesh))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
    new = jax.tree.map(np.asarray, new_state.params)
    jax_grads = convert.vlm_state_dict(masked_grads(new_state.opt_state,
                                                    params))
    assert fake.calls == 3
    jax_new = convert.vlm_state_dict(new['params'], new['batch_stats'])

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    step = make_semivl_train_step(PortBundle(pm, text, mcc), cfg, opt,
                                  TOTAL, device='cpu')
    fake.calls = 0
    launches = (fdb.pass_a_launches, fdb.pass_b_launches,
                fdb.pass_c_launches)
    with mock.patch('semivl_tpu_torch.models.vlm.dropout2d', fake.torch), \
            mock.patch.object(fdb, 'decoder_bwd_banded',
                              wraps=fdb.decoder_bwd_banded) as banded:
        pmetrics = {k: float(v) for k, v in step(batch).items()}
    assert fake.calls == 3 and step.iteration == 1
    assert banded.call_count == 2   # both student passes, the CPU route
    assert (fdb.pass_a_launches, fdb.pass_b_launches,
            fdb.pass_c_launches) == launches
    port_grads = {n: (p.grad.numpy() if p.grad is not None
                      else np.zeros(p.shape, np.float32))
                  for n, p in pm.named_parameters()}
    return dict(jmetrics=jmetrics, pmetrics=pmetrics, jax_new=jax_new,
                jax_grads=jax_grads, port_grads=port_grads, before=before,
                after={k: v.numpy() for k, v in pm.state_dict().items()},
                trainable={n: p.requires_grad
                           for n, p in pm.named_parameters()},
                params=params, pm=pm, cfg=cfg)


def test_cityscapes_step_losses_match_jax(step_pair):
    jm, pmet = step_pair['jmetrics'], step_pair['pmetrics']
    assert set(LOSS_KEYS) | {'grad_norm'} == set(pmet)
    for k in LOSS_KEYS + ('grad_norm',):
        assert np.isfinite(pmet[k]), k
        assert abs(pmet[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pmet[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1', 'loss_mc_fp'):
        assert pmet[k] > 0, k


def test_cityscapes_step_grads_stats_and_update_match_jax(step_pair):
    """Every trainable leaf within 1e-3 of its own scale in gradient and
    update (the conv encoder's gradients within the float32 bound of the
    module docstring), a vanishing gradient (the head's bias) to 1e-6 of
    the largest on both sides; the running statistics after both student
    passes within 1e-5; frozen leaves unchanged."""
    s = step_pair
    assert set(s['jax_new']) == set(s['after'])
    top = max(np.abs(g).max() for g in s['jax_grads'].values())
    bad, checked = [], []
    for name, trainable in s['trainable'].items():
        if not trainable:
            np.testing.assert_array_equal(s['after'][name],
                                          s['before'][name].numpy())
            np.testing.assert_array_equal(s['jax_new'][name],
                                          s['before'][name].numpy())
            continue
        checked.append(name)
        want, got = s['jax_grads'][name], s['port_grads'][name]
        tol = 5e-2 if name.startswith('conv_encoder') else 1e-3
        if np.abs(want).max() <= 1e-6 * top:
            if np.abs(got).max() > 1e-6 * top:
                bad.append((name, 'vanishing', np.abs(got).max()))
        elif rel_err(got, want) > tol:
            bad.append((name, 'grad', rel_err(got, want)))
        if rel_err(s['after'][name], s['jax_new'][name]) > 1e-3:
            bad.append((name, 'update', rel_err(s['after'][name],
                                                s['jax_new'][name])))
        if np.array_equal(s['after'][name], s['before'][name].numpy()):
            bad.append((name, 'unchanged', 0.0))
    running = [k for k in s['after'] if k.endswith(('running_mean',
                                                    'running_var'))]
    for k in running:
        if rel_err(s['after'][k], s['jax_new'][k]) > 1e-5:
            bad.append((k, 'stats', rel_err(s['after'][k], s['jax_new'][k])))
        if np.array_equal(s['after'][k], s['before'][k].numpy()):
            bad.append((k, 'stats unchanged', 0.0))
    assert bad == []
    assert len(running) == 26
    encoder = [n for n in checked if n.startswith('conv_encoder')]
    assert len(encoder) == 39
    errs = sorted(rel_err(s['port_grads'][n], s['jax_grads'][n])
                  for n in encoder)
    assert errs[len(errs) // 2] < 1e-2, errs


def test_cityscapes_optimizer_multipliers_match_jax(step_pair):
    """Each leaf's (lr_mult, decay_mult) from the port's parameter name
    equals JAX's from its path (longest custom key first, substring match):
    conv_encoder x0.1 everywhere in it, BatchNorm leaves included."""
    params, pm, cfg = step_pair['params'], step_pair['pm'], step_pair['cfg']
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    group_of = {id(p): g for g in opt.param_groups for p in g['params']}
    prm = dict(pm.named_parameters())
    names = leaf_names(params)
    for jpath, name in names.items():
        want = jax_optim._custom_key_mults(keys, jpath)
        assert optim.custom_key_mults(keys, name) == want, (jpath, name)
        if prm[name].requires_grad:
            assert group_of[id(prm[name])]['lr_mult'] == want[0]
            assert group_of[id(prm[name])]['weight_decay'] == \
                pytest.approx(0.01 * want[1])
        if name.startswith('conv_encoder'):
            assert want == (0.1, 1.0) and prm[name].requires_grad


# ------------------------------------------------------ sliding window

def test_sliding_window_matches_jax(models):
    """A 74x80 image: windows of 64^2, 64x38, 32x64 and 32x38 (stride 42),
    the edge ones fed at their natural size; predictions identical but at
    JAX near-ties, and the IoU histograms too."""
    jm, params, stats, pm, _ = models
    text = _unit(NCLS, CLIP_DIM, 5)
    cfg = dict(cityscapes_cfg(IMG), nclass=NCLS)
    jev = JaxEvaluator(jm, {'params': params, 'batch_stats': stats}, text,
                       cfg)
    ev = Evaluator(pm, text, cfg, device='cpu')
    hw = (74, 80)
    assert ev.sliding_windows(*hw) == {(64, 64): [(0, 0)],
                                       (64, 38): [(0, 42)],
                                       (32, 64): [(42, 0)],
                                       (32, 38): [(42, 42)]}
    img = (np.random.RandomState(3).rand(1, *hw, 3) * 255).astype(np.uint8)
    got = ev.predict(img, hw, 'sliding_window')
    # the JAX host route (``_sliding``), which also returns the summed
    # probabilities
    want, scores = jev.predict(img, hw, 'sliding_window', return_logits=True)
    top2 = np.sort(scores[0], axis=0)[-2:]
    tie = (top2[1] - top2[0]) < 1e-4
    assert got.shape == want.shape == (1,) + hw
    assert ((got == want) | tie[None]).all()
    mask = np.random.RandomState(13).randint(0, NCLS, hw)
    mask[:4] = 255
    from semivl_tpu.evaluation import metrics as jax_metrics
    for a, b in zip(metrics.intersection_and_union(got[0], mask, NCLS),
                    jax_metrics.intersection_and_union(want[0], mask, NCLS)):
        np.testing.assert_array_equal(a, b)


def test_pos_embed_gradient_through_the_grid_resize():
    """An 801 crop pads to 816 (a 51^2 grid) while the positional grid is
    801 // 16 = 50, so the trainable ``pos_embed`` is trained through its
    bicubic resize. Here the same geometry at small size: a 65-px input
    pads to 80 (5^2) against the 4^2 grid of a 64-px model; the gradient
    of the ViT's outputs with respect to ``pos_embed`` within 1e-5 of its
    scale."""
    from semivl_tpu.models.clip_vit import MaskClipViT as JaxViT
    cfg = {k: v for k, v in BACKBONE.items() if k != 'type'}
    jm = JaxViT(**{**cfg, 'img_size': tuple(cfg['img_size'])})
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, IMG, IMG, 3))))
    params = random_tree(shapes['params'], 11)
    rs = np.random.RandomState(12)
    img = rs.randn(2, 65, 65, 3).astype(np.float32)
    gs = [rs.randn(2, 5, 5, c).astype(np.float32) for c in (EMB, CLIP_DIM)]

    def loss(pos):
        out = jm.apply({'params': {**params, 'pos_embed': pos}},
                       jnp.asarray(img))
        return sum(jnp.sum(f * g) for f, g in zip(out['feats'], gs))

    want = np.asarray(jax.jit(jax.grad(loss))(
        jnp.asarray(params['pos_embed'])))
    pm = build_backbone(BACKBONE, torch.float32)
    sd = {}
    convert.export_maskclip_vit(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    out = pm(_t(img))
    assert [tuple(f.shape) for f in out['feats']] == [(2, 5, 5, EMB),
                                                      (2, 5, 5, CLIP_DIM)]
    (got,) = torch.autograd.grad(
        sum((f * _t(g)).sum() for f, g in zip(out['feats'], gs)),
        pm.pos_embed)
    assert got.shape == want.shape == (1, 17, EMB)
    assert rel_err(got.numpy(), want) < 1e-5
