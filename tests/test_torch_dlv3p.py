"""The port's exp-41 ablation models (a DeepLabV3+ head with BatchNorm on the
MaskCLIP ViT, ``ftap`` and ``ft``, or on a timm ViT) against the JAX
package on the CPU, float32 on both sides, at small widths: ViTs of width
128 with 2 heads of 64 (the MaskCLIP one with 2 layers, its layer-0 map and
dense CLIP embedding standing for layer 4's and the embedding; the timm
one with 3 layers, layers 1 and 2 standing for 4 and 11), the head at its
real widths (ASPP in/8, 48-channel skip, 256-channel fuse) on 8 x 8 maps.
JAX's builder makes every timm ViT ViT-B/16, so both sides' builders are
handed the small one here.

Tolerances: modules 1e-5 of the output scale, their gradients 1e-4 of
each leaf's scale; the step's loss terms 1e-4 relative, every trainable
gradient and updated parameter 1e-3 of its own scale (the bounds of
tests/test_torch_train.py), the BatchNorm running statistics 1e-5, as the
Cityscapes step's (tests/test_torch_cityscapes.py).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.configs.experiments import generate_experiment_cfgs
from semivl_tpu.models import builder as jax_builder
from semivl_tpu.models.dlv3p_head import DLV3PHead as JaxHead
from semivl_tpu.models.timm_vit import TIMMVisionTransformer as JaxTIMM
from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu.train import optim as jax_optim
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs.models import get_model_config
from semivl_tpu_torch.models import vlm as port_vlm
from semivl_tpu_torch.models.builder import build_model, is_trainable
from semivl_tpu_torch.models.dlv3p_head import DLV3PHead
from semivl_tpu_torch.models.timm_vit import TIMMVisionTransformer
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import LOSS_KEYS

from torch_parity import (InjectedDropout, gap_threshold, leaf_names,
                          random_tree, rel_err, resolved_step_mismatches,
                          semivl_batch, semivl_step_pair, text_embedding)

IMG, EMB, NCLS, TOTAL = 128, 128, 21, 100
GRID = IMG // 16
MARGIN = 1e-5
MCVIT = dict(type='MaskClipVisionTransformer', img_size=(IMG, IMG),
             patch_size=16, embed_dims=EMB, num_layers=2, num_heads=2,
             mlp_ratio=4, out_indices=[0, 2], clip_dim=512)
TVIT = dict(type='TIMMVisionTransformer', img_size=IMG, out_indices=[1, 2],
            drop_path_rate=0.1)
SMALL_TIMM = dict(embed_dims=EMB, num_layers=3, num_heads=2)
# exp 41's three DeepLabV3+ rows: (model name, backbone, head in_channels)
MODELS = {
    'vlm-dlv3p-bn12-sk4-ftap-mcvitb': (MCVIT, 512),
    'vlm-dlv3p-bn12-sk4-ft-mcvitb': (MCVIT, 512),
    'vlm-dlv3p-bn11-sk4-ft-tvit-in1k': (TVIT, EMB),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _head_cfg(in_channels):
    return dict(type='DLV3PHead', img_size=IMG, in_channels=in_channels,
                channels=256, c1_in_channels=EMB, c1_channels=48,
                dilations=(6, 12, 18), num_classes=NCLS,
                align_corners=False)


def _random_stats(shapes, seed):
    """BatchNorm running statistics: means N(0, 0.1), variances in
    [0.5, 1.5]."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if jax.tree_util.keystr(path).endswith("'var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_small_timm(real):
    """JAX's ``build_backbone`` with the timm ViT at this file's widths."""
    def build(cfg, dtype):
        if cfg['type'] == 'TIMMVisionTransformer':
            return JaxTIMM(img_size=(cfg['img_size'],) * 2,
                           out_indices=tuple(cfg['out_indices']),
                           dtype=dtype, **SMALL_TIMM)
        return real(cfg, dtype)
    return build


def _port_small_timm(real):
    def build(cfg, dtype):
        if cfg['type'] == 'TIMMVisionTransformer':
            return TIMMVisionTransformer(
                img_size=(cfg['img_size'],) * 2,
                out_indices=tuple(cfg['out_indices']), dtype=dtype,
                **SMALL_TIMM)
        return real(cfg, dtype)
    return build


@pytest.fixture
def small_timm():
    """Both builders make the small timm ViT (module docstring)."""
    with mock.patch.object(jax_builder, 'build_backbone',
                           _jax_small_timm(jax_builder.build_backbone)), \
            mock.patch.object(port_vlm, 'build_backbone',
                              _port_small_timm(port_vlm.build_backbone)):
        yield


# ------------------------------------------------------------- the head

@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('dilations', [(6, 12, 18), (1, 2, 3)])
def test_dlv3p_head_matches_jax(train, dilations):
    """Eval mode on random running statistics; train mode on the batch's,
    with the running statistics' update. Outputs and the gradients of a
    random projection of them, in every parameter and both inputs."""
    jm = JaxHead(img_size=IMG, num_classes=NCLS, in_channels=512,
                 c1_in_channels=EMB, dilations=dilations, axis_name=None)
    rs = np.random.RandomState(1)
    c1 = rs.randn(2, GRID, GRID, EMB).astype(np.float32)
    c4 = rs.randn(2, GRID, GRID, 512).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), (jnp.asarray(c1), jnp.asarray(c4))))
    params = random_tree(shapes['params'], 2)
    stats = _random_stats(shapes['batch_stats'], 3)
    cot = rs.randn(2, NCLS, IMG, IMG).astype(np.float32)

    def loss(p, f1, f4):
        out = jm.apply({'params': p, 'batch_stats': stats}, (f1, f4),
                       train=train, mutable=['batch_stats'])
        return jnp.sum(out[0] * cot), out

    (_, (want, upd)), (gp, g1, g4) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(c1),
                                                jnp.asarray(c4))
    pm = DLV3PHead(IMG, NCLS, in_channels=512, c1_in_channels=EMB,
                   dilations=dilations)
    sd = {}
    convert.export_dlv3p_head(sd, params, stats, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    f1, f4 = _t(c1).requires_grad_(), _t(c4).requires_grad_()
    got = pm((f1, f4), None, output_size=(IMG, IMG), train=train)
    (got * _t(cot)).sum().backward()
    assert got.shape == want.shape == (2, NCLS, IMG, IMG)
    assert rel_err(got.detach().numpy(), want) < 1e-5
    grads = {}
    convert.export_dlv3p_head(grads, jax.tree.map(np.asarray, gp),
                              prefix='')
    prm = dict(pm.named_parameters())
    assert set(grads) == set(prm)
    for name, g in grads.items():
        assert rel_err(prm[name].grad.numpy(), g) < 1e-4, name
    assert rel_err(f1.grad.numpy(), g1) < 1e-4
    assert rel_err(f4.grad.numpy(), g4) < 1e-4
    new = {}
    convert.export_dlv3p_head(new, params, upd.get('batch_stats', stats),
                              prefix='')
    running = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert len(running) == 2 * 9     # ASPP 6 + c1_proj + fuse1 + fuse2
    for k in running:
        assert rel_err(pm.state_dict()[k].numpy(), new[k]) < 1e-5, k
        assert np.allclose(new[k], sd[k]) != train, k


# ------------------------------------------------------------ timm ViT

@pytest.mark.parametrize('hw', [(IMG, IMG), (96, 112)])
def test_timm_vit_matches_jax(hw):
    """The out_indices maps (final norm applied) and the cls embedding, and
    the gradients of a random projection of them in every parameter; an
    input of another size is resized to the training size first."""
    jm = JaxTIMM(img_size=(IMG, IMG), out_indices=(1, 2), **SMALL_TIMM)
    rs = np.random.RandomState(4)
    img = rs.randn(2, *hw, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, IMG, IMG, 3))))
    params = random_tree(shapes['params'], 5)
    cots = [rs.randn(2, GRID, GRID, EMB).astype(np.float32)
            for _ in range(2)] + [rs.randn(2, EMB).astype(np.float32)]

    def loss(p):
        out = jm.apply({'params': p}, jnp.asarray(img))
        outs = list(out['feats']) + [out['global_emb']]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm = TIMMVisionTransformer((IMG, IMG), out_indices=(1, 2), **SMALL_TIMM)
    sd = {}
    convert.export_timm_vit(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    out = pm(_t(img))
    got = list(out['feats']) + [out['global_emb']]
    sum((o * _t(c)).sum() for o, c in zip(got, cots)).backward()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.detach().numpy(), w) < 1e-5
    grads = {}
    convert.export_timm_vit(grads, jax.tree.map(np.asarray, gp), prefix='')
    prm = dict(pm.named_parameters())
    assert set(grads) == set(prm)
    for name, g in grads.items():
        assert rel_err(prm[name].grad.numpy(), g) < 1e-4, name


# ------------------------------------------- the MaskCLIP ViT's two maps

def test_maskclip_vit_layer4_and_clip_embed_match_jax():
    """``out_indices=(4, 12)`` on a 12-layer MaskCLIP ViT (exp 41's
    ``mcvitb`` rows, at width 64): the layer-4 v-path map and the dense
    CLIP embedding, and the cls embedding, as JAX's."""
    from semivl_tpu.models.clip_vit import MaskClipViT as JaxViT
    cfg = dict(img_size=(32, 32), patch_size=16, embed_dims=64,
               num_layers=12, num_heads=4, mlp_ratio=2, out_indices=(4, 12),
               clip_dim=512)
    jm = JaxViT(**cfg)
    img = np.random.RandomState(9).randn(2, 32, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3))))
    params = random_tree(shapes['params'], 10)
    want = jm.apply({'params': params}, jnp.asarray(img))
    pm = port_vlm.build_backbone(dict(cfg, type='MaskClipVisionTransformer'),
                                 torch.float32)
    sd = {}
    convert.export_maskclip_vit(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pm(_t(img))
    assert [tuple(f.shape) for f in got['feats']] == [(2, 2, 2, 64),
                                                      (2, 2, 2, 512)]
    for g, w in zip(got['feats'] + (got['global_emb'],),
                    tuple(want['feats']) + (want['global_emb'],)):
        assert rel_err(g.numpy(), w) < 1e-5


# ------------------------------------------------------------ the VLMs

def _models(name, seed=0, logit_scale=1.0):
    """The JAX VLM of exp 41's ``name`` at this file's widths, its
    variables (random parameters and running statistics) and the port
    model carrying them, with its trainable leaves as the model's freeze
    rule says."""
    backbone, in_channels = MODELS[name]
    head = _head_cfg(in_channels)
    ref = get_model_config(name)['model']
    jm = JaxVLM(backbone_cfg=backbone, decode_head_cfg=head)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        jnp.zeros((NCLS, 512))))
    params = random_tree(shapes['params'], seed)
    cls = params['decode_head']['classifier']
    cls['kernel'] = cls['kernel'] * np.float32(logit_scale)
    cls['bias'] = cls['bias'] * np.float32(logit_scale)
    stats = _random_stats(shapes['batch_stats'], seed + 1)
    pm = convert.load_jax_params(VLM(backbone, head), params, stats).eval()
    for n, p in pm.named_parameters():
        p.requires_grad_(is_trainable(n, ref['freeze_backbone'],
                                      ref['exclude_keys']))
    return jm, params, stats, pm, ref


def _keeps(name, rs, b):
    """Feature-perturbation channel masks of the two maps the head reads."""
    c4 = 512 if MODELS[name][0] is MCVIT else EMB
    return [rs.rand(b, 1, 1, c) < 0.5 for c in (EMB, c4)]


@pytest.mark.parametrize('name', list(MODELS))
def test_vlm_matches_jax(name, small_timm):
    """Eval mode (running statistics) with the clean batch and the
    perturbed w half decoded together (the same channel masks on both
    sides); the head ignores the text."""
    jm, params, stats, pm, _ = _models(name)
    variables = {'params': params, 'batch_stats': stats}
    rs = np.random.RandomState(6)
    img = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    text = text_embedding()
    keeps = _keeps(name, rs, 1)
    fake = InjectedDropout(keeps)
    with mock.patch('semivl_tpu.models.vlm.dropout2d', fake.jax):
        want, want_fp = jm.apply(variables, jnp.asarray(img),
                                 jnp.asarray(text), need_fp=True,
                                 rngs={'fp': jax.random.PRNGKey(0)})
    fake.calls = 0
    with mock.patch('semivl_tpu_torch.models.vlm.dropout2d', fake.torch), \
            torch.no_grad():
        got, got_fp = pm(_t(img), _t(text), need_fp=True)
        other = pm(_t(img), _t(text[::-1].copy()))
    assert fake.calls == 2
    assert got.shape == want.shape == (2, NCLS, IMG, IMG)
    assert got_fp.shape == want_fp.shape == (1, NCLS, IMG, IMG)
    assert rel_err(got.numpy(), want) < 1e-5
    assert rel_err(got_fp.numpy(), want_fp) < 1e-5
    assert torch.equal(other, got)


def test_builder_makes_exp41_models():
    """``build_model`` on each of exp 41's DeepLabV3+ configs (the real
    widths, crop 128): the head on the backbone's two maps, BatchNorm
    statistics as buffers, the frozen leaves of ``ftap`` (all of the backbone but attention and positional
    embedding) and none under ``ft``; the guidance encoder absent (exp 41
    sets no consistency loss)."""
    cfgs = {c['model'].replace('mmseg.', ''): c
            for c in generate_experiment_cfgs(41)}
    for name in MODELS:
        cfg = cfgs[name]
        b = build_model(dict(cfg, crop_size=IMG), device='cpu')
        m = b.model
        assert isinstance(m.decode_head, DLV3PHead) and m.clip_encoder is None
        frozen = [n for n, p in m.named_parameters() if not p.requires_grad]
        if 'ftap' in name:
            assert frozen and all(n.startswith('backbone.') and not any(
                k in n for k in ('attn', 'pos_embed')) for n in frozen)
        else:
            assert frozen == []
        assert len([n for n, _ in m.named_buffers()
                    if n.startswith('decode_head.')]) == 2 * 9
        with torch.no_grad():
            out = m(torch.zeros(1, IMG, IMG, 3), torch.as_tensor(
                b.text_feats))
        assert out.shape == (1, NCLS, IMG, IMG)


# ------------------------------------------------------ masks, groups

@pytest.mark.parametrize('name', list(MODELS))
def test_trainable_mask_and_multipliers_match_jax(name, small_timm):
    """Each leaf's trainable flag and (lr_mult, decay_mult) from its port
    name equal JAX's ``trainable_mask`` and ``_custom_key_mults`` from its
    path under the row's generated config, and the optimizer's groups
    carry them."""
    _, params, _, pm, ref = _models(name)
    cfg = next(c for c in generate_experiment_cfgs(41)
               if c['model'] == 'mmseg.' + name)
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    names = leaf_names(params)
    paths = jax.tree_util.tree_leaves(jax_optim.param_path_strings(params))
    jmask = dict(zip(paths, jax.tree_util.tree_leaves(
        jax_optim.trainable_mask(params, ref['freeze_backbone'],
                                 ref['exclude_keys']))))
    opt, _ = optim.build_optimizer(cfg, pm, TOTAL)
    group_of = {id(p): g for g in opt.param_groups for p in g['params']}
    prm = dict(pm.named_parameters())
    assert len(names) == len(prm)
    seen = set()
    for jpath, pname in names.items():
        assert prm[pname].requires_grad == jmask[jpath], (jpath, pname)
        want = jax_optim._custom_key_mults(keys, jpath)
        assert optim.custom_key_mults(keys, pname) == want, (jpath, pname)
        seen.add(want)
        if jmask[jpath]:
            g = group_of[id(prm[pname])]
            assert g['lr_mult'] == want[0]
            assert g['weight_decay'] == pytest.approx(0.01 * want[1])
        else:
            assert id(prm[pname]) not in group_of
    backbone = cfg['optimizer']['paramwise_cfg']['custom_keys'][
        'backbone']['lr_mult']
    assert seen == {(backbone, 1.0), (10.0, 1.0)}


# ------------------------------------------------------------- convert

@pytest.mark.parametrize('name', list(MODELS))
def test_convert_carries_every_leaf(name, small_timm):
    """Every JAX parameter and BatchNorm statistic lands in exactly one
    port key with its value (``strict`` load), and the port's state dict
    gives the same arrays back."""
    _, params, stats, pm, _ = _models(name)
    sd = convert.vlm_state_dict(params, stats)
    own = pm.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(
        jax.tree_util.tree_leaves(stats))
    assert set(sd) == set(own) and len(sd) == n_leaves
    for k, v in sd.items():
        assert np.array_equal(own[k].numpy(), v), k


# ------------------------------------------------------ one whole step

def _thresholds(pm, text, batch, keeps):
    """A confidence threshold away from every pseudo-label confidence that
    counts (the teacher's, BatchNorm in eval mode; the student's w half,
    train mode, the running statistics restored after), after checking
    that no such label sits within MARGIN of an argmax tie."""
    fake = InjectedDropout(keeps)
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad(), mock.patch(
            'semivl_tpu_torch.models.vlm.dropout2d', fake.torch):
        teacher = pm(_t(batch['img_w_other']), _t(text))
        b = batch['img_x'].shape[0]
        student = pm(_t(np.concatenate([batch['img_x'], batch['img_w']])),
                     _t(text), need_fp=True, train=True)[0][b:]
    for k, v in pm.named_buffers():
        v.copy_(buffers[k])
    confs = []
    for logits in (teacher, student):
        top2 = np.sort(logits.numpy(), axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
        confs.append(torch.softmax(logits, 1).amax(1).numpy().ravel())
    thresh, margin = gap_threshold(np.concatenate(confs))
    assert margin > MARGIN
    return thresh


@pytest.fixture(scope='module', params=list(MODELS))
def step_pair(request):
    """One step of the row's generated config (CELoss, no guidance loss)
    in JAX (1-device mesh) and in the port, from the same variables, batch
    (2 labeled + 2 unlabeled), boxes and perturbation masks."""
    name = request.param
    with mock.patch.object(jax_builder, 'build_backbone',
                           _jax_small_timm(jax_builder.build_backbone)), \
            mock.patch.object(port_vlm, 'build_backbone',
                              _port_small_timm(port_vlm.build_backbone)):
        jm, params, stats, pm, ref = _models(name, seed=3, logit_scale=8.0)
        text = text_embedding()
        batch = semivl_batch(8, 2, IMG)
        keeps = _keeps(name, np.random.RandomState(8), 2)
        cfg = next(c for c in generate_experiment_cfgs(41)
                   if c['model'] == 'mmseg.' + name)
        cfg = dict(cfg, crop_size=IMG, log_grad_norm=True,
                   conf_thresh=_thresholds(pm, text, batch, keeps))
        out = semivl_step_pair(jm, params, pm, None, text, batch, cfg, keeps,
                               TOTAL, stats=stats,
                               freeze_backbone=ref['freeze_backbone'],
                               exclude_keys=ref['exclude_keys'])
    return dict(out, name=name, cfg=cfg)


def test_dlv3p_step_losses_match_jax(step_pair):
    jm, pmet = step_pair['jmetrics'], step_pair['pmetrics']
    keys = ('loss_x', 'loss_s1', 'loss_s2', 'loss_fp', 'loss_all',
            'grad_norm')
    assert set(pmet) == set(keys) and set(keys) < set(LOSS_KEYS) | {
        'grad_norm'}
    for k in keys:
        assert np.isfinite(pmet[k]), k
        assert abs(pmet[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pmet[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp'):
        assert pmet[k] > 0, k


def test_dlv3p_step_grads_stats_and_update_match_jax(step_pair):
    """Every trainable leaf within 1e-3 of its own scale in gradient and in
    its updated value wherever that gradient fixes the first Adam step's
    sign (``resolved_step_mismatches``: an element whose gradient is float32
    rounding, such as a dilated tap that sees only padding, takes a step of
    lr x lr_mult times that rounding's sign on either side, and is held to
    that bound instead), frozen leaves unchanged (``ftap``: the backbone but
    attention and positional embedding), every backbone leaf trained
    (``ft``), and the head's 18 running statistics after both student
    passes within 1e-5 of JAX's and changed."""
    s = step_pair
    bad, n_checked, n_stats = resolved_step_mismatches(s, s['cfg'])
    assert bad == [] and n_stats == 2 * 9 and n_checked > 30
    backbone = [n for n in s['trainable'] if n.startswith('backbone.')]
    assert all(s['trainable'][n] for n in backbone) == ('ftap' not in
                                                        s['name'])
    assert any(s['trainable'][n] for n in backbone)
