"""The port's ZegCLIP model of exp 41 (``vlm-zegclip-rd-pt-vitb``: the VPT
CLIP ViT, the ATM head, SegLossPlus and the ``mmseg`` criteria) and the
concept -> class aggregation of both heads, against the JAX package on the
CPU, float32 on both sides, at small widths: ViTs of width 128 with 2 heads
of 64 and 2 or 3 layers, 3 prompt tokens, 128^2 inputs against an
``input_resolution`` of 64 (so the bilinear position resize runs), the
512-d CLIP space, an ATM head of width 64 with 2 heads over N = 5 classes;
the concept cases at VOC's 98 concepts of 21 classes
(``voc12_wbg_concept4_single``).

Tolerances: modules 1e-5 of the output scale, their input and parameter
gradients 1e-4 of each one's scale; SegLossPlus 1e-5 in value and
gradient; the step's loss terms 1e-4 relative, every trainable gradient and
updated parameter 1e-3 of its own scale, frozen leaves unchanged (the
bounds of tests/test_torch_train.py); the evaluator's predictions equal
but at near-ties of JAX's logits (1e-4), its histograms following.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.configs.experiments import generate_experiment_cfgs
from semivl_tpu.evaluation import metrics as jax_metrics
from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator
from semivl_tpu.losses.seg_loss_plus import seg_loss_plus as jax_seg_loss
from semivl_tpu.models.atm_head import ATMSingleHeadSeg as JaxATM
from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu.models.zegclip_vit import (
    CLIPVisionTransformer as JaxCLIPViT,
    VPTCLIPVisionTransformer as JaxVPT,
)
from semivl_tpu.train import optim as jax_optim
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs import flagship_train_cfg
from semivl_tpu_torch.configs.models import get_model_config
from semivl_tpu_torch.evaluation import metrics
from semivl_tpu_torch.evaluation.predict import Evaluator
from semivl_tpu_torch.losses.seg_loss_plus import seg_loss_plus
from semivl_tpu_torch.models.atm_head import ATMSingleHeadSeg
from semivl_tpu_torch.models.builder import build_model
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.models.zegclip_vit import (
    CLIPVisionTransformer,
    VPTCLIPVisionTransformer,
)
from semivl_tpu_torch.text.embeddings import (
    load_text_embedding,
    text_embedding_path,
)
from semivl_tpu_torch.train import optim
from semivl_tpu_torch.train.step import make_semivl_train_step

from torch_parity import (BACKBONE, HEAD, ZEG_IMG, ZEG_NCLS, ZEG_OUT,
                          InjectedDropout, SharedConceptMax, SharedReluMasks,
                          confident_threshold, init_params, leaf_names,
                          pseudo_label_thresholds, rel_err,
                          resolved_step_mismatches, semivl_batch,
                          semivl_step_pair, text_embedding, tiny_train_vlm,
                          zegclip_batch, zegclip_step_mismatches,
                          zegclip_vlm)

IMG, RES, W, OUT, NCLS, TOTAL = ZEG_IMG, 64, 128, ZEG_OUT, ZEG_NCLS, 100
CONCEPTS = 'voc12_wbg_concept4_single'
ZEG = 'vlm-zegclip-rd-pt-vitb'


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _exp41(split='92'):
    return next(c for c in generate_experiment_cfgs(41)
                if c['model'] == 'mmseg.' + ZEG and c['split'] == split)


def _concept_text():
    return load_text_embedding(text_embedding_path('pascal',
                                                   'concept4_single'))


def _grads_match(jax_grads, prm, export, tol=1e-4):
    """Every parameter's gradient (JAX's exported under the port's names)
    within ``tol`` of its scale; a gradient JAX gives as zero is zero."""
    want = {}
    export(want, jax.tree.map(np.asarray, jax_grads))
    assert set(want) == set(prm)
    for name, g in want.items():
        got = prm[name].grad
        got = np.zeros(g.shape, np.float32) if got is None else got.numpy()
        if not np.abs(g).any():
            assert not np.abs(got).any(), name
        else:
            assert rel_err(got, g) < tol, name


# ------------------------------------------------------- the ViTs

@pytest.mark.parametrize('out_indices,total_d_layer,hw', [
    ((2,), 2, (IMG, IMG)),       # the position grid resized 4x4 -> 8x8
    ((0, 2), 1, (RES, RES)),     # no resize; raw tokens of two layers
    ((2,), 2, (96, 128))])       # a non-square grid
def test_vpt_vit_matches_jax(out_indices, total_d_layer, hw):
    """The prompts in after the cls token, replaced before layers
    1..total_d_layer (layer 2 keeps layer 1's with ``total_d_layer=1``);
    the maps (L2-normalised with one out index) and the global embedding,
    and the gradients of a random projection of them in every parameter
    (the prompts among them) and in the image."""
    kw = dict(input_resolution=RES, patch_size=16, width=W, layers=3,
              heads=2, output_dim=OUT, num_tokens=3, prompt_dim=W,
              total_d_layer=total_d_layer, out_indices=out_indices)
    jm = JaxVPT(**kw)
    rs = np.random.RandomState(1)
    img = rs.randn(2, *hw, 3).astype(np.float32)
    params = init_params(jm, 2, jnp.zeros((1, *hw, 3)))
    gh, gw = hw[0] // 16, hw[1] // 16
    dims = [W] * len(out_indices) if len(out_indices) > 1 else [OUT]
    cots = [rs.randn(2, gh, gw, d).astype(np.float32) for d in dims] + [
        rs.randn(2, OUT).astype(np.float32)]

    def loss(p, x):
        out = jm.apply({'params': p}, x)
        outs = list(out['feats']) + [out['global_emb']]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(img))
    pm = VPTCLIPVisionTransformer(**kw)
    sd = {}
    convert.export_vpt_vit(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    x = _t(img).requires_grad_()
    out = pm(x)
    got = list(out['feats']) + [out['global_emb']]
    sum((o * _t(c)).sum() for o, c in zip(got, cots)).backward()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.detach().numpy(), w) < 1e-5
    _grads_match(gp, dict(pm.named_parameters()),
                 lambda o, t: convert.export_vpt_vit(o, t, prefix=''))
    assert rel_err(x.grad.numpy(), gx) < 1e-4
    assert pm.prompt_embeddings.grad.abs().max() > 0
    assert pm.deep_prompt_embeddings.grad.abs().max() > 0


@pytest.mark.parametrize('embed_v', [False, True])
def test_promptless_clip_vit_matches_jax(embed_v):
    """The prompt-less ZegCLIP ViT, the dense embedding from the tokens or
    (``embed_v``) from the last block's MaskCLIP v-path; outputs and the
    gradients of a random projection of them."""
    kw = dict(input_resolution=RES, patch_size=16, width=W, layers=2,
              heads=2, output_dim=OUT, out_indices=(1,), embed_v=embed_v)
    jm = JaxCLIPViT(**kw)
    rs = np.random.RandomState(3)
    img = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    params = init_params(jm, 4, jnp.zeros((1, IMG, IMG, 3)))
    cots = [rs.randn(2, 8, 8, OUT).astype(np.float32),
            rs.randn(2, OUT).astype(np.float32)]

    def loss(p, x):
        out = jm.apply({'params': p}, x)
        outs = [out['feats'][0], out['global_emb']]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(img))
    pm = CLIPVisionTransformer(**kw)
    sd = {}
    convert.export_vpt_vit(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    x = _t(img).requires_grad_()
    out = pm(x)
    got = [out['feats'][0], out['global_emb']]
    sum((o * _t(c)).sum() for o, c in zip(got, cots)).backward()
    for g, w in zip(got, want):
        assert rel_err(g.detach().numpy(), w) < 1e-5
    _grads_match(gp, dict(pm.named_parameters()),
                 lambda o, t: convert.export_vpt_vit(o, t, prefix=''))
    assert rel_err(x.grad.numpy(), gx) < 1e-4


# ------------------------------------------------------- the ATM head

@pytest.mark.parametrize('use_rd,use_proj,concepts', [
    (True, False, False), (False, True, False), (True, True, True)])
def test_atm_head_matches_jax(use_rd, use_proj, concepts):
    """The last layer's masks at the output size and every layer's at the
    feature grid (``return_aux``), with and without the relationship
    descriptor and the input projection, and over VOC's 98 concepts
    max-aggregated to 21 classes; the gradients of a random projection of
    them in every parameter, the features and the global embedding."""
    n, ncls = (98, 21) if concepts else (NCLS, NCLS)
    kw = dict(img_size=IMG, num_classes=ncls, in_channels=OUT, embed_dims=64,
              num_layers=2, num_heads=2, use_proj=use_proj, use_rd=use_rd,
              text_embedding_name=CONCEPTS if concepts else '')
    jm = JaxATM(**kw)
    rs = np.random.RandomState(5)
    feats = rs.randn(2, 8, 8, OUT).astype(np.float32)
    text = _concept_text() if concepts else text_embedding(n, OUT)
    g = rs.randn(2, OUT).astype(np.float32)
    params = init_params(jm, 6, (jnp.asarray(feats),), jnp.asarray(text),
                         global_emb=jnp.asarray(g))
    cot = rs.randn(2, ncls, IMG, IMG).astype(np.float32)
    cot_aux = [rs.randn(2, ncls, 8, 8).astype(np.float32) for _ in range(2)]

    def loss(p, f, ge):
        pred, aux = jm.apply({'params': p}, (f,), jnp.asarray(text),
                             global_emb=ge, return_aux=True)
        total = jnp.sum(pred * cot) + sum(jnp.sum(a * c)
                                          for a, c in zip(aux, cot_aux))
        return total, [pred] + list(aux)

    (_, want), (gp, gf, gg) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(feats),
                                                jnp.asarray(g))
    pm = ATMSingleHeadSeg(**kw)
    sd = {}
    convert.export_atm_head(sd, params, prefix='')
    pm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    f, ge = _t(feats).requires_grad_(), _t(g).requires_grad_()
    pred, aux = pm((f,), _t(text), global_emb=ge, return_aux=True)
    got = [pred] + aux
    total = (pred * _t(cot)).sum() + sum((a * _t(c)).sum()
                                         for a, c in zip(aux, cot_aux))
    total.backward()
    assert pred.shape == (2, ncls, IMG, IMG) and len(aux) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel_err(a.detach().numpy(), b) < 1e-5
    _grads_match(gp, dict(pm.named_parameters()),
                 lambda o, t: convert.export_atm_head(o, t, prefix=''))
    assert rel_err(f.grad.numpy(), gf) < 1e-4
    if use_rd:
        assert rel_err(ge.grad.numpy(), gg) < 1e-4
    else:
        assert ge.grad is None and not np.abs(np.asarray(gg)).any()


# ------------------------------------------------------- SegLossPlus

@pytest.mark.parametrize('case', ['plain', 'resize', 'aux'])
def test_seg_loss_plus_matches_jax(case):
    """Ignored (255) pixels, classes absent from an image (the dice term
    skips them), predictions at a quarter of the labels' size (resized
    bilinearly) or deep supervision over two aux mask sets; the value and
    its gradients in every mask set."""
    rs = np.random.RandomState({'plain': 0, 'resize': 1, 'aux': 2}[case])
    c, h = 6, 32
    labels = rs.randint(0, 3, (2, h, h)).astype(np.int32)
    labels[1] += 2                         # image 1: classes 2-4 only
    labels[0, :5] = 255
    labels[1, :, -3:] = 255
    ph = h // 4 if case == 'resize' else h
    pred = (3 * rs.randn(2, c, ph, ph)).astype(np.float32)
    aux = ([(3 * rs.randn(2, c, h, h)).astype(np.float32) for _ in range(2)]
           if case == 'aux' else [])

    def loss(p, a):
        return jax_seg_loss(p, jnp.asarray(labels), c, aux_masks=a or None)

    want = float(loss(jnp.asarray(pred), [jnp.asarray(x) for x in aux]))
    gp, ga = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(pred), [jnp.asarray(x) for x in aux])
    tp = _t(pred).requires_grad_()
    ta = [_t(x).requires_grad_() for x in aux]
    got = seg_loss_plus(tp, _t(labels).long(), c, aux_masks=ta or None)
    got.backward()
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    assert rel_err(tp.grad.numpy(), gp) < 1e-5
    for x, g in zip(ta, ga):
        assert rel_err(x.grad.numpy(), g) < 1e-5
    present = {(b, k) for b in range(2) for k in np.unique(labels[b])
               if k != 255}
    assert len(present) == 6 < 2 * c      # absent classes in each image


# ----------------------------------------------- the model and its step

def test_zegclip_vlm_matches_jax():
    """The VLM forward with the clean batch and the perturbed w half
    decoded together: the perturbed half's global embedding is the clean
    one's (JAX vlm.py:126-129), the channel masks injected on both
    sides."""
    jm, params, pm, text = zegclip_vlm(seed=1)
    rs = np.random.RandomState(7)
    img = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    fake = InjectedDropout([rs.rand(1, 1, 1, OUT) < 0.5])
    with mock.patch('semivl_tpu.models.vlm.dropout2d', fake.jax):
        want, want_fp = jm.apply({'params': params}, jnp.asarray(img),
                                 jnp.asarray(text), need_fp=True,
                                 rngs={'fp': jax.random.PRNGKey(0)})
    fake.calls = 0
    with mock.patch('semivl_tpu_torch.models.vlm.dropout2d', fake.torch), \
            torch.no_grad():
        got, got_fp = pm(_t(img), _t(text), need_fp=True)
    assert fake.calls == 1
    assert got.shape == want.shape == (2, NCLS, IMG, IMG)
    assert got_fp.shape == want_fp.shape == (1, NCLS, IMG, IMG)
    assert rel_err(got.numpy(), want) < 1e-5
    assert rel_err(got_fp.numpy(), want_fp) < 1e-5


@pytest.fixture(scope='module')
def step_pair():
    """One step of exp 41's generated ZegCLIP config (``mmseg`` for both
    criteria, SegLossPlus) at 5 classes, in JAX (1-device mesh) and in the
    port, from the same weights, batch (2 + 2 crops), boxes and
    perturbation masks; the confidence threshold in a gap of the
    pseudo-labels' confidences, so the unlabeled terms are non-zero."""
    jm, params, pm, text = zegclip_vlm(seed=5, logit_scale=100.0)
    batch = zegclip_batch(8)
    keeps = [np.random.RandomState(8).rand(2, 1, 1, OUT) < 0.5]
    cfg = dict(_exp41(), crop_size=IMG, nclass=NCLS, log_grad_norm=True,
               conf_thresh=confident_threshold(pm, text, batch, keeps))
    out = semivl_step_pair(jm, params, pm, None, text, batch, cfg, keeps,
                           TOTAL, freeze_backbone=True,
                           exclude_keys=['prompt'])
    return dict(out, cfg=cfg)


def test_zegclip_step_losses_match_jax(step_pair):
    jm, pm = step_pair['jmetrics'], step_pair['pmetrics']
    keys = ('loss_x', 'loss_s1', 'loss_s2', 'loss_fp', 'loss_all',
            'grad_norm')
    assert set(pm) == set(keys)
    for k in keys:
        assert np.isfinite(pm[k]), k
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])
    for k in ('loss_s1', 'loss_s2', 'loss_fp'):
        assert pm[k] > 0, k


def test_zegclip_step_grads_and_update_match_jax(step_pair):
    """Every trainable leaf (the backbone's prompt leaves and the head)
    within 1e-3 of its own scale in gradient and updated value, changed,
    the rest of the backbone unchanged; the leaves whose gradient is zero
    in exact arithmetic (the head's last layer after its attention logits,
    which the loss does not reach, and the earlier layers' key bias) held
    as ``zegclip_step_mismatches`` says."""
    s = step_pair
    bad, n_checked, vanishing, unreached = zegclip_step_mismatches(
        s, s['cfg'])
    assert bad == []
    assert len(unreached) == 12 and all(
        n.startswith('decode_head.decoder.1.') for n in unreached)
    assert vanishing - unreached == {'decode_head.decoder.0.attn.k.bias'}
    trained = sorted(n for n, t in s['trainable'].items()
                     if t and n.startswith('backbone.'))
    assert trained == ['backbone.deep_prompt_embeddings',
                       'backbone.prompt_embeddings',
                       'backbone.prompt_norm.bias',
                       'backbone.prompt_norm.weight',
                       'backbone.prompt_proj.bias',
                       'backbone.prompt_proj.weight']
    assert n_checked == len(trained) + sum(
        1 for n in s['trainable'] if n.startswith('decode_head.'))


# ----------------------------------------------- masks and multipliers

def test_trainable_mask_and_multipliers_match_jax():
    """Each leaf's trainable flag and (lr_mult, decay_mult) from its port
    name equal JAX's ``trainable_mask`` and ``_custom_key_mults`` from its
    path under the generated config (whose ``backbone``, ``head``,
    ``norm`` and ``ln`` keys overlap on these names), and the optimizer's
    groups carry them."""
    _, params, pm, _ = zegclip_vlm()
    ref = get_model_config(ZEG)['model']
    cfg = _exp41()
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
    overlaps = 0
    for jpath, pname in names.items():
        assert prm[pname].requires_grad == jmask[jpath], (jpath, pname)
        want = jax_optim._custom_key_mults(keys, jpath)
        assert optim.custom_key_mults(keys, pname) == want, (jpath, pname)
        overlaps += sum(k in pname for k in keys) > 1
        if jmask[jpath]:
            g = group_of[id(prm[pname])]
            assert g['lr_mult'] == want[0]
            assert g['weight_decay'] == pytest.approx(0.01 * want[1])
        else:
            assert id(prm[pname]) not in group_of
    assert overlaps > 10
    assert sum(jmask.values()) == 6 + sum(1 for p in names
                                          if p.startswith('decode_head.'))


# ------------------------------------------------------- evaluation

def test_zegclip_sliding_window_matches_jax():
    """``zegclip_sliding_window`` with the ATM logits: a 160x200 image (on
    the device route, several windows) and a 96x200 one (shorter than the
    crop: the host route) give JAX's predictions but at near-ties of its
    logits, and the same histograms."""
    jm, params, pm, text = zegclip_vlm(seed=9)
    cfg = dict(nclass=NCLS, crop_size=IMG, stride=96,
               eval_mode='zegclip_sliding_window')
    jev = JaxEvaluator(jm, {'params': params}, text, cfg)
    ev = Evaluator(pm, text, cfg, device='cpu')
    for seed, hw in ((0, (160, 200)), (1, (96, 200))):
        rs = np.random.RandomState(seed)
        img = (rs.rand(1, *hw, 3) * 255).astype(np.uint8)
        assert ev.use_device(img, cfg['eval_mode']) == (min(hw) >= IMG)
        got = ev.predict(img, hw, cfg['eval_mode'])
        want = jev.predict(img, hw, cfg['eval_mode'])
        _, logits = jev.predict(img, hw, cfg['eval_mode'],
                                return_logits=True)
        top2 = np.sort(logits[0], axis=0)[-2:]
        tie = (top2[1] - top2[0]) < 1e-4
        assert got.shape == want.shape == (1,) + hw
        assert ((got == want) | tie[None]).all()
        assert (got == want).mean() > 0.99
        mask = rs.randint(0, NCLS, hw)
        mask[:4] = 255
        for a, b in zip(metrics.intersection_and_union(got[0], mask, NCLS),
                        jax_metrics.intersection_and_union(want[0], mask,
                                                           NCLS)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- convert, builder

def test_convert_carries_every_leaf():
    """Every JAX parameter of the ZegCLIP VLM lands in exactly one port key
    with its value (``strict`` load), and the converted-CLIP loader refuses
    the VPT backbone by name."""
    _, params, pm, _ = zegclip_vlm()
    sd = convert.vlm_state_dict(params)
    own = pm.state_dict()
    assert set(sd) == set(own)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    for k, v in sd.items():
        assert np.array_equal(own[k].numpy(), v), k
    with pytest.raises(NotImplementedError, match='VPTCLIPVisionTransformer'):
        convert.load_pretrained_into(pm, {})


@pytest.mark.parametrize('split', ['92', '1464'])
def test_builder_makes_exp41_zegclip(split):
    """``build_model`` on exp 41's generated ZegCLIP configs (real widths,
    crop 64): the VPT ViT with JAX's builder defaults and 10 prompt tokens,
    the ATM head without input projection, the decoder text's asset name
    handed to the head, no guidance encoder; only the backbone's prompt
    leaves trainable in it; a forward at 64^2 (L = 1 + 10 + 16)."""
    cfg = dict(_exp41(split), crop_size=64)
    b = build_model(cfg, device='cpu')
    m = b.model
    assert isinstance(m.backbone, VPTCLIPVisionTransformer)
    assert isinstance(m.decode_head, ATMSingleHeadSeg)
    assert m.clip_encoder is None and not m.decode_head.use_proj
    assert m.backbone.num_tokens == 10 and len(m.backbone.layers) == 12
    assert m.decode_head.text_embedding_name == text_embedding_path(
        'pascal', 'single')
    trained = sorted(n for n, p in m.named_parameters()
                     if p.requires_grad and n.startswith('backbone.'))
    assert trained == sorted(f'backbone.{k}' for k in (
        'prompt_embeddings', 'deep_prompt_embeddings', 'prompt_proj.weight',
        'prompt_proj.bias', 'prompt_norm.weight', 'prompt_norm.bias'))
    assert all(p.requires_grad for n, p in m.named_parameters()
               if n.startswith('decode_head.'))
    with torch.no_grad():
        out = m(torch.zeros(1, 64, 64, 3), torch.as_tensor(b.text_feats))
    assert out.shape == (1, 21, 64, 64) and torch.isfinite(out).all()


def test_step_checks_the_criteria():
    """'mmseg' with another head than ATM raises JAX's message; OHEM with a
    non-ATM head is taken; exp 41's ZegCLIP config passes with the ATM
    head."""
    from semivl_tpu_torch.models.builder import ModelBundle

    def bundle(head_type):
        model = torch.nn.Identity()
        model.decode_head_cfg = {'type': head_type}
        return ModelBundle(model=model, text_feats=np.zeros((21, 512)))

    cfg = _exp41()
    step = make_semivl_train_step(bundle('ATMSingleHeadSeg'), cfg, None, 10,
                                  device='cpu')
    assert step.iteration == 0
    with pytest.raises(ValueError, match="only the ATM head configures; "
                       "got head 'VLGHead'"):
        make_semivl_train_step(bundle('VLGHead'), cfg, None, 10,
                               device='cpu')
    step = make_semivl_train_step(
        bundle('VLGHead'), dict(flagship_train_cfg(), criterion=dict(
            name='OHEM'), maskclip_consistency_lambda=0), None, 10,
        device='cpu')
    assert step.iteration == 0


# ------------------------------- concept -> class aggregation in VLG

CONCEPT_HEAD = dict(HEAD, text_embedding_name=CONCEPTS)


def test_vlg_head_over_concepts_matches_jax():
    """The flagship-shaped VLM over VOC's 98 concept planes a sample, max-
    aggregated to 21 classes after the head conv and before the resize:
    logits within 1e-5; the gradients of a random projection of them in
    every parameter within 1e-3 (the bound of the VLM tests at 81 and 150
    classes) with the head's ReLUs and concept max routed as JAX's, every
    ReLU input and concept max whose winner differs lying within 1e-5 of
    its call's scale (``SharedReluMasks``, ``SharedConceptMax``)."""
    import semivl_tpu.models.vlg_head as jax_vlg
    import semivl_tpu_torch.models.vlg_head as port_vlg
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=CONCEPT_HEAD)
    text = _concept_text()
    params = init_params(jm, 5, jnp.zeros((1, 64, 64, 3)), jnp.asarray(text))
    pm = convert.load_jax_params(VLM(BACKBONE, CONCEPT_HEAD), params).eval()
    rs = np.random.RandomState(5)
    img = rs.randn(2, 64, 64, 3).astype(np.float32)
    cot = rs.randn(2, 21, 64, 64).astype(np.float32)
    relus, concepts = SharedReluMasks(), SharedConceptMax()

    def loss(p):
        out = jm.apply({'params': p}, jnp.asarray(img), jnp.asarray(text))
        return jnp.sum(out * cot), out

    with mock.patch.object(jax_vlg.nn, 'relu', relus.jax), \
            mock.patch.object(jax_vlg, 'aggregate_concept_predictions',
                              concepts.jax):
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    with mock.patch.object(torch.nn.functional, 'relu', relus.torch), \
            mock.patch.object(port_vlg, 'aggregate_concept_predictions',
                              concepts.torch):
        got = pm(_t(img), _t(text))
    (got * _t(cot)).sum().backward()
    assert concepts.calls == 1 and relus.calls == len(relus.inputs) > 10
    assert max(np.abs(relus.flips + concepts.flips), default=0.0) < 1e-5
    assert got.shape == want.shape == (2, 21, 64, 64)
    assert rel_err(got.detach().numpy(), want) < 1e-5
    want_g = convert.vlm_state_dict(jax.tree.map(np.asarray, grads))
    top = max(np.abs(g).max() for g in want_g.values())
    prm = dict(pm.named_parameters())
    assert set(want_g) == set(prm)
    for name, g in want_g.items():
        mine = prm[name].grad.numpy()
        if np.abs(g).max() <= 1e-6 * top:   # the head's bias (vanishing)
            assert np.abs(mine).max() <= 1e-6 * top, name
        else:
            assert rel_err(mine, g) < 1e-3, name


def test_vlg_step_over_concepts_matches_jax():
    """One flagship step with ``text_embedding_variant = pl_text =
    'concept4_single'`` (98 decoder planes a crop, the guidance labels on
    the same text) against JAX's: loss terms 1e-4; the head's ReLUs and
    concept max routed as JAX's (each differing winner within 1e-5 of its
    call's scale), every trainable leaf's gradient 1e-3 of its scale and
    its update 1e-3 wherever the gradient fixes the first Adam step's sign
    (``resolved_step_mismatches``), frozen leaves unchanged."""
    jm, params, pm, mcc = tiny_train_vlm(seed=3, logit_scale=30.0,
                                         head=CONCEPT_HEAD)
    text = _concept_text()
    batch = semivl_batch(7, 2)
    conf_thresh, mcc_thresh = pseudo_label_thresholds(pm, text, mcc, batch)
    cfg = dict(flagship_train_cfg(64), text_embedding_variant=
               'concept4_single', pl_text='concept4_single',
               conf_thresh=conf_thresh, mcc_conf_thresh=mcc_thresh,
               log_grad_norm=True)
    rs = np.random.RandomState(8)
    keeps = [rs.rand(2, 1, 1, c) < 0.5 for c in (128, 128, 512)]
    relus, concepts = SharedReluMasks(), SharedConceptMax()
    s = semivl_step_pair(jm, params, pm, mcc, text, batch, cfg, keeps, TOTAL,
                         relu_masks=relus, concept_max=concepts)
    assert concepts.calls == 3   # teacher, both student passes
    assert max(np.abs(relus.flips + concepts.flips), default=0.0) < 1e-5
    for k, v in s['pmetrics'].items():
        assert np.isfinite(v) and abs(v - s['jmetrics'][k]) <= 1e-4 * abs(
            s['jmetrics'][k]), k
    for k in ('loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1', 'loss_mc_fp'):
        assert s['pmetrics'][k] > 0, k
    bad, n_checked, _ = resolved_step_mismatches(s, cfg)
    assert bad == [] and n_checked > 20


def test_builder_takes_a_concept_decoder_text():
    """Exp 40's config with ``text_embedding_variant = pl_text =
    'concept4_single'`` (JAX builds and trains it): the VLG head gets the
    asset's name and the model gives 21 class logits from 98 concept
    planes; a concept text without a known list is refused by name."""
    cfg = dict(flagship_train_cfg(64), text_embedding_variant=
               'concept4_single', pl_text='concept4_single')
    b = build_model(cfg, device='cpu')
    assert b.text_feats.shape == (98, 512)
    assert os.path.basename(b.model.decode_head.text_embedding_name) == \
        CONCEPTS + '.npy'
    with torch.no_grad():
        out = b.model(torch.zeros(1, 64, 64, 3), torch.as_tensor(
            b.text_feats))
    assert out.shape == (1, 21, 64, 64) and torch.isfinite(out).all()
    b.model.decode_head.text_embedding_name = 'voc12_wbg_single'
    with pytest.raises(ValueError, match='No concept list'):
        b.model(torch.zeros(1, 64, 64, 3), torch.as_tensor(b.text_feats))
