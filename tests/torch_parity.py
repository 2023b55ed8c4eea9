"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py):
a small flagship-shaped VLM (with the frozen guidance encoder for
training) and a small ZegCLIP VLM (VPT ViT + ATM head), random JAX
parameters made with numpy, the port model carrying the same weights
through ``semivl_tpu_torch.convert``, and the helpers of the whole-step
comparisons (``semivl_batch``, ``pseudo_label_thresholds``,
``semivl_step_pair``, ``step_mismatches``)."""

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu_torch import convert
from semivl_tpu_torch.convert import load_jax_params
from semivl_tpu_torch.models.vlm import VLM

# Flagship structure at small widths: ViT with C=128, 2 heads of 64 and 2
# layers (out_indices [0, 1, 2] as [0, 4, 12] for 12 layers); VLG with
# channels 32, text 32, pool 2, one semantic head of 64.
IMG = 64
BACKBONE = dict(
    type='MaskClipVisionTransformer', img_size=(IMG, IMG), patch_size=16,
    embed_dims=128, num_layers=2, num_heads=2, mlp_ratio=4,
    out_indices=[0, 1, 2], clip_dim=512)
HEAD = dict(
    type='VLGHead', img_size=IMG, num_classes=21, text_in_channels=512,
    text_channels=32, up_channels=(32, 16), skip_in_channels=(128, 128),
    skip_channels=(16, 16), num_layers=2, num_heads=1, channels=32,
    pool_size=(2, 2), conv1_ksize=7, align_corners=False)
# the guidance encoder: the same small ViT, only the dense CLIP embedding
CLIP = dict(BACKBONE, out_indices=None)
MCC_TEXT = 'voc12_wbg_concept4_single'


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """A test module's torch work on 2 threads (autouse in a module that
    imports it): the suite runs several test processes on one host, and
    torch's default of one thread a core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_tree(shapes, seed):
    """numpy leaves for a shape tree: kernels ~ N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), biases N(0, 0.1), embeddings N(0, 0.02)."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if 'cls_token' in name or 'pos_embed' in name:
            return (0.02 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "'scale'" in name:
            return (1 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_params(module, seed, *args, **kwargs):
    """Random numpy params for a flax ``module`` without running its init
    (``eval_shape`` only traces)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))['params']
    return random_tree(shapes, seed)


def text_embedding(n=21, dim=512, seed=5):
    t = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def tiny_vlm(seed=0, img=IMG):
    """(jax module, numpy params, port model with the same weights)."""
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=HEAD)
    params = init_params(jm, seed, jnp.zeros((1, img, img, 3)),
                         jnp.zeros((21, 512)))
    pm = load_jax_params(VLM(BACKBONE, HEAD), params).eval()
    return jm, params, pm


def tiny_train_vlm(seed=0, img=IMG, logit_scale=1.0, backbone=BACKBONE,
                   head=HEAD, clip=CLIP,
                   mcc_text=('pascal', 'concept4_single')):
    """(jax module, numpy params, port model, guidance text) of the small
    VLM (or of the given backbone / head / guidance-encoder configs) with
    the guidance encoder and a real guidance text (``mcc_text``: dataset
    and variant, the ``concept4`` text by default); the port's frozen
    leaves have ``requires_grad=False`` (flagship freeze rule).
    ``logit_scale`` multiplies the decoder head's weights, to give the
    random model confident pseudo-labels."""
    import os

    from semivl_tpu_torch.models.builder import is_trainable
    from semivl_tpu_torch.text.embeddings import (
        load_text_embedding, text_embedding_path)
    path = text_embedding_path(*mcc_text)
    mcc, name = load_text_embedding(path), os.path.basename(path)[:-4]
    jm = JaxVLM(backbone_cfg=backbone, decode_head_cfg=head,
                clip_encoder_cfg=clip, mcc_text_embedding_name=name)
    params = init_params(jm, seed, jnp.zeros((1, img, img, 3)),
                         jnp.zeros((head['num_classes'], 512)),
                         jnp.asarray(mcc), method='init_variables')
    hp = params['decode_head']['head']
    hp['kernel'] = hp['kernel'] * np.float32(logit_scale)
    hp['bias'] = hp['bias'] * np.float32(logit_scale)
    pm = load_jax_params(VLM(backbone, head, clip_encoder_cfg=clip,
                             mcc_text_name=name), params).eval()
    for name, p in pm.named_parameters():
        p.requires_grad_(is_trainable(name, True, ['attn', 'pos_embed']))
    return jm, params, pm, mcc


def rel_err(got, want):
    """max |got - want| relative to the output scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def gap_threshold(conf, lo_q=0.5, hi_q=0.95):
    """A threshold in the widest gap of the sorted confidences between two
    quantiles, and its distance to the nearest value."""
    v = np.sort(np.asarray(conf, np.float64).ravel())
    lo, hi = int(lo_q * len(v)), int(hi_q * len(v))
    i = lo + int(np.argmax(np.diff(v[lo:hi])))
    return float((v[i] + v[i + 1]) / 2), float((v[i + 1] - v[i]) / 2)


@dataclasses.dataclass
class PortBundle:
    model: Any
    text_feats: np.ndarray
    mcc_text_feats: Optional[np.ndarray]


class InjectedDropout:
    """Stands in for both frameworks' ``dropout2d``: the i-th call of a
    pass drops the channels of the i-th given keep mask (B, 1, 1, C)."""

    def __init__(self, keeps):
        self.keeps, self.calls = keeps, 0

    def _next(self):
        keep = self.keeps[self.calls % len(self.keeps)]
        self.calls += 1
        return keep

    def jax(self, rng, x, rate):
        keep = self._next()
        assert keep.shape[-1] == x.shape[-1]
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros((), x.dtype))

    def jax_rows(self, rng, x, rate):
        """``jax`` under ``shard_map``: this device's rows of the keep
        mask, picked by its index on the ``data`` axis."""
        b = x.shape[0]
        keep = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._next()), jax.lax.axis_index('data') * b, b)
        assert keep.shape[-1] == x.shape[-1]
        return jnp.where(keep, x / (1.0 - rate), jnp.zeros((), x.dtype))

    def torch(self, x, rate, generator=None):
        keep = torch.from_numpy(self._next())
        assert keep.shape[-1] == x.shape[-1]
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


class SharedReluMasks:
    """The VLG head's ReLUs through the JAX step and then the port's, with
    the port passing gradient where JAX's did. The frameworks' float32
    forwards differ by ~1e-6, so a ReLU input that close to zero can pass
    gradient on one side only, which moves every gradient upstream of it
    by ~1e-3 and more: at 150 classes a step has enough such inputs that
    one flips at almost any seed. ``jax`` stands in for flax's ``relu`` in
    ``semivl_tpu.models.vlg_head`` and records each call's input (in trace
    order: the teacher pass, then both student passes); ``torch`` stands in
    for the port's ``F.relu`` (the same calls, in the same order) and keeps
    what JAX's input kept, recording every element where the port's own
    sign differs (``flips``: its |x| over the call's largest |x|)."""

    def __init__(self):
        self.inputs, self.traced, self.calls, self.flips = {}, 0, 0, []

    def jax(self, x):
        i = self.traced
        self.traced += 1
        jax.debug.callback(
            lambda v, i=i: self.inputs.__setitem__(i, np.asarray(v)), x)
        return jax.nn.relu(x)

    def torch(self, x, inplace=False):
        ref = self.inputs[self.calls]
        self.calls += 1
        ref = ref.transpose(0, 3, 1, 2) if ref.ndim == 4 else ref
        assert ref.shape == tuple(x.shape), (ref.shape, x.shape)
        keep = torch.from_numpy(ref > 0)
        flip = keep != (x.detach() > 0)
        if flip.any():
            mag = x.detach().abs()
            self.flips += (mag[flip] / mag.max()).tolist()
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype))


class SharedConceptMax:
    """The VLG head's concept -> class max through the JAX step and then the
    port's, the port taking each class's max over the concepts that won
    JAX's (its largest, ties included). Concepts of a class whose logits lie
    within the frameworks' float32 difference (~1e-6 of the scale) of each
    other are common over 98 concepts and many pixels, and a max that picks
    another concept sends the gradient to another plane. ``jax`` stands in
    for ``aggregate_concept_predictions`` in ``semivl_tpu.models.vlg_head``
    and records each call's input (in trace order, as ``SharedReluMasks``);
    ``torch`` stands in for the port's and records, where the port's own
    max differs from its value at JAX's winners, that difference over the
    call's largest |logit| (``flips``)."""

    def __init__(self):
        self.inputs, self.traced, self.calls, self.flips = {}, 0, 0, []

    def jax(self, pred, class_to_concept_idxs):
        from semivl_tpu.text.embeddings import aggregate_concept_predictions
        i = self.traced
        self.traced += 1
        jax.debug.callback(
            lambda v, i=i: self.inputs.__setitem__(i, np.asarray(v)), pred)
        return aggregate_concept_predictions(pred, class_to_concept_idxs)

    def torch(self, pred, class_to_concept_idxs):
        from semivl_tpu_torch.text.embeddings import (
            aggregate_concept_predictions, concept_aggregation_matrix)
        ref = self.inputs[self.calls]
        self.calls += 1
        assert ref.shape == tuple(pred.shape), (ref.shape, pred.shape)
        member = concept_aggregation_matrix(class_to_concept_idxs,
                                           pred.shape[1])[None, :, :, None,
                                                          None]
        ref = np.where(member, ref[:, None], -np.inf)
        won = torch.from_numpy(ref == ref.max(axis=2, keepdims=True))
        out = torch.where(won, pred[:, None], torch.tensor(
            float('-inf'), dtype=pred.dtype)).amax(dim=2)
        own = aggregate_concept_predictions(pred.detach(),
                                            class_to_concept_idxs)
        diff = own - out.detach()
        if diff.any():
            self.flips += (diff[diff != 0] / pred.detach().abs().max()
                           ).tolist()
        return out


def masked_grads(opt_state, params):
    """JAX gradients from the first Adam moment after one update (mu =
    (1 - b1) g), or under the ``original`` SGD from the momentum trace
    after one update (g + 1e-4 p); frozen leaves (no moment) as zeros."""
    first = opt_state.inner_state[0]
    if hasattr(first, 'mu'):
        moment, unscale = first.mu, lambda m, p: np.asarray(m) / 0.1
    else:
        moment = opt_state.inner_state[1].trace
        unscale = lambda m, p: np.asarray(m) - np.float32(1e-4) * p
    mu = jax.tree_util.tree_leaves(
        moment, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    leaves = [np.zeros(np.shape(p), np.float32) if isinstance(
        m, optax.MaskedNode) else unscale(m, np.asarray(p))
        for m, p in zip(mu, jax.tree_util.tree_leaves(params))]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)


def leaf_names(params):
    """JAX path string -> port parameter name, leaf for leaf: every leaf is
    filled with its index and exported through convert."""
    from semivl_tpu.train import optim as jax_optim
    paths = jax.tree_util.tree_leaves(jax_optim.param_path_strings(params))
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(x), i, np.float32) for i, x in
         enumerate(jax.tree_util.tree_leaves(params))])
    out = {}
    for name, v in convert.vlm_state_dict(ids).items():
        out[paths[int(v.flat[0])]] = name
    assert len(out) == len(paths)
    return out


# ------------------------------------------------------- one whole step

MARGIN = 1e-5   # cross-framework float32 differences stay far below this


def semivl_batch(seed, b=2, img=IMG, nclass=21):
    """A SemiVL batch of ``b`` labeled + ``b`` unlabeled ``img``-px crops
    (numpy, normalised scale) labeled with ``nclass`` classes, ignore
    borders and CutMix boxes."""
    rs = np.random.RandomState(seed)

    def im():
        return rs.randn(b, img, img, 3).astype(np.float32)

    ign = np.zeros((b, img, img), np.int32)
    ign[:, :, :3] = 255
    ign_o = ign.copy()
    ign_o[:, -4:] = 255
    mask = rs.randint(0, nclass, (b, img, img)).astype(np.int32)
    mask[:, :2] = 255
    return dict(
        img_x=im(), mask_x=mask, img_w=im(), img_s1=im(), img_s2=im(),
        ignore_mask=ign, img_w_other=im(), img_s1_other=im(),
        img_s2_other=im(), ignore_mask_other=ign_o,
        cutmix_box1=np.array([[10, 5, 20, 35], [0, 0, 64, 16]],
                             np.int32)[:b],
        cutmix_box2=np.array([[32, 32, 30, 30], [5, 40, 50, 20]],
                             np.int32)[:b])


def pseudo_label_thresholds(pm, text, mcc, batch):
    """Thresholds for this batch away from every confidence, after
    checking the argmax margins of the pixels whose labels count."""
    def t(a):
        return torch.from_numpy(np.asarray(a))

    with torch.no_grad():
        teacher = torch.cat([pm(t(batch['img_w_other']), t(text)),
                             pm(t(batch['img_w']), t(text))])
        p = torch.softmax(teacher, dim=1).numpy()
        mc = pm.maskclip_probs(t(np.concatenate(
            [batch['img_w'], batch['img_w_other']])), mcc).numpy()
    conf_thresh, m1 = gap_threshold(p.max(axis=1))
    mcc_thresh, m2 = gap_threshold(mc.max(axis=-1))
    assert min(m1, m2) > MARGIN, (m1, m2)
    for probs, axis, th in ((p, 1, conf_thresh), (mc, -1, mcc_thresh)):
        top2 = np.sort(probs, axis=axis)
        top2 = np.take(top2, [-2, -1], axis=axis)
        gap = np.take(top2, 1, axis=axis) - np.take(top2, 0, axis=axis)
        kept = np.take(top2, 1, axis=axis) >= th
        assert 0 < kept.mean() < 1
        assert gap[kept].min() > MARGIN
    return conf_thresh, mcc_thresh


def semivl_step_pair(jm, params, pm, mcc, text, batch, cfg, keeps,
                     total=100, stats=None, freeze_backbone=True,
                     exclude_keys=('attn', 'pos_embed'), relu_masks=None,
                     concept_max=None, module='vlm'):
    """One SemiVL step in JAX (1-device mesh) and in the port (CPU), from
    the same weights (and BatchNorm running statistics ``stats``), batch,
    boxes and injected feature-perturbation masks ``keeps``, under the
    freeze rule ``freeze_backbone``/``exclude_keys``: the metrics, the JAX
    gradients and updated parameters and statistics under the port's
    names, the port's gradients and its state before and after, and, with
    ``cfg['ema_decay']``, both parameter EMAs (``jax_ema``, ``port_ema``).
    Given ``relu_masks`` (a ``SharedReluMasks``), the VLG head's ReLUs of
    both steps go through it; given ``concept_max`` (a ``SharedConceptMax``),
    its concept -> class max. ``module``: the models' module whose
    ``dropout2d`` the masks replace ('vlm', or 'deeplabv3plus' for the
    UniMatch segmentor)."""
    import contextlib
    from unittest import mock

    import semivl_tpu.models.vlg_head as jax_vlg

    from semivl_tpu_torch.train import optim
    from semivl_tpu_torch.train.step import make_semivl_train_step

    import semivl_tpu_torch.models.vlg_head as port_vlg

    def shared(side):
        stack = contextlib.ExitStack()
        if relu_masks is not None:
            stack.enter_context(
                mock.patch.object(jax_vlg.nn, 'relu', relu_masks.jax)
                if side == 'jax' else mock.patch.object(
                    torch.nn.functional, 'relu', relu_masks.torch))
        if concept_max is not None:
            stack.enter_context(mock.patch.object(
                jax_vlg if side == 'jax' else port_vlg,
                'aggregate_concept_predictions', getattr(concept_max, side)))
        return stack

    with shared('jax'):
        out = jax_step_on_mesh(jm, params, mcc, text, batch, cfg, keeps,
                               total, stats=stats,
                               freeze_backbone=freeze_backbone,
                               exclude_keys=exclude_keys, module=module)
    fake = InjectedDropout(keeps)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt, _ = optim.build_optimizer(cfg, pm, total)
    step = make_semivl_train_step(PortBundle(pm, text, mcc), cfg, opt,
                                  total, device='cpu')
    with mock.patch(f'semivl_tpu_torch.models.{module}.dropout2d',
                    fake.torch), shared('torch'):
        pmetrics = {k: float(v) for k, v in step(batch).items()}
    assert fake.calls == len(keeps) and step.iteration == 1
    for shared_op in (relu_masks, concept_max):
        if shared_op is not None:
            assert shared_op.calls == len(shared_op.inputs) > 0
    port_grads = {n: (p.grad.numpy() if p.grad is not None
                      else np.zeros(p.shape, np.float32))
                  for n, p in pm.named_parameters()}
    return dict(jmetrics=out['jmetrics'], pmetrics=pmetrics,
                jax_new=out['jax_new'], jax_grads=out['jax_grads'],
                jax_ema=out['jax_ema'],
                port_ema=(None if step.ema is None else
                          {k: v.numpy().copy() for k, v in step.ema.items()}),
                port_grads=port_grads, before=before,
                after={k: v.numpy().copy()
                       for k, v in pm.state_dict().items()},
                trainable={n: p.requires_grad
                           for n, p in pm.named_parameters()})


def step_mismatches(s, tol=1e-3):
    """Every trainable leaf's gradient and updated value against JAX's
    within ``tol`` of its own scale (a leaf whose gradient vanishes in
    exact arithmetic held to |g| <= 1e-6 of the largest gradient on both
    sides), frozen leaves unchanged on both sides. Returns the mismatches
    and the number of trainable leaves checked."""
    assert set(s['jax_new']) == set(s['after'])
    top = max(np.abs(g).max() for g in s['jax_grads'].values())
    bad, n_checked = [], 0
    for name, trainable in s['trainable'].items():
        if not trainable:
            np.testing.assert_array_equal(s['after'][name],
                                          s['before'][name].numpy())
            np.testing.assert_array_equal(s['jax_new'][name],
                                          s['before'][name].numpy())
            continue
        n_checked += 1
        want, got = s['jax_grads'][name], s['port_grads'][name]
        if np.abs(want).max() <= 1e-6 * top:
            if np.abs(got).max() > 1e-6 * top:
                bad.append((name, 'vanishing', np.abs(got).max()))
        elif rel_err(got, want) > tol:
            bad.append((name, 'grad', rel_err(got, want)))
        if rel_err(s['after'][name], s['jax_new'][name]) > tol:
            bad.append((name, 'update', rel_err(s['after'][name],
                                                s['jax_new'][name])))
        if np.array_equal(s['after'][name], s['before'][name].numpy()):
            bad.append((name, 'unchanged', 0.0))
    return bad, n_checked


def ema_mismatches(s, decay, tol=1e-6):
    """The parameter EMA after one step (``semivl_step_pair``'s or a step
    of that layout), frozen leaves included: the port's equal to ``decay *
    before + (1 - decay) * after`` in float32 (two products rounded, one
    sum) at every leaf, and within ``tol`` of each leaf's scale of JAX's
    (whose jitted step may fuse the product and the sum: a frozen leaf
    then drifts by another rounding, ~6e-8). Returns the mismatches."""
    assert set(s['port_ema']) == set(s['jax_ema']) == set(s['trainable'])
    bad = []
    for name in s['trainable']:
        got, want = s['port_ema'][name], s['jax_ema'][name]
        recomputed = (np.float32(decay) * s['before'][name].numpy()
                      + np.float32(1.0 - decay) * s['after'][name])
        if not np.array_equal(got, recomputed):
            bad.append((name, 'recomputed', rel_err(got, recomputed)))
        if rel_err(got, want) > tol:
            bad.append((name, 'ema', rel_err(got, want)))
    return bad


def resolved_step_mismatches(s, cfg, tol=1e-3, stats_tol=1e-5):
    """``step_mismatches`` for a first step whose gradient elements the
    frameworks do not all resolve: every trainable leaf's gradient within
    ``tol`` of its scale (a vanishing leaf held to 1e-6 of the largest on
    both sides); its updated value within ``tol`` of its scale at every
    element whose gradient is above ``tol`` of the leaf's largest (where
    the gradients' agreement fixes its sign), and at the others (whose
    sign is within the gradients' difference: AdamW's first step there is
    lr x lr_mult times that sign, on either side) a step of at most
    lr lr_mult (1 + wd |p|) plus the value's float32 rounding; trainable
    leaves changed, frozen ones unchanged on both sides; BatchNorm running
    statistics within ``stats_tol`` and changed. Returns the mismatches,
    the trainable leaves checked and the running statistics checked."""
    from semivl_tpu_torch.train import optim
    opt = cfg['optimizer']
    keys = opt['paramwise_cfg']['custom_keys']
    assert set(s['jax_new']) == set(s['after'])
    top = max(np.abs(g).max() for g in s['jax_grads'].values())
    bad, n_checked = [], 0
    for name, trainable in s['trainable'].items():
        before = s['before'][name].numpy()
        if not trainable:
            np.testing.assert_array_equal(s['after'][name], before)
            np.testing.assert_array_equal(s['jax_new'][name], before)
            continue
        n_checked += 1
        want, got = s['jax_grads'][name], s['port_grads'][name]
        if np.abs(want).max() <= 1e-6 * top:
            if np.abs(got).max() > 1e-6 * top:
                bad.append((name, 'vanishing', np.abs(got).max()))
        elif rel_err(got, want) > tol:
            bad.append((name, 'grad', rel_err(got, want)))
        resolved = np.abs(want) > tol * np.abs(want).max()
        diff = np.abs(s['after'][name] - s['jax_new'][name])[resolved]
        if diff.max(initial=0) > tol * np.abs(s['jax_new'][name]).max():
            bad.append((name, 'update', rel_err(s['after'][name],
                                                s['jax_new'][name])))
        lr = opt['lr'] * optim.custom_key_mults(keys, name)[0]
        size = np.abs(before).max()
        step = (lr * (1 + opt['weight_decay'] * size) * (1 + 1e-4)
                + np.spacing(np.float32(size)))
        for new in (s['after'][name], s['jax_new'][name]):
            if np.abs(new - before)[~resolved].max(initial=0) > step:
                bad.append((name, 'unresolved step', step))
        if np.array_equal(s['after'][name], before):
            bad.append((name, 'unchanged', 0.0))
    running = [k for k in s['after'] if k.endswith(('running_mean',
                                                    'running_var'))]
    for k in running:
        if rel_err(s['after'][k], s['jax_new'][k]) > stats_tol:
            bad.append((k, 'stats', rel_err(s['after'][k], s['jax_new'][k])))
        if np.array_equal(s['after'][k], s['before'][k].numpy()):
            bad.append((k, 'stats unchanged', 0.0))
    return bad, n_checked, len(running)


def jax_step_on_mesh(jm, params, mcc, text, batch, cfg, keeps, total,
                     n_devices=1, stats=None, bn_batch_stats=None,
                     freeze_backbone=True, exclude_keys=('attn', 'pos_embed'),
                     module='vlm'):
    """One JAX SemiVL step over an ``n_devices`` data mesh: the global
    ``batch`` split by rows over the devices, each device taking its rows
    of the injected perturbation masks ``keeps`` (``jax_rows``); ``stats``
    the BatchNorm running statistics, if the model has them. Returns the
    metrics, the gradients averaged over the devices (from the first Adam
    moment), the updated parameters and statistics, under the port's
    names, and ``bn_batch_stats``: the (mean, variance) of each train-mode
    BatchNorm call, in call order (over the mesh: after the ``pmean``).

    Given ``bn_batch_stats``, each train-mode BatchNorm takes those
    values for its statistics, their gradients still JAX's own (through
    the ``pmean`` it computes): the step's gradients at another rounding
    of the statistics. ``module``: as ``semivl_step_pair``'s."""
    from unittest import mock

    import flax.linen.normalization as flax_norm

    from jax.sharding import Mesh

    from semivl_tpu.models.builder import ModelBundle as JaxBundle
    from semivl_tpu.train import optim as jax_optim
    from semivl_tpu.train.step import (TrainState, replicate, shard_batch)
    from semivl_tpu.train.step import make_semivl_train_step as jax_step
    fake = InjectedDropout(keeps)
    exclude_keys = list(exclude_keys) if exclude_keys else None
    bundle = JaxBundle(module=jm, text_feats=text, mcc_text_feats=mcc,
                       num_classes=text.shape[0],
                       img_size=batch['mask_x'].shape[1], model_cfg={},
                       freeze_backbone=freeze_backbone,
                       exclude_keys=exclude_keys)
    tx, _, mask = jax_optim.build_optimizer(
        cfg, params, total, freeze_backbone=freeze_backbone,
        exclude_keys=exclude_keys)
    variables = {'params': params}
    if stats is not None:
        variables['batch_stats'] = stats
    state = TrainState(params=variables, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32),
                       ema_params=(jax.tree.map(jnp.array, params)
                                   if cfg.get('ema_decay') else None))
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ('data',))
    compute_stats = flax_norm._compute_stats
    recorded, calls = {}, [0]

    def batchnorm_stats(x, axes, dtype, axis_name=None, *a, **k):
        if axis_name is None:   # GroupNorm, eval-mode BatchNorm
            return compute_stats(x, axes, dtype, axis_name, *a, **k)
        i = calls[0]
        calls[0] += 1
        out = compute_stats(x, axes, dtype, axis_name, *a, **k)
        if bn_batch_stats is not None:
            return tuple(jnp.asarray(held) + o - jax.lax.stop_gradient(o)
                         for held, o in zip(bn_batch_stats[i], out))
        jax.debug.callback(lambda m, v, i=i: recorded.__setitem__(
            i, (np.asarray(m), np.asarray(v))), *out)
        return out

    with mock.patch(f'semivl_tpu.models.{module}.dropout2d',
                    fake.jax_rows), \
            mock.patch.object(flax_norm, '_compute_stats', batchnorm_stats):
        fn = jax_step(bundle, cfg, tx, mesh, total, mask)
        new_state, jmetrics = fn(replicate(state, mesh),
                                 shard_batch(batch, mesh),
                                 replicate(jax.random.PRNGKey(0), mesh))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
    assert fake.calls == len(keeps)
    new = jax.tree.map(np.asarray, new_state.params)
    names = (convert.dlv3p_state_dict if module == 'deeplabv3plus'
             else convert.vlm_state_dict)
    return dict(jmetrics=jmetrics,
                jax_new=names(new['params'], new.get('batch_stats')),
                jax_grads=names(masked_grads(new_state.opt_state, params)),
                jax_ema=jax_ema(new_state, names),
                bn_batch_stats=[recorded[i] for i in sorted(recorded)])


def jax_ema(state, names=convert.vlm_state_dict):
    """A JAX ``TrainState``'s parameter EMA under the port's names (None
    without one)."""
    if state.ema_params is None:
        return None
    return names(jax.tree.map(np.asarray, state.ema_params))


# ------------------------------------------------- the small ZegCLIP VLM

# exp 41's ZegCLIP structure at small widths: a VPT ViT of width 128 with 2
# heads of 64, 2 layers and 3 prompt tokens, whose 64-px position grid is
# resized to 128^2 inputs, in the 512-d CLIP space; an ATM head of width 64
# with 2 heads and 2 layers over 5 classes
ZEG_IMG, ZEG_NCLS, ZEG_OUT = 128, 5, 512
ZEG_BACKBONE = dict(
    type='VPTCLIPVisionTransformer', input_resolution=64, patch_size=16,
    width=128, layers=2, heads=2, output_dim=ZEG_OUT, num_tokens=3,
    prompt_dim=128, total_d_layer=1, out_indices=[1])
ZEG_HEAD = dict(
    type='ATMSingleHeadSeg', img_size=ZEG_IMG, num_classes=ZEG_NCLS,
    in_channels=ZEG_OUT, embed_dims=64, num_layers=2, num_heads=2,
    use_stages=1, use_proj=False, use_rd=True, align_corners=False,
    text_embedding_name='')


def zegclip_vlm(seed=0, text=None, head=ZEG_HEAD, logit_scale=1.0):
    """(jax module, numpy params, port model, text) of the small ZegCLIP
    VLM, the port's trainable leaves as the model's freeze rule
    (``exclude_keys=['prompt']``) says. ``logit_scale`` multiplies the
    last decoder layer's query projection, and so the masks, to give the
    random model confident pseudo-labels."""
    from semivl_tpu_torch.configs.models import get_model_config
    from semivl_tpu_torch.models.builder import is_trainable
    text = text_embedding(ZEG_NCLS, ZEG_OUT) if text is None else text
    jm = JaxVLM(backbone_cfg=ZEG_BACKBONE, decode_head_cfg=head)
    params = init_params(jm, seed, jnp.zeros((1, ZEG_IMG, ZEG_IMG, 3)),
                         jnp.asarray(text))
    q = params['decode_head'][f'decoder_{head["num_layers"] - 1}']['attn'][
        'q']
    for k in ('kernel', 'bias'):
        q[k] = q[k] * np.float32(logit_scale)
    pm = load_jax_params(VLM(ZEG_BACKBONE, head), params).eval()
    ref = get_model_config('vlm-zegclip-rd-pt-vitb')['model']
    for n, p in pm.named_parameters():
        p.requires_grad_(is_trainable(n, ref['freeze_backbone'],
                                      ref['exclude_keys']))
    return jm, params, pm, text


def zegclip_batch(seed, b=2, nclass=ZEG_NCLS):
    """``semivl_batch`` at 128^2 (5 classes by default), CutMix boxes
    inside the crop."""
    batch = semivl_batch(seed, b, ZEG_IMG, nclass=nclass)
    batch['cutmix_box1'] = np.array([[10, 5, 60, 70], [0, 0, 128, 40]],
                                    np.int32)[:b]
    batch['cutmix_box2'] = np.array([[64, 64, 50, 60], [5, 80, 100, 40]],
                                    np.int32)[:b]
    return batch


def confident_threshold(pm, text, batch, keeps):
    """A confidence threshold away from every pseudo-label confidence of a
    model without guidance encoder (teacher and student w half), after
    checking that no pseudo-label sits within MARGIN of an argmax tie."""
    from unittest import mock
    fake = InjectedDropout(keeps)
    b = batch['img_x'].shape[0]

    def t(a):
        return torch.from_numpy(np.asarray(a))

    with torch.no_grad(), mock.patch(
            'semivl_tpu_torch.models.vlm.dropout2d', fake.torch):
        teacher = pm(t(batch['img_w_other']), t(text))
        student = pm(t(np.concatenate([batch['img_x'], batch['img_w']])),
                     t(text), need_fp=True)[0][b:]
    confs = []
    for logits in (teacher, student):
        top2 = np.sort(logits.numpy(), axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
        confs.append(torch.softmax(logits, 1).amax(1).numpy().ravel())
    thresh, margin = gap_threshold(np.concatenate(confs))
    assert margin > MARGIN
    return thresh


def zegclip_step_mismatches(s, cfg):
    """``step_mismatches`` of a ZegCLIP step, but for the leaves whose
    gradient is zero in exact arithmetic: the ATM head's last layer after
    its attention logits, which the loss does not reach (no gradient on
    either side: AdamW decays it, or leaves it where the ``norm`` key sets
    no decay, on both), and the key bias of every earlier layer, whose
    logits only its softmax reads (float32 rounding on both sides). Those
    are held to a first AdamW step of either sign from their old values on
    both sides, the port's gradient to 1e-6 of the largest, and where
    JAX's gradient is exactly zero to JAX's value. Returns the mismatches,
    the trainable leaves checked, the vanishing leaves and the unreached
    ones."""
    from semivl_tpu_torch.train import optim
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    lr = cfg['optimizer']['lr']
    wd = cfg['optimizer']['weight_decay']
    top = max(np.abs(g).max() for g in s['jax_grads'].values())
    vanishing = {n for n, t in s['trainable'].items()
                 if t and np.abs(s['jax_grads'][n]).max() <= 1e-6 * top}
    unreached = {n for n in vanishing if not np.abs(s['jax_grads'][n]).any()}
    bad, n_checked = step_mismatches(s)
    bad = [b for b in bad if b[0] not in vanishing]
    for name in sorted(vanishing):
        before = s['before'][name].numpy()
        lr_mult, decay_mult = optim.custom_key_mults(keys, name)
        size = np.abs(before).max()
        step = (lr * lr_mult * (1 + wd * decay_mult * size) * (1 + 1e-4)
                + np.spacing(np.float32(size)))
        if np.abs(s['port_grads'][name]).max() > 1e-6 * top:
            bad.append((name, 'vanishing',
                        np.abs(s['port_grads'][name]).max()))
        for new in (s['after'][name], s['jax_new'][name]):
            if np.abs(new - before).max() > step:
                bad.append((name, 'unresolved step', step))
        if name in unreached:
            if np.abs(s['port_grads'][name]).any():
                bad.append((name, 'reached', 0.0))
            if rel_err(s['after'][name], s['jax_new'][name]) > 1e-6:
                bad.append((name, 'decay', rel_err(s['after'][name],
                                                   s['jax_new'][name])))
            if np.array_equal(s['after'][name], before) == (decay_mult > 0):
                bad.append((name, 'decayed', decay_mult))
    return bad, n_checked, vanishing, unreached
