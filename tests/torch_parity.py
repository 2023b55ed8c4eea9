"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py):
a small flagship-shaped VLM (with the frozen guidance encoder for
training), random JAX parameters made with numpy, the port model carrying
the same weights through ``semivl_tpu_torch.convert``, and the helpers of
the whole-step comparisons."""

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
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


def tiny_train_vlm(seed=0, img=IMG, logit_scale=1.0):
    """(jax module, numpy params, port model, guidance text) of the small
    VLM with the guidance encoder and the real ``concept4`` text; the
    port's frozen leaves have ``requires_grad=False`` (flagship freeze
    rule). ``logit_scale`` multiplies the decoder head's weights, to give
    the random model confident pseudo-labels."""
    from semivl_tpu_torch.models.builder import is_trainable
    from semivl_tpu_torch.text.embeddings import (
        load_text_embedding, text_embedding_path)
    mcc = load_text_embedding(text_embedding_path('pascal',
                                                  'concept4_single'))
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=HEAD,
                clip_encoder_cfg=CLIP, mcc_text_embedding_name=MCC_TEXT)
    params = init_params(jm, seed, jnp.zeros((1, img, img, 3)),
                         jnp.zeros((21, 512)), jnp.asarray(mcc),
                         method='init_variables')
    head = params['decode_head']['head']
    head['kernel'] = head['kernel'] * np.float32(logit_scale)
    head['bias'] = head['bias'] * np.float32(logit_scale)
    pm = load_jax_params(VLM(BACKBONE, HEAD, clip_encoder_cfg=CLIP,
                             mcc_text_name=MCC_TEXT), params).eval()
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

    def torch(self, x, rate, generator=None):
        keep = torch.from_numpy(self._next())
        assert keep.shape[-1] == x.shape[-1]
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


def masked_grads(opt_state, params):
    """JAX gradients from the first Adam moment after one update (mu =
    (1 - b1) g); frozen leaves (no moment) as zeros."""
    adam = opt_state.inner_state[0]
    mu = jax.tree_util.tree_leaves(
        adam.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    leaves = [np.zeros(np.shape(p), np.float32) if isinstance(
        m, optax.MaskedNode) else np.asarray(m) / 0.1
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
