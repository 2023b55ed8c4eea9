"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py):
a small flagship-shaped VLM, random JAX parameters made with numpy, and the
port model carrying the same weights through ``semivl_tpu_torch.convert``."""

import jax
import jax.numpy as jnp
import numpy as np

from semivl_tpu.models.vlm import VLM as JaxVLM
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


def init_params(module, seed, *args):
    """Random numpy params for a flax ``module`` without running its init
    (``eval_shape`` only traces)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))['params']
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


def rel_err(got, want):
    """max |got - want| relative to the output scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
