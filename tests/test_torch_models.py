"""Port models vs the JAX package, float32 on the CPU, same weights carried
by the port's bridge (``semivl_tpu_torch.convert``).

Tolerances: modules within 1e-5 of the output scale (float32 on both
sides, sums in another order); the whole VLM within the full-scale parity
bound of tests/test_fullscale_parity.py (max 2e-3 of the logit scale, mean
2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.models.clip_vit import MaskClipViT as JaxViT
from semivl_tpu.models.vlg_head import VLGHead as JaxVLGHead
from semivl_tpu_torch.convert import (
    export_maskclip_vit, export_vlg_head, vlm_state_dict)
from semivl_tpu_torch.models.vlm import VLM, build_backbone, build_head

from torch_parity import (
    BACKBONE, HEAD, init_params, rel_err, text_embedding, tiny_vlm)


def _jax_vit():
    cfg = {k: v for k, v in BACKBONE.items() if k != 'type'}
    return JaxViT(**{**cfg, 'img_size': tuple(cfg['img_size'])})


@pytest.mark.parametrize('hw', [(64, 64), (48, 72)])
def test_maskclip_vit_matches_jax(hw):
    """(48, 72): pos-embed bicubic resize and bottom/right patch padding."""
    jm = _jax_vit()
    params = init_params(jm, 1, jnp.zeros((1, 64, 64, 3)))
    img = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    want = jm.apply({'params': params}, jnp.asarray(img))

    pm = build_backbone(BACKBONE, torch.float32)
    sd = {}
    export_maskclip_vit(sd, params, prefix='')
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(img))
    assert len(got['feats']) == len(want['feats']) == 3
    for g, w in zip(got['feats'], want['feats']):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) < 1e-5
    assert rel_err(got['global_emb'].numpy(), want['global_emb']) < 1e-5


def test_vlg_head_matches_jax():
    cfg = {k: v for k, v in HEAD.items() if k != 'type'}
    jm = JaxVLGHead(**cfg)
    rs = np.random.RandomState(3)
    h = 8   # feature grid of a 128-px image
    feats = (rs.randn(2, h, h, 128).astype(np.float32),
             rs.randn(2, h, h, 128).astype(np.float32),
             rs.randn(2, h, h, 512).astype(np.float32))
    text = text_embedding()
    params = init_params(jm, 4, tuple(jnp.asarray(f) for f in feats),
                         jnp.asarray(text))
    want = np.asarray(jm.apply({'params': params},
                               tuple(jnp.asarray(f) for f in feats),
                               jnp.asarray(text), output_size=(128, 128)))

    sd = {}
    export_vlg_head(sd, params, prefix='')
    pm = build_head(HEAD, torch.float32)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(tuple(torch.from_numpy(f) for f in feats),
                 torch.from_numpy(text), output_size=(128, 128)).numpy()
    assert got.shape == want.shape == (2, 21, 128, 128)
    assert rel_err(got, want) < 1e-5


def test_vlm_forward_matches_jax():
    jm, params, pm = tiny_vlm(seed=6)
    img = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    text = text_embedding()
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(img),
                               jnp.asarray(text)))
    with torch.no_grad():
        got = pm(torch.from_numpy(img), torch.from_numpy(text)).numpy()
    assert got.shape == want.shape == (2, 21, 64, 64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-3 * max(scale, 1.0)
    assert np.abs(got - want).mean() < 2e-4


def test_bridge_consumes_every_leaf():
    """Every JAX leaf becomes exactly one state-dict entry of the same size,
    and the port loads them with strict=True."""
    _, params, pm = tiny_vlm(seed=8)
    sd = vlm_state_dict(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(sd) == len(leaves)
    assert sum(v.size for v in sd.values()) == sum(x.size for x in leaves)
    assert set(sd) == set(pm.state_dict())
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])

    broken = dict(sd)
    broken.pop('decode_head.head.bias')
    with pytest.raises(RuntimeError, match='Missing key'):
        VLM(BACKBONE, HEAD).load_state_dict(
            {k: torch.from_numpy(v) for k, v in broken.items()}, strict=True)
