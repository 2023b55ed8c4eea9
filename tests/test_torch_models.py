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


# one case per JAX flag at its non-default value, and skip_last_attn with
# return_qkv=False; JAX forms no v-path without return_qkv, so it then makes
# no CLIP embedding either
VIT_FLAG_CASES = {
    'pre_norm': dict(pre_norm=False),
    'final_norm': dict(final_norm=False),
    'return_clip_embed': dict(return_clip_embed=False),
    'return_qkv': dict(return_qkv=False, return_clip_embed=False),
    'skip_last_attn': dict(skip_last_attn=True),
    'skip_last_attn_without_qkv': dict(skip_last_attn=True, return_qkv=False,
                                       return_clip_embed=False),
}


@pytest.mark.parametrize('case', list(VIT_FLAG_CASES))
def test_maskclip_vit_flags_match_jax(case):
    """Each flag as JAX's MaskClipViT applies it, fp32, to 1e-5 of the
    output scale; the bridge consumes every leaf of the flag's tree."""
    flags = VIT_FLAG_CASES[case]
    cfg = dict(BACKBONE, **flags)
    jm = JaxViT(**{**{k: v for k, v in cfg.items() if k != 'type'},
                   'img_size': tuple(cfg['img_size'])})
    params = init_params(jm, 11, jnp.zeros((1, 64, 64, 3)))
    img = np.random.RandomState(12).randn(2, 64, 64, 3).astype(np.float32)
    want = jm.apply({'params': params}, jnp.asarray(img))

    pm = build_backbone(cfg, torch.float32)
    sd = {}
    export_maskclip_vit(sd, params, prefix='')
    leaves = jax.tree_util.tree_leaves(params)
    assert len(sd) == len(leaves)
    assert sum(v.size for v in sd.values()) == sum(x.size for x in leaves)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(img))
    assert len(got['feats']) == len(want['feats'])
    for g, w in zip(got['feats'], want['feats']):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) < 1e-5
    if want['global_emb'] is None:
        assert got['global_emb'] is None
    else:
        assert rel_err(got['global_emb'].numpy(), want['global_emb']) < 1e-5


def test_vit_flags_the_port_cannot_consume_are_refused():
    """The combinations JAX fails on are refused by name: a CLIP embedding
    without the v-path it is made from, and a VLM that reads the embedding
    return_clip_embed=False drops (as the decode head's last feature map,
    and as the guidance encoder's output)."""
    cfg = dict(BACKBONE, return_qkv=False)
    jm = JaxViT(**{**{k: v for k, v in cfg.items() if k != 'type'},
                   'img_size': tuple(cfg['img_size'])})
    with pytest.raises(Exception):
        init_params(jm, 11, jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match='return_clip_embed needs return_qkv'):
        build_backbone(cfg, torch.float32)
    no_embed = dict(BACKBONE, return_clip_embed=False)
    with pytest.raises(ValueError, match='backbone: return_clip_embed=False'):
        VLM(no_embed, HEAD)
    with pytest.raises(ValueError,
                       match='clip_encoder: return_clip_embed=False'):
        VLM(BACKBONE, HEAD, clip_encoder_cfg=dict(no_embed, out_indices=None))
    # an embedding nothing reads may be dropped
    assert VLM(dict(no_embed, out_indices=[0, 1]), HEAD).backbone.proj is None


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


@pytest.mark.parametrize('src_img', [48, 64], ids=['resized', 'same grid'])
def test_pretrained_tree_loads_as_jax_loads_it(tmp_path, src_img):
    """A converted CLIP backbone tree written by the test (the npz of
    ``convert_clip_weights.save_flax_npz``, random leaves; its position
    embedding on a 3x3 grid, resized to the model's 4x4, or on the model's
    own) loads into the port model's ``backbone`` and frozen
    ``clip_encoder`` equal to JAX's ``load_pretrained_into``: every leaf
    bit-equal but the resized position embedding, within 1e-6; the other
    weights stay as they were."""
    from semivl_tpu.tools.convert_clip_weights import (
        load_pretrained_into as jax_load, save_flax_npz)
    from semivl_tpu_torch.convert import load_pretrained_into, vlm_state_dict
    from torch_parity import tiny_train_vlm
    _, params, pm, _ = tiny_train_vlm(seed=3)
    cfg = {k: v for k, v in BACKBONE.items() if k != 'type'}
    tree = init_params(JaxViT(**{**cfg, 'img_size': (src_img, src_img)}), 8,
                       jnp.zeros((1, src_img, src_img, 3)))
    path = str(tmp_path / 'clip.npz')
    save_flax_npz(path, tree)
    want = vlm_state_dict(jax_load({'params': params}, path)['params'])
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    load_pretrained_into(pm, path)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        ref = torch.from_numpy(np.array(want[k], np.float32))
        if k.endswith('pos_embed') and src_img != 64:
            assert (v - ref).abs().max() <= 1e-6, k
        else:
            assert torch.equal(v, ref), k
        if not k.startswith(('backbone.', 'clip_encoder.')):
            assert torch.equal(v, before[k]), k
