"""The port's checkpoint converters (``tools.convert_clip_weights``,
``convert_timm_weights``, ``convert_reference_ckpt``, ``convert_to_torch``)
against JAX's on the CPU, on synthetic state dicts made with numpy at
small widths (no real checkpoint is in the repository): the npz each
writes (same keys, equal values), the models' forwards after loading, the
non-VLG refusal, the ``convert_to_torch`` round trip and a TorchScript
archive.

Tolerances: converted leaves bit-equal, a bicubically resized position
embedding within 1e-6 of its scale (two frameworks' float32 products);
forwards within 1e-4 of the output's scale (the tolerance of the port's
VLM forward tests, float32 through a ViT and the VLG head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.models.timm_vit import TIMMVisionTransformer as JaxTIMM
from semivl_tpu.models.vlm import VLM as JaxVLM
from semivl_tpu.tools import convert_clip_weights as jclip
from semivl_tpu.tools import convert_reference_ckpt as jref
from semivl_tpu.tools import convert_timm_weights as jtimm
from semivl_tpu.tools import convert_to_torch as jto
from semivl_tpu_torch import convert
from semivl_tpu_torch.models.timm_vit import TIMMVisionTransformer
from semivl_tpu_torch.models.vlm import VLM
from semivl_tpu_torch.tools import convert_clip_weights as pclip
from semivl_tpu_torch.tools import convert_reference_ckpt as pref
from semivl_tpu_torch.tools import convert_timm_weights as ptimm
from semivl_tpu_torch.tools import convert_to_torch as pto
from semivl_tpu_torch.train.checkpoint import CheckpointManager

import torch_parity
from torch_parity import random_tree, rel_err, text_embedding
from torch_parity import few_threads  # noqa: F401 (autouse)

from test_torch_cityscapes import CONV, _random_stats


def _rand(rs, *shape, scale=0.1):
    return torch.from_numpy((scale * rs.randn(*shape)).astype(np.float32))


def _openai_sd(width=64, layers=12, grid=4, out=32, text_width=32,
               text_layers=12, seed=0):
    """An OpenAI CLIP state dict (visual tower of ``width`` over a
    ``grid``^2 patch grid, projected to ``out``; a text tower unless
    ``text_layers`` is 0)."""
    rs = np.random.RandomState(seed)
    sd = {'visual.class_embedding': _rand(rs, width),
          'visual.positional_embedding': _rand(rs, grid * grid + 1, width),
          'visual.conv1.weight': _rand(rs, width, 3, 16, 16),
          'visual.proj': _rand(rs, width, out)}

    def block(pre, w):
        sd.update({pre + 'ln_1.weight': 1 + _rand(rs, w),
                   pre + 'ln_1.bias': _rand(rs, w),
                   pre + 'attn.in_proj_weight': _rand(rs, 3 * w, w),
                   pre + 'attn.in_proj_bias': _rand(rs, 3 * w),
                   pre + 'attn.out_proj.weight': _rand(rs, w, w),
                   pre + 'attn.out_proj.bias': _rand(rs, w),
                   pre + 'ln_2.weight': 1 + _rand(rs, w),
                   pre + 'ln_2.bias': _rand(rs, w),
                   pre + 'mlp.c_fc.weight': _rand(rs, 4 * w, w),
                   pre + 'mlp.c_fc.bias': _rand(rs, 4 * w),
                   pre + 'mlp.c_proj.weight': _rand(rs, w, 4 * w),
                   pre + 'mlp.c_proj.bias': _rand(rs, w)})

    for ln in ('ln_pre', 'ln_post'):
        sd[f'visual.{ln}.weight'] = 1 + _rand(rs, width)
        sd[f'visual.{ln}.bias'] = _rand(rs, width)
    for i in range(layers):
        block(f'visual.transformer.resblocks.{i}.', width)
    if text_layers:
        sd.update({'token_embedding.weight': _rand(rs, 50, text_width),
                   'positional_embedding': _rand(rs, 77, text_width),
                   'ln_final.weight': 1 + _rand(rs, text_width),
                   'ln_final.bias': _rand(rs, text_width),
                   'text_projection': _rand(rs, text_width, out)})
        for i in range(text_layers):
            block(f'transformer.resblocks.{i}.', text_width)
    return sd


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_npz_equal(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


# ------------------------------------------------------------- CLIP

def test_openai_checkpoint_npz_equals_jax(tmp_path):
    """A raw OpenAI checkpoint (visual and text towers): the backbone npz
    and the ``--text-out`` npz equal JAX's tool's."""
    src = str(tmp_path / 'clip.pt')
    torch.save(_openai_sd(), src)
    out = {}
    for side, mod in (('jax', jclip), ('port', pclip)):
        out[side] = (str(tmp_path / f'{side}.npz'),
                     str(tmp_path / f'{side}_text.npz'))
        mod.convert(src, *out[side])
    _assert_npz_equal(out['port'][0], out['jax'][0])
    _assert_npz_equal(out['port'][1], out['jax'][1])
    assert len(_npz(out['port'][0])) == 8 + 12 * 12   # 12 blocks of 12


def test_clip2mmseg_checkpoint_npz_equals_jax(tmp_path):
    """The reference's ``clip2mmseg`` layout (``backbone.`` keys, the
    projection as a 1x1 conv) through the CLI: JAX's npz."""
    flat = jclip.convert_openai_visual(
        {k: v.numpy() for k, v in _openai_sd(text_layers=0).items()})
    flat['proj.weight'] = flat['proj.weight'][:, :, None, None]
    src = str(tmp_path / 'clip2mmseg.pth')
    torch.save({'backbone.' + k: torch.from_numpy(v)
                for k, v in flat.items()}, src)
    jclip.convert(src, str(tmp_path / 'jax.npz'))
    pclip.main(['--src', src, '--out', str(tmp_path / 'port.npz')])
    _assert_npz_equal(str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz'))


def test_torchscript_archive_loads_as_jax(tmp_path):
    """``load_torch_checkpoint`` reads a TorchScript archive (OpenAI's
    released format) through ``torch.jit.load``, as JAX's does."""
    m = torch.jit.script(torch.nn.Sequential(torch.nn.Linear(4, 3),
                                             torch.nn.LayerNorm(3)))
    path = str(tmp_path / 'scripted.pt')
    m.save(path)
    got, want = pclip.load_torch_checkpoint(path), \
        jclip.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(m.state_dict())
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], v.numpy())


# ------------------------------------------------------------- timm

def _timm_flat(width=64, layers=2, grid=14, seed=0):
    rs = np.random.RandomState(seed)

    def r(*s):
        return (0.1 * rs.randn(*s)).astype(np.float32)

    flat = {'cls_token': r(1, 1, width),
            'pos_embed': r(1, grid * grid + 1, width),
            'patch_embed.proj.weight': r(width, 3, 16, 16),
            'patch_embed.proj.bias': r(width),
            'norm.weight': 1 + r(width), 'norm.bias': r(width)}
    for i in range(layers):
        pre = f'blocks.{i}.'
        for key, shape in (('norm1', (width,)), ('norm2', (width,)),
                           ('attn.qkv', (3 * width, width)),
                           ('attn.proj', (width, width)),
                           ('mlp.fc1', (4 * width, width)),
                           ('mlp.fc2', (width, 4 * width))):
            flat[pre + key + '.weight'] = r(*shape) + (len(shape) == 1)
            flat[pre + key + '.bias'] = r(shape[0])
    return flat


def test_timm_tree_and_forward_match_jax(tmp_path):
    """A timm state dict (14x14 grid) through the CLI at a 64-px grid of
    4x4: the npz equals JAX's (the resized position embedding within
    1e-6), and the port's timm ViT loaded from it gives JAX's features."""
    flat = _timm_flat()
    src = str(tmp_path / 'timm.pth')
    torch.save({'model': {k: torch.from_numpy(v) for k, v in flat.items()}},
               src)
    want = jtimm.convert_timm_vit(flat, grid=(4, 4))
    ptimm.main(['--src', src, '--out', str(tmp_path / 'port.npz'),
                '--img-size', '64'])
    got = _npz(str(tmp_path / 'port.npz'))
    wflat = jclip._flatten(want)
    assert sorted(got) == sorted(wflat)
    for k, v in wflat.items():
        if k.endswith('pos_embed'):
            assert rel_err(got[k], v) < 1e-6
        else:
            np.testing.assert_array_equal(got[k], v, k)
    tree = convert.unflatten(got)['params']
    jm = JaxTIMM(img_size=(64, 64), embed_dims=64, num_layers=2, num_heads=2,
                 out_indices=(0, 1))
    pm = TIMMVisionTransformer(img_size=(64, 64), embed_dims=64,
                               num_layers=2, num_heads=2, out_indices=(0, 1))
    sd = {}
    convert.export_timm_vit(sd, tree, prefix='')
    pm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}, strict=True)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    wout = jm.apply({'params': want['params']}, jnp.asarray(x))
    with torch.no_grad():
        gout = pm(torch.from_numpy(x))
    for g, w in zip(jax.tree.leaves(gout), jax.tree.leaves(wout)):
        assert rel_err(g.numpy(), np.asarray(w)) < 1e-5


# ------------------------------------------------------ reference dicts

BACKBONE = dict(torch_parity.BACKBONE, out_indices=[1, 2])
HEAD = dict(torch_parity.HEAD, skip_in_channels=(128, 256),
            skip_from_conv_feat=True)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """A Cityscapes-shaped VLM (MaskCLIP ViT, VLG head, ResNetV1c skip
    encoder) with random parameters and statistics, its reference-named
    state dict (JAX's ``export_vlm_checkpoint``) saved as a released
    ``best.pth`` would be (``module.`` prefixes, an ``ema_model``, a
    guidance-encoder key), the port model carrying the weights
    (``port()``) and one image's logits of a port model and of JAX's
    jitted forward (``forwards``)."""
    jm = JaxVLM(backbone_cfg=BACKBONE, decode_head_cfg=HEAD,
                conv_encoder_cfg=CONV)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((21, 512))))
    variables = {'params': random_tree(shapes['params'], 5),
                 'batch_stats': _random_stats(shapes['batch_stats'], 6)}
    flat = jto.export_vlm_checkpoint(variables)
    ema = {k: (v * 0.5 if v.dtype == np.float32 else v)
           for k, v in flat.items()}

    def tensors(d):
        return {'module.' + k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in d.items()}

    path = str(tmp_path_factory.mktemp('ref') / 'best.pth')
    torch.save({'model': {**tensors(flat),
                          'module.clip_encoder.cls_token': torch.zeros(3)},
                'ema_model': tensors(ema), 'epoch': 7}, path)
    rs = np.random.RandomState(8)
    x = rs.randn(1, 64, 64, 3).astype(np.float32)
    text = text_embedding()
    jax_fwd = jax.jit(lambda v: jm.apply(v, jnp.asarray(x),
                                         jnp.asarray(text)))

    def port():
        """The port model carrying ``variables``."""
        pm = VLM(BACKBONE, HEAD, conv_encoder_cfg=CONV).eval()
        return convert.load_jax_params(pm, variables['params'],
                                       variables['batch_stats'])

    def forwards(pm, jax_variables):
        """(port logits, JAX's on ``jax_variables``) of one image."""
        with torch.no_grad():
            got = pm(torch.from_numpy(x), torch.from_numpy(text)).numpy()
        return got, np.asarray(jax_fwd(jax_variables))

    return dict(variables=variables, flat=flat, path=path, port=port,
                forwards=forwards)


@pytest.mark.parametrize('ema', [False, True])
def test_reference_checkpoint_npz_equals_jax(reference, tmp_path, ema):
    """``module.`` stripped, ``clip_encoder`` dropped, ``ema_model`` with
    ``--ema``: the CLI's npz equals JAX's converted tree, the epoch too."""
    flat, epoch = jref.load_reference_checkpoint(reference['path'], ema)
    jclip.save_flax_npz(str(tmp_path / 'jax.npz'),
                        jref.convert_vlm_checkpoint(flat))
    pref.main(['--src', reference['path'], '--out',
               str(tmp_path / 'port.npz')] + (['--ema'] if ema else []))
    _assert_npz_equal(str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz'))
    got_flat, got_epoch = pref.load_reference_checkpoint(reference['path'],
                                                         ema)
    assert got_epoch == epoch == 7
    assert not any('clip_encoder' in k or k.startswith('module.')
                   for k in got_flat)


def test_reference_checkpoint_forward_matches_jax(reference):
    """A port model loaded from the reference checkpoint gives JAX's
    logits on JAX's converted tree."""
    flat, _ = jref.load_reference_checkpoint(reference['path'])
    variables = jref.convert_vlm_checkpoint(flat)
    pm = VLM(BACKBONE, HEAD, conv_encoder_cfg=CONV).eval()
    assert pref.load_reference_into(pm, reference['path']) == 7
    got, want = reference['forwards'](pm, variables)
    assert rel_err(got, want) < 1e-4


def test_pretrained_openai_checkpoint_forward_matches_jax(reference,
                                                         tmp_path):
    """``load_pretrained_into`` takes a raw OpenAI checkpoint (its 14x14
    position grid resized to the model's): the VLM's logits equal JAX's
    after JAX's ``load_pretrained_into`` of the same tree."""
    sd = _openai_sd(width=BACKBONE['embed_dims'],
                    layers=BACKBONE['num_layers'], grid=14,
                    out=BACKBONE['clip_dim'], text_layers=0, seed=2)
    src = str(tmp_path / 'clip.pt')
    torch.save(sd, src)
    tree = jclip.mmseg_flat_to_flax(
        jclip.convert_openai_visual({k: v.numpy() for k, v in sd.items()}),
        num_layers=BACKBONE['num_layers'])
    variables = jclip.load_pretrained_into(reference['variables'], tree)
    pm = reference['port']()
    convert.load_pretrained_into(pm, src)
    np.testing.assert_array_equal(
        pm.state_dict()['backbone.layers.1.attn.attn.in_proj_weight'],
        sd['visual.transformer.resblocks.1.attn.in_proj_weight'])
    got, want = reference['forwards'](pm, variables)
    assert rel_err(got, want) < 1e-4


def test_reference_checkpoint_refuses_non_vlg_heads(reference):
    flat = {k: v for k, v in reference['flat'].items()
            if not k.startswith('decode_head.')}
    with pytest.raises(NotImplementedError, match='VLG'):
        pref.convert_vlm_checkpoint(flat)
    with pytest.raises(NotImplementedError):
        jref.convert_vlm_checkpoint(flat)
    with pytest.raises(NotImplementedError, match='VLG'):
        pto.export_vlm_checkpoint({'backbone.cls_token': torch.zeros(1)})


def test_convert_to_torch_round_trip(reference, tmp_path):
    """A port run slot (with a parameter EMA) -> ``convert_to_torch``: the
    keys and values of JAX's ``export_vlm_checkpoint`` (the guidance
    encoder left out, a zero ``num_batches_tracked`` per BatchNorm), the
    epoch from ``extra.json``; back through ``convert_reference_ckpt``,
    the slot's parameters (with ``--ema`` its EMA) and statistics."""
    pm = reference['port']()
    got = pto.export_vlm_checkpoint(pm.state_dict())
    want = reference['flat']
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)

    opt = torch.optim.AdamW(pm.parameters())
    ema = {n: p.detach() + 1.0 for n, p in pm.named_parameters()}
    CheckpointManager(str(tmp_path)).save('latest', pm, opt, 4,
                                          {'epoch': 3}, ema)
    for use_ema in (False, True):
        out = str(tmp_path / f'ref_{use_ema}.pth')
        pto.main(['--run-dir', str(tmp_path), '--slot', 'latest', '--out',
                  out] + (['--ema'] if use_ema else []))
        flat, epoch = pref.load_reference_checkpoint(out)
        assert epoch == 3
        tree = pref.convert_vlm_checkpoint(flat)
        back = convert.vlm_state_dict(tree['params'], tree['batch_stats'])
        sd = pm.state_dict()
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            expect = ema[k] if use_ema and k in ema else v
            np.testing.assert_array_equal(back[k], expect.numpy(), k)
