"""Port ops vs the JAX package on the CPU: resize, attention (plain version
of the packed attention kernel) and the fused VLG decoder (plain version of
the stage kernel). Float32 on both sides; tolerances relative to the output
scale: 1e-5 for resize and attention, 2e-4 for the decoder chain (the bound
tests/test_fused_decoder.py holds the JAX kernel to)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.ops.resize import _axis_weights as jax_axis_weights
from semivl_tpu.ops.resize import resize as jax_resize
from semivl_tpu.ops.resize import resize_longer_matrix as jax_rlm
from semivl_tpu.ops.attention import _mha_xla
from semivl_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from semivl_tpu.ops.fused_decoder import fused_vlg_decoder as jax_decoder
from semivl_tpu.ops.polyphase import chain_reference, from_phases, to_phases
from semivl_tpu_torch import convert
from semivl_tpu_torch.ops import flash_attention, fused_decoder, resize

from torch_parity import rel_err, random_tree


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize('mode,align,in_hw,out_hw', [
    ('bilinear', True, (8, 8), (16, 16)),
    ('bilinear', True, (53, 40), (64, 37)),
    ('bilinear', False, (32, 32), (128, 96)),
    ('bilinear', False, (33, 47), (17, 20)),
    ('bicubic', False, (4, 4), (3, 5)),
    ('bicubic', False, (32, 32), (43, 32)),
])
def test_resize_matches_jax(mode, align, in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw, mode, align))
    got = resize.resize(torch.from_numpy(x), out_hw, mode, align).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5
    np.testing.assert_array_equal(
        resize._axis_weights(out_hw[0], in_hw[0], mode, align, 'float32'),
        jax_axis_weights(out_hw[0], in_hw[0], mode, align, 'float32'))


def test_resize_longer_matrix_matches_jax():
    pos = np.random.RandomState(1).randn(1, 1 + 16, 8).astype(np.float32)
    want = np.asarray(jax_rlm(jnp.asarray(pos), (3, 5), (4, 4)))
    got = resize.resize_longer_matrix(torch.from_numpy(pos), (3, 5), (4, 4))
    assert rel_err(got.numpy(), want) < 1e-5


# ------------------------------------------------------------- attention

@pytest.mark.parametrize('length', [21, 130])
@pytest.mark.parametrize('valid', [False, True])
def test_attention_plain_matches_jax(length, valid):
    """q, k, v as column slices of one (B, L, 3C) projection, as the model
    hands them to the kernel; 2 heads of 64."""
    rs = np.random.RandomState(length)
    qkv = rs.randn(2, length, 3 * 128).astype(np.float32)
    valid_len = length - 5 if valid else None
    q, k, v = np.split(qkv, 3, axis=-1)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_kernel = np.asarray(jax_flash_mha(jq, jk, jv, 2, interpret=True,
                                           valid_len=valid_len))
    want_xla = np.asarray(_mha_xla(jq, jk, jv, 2, valid_len=valid_len))
    before = flash_attention.launches
    tq, tk, tv = torch.from_numpy(qkv).chunk(3, dim=-1)
    got = flash_attention.flash_mha(tq, tk, tv, 2, valid_len=valid_len)
    assert flash_attention.launches == before   # CPU: plain version
    assert rel_err(got.numpy(), want_kernel) < 1e-5
    assert rel_err(got.numpy(), want_xla) < 1e-5


# --------------------------------------------------------------- decoder

def _decoder_setup(seed=21, b=2, n=2, h=8, cin=24, cs1=16, cout1=32,
                   cs2=16, cout2=16):
    """Random JAX Up/head params (flax layout) and inputs: two images of
    two class planes each, at an 8x8 base grid."""
    from semivl_tpu.models.vlg_head import Up
    rs = np.random.RandomState(seed)
    x = rs.randn(b * n, cin, h, h).astype(np.float32)
    skip1 = rs.randn(b, cs1, 2 * h, 2 * h).astype(np.float32)
    skip2 = rs.randn(b, cs2, 4 * h, 4 * h).astype(np.float32)
    shapes = {}
    for name, c_in, cs, co in (('up1', cin, cs1, cout1),
                               ('up2', cout1, cs2, cout2)):
        shapes[name] = jax_eval_up(Up(co, cs), c_in)
    tree = random_tree(shapes, seed + 1)
    rs2 = np.random.RandomState(seed + 2)
    head = {'kernel': (0.2 * rs2.randn(3, 3, cout2, 1)).astype(np.float32),
            'bias': rs2.randn(1).astype(np.float32)}
    return x, skip1, skip2, tree['up1'], tree['up2'], head


def jax_eval_up(module, c_in):
    import jax
    return jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), None, declare=True, in_channels=c_in))['params']


def _port_params(p1, p2, head):
    sd = {}
    for name, p in (('up1', p1), ('up2', p2)):
        sd[f'{name}.up.weight'] = p['up_kernel'].transpose(2, 3, 0, 1)
        sd[f'{name}.up.bias'] = p['up_bias']
        convert._conv_gn(sd, f'{name}.conv.0', f'{name}.conv.1', p['conv1'])
        convert._conv_gn(sd, f'{name}.conv.3', f'{name}.conv.4', p['conv2'])
    convert._conv(sd, 'head', head)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    def stage(name):
        return dict(up_weight=t[f'{name}.up.weight'],
                    up_bias=t[f'{name}.up.bias'],
                    conv1_weight=t[f'{name}.conv.0.weight'],
                    gn1_weight=t[f'{name}.conv.1.weight'],
                    gn1_bias=t[f'{name}.conv.1.bias'],
                    conv2_weight=t[f'{name}.conv.3.weight'],
                    gn2_weight=t[f'{name}.conv.4.weight'],
                    gn2_bias=t[f'{name}.conv.4.bias'])

    return stage('up1'), stage('up2'), dict(weight=t['head.weight'],
                                            bias=t['head.bias'])


def test_decoder_plain_matches_jax_kernel_and_reference():
    x, skip1, skip2, p1, p2, head = _decoder_setup()
    jargs = [jnp.asarray(a) for a in (x, skip1, skip2)]
    want_kernel = np.asarray(jax_decoder(*jargs, p1, p2, head,
                                         interpret=True,
                                         storage=jnp.float32))
    want_ref = np.asarray(from_phases(chain_reference(
        jargs[0], to_phases(jargs[1], 1), to_phases(jargs[2], 2),
        p1, p2, head), 2))
    tp1, tp2, th = _port_params(p1, p2, head)
    before = fused_decoder.launches
    got = fused_decoder.fused_vlg_decoder(
        torch.from_numpy(x), torch.from_numpy(skip1),
        torch.from_numpy(skip2), tp1, tp2, th).numpy()
    assert fused_decoder.launches == before   # CPU: plain version
    assert got.shape == want_kernel.shape == (4, 1, 32, 32)
    assert rel_err(got, want_kernel) < 2e-4
    assert rel_err(got, want_ref) < 2e-4
