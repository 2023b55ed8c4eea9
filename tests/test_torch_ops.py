"""Port ops vs the JAX package on the CPU: resize, attention (plain versions
of the packed attention kernels, forward and backward) and the fused VLG
decoder (plain version of the stage kernels, forward and backward).
Float32 on the port's side; tolerances relative to the output scale: 1e-5
for resize and attention, 2e-4 for the decoder chain (the bound
tests/test_fused_decoder.py holds the JAX kernel to), and for decoder
gradients 1e-4 against the XLA chain and 5e-4 against the JAX kernels'
backward run with float32 storage (the bound the JAX package's own
gradient test holds it to)."""

from unittest import mock

import jax
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
    got = flash_attention.packed_attention(torch.from_numpy(qkv), 2,
                                           valid_len=valid_len)
    assert flash_attention.launches == before   # CPU: plain version
    assert rel_err(got.numpy(), want_kernel) < 1e-5
    assert rel_err(got.numpy(), want_xla) < 1e-5


@pytest.mark.parametrize('length,valid_len', [(21, None), (130, 125)])
def test_attention_bwd_plain_matches_jax(length, valid_len):
    """The plain backward against jax.vjp of the Pallas packed kernels
    (interpret mode), and autograd through the plain forward and through
    the port's Function against both."""
    rs = np.random.RandomState(length + 1)
    qkv = rs.randn(2, length, 3 * 128).astype(np.float32)
    g = rs.randn(2, length, 128).astype(np.float32)

    def jax_attn(q, k, v):
        return jax_flash_mha(q, k, v, 2, interpret=True, valid_len=valid_len)

    _, vjp = jax.vjp(jax_attn, *(jnp.asarray(a)
                                 for a in np.split(qkv, 3, axis=-1)))
    want = np.concatenate([np.asarray(t) for t in vjp(jnp.asarray(g))], -1)
    tqkv, tg = torch.from_numpy(qkv), torch.from_numpy(g)
    out = flash_attention.flash_mha_plain(*tqkv.chunk(3, dim=-1), 2,
                                          valid_len)
    got = flash_attention.flash_mha_bwd_plain(tqkv, out, tg, 2, valid_len)
    assert got.shape == qkv.shape
    assert rel_err(got.numpy(), want) < 1e-5
    before = flash_attention.bwd_launches
    for fn in (flash_attention.packed_attention_plain,
               flash_attention.packed_attention):
        x = tqkv.clone().requires_grad_(True)
        (ag,) = torch.autograd.grad(fn(x, 2, valid_len), x, tg)
        assert rel_err(ag.numpy(), want) < 1e-5
    assert flash_attention.bwd_launches == before   # CPU: plain versions


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


def test_decoder_bwd_plain_matches_jax_kernel_and_reference():
    """Autograd of the port's plain chain against jax.vjp of the XLA Up
    chain and of the fused Pallas chain (interpret mode, float32 storage:
    with bf16 storage the kernels' own rounding, not the algorithm, sets
    the difference), for every input and parameter."""
    x, skip1, skip2, p1, p2, head = _decoder_setup()
    g = np.random.RandomState(30).randn(4, 1, 32, 32).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, skip1, skip2)]

    def xla_chain(x, s1, s2, p1, p2, hd):
        return from_phases(chain_reference(x, to_phases(s1, 1),
                                           to_phases(s2, 2), p1, p2, hd), 2)

    def kernel_chain(x, s1, s2, p1, p2, hd):
        return jax_decoder(x, s1, s2, p1, p2, hd, interpret=True,
                           storage=jnp.float32)

    grads = {}
    for name, fn in (('xla', xla_chain), ('kernel', kernel_chain)):
        _, vjp = jax.vjp(fn, *jargs, p1, p2, head)
        gx, gs1, gs2, gp1, gp2, gh = vjp(jnp.asarray(g))
        tp1, tp2, th = _port_params(*(jax.tree.map(
            lambda a: np.asarray(a, np.float32), t) for t in (gp1, gp2, gh)))
        grads[name] = [np.asarray(a, np.float32) for a in (gx, gs1, gs2)] + [
            t[k].numpy() for t in (tp1, tp2) for k in
            fused_decoder.STAGE_KEYS] + [th['weight'].numpy(),
                                         th['bias'].numpy()]

    tp1, tp2, th = _port_params(p1, p2, head)
    acts = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, skip1, skip2)]
    prms = ([tp1[k] for k in fused_decoder.STAGE_KEYS]
            + [tp2[k] for k in fused_decoder.STAGE_KEYS]
            + [th['weight'], th['bias']])
    for t in prms:
        t.requires_grad_(True)
    out = fused_decoder.fused_vlg_decoder(*acts, tp1, tp2, th)
    got = torch.autograd.grad(out, acts + prms, torch.from_numpy(g))
    assert len(got) == len(grads['xla']) == 21
    for i, a in enumerate(got):
        a = a.numpy()
        assert a.shape == grads['xla'][i].shape, i
        assert rel_err(a, grads['xla'][i]) < 1e-4, i
        assert rel_err(a, grads['kernel'][i]) < 5e-4, i


# ------------------------------------------------------------ stage widths
# The stage kernels take every width JAX's decoder takes: an output (and a
# normalised input) in GroupNorm's kernel layout (``fused_decoder.gn_layout``,
# ``pad_outputs``), the other widths padded to the products' widths
# (``stage_plan``); ``fused_decoder._check_widths`` refuses by name before
# any launch only what JAX refuses (GroupNorm's groups do not split Cout).

def _chain_widths(cin, ups, skips):
    """((Cin, Cu, Cs, Cout, gn_in) of stage 1, of stage 2) of a decoder
    chain, from the ``Up`` modules' parameters."""
    from semivl_tpu_torch.models.vlg_head import Up
    with torch.device('meta'):
        ps = (Up(cin, ups[0], skips[0]).stage_params(),
              Up(ups[0], ups[1], skips[1]).stage_params())
    return tuple((p['up_weight'].shape[0], p['up_weight'].shape[1], cs,
                  p['conv2_weight'].shape[0], k == 1)
                 for k, (p, cs) in enumerate(zip(ps, skips)))


def _takes(widths, bwd):
    for cin, cu, cs, cout, gn_in in widths:
        fused_decoder._check_widths(cin, cout, gn_in)
        plan = fused_decoder.stage_plan(cin, cu, cs, bwd)
        assert plan['cin'] >= cin and plan['cu'] >= cu and plan['cs'] >= cs


@pytest.mark.parametrize('bwd', [False, True], ids=['forward', 'backward'])
@pytest.mark.parametrize('cfg', ['flagship_cfg', 'cityscapes_cfg',
                                 'tiny_cfg'])
def test_stage_checks_take_every_shipped_width(cfg, bwd):
    """Every shipped model's decoder widths (the flagship's, exp 44's and
    the tiny VLM's, from their model configs) pass the stage checks and
    map to a plan, forward and backward."""
    from semivl_tpu_torch import configs
    run = getattr(configs, cfg)()
    head = configs.get_model_config(run['model'], img_size=run['crop_size'])[
        'model']['decode_head']
    _takes(_chain_widths(head['channels'], head['up_channels'],
                         head['skip_channels']), bwd)


# (Cin, up channels, skip channels) -> None (the kernels take it) or the
# refusal's words
WIDTHS = {
    'Cout 48': ((128, (48, 32), (32, 16)), None),
    'Cout 96': ((128, (96, 32), (32, 16)), None),
    'Cin 48': ((48, (64, 32), (16, 16)), None),
    'Cin 24': ((24, (64, 32), (8, 16)), None),
    'Cs 112': ((128, (64, 32), (112, 16)), None),
    'Cu 112': ((128, (64, 32), (16, 16)), None),
    'Cin 160, Cu 144': ((160, (64, 32), (16, 16)), None),
    'Cout 128 (stage 2)': ((128, (64, 128), (32, 16)), None),
    'Cout 24': ((128, (24, 16), (32, 16)), None),
    'Cout 40, 8': ((128, (40, 8), (32, 16)), None),
    'Cout 160, 112': ((128, (160, 112), (32, 16)), None),
    'Cout 33': ((128, (33, 16), (32, 16)), r'\(33, 2\)'),
}


@pytest.mark.parametrize('bwd', [False, True], ids=['forward', 'backward'])
@pytest.mark.parametrize('case', list(WIDTHS))
def test_stage_checks_take_wide_widths(case, bwd):
    """Widths beyond the shipped ones: any Cout JAX takes (8 to 160 here),
    any Cin (padded to 16), Cu and Cs above the backward's widest product
    (column groups) run on the kernels in both directions; a Cout that
    GroupNorm's groups do not split (33) is refused by name, as JAX's
    assert refuses it."""
    (cin, ups, skips), refusal = WIDTHS[case]
    if refusal is None:
        _takes(_chain_widths(cin, ups, skips), bwd)
    else:   # the model's Up refuses it as it is built, as the kernels do
        with pytest.raises(ValueError, match=refusal):
            _takes(_chain_widths(cin, ups, skips), bwd)
        with pytest.raises(ValueError, match=refusal):
            fused_decoder._check_widths(cin, ups[0])


def test_gn_layout_takes_what_jax_takes():
    """Every output width from 8 to 256: ``fused_decoder.gn_layout`` maps
    it exactly where JAX's fused decoder takes it (its group matrix,
    ``_group_mat``, asserts that GroupNorm's groups split Cout), to JAX's
    group size, and refuses the rest by name with JAX's (Cout, groups)."""
    from semivl_tpu.ops.fused_decoder import _group_mat
    for c in range(8, 257):
        try:
            gm = np.asarray(_group_mat(c, 1))
        except AssertionError:
            with pytest.raises(ValueError, match=rf'\({c}, {max(c // 16, 1)}\)'):
                fused_decoder.gn_layout(c)
            continue
        gs, width, index = fused_decoder.gn_layout(c)
        assert (gm[0] > 0).sum() == gs and width % 16 == 0 and width < 2 * c + 16
        assert index.unique().numel() == c


def _jax_xla_chain(x, s1, s2, p1, p2, head, cout1, cs1, cout2, cs2):
    """JAX's XLA Up stages and head (semivl_tpu/models/vlg_head.py:467-475)
    on NCHW planes, NCHW logits."""
    import flax.linen as nn
    from semivl_tpu.models.vlg_head import Up
    y = jnp.transpose(x, (0, 2, 3, 1))
    for p, skip, co, cs in ((p1, s1, cout1, cs1), (p2, s2, cout2, cs2)):
        y = Up(co, cs).apply({'params': p}, y, jnp.transpose(skip,
                                                             (0, 2, 3, 1)))
    y = nn.Conv(1, (3, 3), padding=((1, 1), (1, 1))).apply(
        {'params': head}, y)
    return jnp.transpose(y, (0, 3, 1, 2))


def test_decoder_at_cout_48_matches_jax_xla():
    """At Cout 48 (so stage 2's Cin 48), ``fused_vlg_decoder`` under
    autograd on the CPU (the plain chain, no launch) matches JAX's XLA Up
    stages (``semivl_tpu/models/vlg_head.py:467-475``): the logits within
    2e-4 and every gradient within 1e-4 of its scale, as the plain chain is
    held at the shipped widths."""
    widths = dict(cin=64, cs1=16, cout1=48, cs2=16, cout2=16)
    x, skip1, skip2, p1, p2, head = _decoder_setup(**widths)
    g = np.random.RandomState(33).randn(4, 1, 32, 32).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, skip1, skip2)]

    def xla(x, s1, s2, p1, p2, hd):
        return _jax_xla_chain(x, s1, s2, p1, p2, hd, 48, 16, 16, 16)

    want, vjp = jax.vjp(xla, *jargs, p1, p2, head)
    gx, gs1, gs2, gp1, gp2, gh = vjp(jnp.asarray(g))
    tp1, tp2, th = _port_params(*(jax.tree.map(
        lambda a: np.asarray(a, np.float32), t) for t in (gp1, gp2, gh)))
    want_g = [np.asarray(a, np.float32) for a in (gx, gs1, gs2)] + [
        t[k].numpy() for t in (tp1, tp2) for k in fused_decoder.STAGE_KEYS
    ] + [th['weight'].numpy(), th['bias'].numpy()]

    tp1, tp2, th = _port_params(p1, p2, head)
    acts = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, skip1, skip2)]
    prms = ([tp1[k] for k in fused_decoder.STAGE_KEYS]
            + [tp2[k] for k in fused_decoder.STAGE_KEYS]
            + [th['weight'], th['bias']])
    for t in prms:
        t.requires_grad_(True)
    before = fused_decoder.launches
    out = fused_decoder.fused_vlg_decoder(*acts, tp1, tp2, th)
    assert fused_decoder.launches == before
    assert out.shape == want.shape == (4, 1, 32, 32)
    assert rel_err(out.detach().numpy(), np.asarray(want)) < 2e-4
    got = torch.autograd.grad(out, acts + prms, torch.from_numpy(g))
    assert len(got) == len(want_g) == 21
    for i, (a, wnt) in enumerate(zip(got, want_g)):
        assert a.shape == wnt.shape, i
        assert rel_err(a.numpy(), wnt) < 1e-4, i


# ---------------------------------------------- rounded references (card)
# ``packed_attention_rounded`` and ``fused_vlg_decoder_rounded`` are what
# the CUDA kernels are held to on the card: plain PyTorch that rounds to
# bf16 where the kernels do. Here their structure is checked on the CPU.

def _rel_l2(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _online_softmax_loop(qkv, heads, valid_len, tile):
    """The forward kernel's loop written out: per row, ``tile``-key tiles, the
    running max, p = exp(s - max) rounded to bf16 before p v, the earlier
    sums rescaled by exp(old max - new max), the row sum of the unrounded p
    divided out at the end, the output rounded to bf16."""
    b, length, c3 = qkv.shape
    x = qkv.float()
    out = torch.empty(b, length, c3 // 3)
    for bi in range(b):
        for h in range(heads):
            q, k, v = (x[bi, :, j * c3 // 3 + 64 * h:][:, :64] for j in
                       range(3))
            m = torch.full((length,), float('-inf'))
            row_sum, acc = torch.zeros(length), torch.zeros(length, 64)
            for k0 in range(0, valid_len, tile):
                s = (q / 8) @ k[k0:k0 + tile].T
                s[:, torch.arange(k0, k0 + s.shape[1]) >= valid_len] = -1e30
                m_new = torch.maximum(m, s.amax(1))
                p = torch.exp(s - m_new[:, None])
                corr = torch.exp(m - m_new)
                acc = acc * corr[:, None] + (p.bfloat16().float()
                                             @ v[k0:k0 + tile])
                row_sum = row_sum * corr + p.sum(1)
                m = m_new
            out[bi, :, 64 * h:64 * (h + 1)] = acc / row_sum[:, None]
    return out.bfloat16()


@pytest.mark.parametrize('length,valid_len', [(21, None), (130, 125),
                                              (200, None), (300, None),
                                              (300, 290)])
def test_attention_rounded_reference(length, valid_len):
    """Its forward is the kernel's tiled online softmax over the kernel's
    key tiles (``_BK``; 300 keys end in a ragged tile, and valid_len 290
    falls inside it) to the order of float32 sums: 1e-3 relative L2, under
    one bf16 rounding step; its gradient is ``flash_mha_bwd_plain``; both
    stay within bf16 rounding of p, ds and the outputs (5e-3 relative L2)
    of the float32 plain version."""
    rs = np.random.RandomState(length + 2)
    qkv = torch.from_numpy(rs.randn(2, length, 3 * 128).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rs.randn(2, length, 128).astype(
        np.float32)).bfloat16()
    x = qkv.clone().requires_grad_(True)
    out = flash_attention.packed_attention_rounded(x, 2, valid_len)
    (got,) = torch.autograd.grad(out, x, g)
    assert out.dtype == got.dtype == torch.bfloat16
    out = out.detach()
    assert _rel_l2(out.float(), _online_softmax_loop(
        qkv, 2, valid_len or length, flash_attention._BK).float()) < 1e-3
    assert torch.equal(got, flash_attention.flash_mha_bwd_plain(
        qkv, out, g, 2, valid_len))
    x32 = qkv.float().requires_grad_(True)
    out32 = flash_attention.packed_attention_plain(x32, 2, valid_len)
    (want,) = torch.autograd.grad(out32, x32, g.float())
    assert _rel_l2(out.float(), out32.detach()) < 5e-3
    assert _rel_l2(got.float(), want) < 5e-3


def test_round_bf16_passes_the_gradient_straight_through():
    t = torch.randn(64, dtype=torch.float32, requires_grad=True)
    r = fused_decoder._round_bf16(t)
    assert torch.equal(r, t.detach().bfloat16().float())
    g = torch.randn(64)
    (got,) = torch.autograd.grad(r, t, g)
    assert torch.equal(got, g)


def test_decoder_rounded_reference(monkeypatch):
    """Without its roundings (of values and of gradients) it is the plain
    chain in float32 (values and every gradient to 1e-5); with them its
    logits stay within bf16 storage (1e-2 relative L2) of that chain."""
    x, skip1, skip2, p1, p2, head = _decoder_setup()
    tp1, tp2, th = _port_params(p1, p2, head)
    prms = ([tp1[k] for k in fused_decoder.STAGE_KEYS]
            + [tp2[k] for k in fused_decoder.STAGE_KEYS]
            + [th['weight'], th['bias']])
    for t in prms:
        t.requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(31).randn(
        4, 1, 32, 32).astype(np.float32))

    def run(fn):
        acts = [torch.from_numpy(a).requires_grad_(True)
                for a in (x, skip1, skip2)]
        out = fn(*acts, tp1, tp2, th)
        return out, torch.autograd.grad(out, acts + prms, g)

    want, want_grads = run(fused_decoder.fused_vlg_decoder_plain)
    rounded, _ = run(fused_decoder.fused_vlg_decoder_rounded)
    assert _rel_l2(rounded.detach(), want.detach()) < 1e-2
    monkeypatch.setattr(fused_decoder, '_round_bf16', lambda t: t)
    monkeypatch.setattr(fused_decoder, '_round_grad_bf16', lambda t: t)
    got, got_grads = run(fused_decoder.fused_vlg_decoder_rounded)
    assert rel_err(got.detach().numpy(), want.detach().numpy()) < 1e-5
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        assert rel_err(a.numpy(), w.numpy()) < 1e-5, i


def test_decoder_rounded_reference_takes_the_stored_conv2():
    """``raw2_1`` (stage 1's raw conv2 as the kernels stored it) replaces
    the reference's own values: the logits are stage 2 and the head on
    GN2+ReLU of it, exactly; the gradient still reaches every input and
    parameter of stage 1, through the reference's own conv2."""
    x, skip1, skip2, p1, p2, head = _decoder_setup()
    tp1, tp2, th = _port_params(p1, p2, head)
    for t in tp1.values():
        t.requires_grad_(True)
    acts = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, skip1, skip2)]
    raw2 = torch.randn(4, 32, 16, 16, generator=torch.Generator()
                       .manual_seed(34)).bfloat16().float()
    out = fused_decoder.fused_vlg_decoder_rounded(*acts, tp1, tp2, th,
                                                  raw2_1=raw2)
    a2 = fused_decoder._gn_relu_rounded(raw2, tp1['gn2_weight'],
                                        tp1['gn2_bias'])
    want = fused_decoder.head_rounded(fused_decoder.up_stage_rounded(
        a2, acts[2], tp2), th)
    assert torch.equal(out, want)
    grads = torch.autograd.grad(out.sum(), [acts[0], acts[1]]
                                + [tp1[k] for k in fused_decoder.STAGE_KEYS])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_round_grad_bf16_rounds_only_the_gradient():
    t = torch.randn(64, dtype=torch.float64, requires_grad=True)
    r = fused_decoder._round_grad_bf16(t)
    assert torch.equal(r, t.detach())
    g = torch.randn(64, dtype=torch.float64)
    (got,) = torch.autograd.grad(r, t, g)
    assert got.dtype == torch.float64
    assert torch.equal(got, g.bfloat16().double())


def _conv_pass_stats_of_stored(taps_lists, read, w_at, geo, cdt, store,
                               tiles):
    """JAX ``_conv_pass`` with the GroupNorm sums taken over the stored
    (``cdt``) values, as the port's kernels take them, instead of over the
    float32 accumulators."""
    from semivl_tpu.ops.fused_decoder import _mask_cols, _phase_conv
    ssum = ssq = None
    for v in range(4):
        for f0, F in tiles:
            acc = _mask_cols(_phase_conv(taps_lists[v], read, geo, w_at(v),
                                         cdt, f0, F), geo, f0, F)
            store(v, f0, acc)
            acc = acc.astype(cdt).astype(jnp.float32)
            s = jnp.sum(acc, axis=1, keepdims=True)
            q = jnp.sum(acc * acc, axis=1, keepdims=True)
            ssum = s if ssum is None else ssum + s
            ssq = q if ssq is None else ssq + q
    return ssum, ssq


@pytest.mark.parametrize('route', ['whole', 'banded'])
def test_decoder_bf16_grad_reference_matches_jax_kernel(monkeypatch, route):
    """The backward's bf16 gradient rounding points against the JAX fused
    chain at its own bf16 storage (interpret mode), on the whole-plane
    route and on the banded one (``SEMIVL_FORCE_BANDED_BWD=1``, whose
    kernels store gy2, graw2, gy1, graw1 and g_x in bf16): each gradient
    leaf of ``fused_vlg_decoder_rounded`` within 1e-2 relative L2, and the
    leaves' summed squared distances under 0.9 of those of the float32-
    gradient reference (``bf16_grads=False``) to the same JAX run, which
    shows that the rounding points agree. (Measured: 2.3e-4 against
    3.0e-4, the same on both routes; the tail leaves of the last stage,
    which see only the head's rounded gradient, 3.9e-4 and 5e-9 against
    3.1e-3 and 8.7e-4.) The banded case also asserts that JAX ran its
    banded kernels, once per stage.

    The two forwards are made to agree first, so that the gradient
    roundings are not buried under forward differences that GroupNorm
    amplifies (with the seeded weights as they are, both references lie
    ~1e-1 from JAX): inputs and the logits' gradient hold bf16 values; the
    transpose convs copy channels (0/1 weights, zero bias) and conv1's
    weights are multiples of 1/64 up to 1/4, so that JAX's composite
    weights (the transpose conv folded into conv1, rounded to bf16) are
    exact and the port's bf16 rounding of the transpose conv output is
    too; and JAX's GroupNorm statistics are taken over the stored bf16 raw
    outputs, as the port's are (patched here: JAX sums the float32
    accumulators). What is left is float32 sum order, which flips rare
    bf16 roundings."""
    from semivl_tpu.ops import fused_decoder as jfd
    monkeypatch.setattr(jfd, '_conv_pass', _conv_pass_stats_of_stored)
    banded_calls = []
    if route == 'banded':
        from semivl_tpu.ops import fused_decoder_banded as jfdb
        monkeypatch.setenv('SEMIVL_FORCE_BANDED_BWD', '1')
        real = jfdb._stage_bwd_banded
        monkeypatch.setattr(jfdb, '_stage_bwd_banded', lambda *a, **k: (
            banded_calls.append(1), real(*a, **k))[1])

    def bf16(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    x, skip1, skip2, p1, p2, head = _decoder_setup()
    x, skip1, skip2 = bf16(x), bf16(skip1), bf16(skip2)
    rs = np.random.RandomState(5)
    for p in (p1, p2):
        k = np.asarray(p['up_kernel'])
        sel = np.zeros(k.shape, np.float32)
        for c in range(k.shape[3]):
            sel[:, :, c, c] = 1
        p['up_kernel'] = sel
        p['up_bias'] = np.zeros(k.shape[3], np.float32)
        w1 = p['conv1']['conv']['kernel']
        p['conv1']['conv']['kernel'] = (
            rs.randint(-16, 17, w1.shape) / 64).astype(np.float32)
    g = bf16(np.random.RandomState(30).randn(4, 1, 32, 32).astype(np.float32))

    jargs = [jnp.asarray(a) for a in (x, skip1, skip2)]
    out, vjp = jax.vjp(lambda *a: jax_decoder(*a, interpret=True), *jargs,
                       p1, p2, head)
    gx, gs1, gs2, gp1, gp2, gh = vjp(jnp.asarray(g, out.dtype))
    assert len(banded_calls) == (2 if route == 'banded' else 0)
    tp1, tp2, th = _port_params(*(jax.tree.map(
        lambda a: np.asarray(a, np.float32), t) for t in (gp1, gp2, gh)))
    want = [np.asarray(a, np.float32) for a in (gx, gs1, gs2)] + [
        t[k].numpy() for t in (tp1, tp2) for k in
        fused_decoder.STAGE_KEYS] + [th['weight'].numpy(), th['bias'].numpy()]

    tp1, tp2, th = _port_params(p1, p2, head)
    prms = ([tp1[k] for k in fused_decoder.STAGE_KEYS]
            + [tp2[k] for k in fused_decoder.STAGE_KEYS]
            + [th['weight'], th['bias']])
    for t in prms:
        t.requires_grad_(True)
    dist = {}
    for bf16_grads in (True, False):
        acts = [torch.from_numpy(a).requires_grad_(True)
                for a in (x, skip1, skip2)]
        o = fused_decoder.fused_vlg_decoder_rounded(
            *acts, tp1, tp2, th, bf16_grads=bf16_grads)
        assert _rel_l2(o.detach(), torch.from_numpy(
            np.asarray(out, np.float32))) < 5e-3
        got = torch.autograd.grad(o, acts + prms, torch.from_numpy(g))
        dist[bf16_grads] = [_rel_l2(a, torch.from_numpy(w))
                            for a, w in zip(got, want)]
    assert max(dist[True]) < 1e-2, dist[True]
    assert sum(e * e for e in dist[True]) < 0.9 * sum(
        e * e for e in dist[False]), dist


# ------------------------------------------------- banded decoder backward
# The three passes of ``ops.fused_decoder_banded`` in their plain versions,
# float32 storage on both sides, against the JAX package's row-banded
# Pallas passes (interpret mode) at its own multi-band test geometry, with
# the bound that test holds the banded kernels to: 2e-5 of each output's
# scale (floored at 1e-3, as there); and passes A and C at bf16 storage on
# both sides (``BF16_PASS_TOL``).

def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


def _port_stage(p):
    """flax ``Up`` params -> the port's stage dict (float32 tensors)."""
    sd = {'up.weight': p['up_kernel'].transpose(2, 3, 0, 1),
          'up.bias': p['up_bias']}
    convert._conv_gn(sd, 'conv1', 'gn1', p['conv1'])
    convert._conv_gn(sd, 'conv2', 'gn2', p['conv2'])
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
         for k, v in sd.items()}
    return dict(up_weight=t['up.weight'], up_bias=t['up.bias'],
                conv1_weight=t['conv1.weight'], gn1_weight=t['gn1.weight'],
                gn1_bias=t['gn1.bias'], conv2_weight=t['conv2.weight'],
                gn2_weight=t['gn2.weight'], gn2_bias=t['gn2.bias'])


def _exact_composite(params, seed):
    """Make JAX's composite conv1 weights (the transpose conv folded into
    conv1, rounded to the storage dtype) exact in bf16, as the port's
    rounding of the transpose conv output is: the transpose conv copies
    channels (0/1 weights, zero bias), conv1's weights are multiples of
    1/64 up to 1/4."""
    rs = np.random.RandomState(seed)
    k = np.asarray(params['up_kernel'])
    sel = np.zeros(k.shape, np.float32)
    for c in range(k.shape[3]):
        sel[:, :, c % k.shape[2], c] = 1
    params['up_kernel'] = sel
    params['up_bias'] = np.zeros(k.shape[3], np.float32)
    w1 = params['conv1']['conv']['kernel']
    params['conv1']['conv']['kernel'] = (
        rs.randint(-16, 17, w1.shape) / 64).astype(np.float32)


def _banded_stage(b, n, h, w, cin, cs, cout, head, seed, storage=jnp.float32):
    """One stage on both sides: the JAX stage's packed weights, saved
    statistics and banded-backward callable, and the port's inputs. With
    bf16 ``storage`` the inputs hold bf16 values and the weights make JAX's
    composite conv exact (``_exact_composite``)."""
    from semivl_tpu.models.vlg_head import Up
    from semivl_tpu.ops.fused_decoder import (
        _deinterleave, _fwd_tap_lists, _pack_stage_weights, _stage_fwd_core)
    from semivl_tpu.ops.fused_decoder_banded import _stage_bwd_banded
    rs = np.random.RandomState(seed)
    x = rs.randn(b * n, cin, h, w).astype(np.float32)
    skip = rs.randn(b, cs, 2 * h, 2 * w).astype(np.float32)
    g = rs.randn(b * n, 1 if head else cout, 2 * h, 2 * w).astype(np.float32)
    params = random_tree({'up': jax_eval_up(Up(cout, cs), cin)}, seed)['up']
    if storage == jnp.bfloat16:
        x, skip, g = (torch.from_numpy(t).bfloat16().float().numpy()
                      for t in (x, skip, g))
        _exact_composite(params, seed)
    hp = None
    if head:
        hp = {'kernel': (0.3 * rs.randn(3, 3, cout, 1)).astype(np.float32),
              'bias': rs.randn(1).astype(np.float32)}
    t1, t2 = _fwd_tap_lists(cin, cs, cout)

    def pack(prm, hd):
        return _pack_stage_weights(prm, hd, t1, t2, jnp.float32)

    pw = pack(params, hp)
    keys = ['w1', 'g1s', 'g1b', 'w2', 'g2s', 'g2b'] + (
        ['wh', 'hb'] if head else [])
    args = [pw[k] for k in keys]
    jx, skip_ph = jnp.asarray(x), _deinterleave(jnp.asarray(skip))
    g_ph = _deinterleave(jnp.asarray(g))
    _, jstats = _stage_fwd_core(jx, skip_ph, *args, interpret=True,
                                storage=storage, save_stats=True)

    def jax_bwd(stop_after=None):
        return _stage_bwd_banded(jx, skip_ph, g_ph, jstats, *args,
                                 interpret=True, storage=storage,
                                 band_rows=4, stop_after=stop_after)

    def unpack_grads(outs):
        """Packed-weight gradients -> flax parameter gradients."""
        _, vjp = jax.vjp(pack, params, hp)
        return vjp(dict(zip(keys, outs[2:])))

    port = dict(x=torch.from_numpy(x), skip=torch.from_numpy(skip),
                g=torch.from_numpy(g), p=_port_stage(params), head=None)
    if head:
        port['head'] = dict(
            weight=torch.from_numpy(hp['kernel'].transpose(3, 2, 0, 1)
                                    .copy()),
            bias=torch.from_numpy(hp['bias']))
    return port, jstats, jax_bwd, unpack_grads


def _from_bands(sp, plan, p, c):
    """JAX band-layout phase planes -> (P, c, 2h, 2w)."""
    from semivl_tpu.ops.fused_decoder import _interleave
    from semivl_tpu.ops.fused_decoder_banded import band_join
    flat = band_join(sp, plan).reshape(p, 4, c, plan.h, plan.geo.ws)
    return np.asarray(_interleave(flat[..., :plan.w]))


@pytest.mark.parametrize('geom', [
    # (b, n, h, w, cin, cs, cout, head, seed): the multi-band geometry of
    # tests/test_fused_decoder_banded.py (h = 40 -> 3 bands of 16 rows)
    # and a head stage with a ragged last band
    (1, 2, 40, 8, 24, 16, 32, False, 0),
    (1, 2, 11, 12, 24, 16, 32, True, 3)])
def test_banded_passes_match_jax(geom):
    """Each plain pass on its own inputs and the composed stage backward
    against ``_stage_bwd_banded``: pass A's recomputed raw1/raw2, gy2 and
    GN2 sums, pass B's gy1 and GN1 sums, pass C's (the stage's) gradients;
    and the forward's saved statistics against ``_stage_fwd_core``."""
    from semivl_tpu.ops.fused_decoder_banded import make_band_plan
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    b, n, h, w, cin, cs, cout, head, seed = geom
    port, jstats, jax_bwd, unpack_grads = _banded_stage(*geom)
    p, x, skip, g, hp = (port[k] for k in ('p', 'x', 'skip', 'g', 'head'))
    pl = b * n

    _, stats = fused_decoder.stage_fwd_stats_plain(x, skip, p, head=hp)
    for got, want in zip(stats, jstats):
        assert _scaled_err(got, np.asarray(want)[..., 0]) < 1e-5

    a = fdb.pass_a_plain(x, skip, p, stats, g, head=hp)
    ja = jax_bwd('A')
    plan_a = make_band_plan(h, w, 3 if head else 2, 4)
    assert plan_a.nb >= 2
    for i, k in enumerate(('raw1', 'raw2', 'gy2')):
        assert _scaled_err(a[k], _from_bands(ja[i], plan_a, pl, cout)) \
            < 2e-5, k
    for i, k in ((3, 'sgy2'), (4, 'sgyx2')):
        assert _scaled_err(a[k], np.asarray(ja[i])[..., 0]) < 2e-5, k

    hw = 4 * h * w
    g2w, g2b, mga2, mgb2 = fdb.close_gn(a['sgy2'], a['sgyx2'],
                                        p['gn2_weight'], hw)
    bb = fdb.pass_b_plain(a['raw1'], a['raw2'], a['gy2'], p, stats,
                          (mga2, mgb2))
    jb = jax_bwd('B')
    plan_b = make_band_plan(h, w, 1, 4)
    assert _scaled_err(bb['gy1'], _from_bands(jb[0], plan_b, pl, cout)) \
        < 2e-5
    for i, k in ((1, 'sgy1'), (2, 'sgyx1')):
        assert _scaled_err(bb[k], np.asarray(jb[i])[..., 0]) < 2e-5, k

    g_x, g_skip, grads = fdb.stage_bwd_banded(x, skip, p, stats, g,
                                              head=hp, plain=True)
    jout = jax_bwd()
    from semivl_tpu.ops.fused_decoder import _interleave
    assert _scaled_err(g_x, jout[0]) < 2e-5
    assert _scaled_err(g_skip, _interleave(jout[1])) < 2e-5
    jp, jh = unpack_grads(jout)
    want = _port_stage(jax.tree.map(np.asarray, jp))
    for k in fused_decoder.STAGE_KEYS:
        assert _scaled_err(grads[k], want[k]) < 2e-5, k
    if head:
        assert _scaled_err(grads['head_weight'], np.asarray(
            jh['kernel']).transpose(3, 2, 0, 1)) < 2e-5
        assert _scaled_err(grads['head_bias'], jh['bias']) < 2e-5
    # the GN2 closure after pass A gives the stage's GN2 gradients
    assert torch.equal(g2w, grads['gn2_weight'])
    assert torch.equal(g2b, grads['gn2_bias'])


# relative L2 of each output at bf16 storage: pass A's outputs are JAX's
# to float32 sum order (measured <= 7e-5); pass C's also carry the port's
# bf16 g_up and g_img (measured <= 2.7e-3)
BF16_PASS_TOL = dict(A=1e-3, C=5e-3)


@pytest.mark.parametrize('which', ['A', 'C'])
@pytest.mark.parametrize('geom', [
    (1, 2, 40, 8, 24, 16, 32, False, 0),
    (1, 2, 11, 12, 24, 16, 32, True, 3)])
def test_banded_plain_passes_match_jax_at_bf16(geom, which):
    """The plain passes A and C at bf16 storage, the points where the
    kernels store, against JAX's banded kernels at their own bf16 storage
    (interpret mode), each on the same inputs (JAX's saved statistics;
    pass C on JAX's raw1, gy1 and GN1 sums): every output within
    ``BF16_PASS_TOL`` relative L2. What is left between them is the order of
    float32 sums, which flips rare bf16 roundings, and, in pass C, the
    port's two extra bf16 operands (g_up and g_img), which JAX never
    forms."""
    from semivl_tpu.ops.fused_decoder import _interleave
    from semivl_tpu.ops.fused_decoder_banded import make_band_plan
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    b, n, h, w, cin, cs, cout, head, seed = geom
    port, jstats, jax_bwd, unpack_grads = _banded_stage(
        *geom, storage=jnp.bfloat16)
    p, hp = port['p'], port['head']
    x, skip, g = (port[k].bfloat16() for k in ('x', 'skip', 'g'))
    pl, hw = b * n, 4 * h * w
    stats = [torch.from_numpy(np.asarray(t, np.float32)[..., 0])
             for t in jstats]
    a = fdb.pass_a_plain(x, skip, p, stats, g, head=hp)
    ja = jax_bwd('A')
    plan_a = make_band_plan(h, w, 3 if head else 2, 4)
    got = {}
    if which == 'A':
        for i, k in enumerate(('raw1', 'raw2', 'gy2')):
            got[k] = _rel_l2(a[k].float(), torch.from_numpy(
                _from_bands(ja[i], plan_a, pl, cout).astype(np.float32)))
        for i, k in ((3, 'sgy2'), (4, 'sgyx2')):
            got[k] = _rel_l2(a[k], torch.from_numpy(
                np.asarray(ja[i], np.float32)[..., 0]))
        if head:
            got['head_weight'] = _rel_l2(a['head_weight'], torch.from_numpy(
                np.asarray(unpack_grads(jax_bwd())[1]['kernel'])
                .transpose(3, 2, 0, 1).copy()))
    else:
        jb = jax_bwd('B')
        plan_b = make_band_plan(h, w, 1, 4)
        raw1 = torch.from_numpy(_from_bands(ja[0], plan_a, pl, cout)
                                .astype(np.float32)).bfloat16()
        gy1 = torch.from_numpy(_from_bands(jb[0], plan_b, pl, cout)
                               .astype(np.float32)).bfloat16()
        sgy1, sgyx1 = (torch.from_numpy(np.asarray(jb[i], np.float32)[..., 0])
                       for i in (1, 2))
        mg1 = fdb.close_gn(sgy1, sgyx1, p['gn1_weight'], hw)[2:]
        c = fdb.pass_c_plain(a['xin'], a['up'], skip, raw1, gy1, p, stats,
                             mg1)
        jout = jax_bwd()
        got['g_x'] = _rel_l2(c['g_x'].float(), torch.from_numpy(
            np.asarray(jout[0], np.float32)))
        got['g_skip'] = _rel_l2(c['g_skip'], torch.from_numpy(
            np.asarray(_interleave(jout[1]), np.float32)))
        want = _port_stage(jax.tree.map(np.asarray, unpack_grads(jout)[0]))
        for k in ('conv1_weight', 'up_weight', 'up_bias'):
            got[k] = _rel_l2(c[k], want[k])
    assert all(v < BF16_PASS_TOL[which] for v in got.values()), got


def test_decoder_banded_chain_matches_jax(monkeypatch):
    """``fused_vlg_decoder(..., bwd='banded')`` under autograd on the CPU
    (plain forward with saved statistics, the plain passes composed)
    against jax.vjp of the JAX chain with ``SEMIVL_FORCE_BANDED_BWD=1``
    (interpret mode, float32 storage), every input and parameter within
    5e-4 of its scale, the bound of the JAX package's own banded chain
    test; the CPU launches no kernel."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    monkeypatch.setenv('SEMIVL_FORCE_BANDED_BWD', '1')
    x, skip1, skip2, p1, p2, head = _decoder_setup()
    g = np.random.RandomState(32).randn(4, 1, 32, 32).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, skip1, skip2)]

    def kernel_chain(x, s1, s2, p1, p2, hd):
        return jax_decoder(x, s1, s2, p1, p2, hd, interpret=True,
                           storage=jnp.float32)

    _, vjp = jax.vjp(kernel_chain, *jargs, p1, p2, head)
    gx, gs1, gs2, gp1, gp2, gh = vjp(jnp.asarray(g))
    tp1, tp2, th = _port_params(*(jax.tree.map(
        lambda a: np.asarray(a, np.float32), t) for t in (gp1, gp2, gh)))
    want = [np.asarray(a, np.float32) for a in (gx, gs1, gs2)] + [
        t[k].numpy() for t in (tp1, tp2) for k in fused_decoder.STAGE_KEYS
    ] + [th['weight'].numpy(), th['bias'].numpy()]

    tp1, tp2, th = _port_params(p1, p2, head)
    acts = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, skip1, skip2)]
    prms = ([tp1[k] for k in fused_decoder.STAGE_KEYS]
            + [tp2[k] for k in fused_decoder.STAGE_KEYS]
            + [th['weight'], th['bias']])
    for t in prms:
        t.requires_grad_(True)
    before = (fdb.pass_a_launches, fdb.pass_b_launches, fdb.pass_c_launches,
              fused_decoder.launches)
    out = fused_decoder.fused_vlg_decoder(*acts, tp1, tp2, th, bwd='banded')
    got = torch.autograd.grad(out, acts + prms, torch.from_numpy(g))
    assert (fdb.pass_a_launches, fdb.pass_b_launches, fdb.pass_c_launches,
            fused_decoder.launches) == before
    assert len(got) == len(want) == 21
    for i, (a, wnt) in enumerate(zip(got, want)):
        assert _scaled_err(a.numpy(), wnt) < 5e-4, i
