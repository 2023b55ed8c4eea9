"""The host side of the decoder's tensor-core products
(``csrc/decoder_igemm.cuh``, ``csrc/decoder_stage_bwd.cuh``: the
whole-plane route's ``csrc/fused_decoder_bwd.cu``, the banded route's
passes A, B and C, ``csrc/fused_decoder_banded.cu``, and the fused Up
stage, ``csrc/fused_up.cu``), on the CPU.

A CUDA kernel does not run here, so each test writes out in PyTorch the
index arithmetic a kernel does with the operands ``ops/fused_decoder.py``
hands it (the weight layouts, the transpose conv's column groups, the
phase-separated gradient, the weight gradients' layouts) and holds the
result against autograd of the plain operation: float64, to 1e-12 of the
scale. The widths each route runs a stage at (``stage_plan``, with the
zero padding of ``pad_stage``) are pinned, and the padded stage is held to
the unpadded one. The slot names the wrappers pass are checked against
the C entry points' enums.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder as fd
from semivl_tpu_torch.ops import fused_decoder_banded as fdb
from semivl_tpu_torch.ops import fused_up as fu

CSRC = os.path.join(os.path.dirname(fd.__file__), os.pardir, 'csrc')


def _close(a, b):
    return (a - b).abs().max().item() <= 1e-12 * max(b.abs().max().item(), 1)


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize('source,enum,slots', [
    ('fused_decoder_bwd', 'TailSlot', fd._TAIL_SLOTS),
    ('fused_decoder_bwd', 'InputSlot', fd._INPUT_SLOTS),
    ('fused_decoder_banded', 'ASlot', fdb._A_SLOTS),
    ('fused_decoder_banded', 'BSlot', fdb._B_SLOTS),
    ('fused_decoder_banded', 'CSlot', fdb._C_SLOTS),
    ('fused_up', 'UpSlot', fu._SLOTS)])
def test_slots_match_the_entry_points(source, enum, slots):
    with open(os.path.join(CSRC, source + '.cu')) as f:
        src = f.read()
    body = re.search(rf'enum {enum} {{(.*?)}};', src, re.S).group(1)
    names = [n.strip() for n in body.split(',') if n.strip()]
    assert names[-1].endswith('_COUNT')
    assert [n.split('_', 1)[1].lower() for n in names[:-1]] == list(slots)


def _igemm_conv(x, b9):
    """conv_kernel<N, 9>: out[p][n][y][x] = sum over taps (ky, kx) and
    channels c of B[ky * 3 + kx][n][c] x[p][c][y + ky - 1][x + kx - 1]."""
    xp = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[2:]
    out = 0
    for t in range(9):
        ky, kx = divmod(t, 3)
        out = out + torch.einsum('nc,pchw->pnhw', b9[t],
                                 xp[:, :, ky:ky + h, kx:kx + w])
    return out


def _igemm_wgrad(x, g):
    """wgrad_kernel<N, 9>: [9][ci][co] = sum over pixels of x[ci][pix + tap]
    g[co][pix]."""
    xp = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[2:]
    return torch.stack([torch.einsum(
        'pchw,pnhw->cn', xp[:, :, t // 3:t // 3 + h, t % 3:t % 3 + w], g)
        for t in range(9)])


@pytest.mark.parametrize('ci,co', [(24, 16), (16, 32)])
def test_conv_layouts(ci, co):
    """Forward, dgrad (flipped, transposed weights) and wgrad of a 3x3
    conv as the igemm kernels read and write them."""
    w = _rand(co, ci, 3, 3, seed=1).bfloat16().double()   # the kernels' bf16
    x = _rand(3, ci, 6, 5, seed=2).requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    y = F.conv2d(x, wt, padding=1)
    g = _rand(*y.shape, seed=3)
    gx, gw = torch.autograd.grad(y, (x, wt), g)
    with torch.no_grad():
        assert _close(_igemm_conv(x, fd._igemm_weight(w).double()), y)
    assert _close(_igemm_conv(g, fd._igemm_dgrad_weight(w).double()), gx)
    got = fd._from_taps(_igemm_wgrad(x.detach(), g), ci, co)
    assert got.shape == gw.shape and _close(got, gw)


def test_transpose_conv_layouts():
    """The transpose conv's three products: the forward per output phase
    (EPI_TCONV's scatter), the input gradient from the phase-separated
    g_up (EPI_PHASE's layout, K = (phase, cu)) and the weight gradient
    [4 cu][cin] with its torch layout."""
    cin, cu, p, h, w = 8, 6, 2, 3, 4
    wt = _rand(cin, cu, 2, 2, seed=4).bfloat16().double().requires_grad_(True)
    bias = _rand(cu, seed=5)
    x = _rand(p, cin, h, w, seed=6).requires_grad_(True)
    up = fd.conv_transpose_2x2(x, wt, bias)
    g = _rand(*up.shape, seed=7)
    gx, gw = torch.autograd.grad(up, (x, wt), g)
    wf = fd._tconv_fwd_weight(wt.detach()).double()
    got = torch.empty_like(up)
    for k in range(4):
        ky, kx = divmod(k, 2)
        got[:, :, ky::2, kx::2] = torch.einsum(
            'nc,pchw->pnhw', wf[k], x.detach()) + bias[:, None, None]
    assert _close(got, up.detach())
    # g_up as EPI_PHASE stores it: [p][ky * 2 + kx][cu][h][w]
    gph = torch.stack([g[:, :, k // 2::2, k % 2::2] for k in range(4)], 1)
    wd = fd._tconv_dgrad_weight(wt.detach()).double()
    assert _close(torch.einsum('pkhw,ck->pchw', gph.reshape(p, 4 * cu, h, w),
                               wd), gx)
    d = torch.einsum('pkhw,pchw->kc', gph.reshape(p, 4 * cu, h, w),
                     x.detach())
    assert _close(fd._tconv_wgrad_to_torch(d, cin, cu), gw)


def _stage(ci, cu, cs, co, seed):
    """Stage weights (float64 holding bf16 values, as the kernels read
    them) in torch layouts."""
    def r(*shape, seed):
        return _rand(*shape, seed=seed).bfloat16().double()
    return dict(up_weight=r(ci, cu, 2, 2, seed=seed),
                up_bias=r(cu, seed=seed + 1),
                conv1_weight=r(co, cu + cs, 3, 3, seed=seed + 2),
                conv2_weight=r(co, co, 3, 3, seed=seed + 3),
                gn1_weight=torch.ones(co), gn1_bias=torch.zeros(co),
                gn2_weight=torch.ones(co), gn2_bias=torch.zeros(co))


@pytest.mark.parametrize('head', [False, True])
def test_pass_a_layouts(head):
    """Pass A's tensor-core products with the weights its wrapper hands the
    kernel (``fused_decoder._igemm_stage_weights``): the transpose conv per
    output phase, conv1's skip half per image as the up half's addend, conv2
    over GN1+ReLU(raw1), and with the head its CUDA-core dgrad
    (``_dgrad_weight``'s [1][9][cout]) and its wgrad at N = 16 (column 0),
    against the plain chain and its autograd."""
    ci, cu, cs, co, b, n, h, w = 8, 6, 4, 16, 2, 2, 3, 4
    p = _stage(ci, cu, cs, co, 10)
    x = _rand(b * n, ci, h, w, seed=20)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=21)
    kw = {k: v.double() for k, v in fd._igemm_stage_weights(
        p, torch.float64).items()}
    up = torch.empty(b * n, cu, 2 * h, 2 * w, dtype=torch.float64)
    for k in range(4):
        up[:, :, k // 2::2, k % 2::2] = torch.einsum(
            'nc,pchw->pnhw', kw['up_wf'][k], x) + kw['up_b'][:, None, None]
    ys = _igemm_conv(skip, kw['w1s'])
    raw1 = _igemm_conv(up, kw['w1u']) + ys.repeat_interleave(n, 0)
    w1 = p['conv1_weight']
    up_ref = fd.conv_transpose_2x2(x, p['up_weight'], p['up_bias'])
    raw1_ref = (F.conv2d(up_ref, w1[:, :cu], padding=1)
                + F.conv2d(skip, w1[:, cu:], padding=1).repeat_interleave(n, 0))
    assert _close(up, up_ref) and _close(raw1, raw1_ref)
    a1 = F.relu(F.group_norm(raw1, co // 16))
    raw2 = _igemm_conv(a1, kw['w2'])
    assert _close(raw2, F.conv2d(a1, p['conv2_weight'], padding=1))
    if not head:
        return
    hw = _rand(1, co, 3, 3, seed=30).bfloat16().double()
    a2 = F.relu(F.group_norm(raw2, co // 16)).requires_grad_(True)
    hwt = hw.clone().requires_grad_(True)
    out = F.conv2d(a2, hwt, padding=1)
    g = _rand(*out.shape, seed=31)
    ga2, ghw = torch.autograd.grad(out, (a2, hwt), g)
    # the CUDA-core conv: out[co][pix] = sum_tap w[0][tap][co] g[pix + tap]
    wd = fd._dgrad_weight(hw).reshape(1, 9, co)
    got = _igemm_conv(g, wd.permute(1, 2, 0))
    assert _close(got, ga2)
    g16 = F.pad(g, (0, 0, 0, 0, 0, 15))   # N = 16, column 0 the head's
    got = fd._from_taps(_igemm_wgrad(a2.detach(), g16)[..., :1], co, 1)
    assert got.shape == ghw.shape and _close(got, ghw)


def test_pass_c_layouts():
    """Pass C's tensor-core products from graw1 with the weights its
    wrapper hands the kernel (``fused_decoder._igemm_input_weights``):
    conv1's up-half dgrad into the phase-separated g_up and its wgrad, the
    skip half's dgrad and wgrad on the per-image sum g_img, and the
    transpose conv's input, weight and bias gradients, against autograd of
    the stage's conv1 and transpose conv."""
    ci, cu, cs, co, b, n, h, w = 8, 6, 4, 16, 2, 2, 3, 4
    p = _stage(ci, cu, cs, co, 40)
    x = _rand(b * n, ci, h, w, seed=50).requires_grad_(True)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=51).requires_grad_(True)
    prm = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    up = fd.conv_transpose_2x2(x, prm['up_weight'], prm['up_bias'])
    w1 = prm['conv1_weight']
    raw1 = (F.conv2d(up, w1[:, :cu], padding=1)
            + F.conv2d(skip, w1[:, cu:], padding=1).repeat_interleave(n, 0))
    graw1 = _rand(*raw1.shape, seed=52)
    want = torch.autograd.grad(raw1, (x, skip, prm['conv1_weight'],
                                      prm['up_weight'], prm['up_bias']),
                               graw1)
    kw = {k: v.double() for k, v in fd._igemm_input_weights(p).items()}
    up = up.detach()
    g_up = _igemm_conv(graw1, kw['w1u_d'])
    gph = torch.stack([g_up[:, :, k // 2::2, k % 2::2] for k in range(4)],
                      1).reshape(b * n, 4 * cu, h, w)
    g_img = graw1.unflatten(0, (b, n)).sum(1)
    got = [torch.einsum('pkhw,ck->pchw', gph, kw['up_wd']),
           _igemm_conv(g_img, kw['w1s_d']),
           torch.cat([fd._from_taps(_igemm_wgrad(up, graw1), cu, co),
                      fd._from_taps(_igemm_wgrad(skip.detach(), g_img), cs,
                                    co)], 1),
           fd._tconv_wgrad_to_torch(torch.einsum(
               'pkhw,pchw->kc', gph, x.detach()), ci, cu),
           gph.unflatten(1, (4, cu)).sum((0, 1, 3, 4))]
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.shape == r.shape and _close(a, r), i


def test_pass_b_layouts():
    """Pass B's tensor-core products (``conv2_bwd``) with the weights its
    wrapper hands the kernel: conv2's dgrad from graw2 with
    ``_igemm_dgrad_weight``'s [9][cout][cout], and its wgrad over
    GN1+ReLU(raw1) as per-slot partials ([slots][9][cout][cout], each slot
    a share of the planes) added in order, read back by ``_from_taps``,
    against autograd of conv2."""
    co, pl, h, w = 16, 5, 6, 5
    p = _stage(8, 6, 4, co, 80)
    raw1 = _rand(pl, co, h, w, seed=81)
    a1 = F.relu(F.group_norm(raw1, co // 16)).requires_grad_(True)
    w2 = p['conv2_weight'].clone().requires_grad_(True)
    raw2 = F.conv2d(a1, w2, padding=1)
    graw2 = _rand(*raw2.shape, seed=82)
    ga1, gw2 = torch.autograd.grad(raw2, (a1, w2), graw2)
    a1 = a1.detach()
    got = _igemm_conv(graw2, fd._igemm_dgrad_weight(p['conv2_weight'])
                      .double())
    assert _close(got, ga1)
    slots = 3
    part = torch.stack([_igemm_wgrad(a1[s::slots], graw2[s::slots])
                        for s in range(slots)])
    got = fd._from_taps(sum(part[s] for s in range(slots)), co, co)
    assert got.shape == gw2.shape and _close(got, gw2)
    # D_WG_PLANES below P (the planted fault) leaves a plane out
    short = fd._from_taps(_igemm_wgrad(a1[:-1], graw2[:-1]), co, co)
    assert not _close(short, gw2)


def _stage64(x, skip, p, n):
    """The Up stage in float64 at its true widths (GroupNorm in float64),
    the reference of the layout tests."""
    up = fd.conv_transpose_2x2(x, p['up_weight'], p['up_bias'])
    cu = up.shape[1]
    w1 = p['conv1_weight']
    raw1 = (F.conv2d(up, w1[:, :cu], padding=1)
            + F.conv2d(skip, w1[:, cu:], padding=1).repeat_interleave(n, 0))
    a1 = F.relu(F.group_norm(raw1, raw1.shape[1] // 16, p['gn1_weight'],
                             p['gn1_bias']))
    raw2 = F.conv2d(a1, p['conv2_weight'], padding=1)
    return F.relu(F.group_norm(raw2, raw2.shape[1] // 16, p['gn2_weight'],
                               p['gn2_bias']))


@pytest.mark.parametrize('head', [False, True])
@pytest.mark.parametrize('ci,cu,cs,co', [
    (32, 48, 16, 32),     # the widths as they are
    (32, 80, 8, 16),      # Cu 80 -> 96, Cs 8 -> 16
    (64, 144, 24, 16)])   # Cu in two column groups (128 + 16), Cs 24 -> 32
def test_fused_up_layouts(ci, cu, cs, co, head):
    """The fused Up stage's sequence (``stage_recompute``, then GN2+ReLU or
    the head's CUDA-core conv) with the operands its wrapper hands the
    kernel: the skip and weights zero-padded to ``stage_plan``'s widths,
    the transpose conv per column group and output phase from the grouped
    ``up_wf``, conv1's skip half per image as the up half's addend, conv2
    over GN1+ReLU(raw1), the head's [cout][9][1] weights; against the
    stage at its true widths."""
    b, n, h, w = 2, 2, 3, 4
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 60).items()}
    p.update(gn1_weight=1 + 0.1 * _rand(co, seed=66).bfloat16().double(),
             gn2_bias=0.1 * _rand(co, seed=67).bfloat16().double())
    x = _rand(b * n, ci, h, w, seed=70)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=71)
    plan = fd.stage_plan(ci, cu, cs)
    assert (plan['cu'] > cu or plan['cs'] > cs) == ((cu, cs) != (48, 16))
    sp, pp = fd.pad_stage(skip, p, plan)
    kw = {k: v.double() for k, v in fd._igemm_stage_weights(
        pp, torch.float64).items()}
    wf = kw['up_wf'].flatten()
    up = torch.empty(b * n, plan['cu'], 2 * h, 2 * w, dtype=torch.float64)
    n0 = 0
    for g in plan['tconv_groups']:   # EPI_TCONV at channel n0 of cstride
        blk = wf[4 * n0 * ci:4 * (n0 + g) * ci].reshape(4, g, ci)
        for k in range(4):
            up[:, n0:n0 + g, k // 2::2, k % 2::2] = torch.einsum(
                'nc,pchw->pnhw', blk[k], x) + kw['up_b'][n0:n0 + g, None,
                                                         None]
        n0 += g
    assert n0 == plan['cu'] and not up[:, cu:].any()
    raw1 = _igemm_conv(up, kw['w1u']) + _igemm_conv(
        sp, kw['w1s']).repeat_interleave(n, 0)
    a1 = F.relu(F.group_norm(raw1, co // 16, p['gn1_weight'],
                             p['gn1_bias']))
    raw2 = _igemm_conv(a1, kw['w2'])
    got = F.relu(F.group_norm(raw2, co // 16, p['gn2_weight'],
                              p['gn2_bias']))
    want = _stage64(x, skip, p, n)
    if head:
        hd = dict(weight=_rand(1, co, 3, 3, seed=72).bfloat16().double(),
                  bias=_rand(1, seed=73))
        hw, hb = fd._head_weight(hd, torch.float64)
        # the CUDA-core conv: out[pix] = b + sum_(c, tap) w[c][tap][0]
        # a2[c][pix + tap]
        got = _igemm_conv(got, hw.double().reshape(co, 9, 1).permute(
            1, 2, 0)) + hb.double()[:, None, None]
        want = F.conv2d(want, hd['weight'], hd['bias'].float().double(),
                        padding=1)
    assert got.shape == want.shape and _close(got, want)


@pytest.mark.parametrize('bwd', [False, True], ids=['fused_up', 'backward'])
def test_stage_plan_maps_every_width(bwd):
    """Every width the forward checks take (Cout in 16, 32, 64; Cin % 32,
    Cu % 16, Cs % 8) maps to a launch plan of igemm widths, padded by less
    than one step: the fused Up stage (#11) takes them all; both backward
    routes (the whole-plane #6/#7 and the banded #8-#10, through
    ``_check_igemm``) take exactly Cin in 32-128, Cu and Cs up to 96, and
    refuse the rest by name."""
    for cin in range(32, 288, 32):
        for cu in range(16, 288, 16):
            for cs in range(8, 136, 8):
                takes = not bwd or (cin <= 128 and cu <= 96 and cs <= 96)
                if not takes:
                    with pytest.raises(ValueError, match='Cu and Cs up to 96'):
                        fd.stage_plan(cin, cu, cs, bwd)
                    continue
                plan = fd.stage_plan(cin, cu, cs, bwd)
                groups = plan['tconv_groups']
                assert sum(groups) == plan['cu'], (cin, cu, cs)
                assert all(g == fd.TCONV_GROUP for g in groups[:-1])
                assert all(g in fd.TCONV_N for g in groups)
                assert cu <= plan['cu'] < cu + 32 and cs <= plan['cs']
                if bwd:
                    assert plan['cu'] in fd.CONV_N and plan['cs'] in fd.CONV_N
                    assert plan['cs'] == min(n for n in fd.CONV_N if n >= cs)
                    assert cin in fd.BWD_CIN
                else:
                    assert plan['cs'] == -(-cs // 16) * 16


def test_padded_stage_gradients_match_unpadded():
    """A stage zero-padded as the backward routes pad it (Cu 80 -> 96, Cs
    24 -> 32), run and differentiated in float64, with its gradients cut
    back by ``unpad_grads``, against the unpadded stage's output and
    gradients."""
    ci, cu, cs, co, b, n, h, w = 32, 80, 24, 16, 2, 2, 3, 4
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 90).items()}
    x = _rand(b * n, ci, h, w, seed=91)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=92)
    plan = fd.stage_plan(ci, cu, cs, bwd=True)
    assert (plan['cu'], plan['cs']) == (96, 32)
    g = _rand(b * n, co, 2 * h, 2 * w, seed=93)
    keys = ('up_weight', 'up_bias', 'conv1_weight')

    def grads(skip, p):
        skip = skip.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(k in keys) for k, v in p.items()}
        y = _stage64(x, skip, p, n)
        out = torch.autograd.grad(y, [skip] + [p[k] for k in keys], g)
        return y.detach(), dict(zip(('g_skip',) + keys, out))

    y, want = grads(skip, p)
    sp, pp = fd.pad_stage(skip, p, plan)
    assert sp.shape[1] == 32 and pp['conv1_weight'].shape[1] == 128
    y_pad, got = grads(sp, pp)
    got = fd.unpad_grads(got, cu, cs)
    assert _close(y_pad, y)
    for k, v in want.items():
        assert got[k].shape == v.shape and _close(got[k], v), k
