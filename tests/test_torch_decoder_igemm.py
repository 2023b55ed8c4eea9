"""The host side of the decoder's tensor-core products
(``csrc/decoder_igemm.cuh``, ``csrc/decoder_stage_bwd.cuh``: the
whole-plane route's ``csrc/fused_decoder_bwd.cu``, the banded route's
passes A, B and C, ``csrc/fused_decoder_banded.cu``, and the decoder
forward with the fused Up stage, ``csrc/fused_decoder.cu``), on the CPU.

A CUDA kernel does not run here, so each test writes out in PyTorch the
index arithmetic a kernel does with the operands ``ops/fused_decoder.py``
hands it (the weight layouts, the transpose conv's column groups, the
phase-separated gradient, the weight gradients' layouts) and holds the
result against autograd of the plain operation: float64, to 1e-12 of the
scale. The widths each route runs a stage at (``stage_plan``, with the
zero padding of ``pad_stage``) are pinned, and the padded stage is held to
the unpadded one; so are the column groups that wider outputs run in. The
slot names the wrappers pass are checked against the C entry points'
enums.
"""

import os
import re
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder as fd
from semivl_tpu_torch.ops import fused_decoder_banded as fdb

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
    ('fused_decoder', 'StageSlot', fd._FWD_SLOTS)])
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


def _stage64(x, skip, p, n, raw=False):
    """The Up stage in float64 at its true widths (GroupNorm in float64),
    the reference of the layout tests; with ``raw`` up to the raw conv2."""
    up = fd.conv_transpose_2x2(x, p['up_weight'], p['up_bias'])
    cu = up.shape[1]
    w1 = p['conv1_weight']
    raw1 = (F.conv2d(up, w1[:, :cu], padding=1)
            + F.conv2d(skip, w1[:, cu:], padding=1).repeat_interleave(n, 0))
    a1 = F.relu(F.group_norm(raw1, fd.gn_groups(raw1.shape[1]),
                             p['gn1_weight'], p['gn1_bias']))
    raw2 = F.conv2d(a1, p['conv2_weight'], padding=1)
    if raw:
        return raw2
    return F.relu(F.group_norm(raw2, fd.gn_groups(raw2.shape[1]),
                               p['gn2_weight'], p['gn2_bias']))


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
    _, sp, pp = fd.pad_stage(x, skip, p, plan)
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


def _header_const(name):
    """An integer constant of csrc/decoder_igemm.cuh."""
    with open(os.path.join(CSRC, 'decoder_igemm.cuh')) as f:
        return int(re.search(rf'constexpr int {name} = (\d+);', f.read())
                   .group(1))


def _tile_partials(raw):
    """The igemm conv epilogue's GroupNorm partials of raw (P, C, H, W):
    per plane, group of 16 channels and CONV_ROWS x TW tile (row-major
    over the tiles), the sum and the sum of squares."""
    rows, cols = _header_const('CONV_ROWS'), _header_const('TW')
    p, c, h, w = raw.shape
    ty, tx = -(-h // rows), -(-w // cols)
    r = F.pad(raw, (0, tx * cols - w, 0, ty * rows - h)).reshape(
        p, c // 16, 16, ty, rows, tx, cols)
    return torch.stack([r.sum((2, 4, 6)), (r * r).sum((2, 4, 6))],
                       -1).reshape(p, c // 16, ty * tx, 2)


def _gn_relu_from(raw, part, gamma, beta, gs=16):
    """GN+ReLU of raw with the statistics its partials give (groups of
    ``gs`` channels on whole chunks of 16), in float64."""
    p, c, h, w = raw.shape
    n = gs * h * w
    k = -(-gs // 16)
    s = part.double().sum(2).reshape(p, c // (16 * k), k, 2).sum(2)
    mean = s[..., 0] / n
    rstd = 1 / torch.sqrt((s[..., 1] / n - mean * mean).clamp(min=0) + 1e-5)
    y = (raw - mean.repeat_interleave(16 * k, 1)[..., None, None]) \
        * rstd.repeat_interleave(16 * k, 1)[..., None, None]
    return F.relu(y * gamma.double()[:, None, None]
                  + beta.double()[:, None, None])


def _decoder_stage_fwd(t, dims):
    """``decoder_stage_fwd`` in float64 over the tensors its wrapper hands
    it by slot name (``fused_decoder._FWD_SLOTS``): the input's GN+ReLU
    from the given partials, the transpose conv per column group and output
    phase, conv1's skip half per image as the up half's addend, the tile
    partials of raw conv1 and raw conv2 written into their slots (whose
    shape must be the kernel's), GN1+ReLU, conv2, and the head's
    CUDA-core conv, or GN2+ReLU into ``out`` without it."""
    pl, cin, h, w, nparts, b, cs, cu, cout, skip_half, gs, gs_in = dims
    x = t['x'].double()
    if t.get('gn_part') is not None:
        assert t['gn_part'].shape[2] == nparts
        x = _gn_relu_from(x, t['gn_part'], t['gn_gamma'], t['gn_beta'],
                          gs_in)
    wf = t['up_wf'].double().flatten()
    up = torch.empty(pl, cu, 2 * h, 2 * w, dtype=torch.float64)
    n0 = 0
    for n in fd.column_groups(cu, fd.TCONV_N):   # EPI_TCONV, cstride cu
        blk = wf[4 * n0 * cin:4 * (n0 + n) * cin].reshape(4, n, cin)
        for k in range(4):
            up[:, n0:n0 + n, k // 2::2, k % 2::2] = torch.einsum(
                'nc,pchw->pnhw', blk[k], x) + t['up_b'].double()[
                    n0:n0 + n, None, None]
        n0 += n
    raw1 = _igemm_conv(up, t['w1u'].double())
    if skip_half:
        raw1 = raw1 + _igemm_conv(t['skip'].double(), t['w1s'].double()) \
            .repeat_interleave(pl // b, 0)
    part1 = _tile_partials(raw1)
    a1 = _gn_relu_from(raw1, part1, t['g1w'], t['g1b'], gs)
    raw2 = _igemm_conv(a1, t['w2'].double())
    part2 = _tile_partials(raw2)
    for k, v in (('c1', raw1), ('part1', part1), ('c2', raw2),
                 ('part2', part2)):
        assert t[k].shape == v.shape, k
        t[k].copy_(v)
    a2 = _gn_relu_from(raw2, part2, t['g2w'], t['g2b'], gs)
    if t.get('head_w') is not None:
        t['out'].copy_(_igemm_conv(a2, t['head_w'].double().reshape(
            cout, 9, 1).permute(1, 2, 0)) + t['head_b'].double()[:, None,
                                                                  None])
    elif t.get('out') is not None:
        t['out'].copy_(a2)


@pytest.mark.parametrize('gn_in,head', [(False, False), (True, False),
                                        (True, True)],
                         ids=['stage 1', 'stage 2', 'stage 2 + head'])
@pytest.mark.parametrize('ci,cu,cs,co', [
    (32, 48, 16, 32),     # the widths as they are
    (32, 80, 8, 16),      # Cu 80 -> 96, Cs 8 -> 16
    (64, 144, 24, 16),    # Cu in two column groups (128 + 16), Cs 24 -> 32
    (48, 112, 16, 48),    # Cout 48, Cu 112 -> 128
    (16, 32, 16, 96)])    # Cout 96
def test_decoder_fwd_layouts(ci, cu, cs, co, gn_in, head):
    """The decoder forward's wrapper (``fused_decoder._stage``) with the C
    call run in float64 PyTorch (``_decoder_stage_fwd``) over the tensors
    it hands the kernel: the weights in the igemm layouts, the skip and
    weights zero-padded to ``stage_plan``'s widths, the partials in the
    conv tiles' layout (P, Cout / 16, ceil(H / 4) ceil(W / 64), 2) that
    the next stage's ``gn_in`` reads; the raw conv2 (or the logits) against
    the stage at its true widths, to 1e-12 of the scale. W = 72 leaves a
    ragged second tile column."""
    b, n, h, w = 2, 2, 3, 36
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 60).items()}
    # the GroupNorm affines as the kernel reads them, float32
    p.update(gn1_weight=(1 + 0.1 * _rand(co, seed=66)).float().double(),
             gn2_bias=(0.1 * _rand(co, seed=67)).float().double())
    x = _rand(b * n, ci, h, w, seed=70)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=71)
    xin, gn = x, None
    if gn_in:   # x raw, normalised by the previous stage's GN2
        g_w = 1 + 0.1 * _rand(ci, seed=74)
        g_b = 0.1 * _rand(ci, seed=75)
        gn = (_tile_partials(x), g_w, g_b)
        xin = F.relu(F.group_norm(x, ci // 16, g_w, g_b))
    hd = None
    if head:
        hd = dict(weight=_rand(1, co, 3, 3, seed=72).bfloat16().double(),
                  bias=_rand(1, seed=73))
    calls = []

    def c_call(fn_name, slots, t, dims, x, lib):
        assert (fn_name, slots, lib) == ('decoder_stage_fwd', fd._FWD_SLOTS,
                                         'fused_decoder')
        assert set(t) <= set(slots)
        plan = fd.stage_plan(ci, cu, cs)
        assert dims[6:8] == (plan['cs'], plan['cu'])
        assert dims[1] == plan['cin']
        calls.append(dims)
        _decoder_stage_fwd(t, dims)

    before = fd.launches
    with mock.patch.object(fd, '_check', lambda *a: None), \
            mock.patch.object(fd, '_call', c_call):
        got = fd._stage(x, skip, p, gn_in=gn, head=hd)
    assert fd.launches == before + 1 and len(calls) == 1
    tiles = -(-2 * h // 4) * -(-2 * w // 64)
    assert calls[0][4] == (gn[0].shape[2] if gn_in else 0)   # D_GN_NPARTS
    want = _stage64(xin, skip, p, n, raw=not head)
    if head:
        want = F.conv2d(want, hd['weight'], hd['bias'].float().double(),
                        padding=1)
    else:
        got, part2 = got
        assert part2.shape == (b * n, co // 16, tiles, 2)
        sums = want.reshape(b * n, co // 16, -1).sum(-1)
        assert torch.allclose(part2[..., 0].double().sum(-1), sums,
                              rtol=1e-5, atol=1e-5 * sums.abs().max())
    assert got.shape == want.shape and _close(got, want)


def test_decoder_fwd_pads_the_input():
    """Stage 1 at Cin 24: ``_stage`` hands the kernel x and the transpose
    conv's weight rows zero-padded to Cin 32 (a K width), and the raw
    conv2 equals the stage at its true widths."""
    ci, cu, cs, co, b, n, h, w = 24, 32, 16, 32, 1, 2, 3, 36
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 120).items()}
    x = _rand(b * n, ci, h, w, seed=121)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=122)
    dims = []

    def c_call(fn_name, slots, t, d, x, lib):
        assert t['x'].shape[1] == 32 and t['up_wf'].shape == (4, 32, 32)
        dims.append(d)
        _decoder_stage_fwd(t, d)

    with mock.patch.object(fd, '_check', lambda *a: None), \
            mock.patch.object(fd, '_call', c_call):
        got, _ = fd._stage(x, skip, p)
    assert dims[0][1] == 32
    want = _stage64(x, skip, p, n, raw=True)
    assert got.shape == want.shape and _close(got, want)


@pytest.mark.parametrize('bwd', [False, True], ids=['fused_up', 'backward'])
def test_stage_plan_maps_every_width(bwd):
    """Every width maps to a launch plan of igemm widths, each padded by
    less than one step: Cin and Cs to multiples of 16 (K widths); the
    forward (#5, #11) Cu to column groups of 128 and a last one of
    ``TCONV_N``; both backward routes (the whole-plane #6/#7 and the banded
    #8-#10) Cu and Cs up to 96 to the next of ``CONV_N`` (one product each)
    and wider ones to multiples of 16 (``column_groups``). The transpose
    conv's groups are the ones ``stage_recompute`` runs."""
    for cin in range(8, 296, 24):
        for cu in range(8, 296, 8):
            for cs in range(8, 296, 24):
                plan = fd.stage_plan(cin, cu, cs, bwd)
                groups = plan['tconv_groups']
                assert groups == fd.column_groups(plan['cu'], fd.TCONV_N)
                assert sum(groups) == plan['cu'], (cin, cu, cs)
                assert plan['cin'] == -(-cin // 16) * 16
                assert cu <= plan['cu'] < cu + 32 and cs <= plan['cs']
                if bwd:
                    for c, pc in ((cu, plan['cu']), (cs, plan['cs'])):
                        assert pc == (min(n for n in fd.CONV_N if n >= c)
                                      if c <= 96 else -(-c // 16) * 16)
                else:
                    assert all(g == 128 for g in groups[:-1])
                    assert plan['cs'] == -(-cs // 16) * 16


def test_column_groups_cover_every_width():
    """The column groups a wider output runs in: ``column_groups`` (the
    transpose conv and conv_cols: the widest instance that fits what is
    left) covers every multiple of 16 exactly with instances, and
    ``wgrad_width`` (wgrad_cols: the narrowest instance that covers what is
    left) sizes the partials of every group. A wgrad group wider than what
    is left reads the channels after it (the next plane's, or TMA's zeros
    past the last), and drops those columns: emulated here in float64 for
    Cout 48 (one product of 64 columns) and Cin 144 (128 + 32), against the
    whole weight gradient."""
    for c in range(16, 528, 16):
        for widths in (fd.CONV_N, fd.TCONV_N):
            groups = fd.column_groups(c, widths)
            assert sum(groups) == c and set(groups) <= set(widths)
        for taps in (9, 1):
            assert fd.wgrad_width(c, taps) in fd.WGRAD_N[taps]
    x = _rand(3, 16, 5, 6, seed=100)
    for c, taps in ((48, 9), (144, 1), (16, 1)):
        g = _rand(3, c, 5, 6, seed=101)
        want = (_igemm_wgrad(x, g) if taps == 9 else
                torch.einsum('pmhw,pnhw->mn', x, g)[None])
        # B as the kernel reads it: the planes' channels one after another,
        # zeros past the last
        flat = torch.cat([g.flatten(0, 1), torch.zeros(128, 5, 6,
                                                       dtype=g.dtype)])
        got = torch.empty_like(want)
        n0 = 0
        while n0 < c:
            n = fd.wgrad_width(c - n0, taps)
            assert n <= fd.wgrad_width(c, taps)
            b = torch.stack([flat[p * c + n0:p * c + n0 + n]
                             for p in range(3)])
            part = (_igemm_wgrad(x, b) if taps == 9 else
                    torch.einsum('pmhw,pnhw->mn', x, b)[None])
            cols = min(n, c - n0)
            got[..., n0:n0 + cols] = part[..., :cols]
            n0 += cols
        assert _close(got, want), (c, taps)


def test_padded_stage_gradients_match_unpadded():
    """A stage zero-padded as the backward routes pad it (Cin 24 -> 32, Cu
    80 -> 96, Cs 24 -> 32), run and differentiated in float64, with its
    gradients cut back by ``unpad_grads``, against the unpadded stage's
    output and gradients."""
    ci, cu, cs, co, b, n, h, w = 24, 80, 24, 16, 2, 2, 3, 4
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 90).items()}
    x = _rand(b * n, ci, h, w, seed=91)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=92)
    plan = fd.stage_plan(ci, cu, cs, bwd=True)
    assert (plan['cin'], plan['cu'], plan['cs']) == (32, 96, 32)
    g = _rand(b * n, co, 2 * h, 2 * w, seed=93)
    keys = ('up_weight', 'up_bias', 'conv1_weight')

    def grads(x, skip, p):
        x = x.clone().requires_grad_(True)
        skip = skip.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(k in keys) for k, v in p.items()}
        y = _stage64(x, skip, p, n)
        out = torch.autograd.grad(y, [x, skip] + [p[k] for k in keys], g)
        return y.detach(), dict(zip(('g_x', 'g_skip') + keys, out))

    y, want = grads(x, skip, p)
    xp, sp, pp = fd.pad_stage(x, skip, p, plan)
    assert xp.shape[1] == 32 and pp['up_weight'].shape[:2] == (32, 96)
    assert sp.shape[1] == 32 and pp['conv1_weight'].shape[1] == 128
    y_pad, got = grads(xp, sp, pp)
    got = fd.unpad_grads(got, ci, cu, cs)
    assert _close(y_pad, y)
    for k, v in want.items():
        assert got[k].shape == v.shape and _close(got[k], v), k


def test_stage_checks_refuse_by_name():
    """What the stage kernels refuse, by name, before any launch: what
    JAX's decoder refuses, an output width (Cout) or an input still to be
    normalised (``gn_in``) that GroupNorm's groups do not split (JAX's
    assert), and a normalised width wider than ``MAX_GN_WIDTH`` in the
    kernels' layout. Every other width passes, Cout 8 to 160 included."""
    for ci, co, gn_in, match in ((32, 33, False, r'\(33, 2\)'),
                                 (33, 32, True, r'\(33, 2\)'),
                                 (32, 1024, False, 'at most 512')):
        with pytest.raises(ValueError, match=match):
            fd._check_widths(ci, co, gn_in)
    for co in fd.CONV_N + (8, 24, 40, 112, 128, 160):
        fd._check_widths(24, co)
        fd._check_widths(co, 32, True)


@pytest.mark.parametrize('co', [8, 24, 40, 112, 128, 160])
def test_gn_layout_places_every_group(co):
    """GroupNorm's kernel layout (``gn_layout``) of an output width: JAX's
    ``max(C // 16, 1)`` groups, each on whole chunks of 16 channels, its
    own channels first; the padding is zero channels only, and a multiple
    of 16 lies as it is."""
    gs, width, index = fd.gn_layout(co)
    g = fd.gn_groups(co)
    assert gs * g == co and width == g * -(-gs // 16) * 16
    assert index.unique().numel() == co and int(index.max()) < width
    chunk = index // 16
    for k in range(g):
        own = chunk[k * gs:(k + 1) * gs]
        assert own.min() == k * -(-gs // 16) and own.max() < (k + 1) * -(
            -gs // 16)
    if co % 16 == 0:
        assert width == co and torch.equal(index, torch.arange(co))


@pytest.mark.parametrize('gn_in,head', [(False, False), (True, True)],
                         ids=['stage 1', 'stage 2 + head'])
@pytest.mark.parametrize('co', [8, 24, 40])
def test_decoder_fwd_padded_groups(co, gn_in, head):
    """The decoder forward's wrapper at an output width whose GroupNorm
    groups are not whole chunks of 16 (Cout 8: one group of 8; 24: one of
    24; 40: two of 20): ``pad_outputs`` lays the stage out with zero
    channels after each group's own, ``_stage`` hands the kernel that
    layout and the group size (``D_GS``; a normalised input's in
    ``D_GS_IN``), and the C call run in float64 (``_decoder_stage_fwd``,
    sums over each group's chunks divided by its true count) gives the
    raw conv2 or the logits of the stage at its true widths, to 1e-12 of
    the scale."""
    ci, cu, cs, b, n, h, w = 40, 32, 16, 2, 2, 3, 36
    p = {k: v.double() for k, v in _stage(ci, cu, cs, co, 140).items()}
    p.update(gn1_weight=(1 + 0.1 * _rand(co, seed=146)).float().double(),
             gn2_bias=(0.1 * _rand(co, seed=147)).float().double())
    x = _rand(b * n, ci, h, w, seed=141)
    skip = _rand(b, cs, 2 * h, 2 * w, seed=142)
    xin, gn, cin_layout = x, None, None
    if gn_in:   # x raw (Cin 40: two groups of 20), laid out as the kernel
        gs_in, width, index = fd.gn_layout(ci)
        g_w = 1 + 0.1 * _rand(ci, seed=144)
        g_b = 0.1 * _rand(ci, seed=145)
        xin = F.relu(F.group_norm(x, fd.gn_groups(ci), g_w, g_b))
        x = fd._scatter(x, 1, index, width)
        gn = (_tile_partials(x), fd._scatter(g_w, 0, index, width),
              fd._scatter(g_b, 0, index, width), gs_in)
        cin_layout = (index, width)
    hd = None
    if head:
        hd = dict(weight=_rand(1, co, 3, 3, seed=148).bfloat16().double(),
                  bias=_rand(1, seed=149))
    pp, hp, gs, layout = fd.pad_outputs(p, hd, cin_layout)
    assert layout is not None and gs == co // fd.gn_groups(co)
    dims = []

    def c_call(fn_name, slots, t, d, x, lib):
        dims.append(d)
        _decoder_stage_fwd(t, d)

    with mock.patch.object(fd, '_check', lambda *a: None), \
            mock.patch.object(fd, '_call', c_call):
        got = fd._stage(x, skip, pp, gn_in=gn, head=hp, gs=gs)
    assert dims[0][8] == layout[1] and dims[0][10:] == (
        gs, gn[3] if gn_in else 16)
    want = _stage64(xin, skip, p, n, raw=not head)
    if head:
        want = F.conv2d(want, hd['weight'], hd['bias'].float().double(),
                        padding=1)
    else:
        got, _ = got
        assert not got[:, ~torch.isin(torch.arange(layout[1]),
                                       layout[0])].any()
        got = got[:, layout[0]]
    assert got.shape == want.shape and _close(got, want)


@pytest.mark.parametrize('co1,co2', [(32, 16), (8, 16), (40, 24),
                                     (112, 8), (160, 40)])
def test_padded_groups_match_unpadded(co1, co2):
    """The decoder at output widths JAX takes beyond the shipped ones, in
    GroupNorm's kernel layout (``pad_decoder``) on the banded route's
    plain passes (the kernels' arithmetic: statistics over each group's
    chunks divided by its true count, ``gn_stats_plain``; the closed
    GroupNorm sums, ``close_gn``), against the chain at the true widths in
    float64 (``_stage64`` twice, then the head) and its autograd: the
    logits and, gathered back through the padding, every gradient, to 1e-5
    of the scale (the plain passes' statistics and weights are float32:
    the unpadded control, Cout 32 and 16, reads 6e-7 and 9e-7).""" 
    b, n, h, w, ci, cs1, cs2 = 1, 2, 3, 4, 24, 16, 8
    p1 = {k: v.double() for k, v in _stage(ci, 32, cs1, co1, 150).items()}
    p2 = {k: v.double() for k, v in _stage(co1, 16, cs2, co2, 160).items()}
    for p, c, seed in ((p1, co1, 170), (p2, co2, 171)):
        p.update(gn1_weight=1 + 0.1 * _rand(c, seed=seed),
                 gn2_bias=0.1 * _rand(c, seed=seed + 10))
    hd = dict(weight=_rand(1, co2, 3, 3, seed=172), bias=_rand(1, seed=173))
    x = _rand(b * n, ci, h, w, seed=174)
    s1 = _rand(b, cs1, 2 * h, 2 * w, seed=175)
    s2 = _rand(b, cs2, 4 * h, 4 * w, seed=176)
    g = _rand(b * n, 1, 4 * h, 4 * w, seed=177)

    def run(route):
        leaves = [x, s1, s2, *p1.values(), *p2.values(), *hd.values()]
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        xx, a, c = leaves[:3]
        q1 = dict(zip(p1, leaves[3:11]))
        q2 = dict(zip(p2, leaves[11:19]))
        qh = dict(zip(hd, leaves[19:]))
        if route == 'plain':
            out = F.conv2d(_stage64(_stage64(xx, a, q1, n), c, q2, n),
                           qh['weight'], qh['bias'], padding=1)
        else:
            out = fd.fused_vlg_decoder(xx, a, c, q1, q2, qh, bwd='banded')
        return out, torch.autograd.grad(out, leaves, g)

    want, gwant = run('plain')
    got, ggot = run('banded')
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for i, (a, r) in enumerate(zip(ggot, gwant)):
        assert a.shape == r.shape, i
        assert (a - r).abs().max() <= 1e-5 * max(r.abs().max(), 1), i
