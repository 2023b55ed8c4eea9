"""The host side of the whole-plane decoder backward's tensor-core products
(``csrc/decoder_igemm.cuh``, ``csrc/fused_decoder_bwd.cu``), on the CPU.

A CUDA kernel does not run here, so each test writes out in PyTorch the
index arithmetic a kernel does with the operands ``ops/fused_decoder.py``
hands it (the weight layouts, the phase-separated gradient, the weight
gradients' layouts) and holds the result against autograd of the plain
operation: float64, to 1e-12 of the scale. The slot names the wrapper
passes are checked against the C entry points' enums.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder as fd

CSRC = os.path.join(os.path.dirname(fd.__file__), os.pardir, 'csrc')


def _close(a, b):
    return (a - b).abs().max().item() <= 1e-12 * max(b.abs().max().item(), 1)


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize('enum,slots', [('TailSlot', fd._TAIL_SLOTS),
                                        ('InputSlot', fd._INPUT_SLOTS)])
def test_slots_match_the_entry_points(enum, slots):
    with open(os.path.join(CSRC, 'fused_decoder_bwd.cu')) as f:
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
