"""Fused VLG decoder tail (up1 -> up2 -> head): the Hopper kernel and its
plain version.

Counterpart of ``semivl_tpu/ops/fused_decoder.py::fused_vlg_decoder``
(``_stage_fwd_kernel``, forward only). Stage parameters are dicts of torch
tensors in torch layout, as ``models.vlg_head.Up.stage_params`` gives them:

- ``up_weight`` (Cin, Cu, 2, 2) and ``up_bias`` (Cu,): the transpose conv;
- ``conv1_weight`` (Cout, Cu + Cs, 3, 3), ``gn1_weight``, ``gn1_bias``;
- ``conv2_weight`` (Cout, Cout, 3, 3), ``gn2_weight``, ``gn2_bias``;

and the head is ``{'weight': (1, C, 3, 3), 'bias': (1,)}``. CUDA tensors
launch ``csrc/fused_decoder.cu`` once per stage (bf16) or raise; CPU
tensors take ``fused_vlg_decoder_plain``.
"""

import ctypes

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import _build

launches = 0  # stage launches since the last reset (read by chip_smoke.py)


# ---------------------------------------------------------------------------
# plain version: the XLA ``Up`` chain of models/vlg_head.py:467-477

def conv_transpose_2x2(x, weight, bias):
    """torch ConvTranspose2d(k=2, s=2) on NCHW as a product + reshape
    (JAX ``conv_transpose_2x2``); ``weight`` (Cin, Cout, 2, 2)."""
    b, _, h, w = x.shape
    out = torch.einsum('bchw,coij->bohiwj', x, weight)
    return out.reshape(b, weight.shape[1], 2 * h, 2 * w) + bias[:, None, None]


def gn_relu(x, weight, bias):
    """GroupNorm(C // 16 groups, eps 1e-5) with float32 statistics, then
    ReLU, output in the input dtype."""
    y = F.group_norm(x.float(), x.shape[1] // 16, weight, bias, eps=1e-5)
    return F.relu(y).to(x.dtype)


def up_stage_plain(x, skip, p):
    """One Up stage on NCHW planes x (P, Cin, h, w) with the per-image skip
    (B, Cs, 2h, 2w): the skip half of conv1 runs once per image."""
    dt = x.dtype
    up = conv_transpose_2x2(x, p['up_weight'].to(dt), p['up_bias'].to(dt))
    cu = up.shape[1]
    w1 = p['conv1_weight'].to(dt)
    ym = F.conv2d(up, w1[:, :cu], padding=1)
    ys = F.conv2d(skip.to(dt), w1[:, cu:], padding=1)
    y = (ym.unflatten(0, (skip.shape[0], -1)) + ys[:, None]).flatten(0, 1)
    y = gn_relu(y, p['gn1_weight'], p['gn1_bias'])
    y = F.conv2d(y, p['conv2_weight'].to(dt), padding=1)
    return gn_relu(y, p['gn2_weight'], p['gn2_bias'])


def fused_vlg_decoder_plain(x, skip1, skip2, params1, params2, head_params):
    """up1 -> up2 -> head in plain PyTorch; (P, 1, 4h, 4w) in x's dtype."""
    y = up_stage_plain(x, skip1, params1)
    y = up_stage_plain(y, skip2, params2)
    dt = y.dtype
    return F.conv2d(y, head_params['weight'].to(dt),
                    head_params['bias'].to(dt), padding=1)


# ---------------------------------------------------------------------------
# kernel wrapper

def _kernel_weights(p, dt):
    """float32 weights in the kernel's layouts, rounded to the activation
    dtype first (the plain chain multiplies in that dtype)."""
    def r(t):
        return t.to(dt).float()

    cu = p['up_weight'].shape[1]
    w1 = r(p['conv1_weight'])
    return dict(
        # [ci][4][cu] and [ci][9][co] layouts
        up_w=r(p['up_weight']).permute(0, 2, 3, 1).contiguous(),
        up_b=r(p['up_bias']).contiguous(),
        w1u=w1[:, :cu].permute(1, 2, 3, 0).contiguous(),
        w1s=w1[:, cu:].permute(1, 2, 3, 0).contiguous(),
        w2=r(p['conv2_weight']).permute(1, 2, 3, 0).contiguous(),
        g1w=p['gn1_weight'].float().contiguous(),
        g1b=p['gn1_bias'].float().contiguous(),
        g2w=p['gn2_weight'].float().contiguous(),
        g2b=p['gn2_bias'].float().contiguous())


def _check(x, skip, p):
    if not (x.is_cuda and skip.is_cuda) or x.dtype != torch.bfloat16 \
            or skip.dtype != torch.bfloat16:
        raise ValueError('fused_vlg_decoder kernel takes bf16 CUDA tensors, '
                         f'got {x.dtype} on {x.device}, {skip.dtype} on '
                         f'{skip.device}')
    if not (x.is_contiguous() and skip.is_contiguous()):
        raise ValueError('fused_vlg_decoder kernel needs contiguous NCHW')
    pl, cin, h, w = x.shape
    b, cs, hs, ws = skip.shape
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    if (hs, ws) != (2 * h, 2 * w) or pl % b:
        raise ValueError(f'skip {tuple(skip.shape)} does not match planes '
                         f'{tuple(x.shape)}')
    if p['up_weight'].shape[0] != cin or \
            p['conv1_weight'].shape[1] != cu + cs:
        raise ValueError('stage weights do not match the input channels')
    if cout not in (16, 32, 64) or cin % 32 or cu % 16 or cs % 8:
        raise ValueError(f'fused_vlg_decoder kernel takes Cout in (16, 32, '
                         f'64), Cin % 32 == 0, Cu % 16 == 0, Cs % 8 == 0; '
                         f'got {cout}, {cin}, {cu}, {cs}')


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] + [ctypes.c_void_p] * 14)


def _stage(x, skip, p, gn_in=None, head=None):
    """One kernel stage. ``gn_in``: (partials, gamma, beta) of a raw input
    still to be normalised on load. Returns (raw conv2, its partials) or,
    with ``head``, the head logits."""
    global launches
    _check(x, skip, p)
    pl, cin, h, w = x.shape
    b, cs = skip.shape[:2]
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    kw = _kernel_weights(p, x.dtype)
    dev, hh, ww = x.device, 2 * h, 2 * w
    tiles = -(-hh // 16) * -(-ww // 16)
    up = torch.empty((pl, cu, hh, ww), dtype=x.dtype, device=dev)
    ys = torch.empty((b, cout, hh, ww), dtype=torch.float32, device=dev)
    c1 = torch.empty((pl, cout, hh, ww), dtype=x.dtype, device=dev)
    c2 = torch.empty_like(c1)
    part1 = torch.empty((pl, cout // 16, tiles, 2), dtype=torch.float32,
                        device=dev)
    part2 = torch.empty_like(part1)
    null = ctypes.c_void_p(None)
    if gn_in is None:
        gn_ptrs, gn_nparts = (null, null, null), 0
    else:
        gn_ptrs = tuple(_build.ptr(t) for t in gn_in)
        gn_nparts = gn_in[0].shape[2]
    out = None
    head_ptrs = (null, null, null)
    if head is not None:
        hw_ = head['weight'].to(x.dtype).float().permute(1, 2, 3, 0)
        hw_, hb = hw_.contiguous(), head['bias'].float().contiguous()
        out = torch.empty((pl, 1, hh, ww), dtype=x.dtype, device=dev)
        head_ptrs = (_build.ptr(hw_), _build.ptr(hb), _build.ptr(out))
    fn = _build.load('fused_decoder').decoder_stage_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    k = {n: _build.ptr(t) for n, t in kw.items()}
    err = fn(_build.ptr(x), pl, cin, h, w, *gn_ptrs, gn_nparts,
             _build.ptr(skip), b, cs, k['up_w'], k['up_b'], cu,
             k['w1u'], k['w1s'], k['w2'], cout, k['g1w'], k['g1b'],
             k['g2w'], k['g2b'], head_ptrs[0], head_ptrs[1],
             _build.ptr(up), _build.ptr(ys), _build.ptr(c1),
             _build.ptr(part1), _build.ptr(part2), _build.ptr(c2),
             head_ptrs[2],
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, 'decoder_stage_fwd')
    launches += 1
    if head is not None:
        return out
    return c2, part2


def fused_vlg_decoder(x, skip1, skip2, params1, params2, head_params):
    """Full up1 -> up2 -> head decoder tail, forward.

    x: (P, C, h, w) class planes (P = B*N); skip1: (B, Cs1, 2h, 2w); skip2:
    (B, Cs2, 4h, 4w), both already resized to their stage's output size.
    Returns (P, 1, 4h, 4w) logits in x's dtype."""
    if not x.is_cuda:
        return fused_vlg_decoder_plain(x, skip1, skip2, params1, params2,
                                       head_params)
    c2, part2 = _stage(x, skip1, params1)
    gn_in = (part2, params1['gn2_weight'].float().contiguous(),
             params1['gn2_bias'].float().contiguous())
    return _stage(c2, skip2, params2, gn_in=gn_in, head=head_params)
