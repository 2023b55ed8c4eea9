"""The banded backward of the fused VLG decoder: the Hopper kernels of its
three passes and their plain versions.

Counterpart of ``semivl_tpu/ops/fused_decoder_banded.py::_stage_bwd_banded``
(``_pass_a_kernel``, ``_pass_b_kernel``, ``_pass_c_kernel``), the route the
JAX package takes with ``SEMIVL_FORCE_BANDED_BWD=1``. The forward saves each
stage's GroupNorm statistics, (P, Cout) float32 mean and rstd
(``fused_decoder._stage(..., stats=True)``); the backward of a stage is

- pass A: recompute xin (the input's GroupNorm+ReLU, stage 2), up, raw1 and
  raw2 with the saved statistics; the head's gradients (last stage); gy2,
  the ReLU-masked gradient in front of GN2; the per-plane sums of gy2 and
  gy2 * x_hat2;
- closing the GN2 sums on (P, C) vectors (``close_gn``, plain PyTorch);
- pass B: graw2 (the GN2 solve), conv2's weight gradient and g_a1, gy1 and
  the per-plane GN1 sums;
- closing the GN1 sums;
- pass C: graw1, conv1's weight gradients, the gradients of up and of the
  skip, the transpose conv's gradients and the stage input's.

CUDA tensors launch ``csrc/fused_decoder_banded.cu`` (one launch per pass,
counted in ``pass_a_launches``, ``pass_b_launches``, ``pass_c_launches``) or
raise; CPU tensors take ``pass_a_plain``, ``pass_b_plain``,
``pass_c_plain``: the same arithmetic in plain PyTorch, float32 sums,
rounded to the storage dtype (that of the stage input) where the kernels
store it. ``decoder_bwd_banded(..., plain=True)`` composes the plain passes
into the whole decoder backward. The gradients between the steps are
stored in that dtype where JAX's banded kernels store them in theirs
(gy2, graw2, gy1, graw1 and the stage input's gradient), and so are two
operands of pass C's tensor-core products that JAX never forms (the
transpose conv output's gradient g_up and the per-image sum of graw1,
g_img), as the whole-plane backward stores them; the stage input's
gradient is that of its normalised value, which the previous stage's pass
A takes as the gradient of its GN2+ReLU output.
"""

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder as fd

pass_a_launches = 0   # kernel launches since the last reset
pass_b_launches = 0
pass_c_launches = 0

_A_SLOTS = (
    'x gx_mean gx_rstd gx_gamma gx_beta skip up_w up_b w1u w1s w2 g1w g1b '
    'g2w g2b m1 r1 m2 r2 head_wd g_out g_a2 xin up ys raw1 raw2 a1 a2 gy2 '
    'gpart sums wpart bpart scr_a scr_b scr_g g_hw g_hb').split()
_B_SLOTS = (
    'raw1 raw2 gy2 m1 r1 m2 r2 g1w g1b g2w g2b mga mgb w2_d graw2 a1 gy1 '
    'gpart sums wpart scr_a scr_b g_w2').split()
_C_SLOTS = (
    'xin up skip raw1 gy1 m1 r1 g1w g1b mga mgb up_w w1u_d w1s_d graw1 g_up '
    'g_img wpart bpart scr_a scr_b g_xin g_skip g_w1u g_w1s g_up_w '
    'g_up_b').split()


def _f32(t):
    return t.float().contiguous()


def _bc(v):
    """(P, C) -> (P, C, 1, 1)."""
    return v[..., None, None]


def _sums(gy, xhat):
    """Per-plane sums of gy and gy * xhat, (P, C) float32 (double sums)."""
    g = gy.double()
    return (g.sum((2, 3)).float(), (g * xhat.double()).sum((2, 3)).float())


def _wgrad(inp, weight_shape, g):
    return torch.nn.grad.conv2d_weight(inp, weight_shape, g, padding=1)


def _dgrad(g, weight):
    return F.conv_transpose2d(g, weight, padding=1)


# ---------------------------------------------------------------------------
# plain versions of the passes

def pass_a_plain(x, skip, p, stats, g, gn_x=None, head=None):
    """Pass A in plain PyTorch. x (P, Cin, h, w) in the storage dtype (raw,
    with ``gn_x`` = (mean, rstd, gamma, beta) of its GroupNorm+ReLU);
    ``stats`` = (m1, r1, m2, r2) saved by the forward; ``g``: with ``head``
    the logits' gradient (P, 1, H, W), else the gradient of the stage's
    GN2+ReLU output, both taken in the storage dtype. Returns xin, up,
    raw1, raw2, gy2 (storage dtype), the per-plane sums sgy2, sgyx2 (P,
    Cout) of the stored gy2 and, with the head, its weight and bias
    gradients."""
    dt = x.dtype
    m1, r1, m2, r2 = stats
    r = fd.stage_recompute_plain(x, skip, p, m1, r1, gn_x)
    out = {k: r[k].to(dt) for k in ('xin', 'up', 'raw1', 'raw2')}
    raw2 = r['raw2']
    if head is not None:
        a2 = fd.gn_act(raw2, m2, r2, p['gn2_weight'], p['gn2_bias'], dt)
        g_out = g.to(dt).float()
        hw = head['weight'].to(dt).float()
        g_a2 = fd._store(_dgrad(g_out, hw), dt)
        out['head_weight'] = _wgrad(a2, hw.shape, g_out)
        out['head_bias'] = g_out.double().sum((0, 2, 3)).float()
    else:
        g_a2 = g.to(dt).float()
    xhat = (raw2 - _bc(m2)) * _bc(r2)
    on = (xhat * p['gn2_weight'].float()[:, None, None]
          + p['gn2_bias'].float()[:, None, None]) > 0
    gy2 = torch.where(on, g_a2, torch.zeros((), device=g_a2.device))
    out['gy2'] = gy2.to(dt)
    out['sgy2'], out['sgyx2'] = _sums(gy2, xhat)
    return out


def pass_b_plain(raw1, raw2, gy2, p, stats, mg2):
    """Pass B in plain PyTorch: from pass A's raw1, raw2, gy2 and the closed
    GN2 vectors ``mg2`` = (mga, mgb) (P, Cout), gy1 (storage dtype), the
    GN1 sums sgy1, sgyx1 of the stored gy1 and conv2's weight gradient
    (torch layout). graw2 and g_a1 are rounded to the storage dtype, where
    the kernel stores them."""
    dt = raw1.dtype
    m1, r1, m2, r2 = stats
    c1, c2 = raw1.float(), raw2.float()
    xhat2 = (c2 - _bc(m2)) * _bc(r2)
    graw2 = fd._store(_bc(r2) * (p['gn2_weight'].float()[:, None, None]
                                 * gy2.to(dt).float() - _bc(mg2[0])
                                 - xhat2 * _bc(mg2[1])), dt)
    a1 = fd.gn_act(c1, m1, r1, p['gn1_weight'], p['gn1_bias'], dt)
    w2 = p['conv2_weight'].to(dt).float()
    g_a1 = fd._store(_dgrad(graw2, w2), dt)
    xhat1 = (c1 - _bc(m1)) * _bc(r1)
    on = (xhat1 * p['gn1_weight'].float()[:, None, None]
          + p['gn1_bias'].float()[:, None, None]) > 0
    gy1 = torch.where(on, g_a1, torch.zeros((), device=g_a1.device))
    sgy1, sgyx1 = _sums(gy1, xhat1)
    return dict(gy1=gy1.to(dt), sgy1=sgy1, sgyx1=sgyx1,
                conv2_weight=_wgrad(a1, w2.shape, graw2))


def pass_c_plain(xin, up, skip, raw1, gy1, p, stats, mg1):
    """Pass C in plain PyTorch: from pass A's xin, up, raw1, pass B's gy1
    and the closed GN1 vectors ``mg1``, the gradients of the stage input
    g_x (of its normalised value; storage dtype), of the skip g_skip
    (summed over each image's planes) and of conv1 and the transpose conv
    (float32, torch layouts). graw1, g_up and g_img are rounded to the
    storage dtype, where the kernel stores them."""
    dt = xin.dtype
    m1, r1 = stats[:2]
    c1 = raw1.float()
    xhat1 = (c1 - _bc(m1)) * _bc(r1)
    graw1 = fd._store(_bc(r1) * (p['gn1_weight'].float()[:, None, None]
                                 * gy1.to(dt).float() - _bc(mg1[0])
                                 - xhat1 * _bc(mg1[1])), dt)
    w1 = p['conv1_weight'].to(dt).float()
    cu = up.shape[1]
    g_up = fd._store(_dgrad(graw1, w1[:, :cu]), dt)
    g_img = fd._store(graw1.unflatten(0, (skip.shape[0], -1)).sum(1), dt)
    pl, cin, h, w = xin.shape
    g6 = g_up.reshape(pl, cu, h, 2, w, 2)
    up_w = p['up_weight'].to(dt).float()
    return dict(
        g_x=torch.einsum('pchiwj,dcij->pdhw', g6, up_w).to(dt),
        g_skip=_dgrad(g_img, w1[:, cu:]),
        conv1_weight=torch.cat([
            _wgrad(up.float(), w1[:, :cu].shape, graw1),
            _wgrad(skip.float(), w1[:, cu:].shape, g_img)], dim=1),
        up_weight=torch.einsum('pdhw,pchiwj->dcij', xin.float(), g6),
        up_bias=g_up.double().sum((0, 2, 3)).float())


def close_gn(sgy, sgyx, gamma, hw, gs=16):
    """Close a GroupNorm's per-plane sums (P, C): its scale and shift
    gradients (C,) and the mean-gradient vectors mga = group_sum(gamma sgy)
    / n, mgb = group_sum(gamma sgyx) / n (P, C), n = gs * H * W, over
    groups of ``gs`` channels in the kernels' layout (whole chunks of 16,
    ``fused_decoder.gn_layout``)."""
    pl, c = sgy.shape
    n = gs * hw
    width = -(-gs // 16) * 16

    def group_mean(v):
        v = (gamma.double() * v.double()).reshape(pl, c // width, width)
        return (v.sum(-1, keepdim=True) / n).expand(-1, -1, width).reshape(
            pl, c).float().contiguous()

    return (sgyx.double().sum(0).float(), sgy.double().sum(0).float(),
            group_mean(sgy), group_mean(sgyx))


# ---------------------------------------------------------------------------
# kernel wrappers

def _dims(pl, cin, h, w, b, cs, cu, cout, pitch=0, skip_half=True,
          wg_planes=0, slots=(0, 0, 0)):
    """The C entry points' sizes (``enum Dim``)."""
    return (pl, cin, h, w, b, cs, cu, cout, pitch, int(skip_half), wg_planes,
            *slots)


def _check_stored(**tensors):
    """The spilled planes a pass reads: bf16, contiguous, on the card, at
    most ``fused_decoder.MAX_PLANES`` of them."""
    for name, t in tensors.items():
        fd.check_planes(t.shape[0], f'banded pass ({name})')
        if not t.is_cuda or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous bf16 CUDA '
                             f'tensor, got {t.dtype} on {t.device}')


def _empty(dev):
    def e(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return e


def pass_a(x, skip, p, stats, g, gn_x=None, head=None, skip_half=True):
    """Pass A (kernel #8); arguments and results as ``pass_a_plain``.
    ``skip_half=False`` leaves conv1's skip half out of the recompute (a
    planted fault inside the kernel's tensor-core product). A stage whose
    Cin, Cu or Cs is not an igemm width runs zero-padded
    (``fused_decoder.stage_plan``); ``up`` and ``xin`` are returned at the
    true Cu and Cin."""
    global pass_a_launches
    if not x.is_cuda:
        return pass_a_plain(x, skip, p, stats, g, gn_x, head)
    cin0, cu0 = x.shape[1], p['up_weight'].shape[1]
    x, skip, p = fd.pad_stage(x, skip, p, fd._check_igemm(
        x, skip, p, gn_in=gn_x))
    pl, cin, h, w = x.shape
    b, cs, hh, ww = skip.shape
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    dt, dev = x.dtype, x.device
    e = _empty(dev)
    plane = (pl, cout, hh, ww)
    kw = fd._igemm_stage_weights(p, dt)
    t = dict(kw, up_w=kw['up_wf'], x=x, skip=skip, xin=x,
             up=e((pl, cu, hh, ww), dt), ys=e((b, cout, hh, ww)),
             raw1=e(plane, dt), raw2=e(plane, dt), a1=e(plane, dt),
             gy2=e(plane, dt), gpart=e((pl, cout, -(-hh * ww // 256), 2)),
             sums=e((pl, cout, 2)))
    channels = (cin, cu, cout, cs)
    t['scr_a'], = fd._tma_scratch(pl, channels, hh, ww, dev, 1)
    t.update(zip(('m1', 'r1', 'm2', 'r2'), (_f32(s) for s in stats)))
    if gn_x is not None:
        t.update(zip(('gx_mean', 'gx_rstd', 'gx_gamma', 'gx_beta'),
                     (_f32(v) for v in gn_x)), xin=e((pl, cin, h, w), dt))
    slots = 0
    if head is not None:
        slots = fd._wgrad_slots(dev, 9, cout)
        t['scr_b'], = fd._tma_scratch(pl, channels, hh, ww, dev, 1)
        t.update(head_wd=fd._dgrad_weight(head['weight'].to(dt).float()),
                 g_out=g.to(dt).contiguous(), g_a2=e(plane, dt),
                 a2=e(plane, dt), wpart=e((slots, 9, cout, 16)),
                 bpart=e((pl,)), scr_g=e((pl * hh * (-(-ww // 8) * 8),), dt),
                 g_hw=e((9, cout, 16)), g_hb=e((1,)))
    else:
        t['g_a2'] = g.to(dt).contiguous()
    fd._call('banded_pass_a', _A_SLOTS, t,
             _dims(pl, cin, h, w, b, cs, cu, cout, skip_half=skip_half,
                   slots=(slots, 0, 0)), x, lib='fused_decoder_banded')
    pass_a_launches += 1
    out = {k: t[k] for k in ('xin', 'raw1', 'raw2', 'gy2')}
    out['up'] = t['up'][:, :cu0]
    if cin != cin0:
        out['xin'] = t['xin'][:, :cin0].contiguous()
    out.update(sgy2=t['sums'][..., 0], sgyx2=t['sums'][..., 1])
    if head is not None:
        out.update(head_weight=fd._from_taps(t['g_hw'][..., :1], cout, 1),
                   head_bias=t['g_hb'])
    return out


def pass_b(raw1, raw2, gy2, p, stats, mg2, wgrad_planes=None):
    """Pass B (kernel #9); arguments and results as ``pass_b_plain``.
    ``wgrad_planes``: the planes conv2's weight gradient reduces over (all
    of them unless a planted fault asks for fewer)."""
    global pass_b_launches
    if not raw1.is_cuda:
        return pass_b_plain(raw1, raw2, gy2, p, stats, mg2)
    _check_stored(raw1=raw1, raw2=raw2)
    pl, cout, hh, ww = raw1.shape
    if hh % 2 or ww % 2 or raw2.shape != raw1.shape or gy2.shape != \
            raw1.shape or p['conv2_weight'].shape[0] != cout:
        raise ValueError('pass B: raw1, raw2, gy2 must share an even '
                         f'(P, Cout, H, W) shape, got {tuple(raw1.shape)}')
    dt, dev = raw1.dtype, raw1.device
    e = _empty(dev)
    plane = (pl, cout, hh, ww)
    slots = fd._wgrad_slots(dev, 9, cout)
    t = dict(raw1=raw1, raw2=raw2, gy2=gy2.to(dt).contiguous(),
             g1w=_f32(p['gn1_weight']), g1b=_f32(p['gn1_bias']),
             g2w=_f32(p['gn2_weight']), g2b=_f32(p['gn2_bias']),
             mga=_f32(mg2[0]), mgb=_f32(mg2[1]),
             w2_d=fd._igemm_dgrad_weight(p['conv2_weight']),
             graw2=e(plane, dt), a1=e(plane, dt), gy1=e(plane, dt),
             gpart=e((pl, cout, -(-hh * ww // 256), 2)),
             sums=e((pl, cout, 2)),
             wpart=e((slots, 9, cout, fd.wgrad_width(cout, 9))),
             g_w2=e((9, cout, cout)))
    t['scr_a'], t['scr_b'] = fd._tma_scratch(pl, (cout,), hh, ww, dev)
    t.update(zip(('m1', 'r1', 'm2', 'r2'), (_f32(s) for s in stats)))
    fd._call('banded_pass_b', _B_SLOTS, t,
             _dims(pl, 0, hh // 2, ww // 2, 0, 0, 0, cout,
                   wg_planes=pl if wgrad_planes is None else wgrad_planes,
                   slots=(slots, 0, 0)), raw1, lib='fused_decoder_banded')
    pass_b_launches += 1
    return dict(gy1=t['gy1'], sgy1=t['sums'][..., 0],
                sgyx1=t['sums'][..., 1],
                conv2_weight=fd._from_taps(t['g_w2'], cout, cout))


def pass_c(xin, up, skip, raw1, gy1, p, stats, mg1):
    """Pass C (kernel #10); arguments and results as ``pass_c_plain``."""
    global pass_c_launches
    if not xin.is_cuda:
        return pass_c_plain(xin, up, skip, raw1, gy1, p, stats, mg1)
    plan = fd._check_igemm(xin, skip, p)
    pl, cin0, h, w = xin.shape
    b, cs0, hh, ww = skip.shape
    cu0 = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    if up.shape != (pl, cu0, hh, ww) or raw1.shape != (pl, cout, hh, ww):
        raise ValueError(f'pass C: up {tuple(up.shape)} / raw1 '
                         f'{tuple(raw1.shape)} do not match the stage')
    xin, skip, p = fd.pad_stage(xin, skip, p, plan)
    up = fd._pad_channels(up, plan['cu'])
    _check_stored(up=up, raw1=raw1)
    cin, cs, cu = plan['cin'], plan['cs'], plan['cu']
    dt, dev = xin.dtype, xin.device
    e = _empty(dev)
    pitch = -(-w // 8) * 8
    slots = (fd._wgrad_slots(dev, 9, cu), fd._wgrad_slots(dev, 9, cs),
             fd._wgrad_slots(dev, 1, 4 * cu))
    kw = fd._igemm_input_weights(p)
    t = dict(xin=xin, up=up, skip=skip, raw1=raw1, gy1=gy1.to(dt).contiguous(),
             m1=_f32(stats[0]), r1=_f32(stats[1]),
             g1w=_f32(p['gn1_weight']), g1b=_f32(p['gn1_bias']),
             mga=_f32(mg1[0]), mgb=_f32(mg1[1]), up_w=kw['up_wd'],
             w1u_d=kw['w1u_d'], w1s_d=kw['w1s_d'],
             graw1=e((pl, cout, hh, ww), dt), g_up=e((pl, 4, cu, h, pitch), dt),
             g_img=e((b, cout, hh, ww), dt),
             wpart=e(max(slots[0] * 9 * cu * fd.wgrad_width(cout, 9),
                         slots[1] * 9 * cs * fd.wgrad_width(cout, 9),
                         slots[2] * 4 * cu * fd.wgrad_width(cin, 1))),
             bpart=e((pl, cu)), g_xin=e((pl, cin, h, w), dt),
             g_skip=e((b, cs, hh, ww)), g_w1u=e((9, cu, cout)),
             g_w1s=e((9, cs, cout)), g_up_w=e((4 * cu, cin)),
             g_up_b=e((cu,)))
    t['scr_a'], t['scr_b'] = fd._tma_scratch(pl, (cin, cu, cout, cs), hh, ww,
                                             dev)
    fd._call('banded_pass_c', _C_SLOTS, t,
             _dims(pl, cin, h, w, b, cs, cu, cout, pitch, slots=slots), xin,
             lib='fused_decoder_banded')
    pass_c_launches += 1
    return fd.unpad_grads(dict(
        g_x=t['g_xin'], g_skip=t['g_skip'], up_bias=t['g_up_b'],
        up_weight=fd._tconv_wgrad_to_torch(t['g_up_w'], cin, cu),
        conv1_weight=torch.cat([fd._from_taps(t['g_w1u'], cu, cout),
                                fd._from_taps(t['g_w1s'], cs, cout)], dim=1)),
        cin0, cu0, cs0)


# ---------------------------------------------------------------------------
# the composed backward and the autograd route

def stage_bwd_banded(x, skip, p, stats, g, gn_x=None, head=None,
                     plain=False, gs=16):
    """One stage's backward as passes A, B, C with the closures between
    (GroupNorm groups of ``gs`` channels). Returns (g_x, g_skip,
    {parameter: gradient}) (the head's as 'head_weight', 'head_bias')."""
    pa, pb, pc = ((pass_a_plain, pass_b_plain, pass_c_plain) if plain
                  else (pass_a, pass_b, pass_c))
    a = pa(x, skip, p, stats, g, gn_x, head)
    hw = a['raw2'].shape[2] * a['raw2'].shape[3]
    g2w, g2b, mga2, mgb2 = close_gn(a['sgy2'], a['sgyx2'], p['gn2_weight'],
                                    hw, gs)
    b = pb(a['raw1'], a['raw2'], a['gy2'], p, stats, (mga2, mgb2))
    g1w, g1b, mga1, mgb1 = close_gn(b['sgy1'], b['sgyx1'], p['gn1_weight'],
                                    hw, gs)
    c = pc(a['xin'], a['up'], skip, a['raw1'], b['gy1'], p, stats,
           (mga1, mgb1))
    grads = dict(up_weight=c['up_weight'], up_bias=c['up_bias'],
                 conv1_weight=c['conv1_weight'], gn1_weight=g1w,
                 gn1_bias=g1b, conv2_weight=b['conv2_weight'],
                 gn2_weight=g2w, gn2_bias=g2b)
    if head is not None:
        grads.update(head_weight=a['head_weight'], head_bias=a['head_bias'])
    return c['g_x'], c['g_skip'], grads


def decoder_fwd_stats(x, skip1, skip2, p1, p2, head, gs=(16, 16)):
    """The forward with saved statistics: (logits, stage 1's raw conv2,
    stage 1's and stage 2's (m1, r1, m2, r2)); the kernel on the card, the
    plain version on the CPU. The stages lie in GroupNorm's kernel layout,
    ``gs`` their group sizes (``fused_decoder.pad_decoder``)."""
    if x.is_cuda:
        c2, part2, st1 = fd._stage(x, skip1, p1, stats=True, gs=gs[0])
        gn_in = (part2, _f32(p1['gn2_weight']), _f32(p1['gn2_bias']), gs[0])
        out, st2 = fd._stage(c2, skip2, p2, gn_in=gn_in, head=head,
                             stats=True, gs=gs[1])
    else:
        c2, st1 = fd.stage_fwd_stats_plain(x, skip1, p1, gs=gs[0])
        out, st2 = fd.stage_fwd_stats_plain(
            c2, skip2, p2, gn_x=_gn_x(st1, p1), head=head, gs=gs[1])
    return out, c2, st1, st2


def _gn_x(st1, p1):
    """Stage 2's input normalisation: stage 1's GN2."""
    return (st1[2], st1[3], p1['gn2_weight'], p1['gn2_bias'])


def decoder_bwd_banded(x, skip1, skip2, c2, p1, p2, head, st1, st2, g_out,
                       plain=False, gs=(16, 16)):
    """The whole decoder's banded backward from the forward's saved stage
    inputs and statistics; gradients of x, skip1, skip2, up1's and up2's
    ``STAGE_KEYS`` and the head's weight and bias, in that order.
    ``plain``: the plain passes (on any device); ``gs``: as
    ``decoder_fwd_stats`` takes it."""
    gx2, g_s2, gr2 = stage_bwd_banded(c2, skip2, p2, st2, g_out,
                                      _gn_x(st1, p1), head, plain, gs[1])
    gx1, g_s1, gr1 = stage_bwd_banded(x, skip1, p1, st1, gx2, plain=plain,
                                      gs=gs[0])
    return ([gx1, g_s1, g_s2] + [gr1[k] for k in fd.STAGE_KEYS]
            + [gr2[k] for k in fd.STAGE_KEYS]
            + [gr2['head_weight'], gr2['head_bias']])


class BandedDecoder(torch.autograd.Function):
    """``fused_decoder.fused_vlg_decoder(..., bwd='banded')`` under
    autograd: the decoder forward with saved GroupNorm statistics and the
    banded backward (kernels on the card, plain passes on the CPU). Kept
    for the backward: the stage inputs (x, the skips, stage 1's raw conv2)
    and both stages' statistics."""

    @staticmethod
    def forward(ctx, x, skip1, skip2, gs, *flat):
        p1, p2, head = fd._unflatten(flat)
        out, c2, st1, st2 = decoder_fwd_stats(x, skip1, skip2, p1, p2, head,
                                              gs)
        ctx.save_for_backward(x, skip1, skip2, *flat)
        ctx.c2, ctx.st1, ctx.st2, ctx.gs = c2, st1, st2, gs
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, skip1, skip2, *flat = ctx.saved_tensors
        p1, p2, head = fd._unflatten(flat)
        grads = decoder_bwd_banded(x, skip1, skip2, ctx.c2, p1, p2, head,
                                   ctx.st1, ctx.st2, g_out.contiguous(),
                                   gs=ctx.gs)
        grads = [g.to(t.dtype) for g, t in zip(grads, (x, skip1, skip2,
                                                        *flat))]
        return (*grads[:3], None, *grads[3:])
