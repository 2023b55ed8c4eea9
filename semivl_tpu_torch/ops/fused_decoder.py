"""Fused VLG decoder tail (up1 -> up2 -> head): the Hopper kernel and its
plain version.

Counterpart of ``semivl_tpu/ops/fused_decoder.py::fused_vlg_decoder``
(``_stage_fwd_kernel`` forward; ``_stage_bwd_tail_kernel`` and
``_stage_bwd_input_kernel`` backward). Stage parameters are dicts of torch
tensors in torch layout, as ``models.vlg_head.Up.stage_params`` gives them:

- ``up_weight`` (Cin, Cu, 2, 2) and ``up_bias`` (Cu,): the transpose conv;
- ``conv1_weight`` (Cout, Cu + Cs, 3, 3), ``gn1_weight``, ``gn1_bias``;
- ``conv2_weight`` (Cout, Cout, 3, 3), ``gn2_weight``, ``gn2_bias``;

and the head is ``{'weight': (1, C, 3, 3), 'bias': (1,)}``. CUDA tensors
launch ``csrc/fused_decoder.cu`` once per stage (bf16; the tensor-core
sequence ``stage_recompute``, the input, skip and up channels zero-padded
to its products' widths, ``stage_plan``) or raise; under autograd the call
is a ``torch.autograd.Function`` whose backward launches
``csrc/fused_decoder_bwd.cu`` twice per stage (tail, then input). The
kernels take every width JAX's decoder takes: each stage's output runs in
GroupNorm's kernel layout (``gn_layout``: a group whose channels are not a
whole number of 16-channel chunks is zero-padded to one, ``pad_decoder``),
and an output width that GroupNorm's groups do not split (JAX's assert)
raises by name before any launch. CPU tensors take
``fused_vlg_decoder_plain``, and autograd through it is the plain
backward. The forward rounds the float32 weights to the
activation dtype; the gradient passes that rounding straight through, as
autograd of ``.to(bfloat16)`` does. ``fused_vlg_decoder_rounded`` is the
kernels' own arithmetic in plain PyTorch, the reference the kernels are
held to on the card (with the bf16 gradient roundings that both backward
routes store).

``bwd='banded'`` routes the backward through ``ops.fused_decoder_banded``
instead: the forward then also saves each stage's GroupNorm statistics
(``_stage(..., stats=True)`` on the card, ``stage_fwd_stats_plain`` on the
CPU), and the backward is three passes per stage that normalise with them.
"""

import ctypes

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import _build

launches = 0            # forward stage launches since the last reset
bwd_tail_launches = 0   # backward launches (read by chip_smoke.py)
bwd_input_launches = 0

_TILE_ROWS, _TILE_COLS = 4, 64   # the igemm conv's tile (GroupNorm partials)

STAGE_KEYS = ('up_weight', 'up_bias', 'conv1_weight', 'gn1_weight',
              'gn1_bias', 'conv2_weight', 'gn2_weight', 'gn2_bias')


# ---------------------------------------------------------------------------
# plain version: the XLA ``Up`` chain of models/vlg_head.py:467-477

def conv_transpose_2x2(x, weight, bias):
    """torch ConvTranspose2d(k=2, s=2) on NCHW as a product + reshape
    (JAX ``conv_transpose_2x2``); ``weight`` (Cin, Cout, 2, 2)."""
    b, _, h, w = x.shape
    out = torch.einsum('bchw,coij->bohiwj', x, weight)
    return out.reshape(b, weight.shape[1], 2 * h, 2 * w) + bias[:, None, None]


def gn_groups(c):
    """GroupNorm groups of a C-channel map: C // 16, at least one (JAX
    ``fused_up.py:262-267``: C = 24 is one group of 24)."""
    return max(c // 16, 1)


MAX_GN_WIDTH = 512   # a normalised plane's channels in the kernels' layout


def gn_layout(c, what='fused_vlg_decoder kernel'):
    """GroupNorm over c channels as the stage kernels lay it out: (gs, the
    channels of a group; the padded width; index (c,), each channel's
    place in it). JAX's ``gn_groups(c)`` groups must split c (JAX's assert,
    ``semivl_tpu/ops/fused_decoder.py:329``; else ValueError). Each group
    fills ceil(gs / 16) whole chunks of 16 channels, its own channels first
    and zero channels after them, so that the kernels' per-chunk sums add
    up to the group's (divided by gs, not the padded count). A multiple of
    16 lies as it is."""
    g = gn_groups(c)
    if c % g:
        raise ValueError(f'{what}: GroupNorm splits {c} channels into {g} '
                         f'groups (JAX: assert cout % num_groups == 0, '
                         f'{(c, g)})')
    gs = c // g
    gk = -(-gs // 16)
    i = torch.arange(c)
    return gs, g * gk * 16, (i // gs) * gk * 16 + i % gs


def _scatter(t, dim, index, width):
    """``t`` with its axis ``dim`` placed at ``index`` of a zero axis
    ``width`` long (differentiable: the gradient gathers back)."""
    shape = list(t.shape)
    shape[dim] = width
    return t.new_zeros(shape).index_copy(dim, index.to(t.device), t)


_OUT_KEYS = ('conv1_weight', 'gn1_weight', 'gn1_bias', 'conv2_weight',
             'gn2_weight', 'gn2_bias')


def pad_outputs(p, head=None, cin_layout=None):
    """A stage's parameters with its output channels in GroupNorm's kernel
    layout (``gn_layout``; zero weights, gamma and beta on the padded
    channels, so they stay 0 through GN+ReLU), the head's input channels
    with them, and with ``cin_layout`` (the previous stage's (index,
    width)) the transpose conv's input rows in that one. Returns (p, head,
    gs, layout): ``layout`` (index, width) of the outputs, None where they
    lie as they are."""
    q = dict(p)
    if cin_layout is not None:
        q['up_weight'] = _scatter(p['up_weight'], 0, *cin_layout)
    gs, width, index = gn_layout(p['conv2_weight'].shape[0])
    if width == index.numel():
        return q, head, gs, None
    layout = (index, width)
    for k in _OUT_KEYS:
        q[k] = _scatter(q[k], 0, *layout)
    q['conv2_weight'] = _scatter(q['conv2_weight'], 1, *layout)
    if head is not None:
        head = dict(head, weight=_scatter(head['weight'], 1, *layout))
    return q, head, gs, layout


def pad_decoder(params1, params2, head_params):
    """Both stages and the head in the kernels' layout (``pad_outputs``):
    (params1, params2, head, (gs1, gs2)). The padded chain computes the
    true one; autograd through the padding gathers the gradients back."""
    p1, _, gs1, layout1 = pad_outputs(params1)
    p2, head, gs2, _ = pad_outputs(params2, head_params, layout1)
    return p1, p2, head, (gs1, gs2)


def gn_relu(x, weight, bias):
    """GroupNorm(``gn_groups(C)``, eps 1e-5) with float32 statistics, then
    ReLU, output in the input dtype."""
    y = F.group_norm(x.float(), gn_groups(x.shape[1]), weight, bias,
                     eps=1e-5)
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


def _round_bf16(t):
    """``t`` rounded to bf16 values in its own dtype; the gradient passes
    straight through unrounded."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity; its backward rounds the gradient to bf16 values."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _round_grad_bf16(t):
    """``t`` itself, with its gradient rounded to bf16 values in its own
    dtype: a point where the backward kernels store a gradient in bf16."""
    return _RoundGrad.apply(t)


def up_stage_rounded(y, skip, p, dtype=torch.float32, bf16_grads=True,
                     raw2=None):
    """One Up stage as the stage kernels compute it (see
    ``fused_vlg_decoder_rounded``): ``y`` in ``dtype``, the normalised
    output in ``dtype`` holding bf16 values. ``raw2``: values that replace
    the raw conv2's, its gradient passing as through the stage's own."""
    gr = _round_grad_bf16 if bf16_grads else (lambda t: t)
    w = {k: _round_bf16(p[k].to(dtype)) for k in ('up_weight', 'up_bias',
                                                  'conv1_weight',
                                                  'conv2_weight')}
    y = gr(y)                                           # g_x
    up = gr(_round_bf16(conv_transpose_2x2(y, w['up_weight'],
                                           w['up_bias'])))   # g_up
    cu = up.shape[1]
    ym = F.conv2d(up, w['conv1_weight'][:, :cu], padding=1)
    ys = gr(F.conv2d(skip.to(dtype), w['conv1_weight'][:, cu:],
                     padding=1))                        # g_img
    c1 = gr(_round_bf16((ym.unflatten(0, (skip.shape[0], -1))
                         + ys[:, None]).flatten(0, 1)))   # g_raw1
    a1 = gr(_gn_relu_rounded(c1, p['gn1_weight'], p['gn1_bias']))   # g_a1
    c2 = gr(_round_bf16(F.conv2d(a1, w['conv2_weight'], padding=1)))  # g_raw2
    if raw2 is not None:
        c2 = c2 + (raw2.to(dtype) - c2).detach()
    return gr(_gn_relu_rounded(c2, p['gn2_weight'], p['gn2_bias']))  # g_a2


def _gn_relu_rounded(c, weight, bias):
    y = F.group_norm(c, gn_groups(c.shape[1]), weight.to(c.dtype),
                     bias.to(c.dtype), eps=1e-5)
    return _round_bf16(F.relu(y))


def head_rounded(y, head_params):
    """The 3x3 head conv as the kernels compute it: weights rounded to bf16,
    sums in y's dtype, the logits rounded to bf16."""
    dtype = y.dtype
    return _round_bf16(F.conv2d(y, _round_bf16(head_params['weight'].to(dtype)),
                                head_params['bias'].to(dtype), padding=1))


def fused_vlg_decoder_rounded(x, skip1, skip2, params1, params2,
                              head_params, dtype=torch.float32,
                              bf16_grads=True, raw2_1=None):
    """The decoder kernels' arithmetic in plain PyTorch: products and
    GroupNorm in ``dtype`` (float32, as the kernels sum) over weights
    rounded to bf16, and a bf16 rounding wherever the kernels store bf16
    (the transpose conv output, the raw conv1 output after its up and skip
    halves are summed, the raw conv2 output, both activations, the logits).
    Every value rounding passes the gradient straight through. With
    ``bf16_grads`` (both backward routes: the whole-plane kernels #6/#7 and
    the banded passes #8-#10) the gradient is rounded to bf16 where those
    kernels store it, JAX's points (the gradients of each stage's input,
    both raw conv outputs and both activations, which JAX's banded kernels
    store as gy2, graw2, gy1, graw1 and g_x) and two of the port's own (the
    transpose conv output's gradient and the per-image sum of conv1's,
    operands of its bf16 tensor-core products); without, autograd computes
    float32 gradients. The kernels differ from it only in the order of
    float32 sums (``dtype=torch.float64`` measures how much that order
    matters). ``raw2_1``: stage 1's raw conv2 as the kernels' forward
    stored it, the input that their backward reads; its values replace the
    reference's own (the gradient passing as through those), so that a
    backward is held at the point its forward reached.
    Returns (P, 1, 4h, 4w) logits in x's dtype."""
    y = x.to(dtype)
    for p, skip, raw2 in ((params1, skip1, raw2_1), (params2, skip2, None)):
        y = up_stage_rounded(y, skip, p, dtype, bf16_grads, raw2)
    return head_rounded(y, head_params).to(x.dtype)


def _store(t, dt):
    """float32 ``t`` as it is stored in ``dt``, back in float32."""
    return t.to(dt).float()


def gn_stats_plain(c, gs=16):
    """GroupNorm statistics (mean, rstd), each (P, C) float32 with every
    group's value on its channels, of raw conv outputs c (P, C, H, W) in
    GroupNorm's kernel layout (groups of ``gs`` channels on whole chunks of
    16, ``gn_layout``): sums in double, var = E[c^2] - E[c]^2 clamped at 0,
    as the kernels' prologue reduces their partials."""
    p, ch = c.shape[:2]
    width = -(-gs // 16) * 16
    g = c.double().reshape(p, ch // width, -1)
    if width == gs:
        mean, sq = g.mean(-1), (g * g).mean(-1)
    else:
        n = gs * c.shape[2] * c.shape[3]
        mean, sq = g.sum(-1) / n, (g * g).sum(-1) / n
    var = (sq - mean * mean).clamp(min=0)
    rstd = 1 / torch.sqrt(var + 1e-5)
    return (mean.float().repeat_interleave(width, 1),
            rstd.float().repeat_interleave(width, 1))


def gn_act(c, mean, rstd, gamma, beta, dt):
    """ReLU((c - mean) rstd gamma + beta) stored in ``dt`` (float32 out),
    with (P, C) statistics."""
    y = ((c - mean[..., None, None]) * rstd[..., None, None]
         * gamma.float()[:, None, None] + beta.float()[:, None, None])
    return _store(F.relu(y), dt)


def stage_recompute_plain(x, skip, p, m1, r1, gn_x=None, gs=16):
    """The stage forward up to the raw conv2 in float32, rounding to x's
    dtype where the kernels store, with conv1's GroupNorm from the given
    statistics (None: computed here, in groups of ``gs`` channels).
    ``gn_x``: (mean, rstd, gamma, beta) of a raw input still to be
    normalised. Returns a dict of xin, up, raw1 (and its statistics m1,
    r1), raw2, all float32."""
    dt = x.dtype
    xin = x.float()
    if gn_x is not None:
        xin = gn_act(xin, *gn_x, dt)
    w = {k: p[k].to(dt).float() for k in ('up_weight', 'up_bias',
                                          'conv1_weight', 'conv2_weight')}
    up = _store(conv_transpose_2x2(xin, w['up_weight'], w['up_bias']), dt)
    cu = up.shape[1]
    ym = F.conv2d(up, w['conv1_weight'][:, :cu], padding=1)
    ys = F.conv2d(skip.float(), w['conv1_weight'][:, cu:], padding=1)
    raw1 = _store((ym.unflatten(0, (skip.shape[0], -1))
                   + ys[:, None]).flatten(0, 1), dt)
    if m1 is None:
        m1, r1 = gn_stats_plain(raw1, gs)
    a1 = gn_act(raw1, m1, r1, p['gn1_weight'], p['gn1_bias'], dt)
    raw2 = _store(F.conv2d(a1, w['conv2_weight'], padding=1), dt)
    return dict(xin=xin, up=up, raw1=raw1, m1=m1, r1=r1, raw2=raw2)


def stage_fwd_stats_plain(x, skip, p, gn_x=None, head=None, gs=16):
    """One stage as the forward kernel computes it, in plain PyTorch
    (float32 sums, x's dtype where the kernel stores), with the GroupNorm
    statistics it normalised with (groups of ``gs`` channels). Returns (raw
    conv2, or with ``head`` the logits, in x's dtype; (mean1, rstd1, mean2,
    rstd2), each (P, Cout) float32)."""
    dt = x.dtype
    r = stage_recompute_plain(x, skip, p, None, None, gn_x, gs)
    m2, r2 = gn_stats_plain(r['raw2'], gs)
    stats = (r['m1'], r['r1'], m2, r2)
    if head is None:
        return r['raw2'].to(dt), stats
    a2 = gn_act(r['raw2'], m2, r2, p['gn2_weight'], p['gn2_bias'], dt)
    out = F.conv2d(a2, head['weight'].to(dt).float(), head['bias'].float(),
                   padding=1)
    return out.to(dt), stats


# ---------------------------------------------------------------------------
# kernel wrapper

def _head_weight(head, dt):
    """The head's weight in the CUDA-core conv's float32 [cin][9][1] layout
    (rounded to the activation dtype first) and its float32 bias."""
    return (head['weight'].to(dt).float().permute(1, 2, 3, 0).contiguous(),
            head['bias'].float().contiguous())


# The stage kernels' per-plane passes (GroupNorm, its backward, the head
# conv) put the plane on gridDim.y, which CUDA bounds at 65535; every
# element index is 64-bit (P C H W at the largest plane count the port
# hands them, ADE's 600-plane evaluation chunk, is 6.3e8 in stage 2).
MAX_PLANES = 65535


def check_planes(planes, what='fused_vlg_decoder kernel'):
    """Refuse, by name and before any launch, a plane count the stage
    kernels' grids cannot hold (``MAX_PLANES``)."""
    if planes > MAX_PLANES:
        raise ValueError(f'{what} takes at most {MAX_PLANES} planes (B x '
                         f'classes; CUDA gridDim.y), got {planes}')


def _check_widths(cin, cout, gn_in=False, what='fused_vlg_decoder kernel'):
    """What the stage kernels refuse of a stage's widths, by name: what
    JAX's decoder refuses, an output width (and with ``gn_in``, an input
    still to be normalised) that GroupNorm's groups do not split
    (``gn_layout``), and a normalised width whose kernel layout is wider
    than ``MAX_GN_WIDTH``. Every other width runs: the output (and a
    normalised input) in GroupNorm's kernel layout (``pad_outputs``), the
    other widths zero-padded (``stage_plan``)."""
    for c in (cout, cin) if gn_in else (cout,):
        width = gn_layout(c, what)[1]
        if width > MAX_GN_WIDTH:
            raise ValueError(f'{what} normalises at most {MAX_GN_WIDTH} '
                             f'channels in its layout: {c} take {width}')


def _check_layout(cout, gs, what='fused_vlg_decoder kernel'):
    """A stage handed to a kernel has its output in GroupNorm's kernel
    layout: Cout whole groups of ceil(gs / 16) chunks of 16 channels."""
    if cout % (-(-gs // 16) * 16) or gs > cout:
        raise ValueError(f'{what}: Cout {cout} is not in GroupNorm\'s kernel '
                         f'layout for groups of {gs} channels (pad_outputs '
                         f'first)')


def _check(x, skip, p, what='fused_vlg_decoder kernel', gn_in=None):
    """bf16 contiguous planes on the card whose shapes match the stage's
    weights, at widths the kernels take (``_check_widths``)."""
    if not (x.is_cuda and skip.is_cuda) or x.dtype != torch.bfloat16 \
            or skip.dtype != torch.bfloat16:
        raise ValueError(f'{what} takes bf16 CUDA tensors, '
                         f'got {x.dtype} on {x.device}, {skip.dtype} on '
                         f'{skip.device}')
    if not (x.is_contiguous() and skip.is_contiguous()):
        raise ValueError(f'{what} needs contiguous NCHW')
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
    check_planes(pl, what)
    _check_widths(cin, cout, gn_in is not None, what)
    if cout % 16:
        raise ValueError(f'{what} runs Cout {cout} in GroupNorm\'s kernel '
                         f'layout (pad_outputs first)')


_FWD_SLOTS = ('x gn_part gn_gamma gn_beta skip up_wf up_b w1u w1s w2 g1w g1b '
              'g2w g2b head_w head_b xin up ys c1 part1 a1 c2 part2 scr '
              'out').split()


def _tiles(hh, ww):
    """GroupNorm partials per plane and group of an hh x ww conv output:
    one per igemm conv tile (``_TILE_ROWS`` x ``_TILE_COLS`` pixels)."""
    return -(-hh // _TILE_ROWS) * -(-ww // _TILE_COLS)


def stage_tensors(x, skip, p, head=None):
    """The tensors of ``stage_recompute`` for a stage at its igemm widths
    (skip and p padded): the weights in the igemm layouts, x and skip, the
    outputs and scratch (up, ys, c1, a1, c2, part1, part2, scr), and with
    ``head`` its weights and the logits ``out``; by slot name."""
    pl, cin, h, w = x.shape
    b, cs = skip.shape[:2]
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    dev, hh, ww = x.device, 2 * h, 2 * w

    def e(shape, dtype=x.dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    plane = (pl, cout, hh, ww)
    part = (pl, cout // 16, _tiles(hh, ww), 2)
    t = dict(_igemm_stage_weights(p, x.dtype), x=x, skip=skip,
             up=e((pl, cu, hh, ww)), ys=e((b, cout, hh, ww), torch.float32),
             c1=e(plane), a1=e(plane), c2=e(plane),
             part1=e(part, torch.float32), part2=e(part, torch.float32))
    t['scr'], = _tma_scratch(pl, (cin, cu, cs, cout), hh, ww, dev, 1)
    if head is not None:
        t['out'] = e((pl, 1, hh, ww))
        t['head_w'], t['head_b'] = _head_weight(head, x.dtype)
    return t


def _gn_in_size(gn_in):
    """Channels per GroupNorm group of a normalised input: ``gn_in``'s
    fourth entry (16 without one)."""
    return 16 if gn_in is None or len(gn_in) < 4 else gn_in[3]


def _stage(x, skip, p, gn_in=None, head=None, stats=False, skip_half=True,
           gs=16):
    """One launch of ``decoder_stage_fwd``. ``gn_in``: (partials, gamma,
    beta[, gs]) of a raw input still to be normalised (GN+ReLU) first, in
    groups of gs channels (16 without it). ``gs``: channels per GroupNorm
    group of the stage's output, which lies in the kernels' layout
    (``pad_outputs``); the raw conv2 returned lies in it too. Returns
    (raw conv2, its partials) or, with ``head``, the head logits; with
    ``stats`` also the GroupNorm statistics it normalised with, (mean1,
    rstd1, mean2, rstd2) each (P, Cout) float32, read from the partials by
    ``decoder_gn_stats``. A stage whose Cin, Cu or Cs is not an igemm
    width runs zero-padded (``stage_plan``, ``pad_stage``).
    ``skip_half=False`` leaves
    conv1's skip half out (a planted fault inside the kernel's
    sequence)."""
    global launches
    x, skip, p = pad_stage(x, skip, p, _check_igemm(
        x, skip, p, 'fused_vlg_decoder kernel', bwd=False, gn_in=gn_in))
    pl, cin, h, w = x.shape
    b, cs = skip.shape[:2]
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    _check_layout(cout, gs)
    t = stage_tensors(x, skip, p, head)
    if gn_in is not None:
        t.update(gn_part=gn_in[0], gn_gamma=gn_in[1], gn_beta=gn_in[2],
                 xin=torch.empty_like(x))
    gn_nparts = 0 if gn_in is None else gn_in[0].shape[2]
    _call('decoder_stage_fwd', _FWD_SLOTS, t,
          (pl, cin, h, w, gn_nparts, b, cs, cu, cout, int(skip_half), gs,
           _gn_in_size(gn_in)), x, lib='fused_decoder')
    launches += 1
    res = (t['out'],) if head is not None else (t['c2'], t['part2'])
    if stats:
        res += (_gn_stats(t['part1'], t['c1'].shape, gs)
                + _gn_stats(t['part2'], t['c2'].shape, gs),)
    return res[0] if len(res) == 1 else res


def stored_raw2(x, skip, p):
    """Stage 1's raw conv2 as the forward kernel stores it (the input the
    backward reads), at the stage's true output width (gathered from
    GroupNorm's kernel layout, ``pad_outputs``)."""
    q, _, gs, layout = pad_outputs(p)
    c2 = _stage(x, skip, q, gs=gs)[0]
    return c2 if layout is None else c2[:, layout[0].to(c2.device)]


def _gn_stats(part, shape, gs=16):
    """(mean, rstd) (P, C) float32 of a conv output of ``shape`` (groups of
    ``gs`` channels in the kernels' layout) from its partials (P, C / 16,
    nparts, 2), reduced as the forward reduced them."""
    pl, c, hh, ww = shape
    mean = torch.empty((pl, c), dtype=torch.float32, device=part.device)
    rstd = torch.empty_like(mean)
    fn = _build.load('fused_decoder').decoder_gn_stats
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    _build.check(fn(_build.ptr(part), pl, c, part.shape[2], hh, ww, gs,
                    _build.ptr(mean), _build.ptr(rstd), ctypes.c_void_p(
                        torch.cuda.current_stream(part.device).cuda_stream)),
                 'decoder_gn_stats')
    return mean, rstd


# ---------------------------------------------------------------------------
# backward kernel wrappers

_TAIL_SLOTS = (
    'x gn_part gn_gamma gn_beta skip up_wf up_b w1u w1s w2 g1w g1b g2w g2b '
    'w2_d head_wd g_out g_a2 xin up ys c1 part1 c2 part2 a1 a2 g_raw2 g_a1 '
    'gpart gsum gab bpart igpart scr_a scr_b scr_g g_c1 g_w2 g_g1w g_g1b '
    'g_g2w g_g2b g_hw g_hb').split()
_INPUT_SLOTS = (
    'g_c1 up xin skip up_wd w1u_d w1s_d gph g_img igpart bpart scr_a scr_b '
    'g_xin g_skip g_w1u g_w1s g_up_w g_up_b').split()
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _dgrad_weight(w):
    """(co, ci, 3, 3) conv weight -> the dgrad conv's [co][9][ci] layout:
    flipped taps, input and output channels swapped (the head's CUDA-core
    dgrad)."""
    return w.flip(2, 3).permute(0, 2, 3, 1).contiguous()


def _igemm_weight(w):
    """(out, in, 3, 3) conv weight -> bf16 [9][out][in] (tap ky * 3 + kx),
    the B operand of the igemm conv."""
    o, i = w.shape[:2]
    return w.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, o, i) \
        .contiguous()


def _igemm_dgrad_weight(w):
    """The igemm weight of the dgrad of a (co, ci, 3, 3) conv: the conv from
    co to ci channels with flipped taps."""
    return _igemm_weight(w.flip(2, 3).transpose(0, 1))


def _tconv_fwd_weight(w):
    """Transpose conv weight (cin, cu, 2, 2) -> bf16 [4][cu][cin] (output
    phase ky * 2 + kx), the B operand of its forward product."""
    cin, cu = w.shape[:2]
    return w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(4, cu, cin) \
        .contiguous()


def _tconv_groups(wf):
    """[4][cu][cin] transpose conv weight -> the column groups that
    ``stage_recompute`` runs (``column_groups(cu, TCONV_N)``), each
    [4][group][cin], one after another (itself for one group, and for a
    width that is not a multiple of 16, which no kernel takes)."""
    cu = wf.shape[1]
    groups = column_groups(cu, TCONV_N) if cu % 16 == 0 else (cu,)
    if len(groups) == 1:
        return wf
    starts = [sum(groups[:k]) for k in range(len(groups))]
    return torch.cat([wf[:, n0:n0 + n].flatten()
                      for n0, n in zip(starts, groups)])


def _tconv_dgrad_weight(w):
    """Transpose conv weight (cin, cu, 2, 2) -> bf16 [cin][4 cu] (K index
    (ky * 2 + kx) cu + c), the B operand of its input gradient."""
    cin, cu = w.shape[:2]
    return w.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(cin, 4 * cu) \
        .contiguous()


def _tconv_wgrad_to_torch(g, cin, cu):
    """[4 cu][cin] transpose conv weight gradient -> torch (cin, cu, 2, 2)."""
    return g.reshape(2, 2, cu, cin).permute(3, 2, 0, 1)


def _from_taps(g, ci, co):
    """[9][ci][co] weight gradient -> torch (co, ci, 3, 3)."""
    return g.reshape(3, 3, ci, co).permute(3, 2, 0, 1)


def _wgrad_slots(dev, taps, mrows):
    """Slots of an igemm weight-gradient reduction: about one block per SM
    over the (column shift, 64-row tile) blocks of each slot (as
    ``decoder_igemm.cuh::wgrad_slots``)."""
    blocks = (3 if taps == 9 else 1) * -(-mrows // 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return -(-sms // blocks)


def _tma_scratch(pl, channels, hh, ww, dev, n=2):
    """``n`` bf16 buffers, each with room for the three column-shifted
    copies (at a pitch TMA takes) of the largest source a 3x3 product
    reads."""
    size = 3 * pl * max(channels) * hh * (-(-ww // 8) * 8)
    return tuple(torch.empty(size, dtype=torch.bfloat16, device=dev)
                 for _ in range(n))


def _igemm_stage_weights(p, dt):
    """A stage's forward weights in the igemm layouts (bf16), the transpose
    conv's bias (rounded to the activation dtype ``dt``, as the plain chain
    adds it) and the GroupNorm affines (float32)."""
    cu = p['up_weight'].shape[1]
    w1 = p['conv1_weight']
    return dict(up_wf=_tconv_groups(_tconv_fwd_weight(p['up_weight'])),
                up_b=p['up_bias'].to(dt).float().contiguous(),
                w1u=_igemm_weight(w1[:, :cu]), w1s=_igemm_weight(w1[:, cu:]),
                w2=_igemm_weight(p['conv2_weight']),
                **{k: p[n].float().contiguous() for k, n in (
                    ('g1w', 'gn1_weight'), ('g1b', 'gn1_bias'),
                    ('g2w', 'gn2_weight'), ('g2b', 'gn2_bias'))})


def _igemm_input_weights(p):
    """The dgrad weights of a stage's input half in the igemm layouts."""
    cu = p['up_weight'].shape[1]
    w1 = p['conv1_weight']
    return dict(up_wd=_tconv_dgrad_weight(p['up_weight']),
                w1u_d=_igemm_dgrad_weight(w1[:, :cu]),
                w1s_d=_igemm_dgrad_weight(w1[:, cu:]))


def _call(fn_name, slots, tensors, dims, x, lib='fused_decoder_bwd'):
    """Launch ``fn_name`` of ``csrc/<lib>.cu``: the tensors by slot name (a
    missing slot passes a null pointer), the sizes as an int array."""
    ptrs = (ctypes.c_void_p * len(slots))(
        *[None if tensors.get(s) is None else tensors[s].data_ptr()
          for s in slots])
    fn = getattr(_build.load(lib), fn_name)
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    err = fn(ptrs, (ctypes.c_int * len(dims))(*dims),
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, fn_name)


# Output widths (N) of decoder_stage_bwd.cuh's igemm products: the 3x3
# conv (CONV_N), the transpose conv's products (TCONV_N) and the weight
# gradients (WGRAD_N, by taps). A wider output runs in column groups:
# conv_cols and the transpose conv take the widest width that fits what is
# left (``column_groups``), wgrad_cols the narrowest that covers it
# (``wgrad_width``). K (input channels) is any multiple of 16.
CONV_N = (16, 32, 48, 64, 96)
TCONV_N = CONV_N + (128,)
WGRAD_N = {9: (16, 32, 64), 1: (32, 64, 96, 128)}


def _next(c, widths):
    return next((n for n in widths if n >= c), None)


def _round16(c):
    return -(-c // 16) * 16


def column_groups(c, widths):
    """The column groups ``stage_recompute`` and ``conv_cols`` run an
    output of c channels (a multiple of 16) in: each the widest of
    ``widths`` that fits what is left."""
    groups = []
    while c > 0:
        groups.append(max(n for n in widths if n <= c))
        c -= groups[-1]
    return tuple(groups)


def wgrad_width(c, taps):
    """The widest weight-gradient product ``wgrad_cols`` runs for c
    columns (the room its partials need per column)."""
    return _next(c, WGRAD_N[taps]) or WGRAD_N[taps][-1]


def stage_plan(cin, cu, cs, bwd=False):
    """The widths the igemm sequences run a stage of Cin, Cu, Cs channels
    at: dict(cin=, cu=, cs=, tconv_groups=), each zero-padded (exact:
    ``pad_stage``). Cin and Cs are K widths, padded to multiples of 16.
    The forward (``bwd`` False: the decoder forward #5 and the fused Up
    stage #11) pads Cu to column groups of ``TCONV_N`` widths (128 each but
    the last, that one padded to the next width). The backward routes
    (#6-#10) also take Cu and Cs as N of 3x3 dgrads: up to 96 each pads to
    the next of ``CONV_N`` (one product), a wider one to a multiple of 16
    (``column_groups``)."""
    if bwd:
        pcu = _next(cu, CONV_N) or _round16(cu)
        pcs = _next(cs, CONV_N) or _round16(cs)
    else:
        full, rest = divmod(cu - 1, TCONV_N[-1])
        pcu = TCONV_N[-1] * full + _next(rest + 1, TCONV_N)
        pcs = _round16(cs)
    return dict(cin=_round16(cin), cu=pcu, cs=pcs,
                tconv_groups=column_groups(pcu, TCONV_N))


def _pad_channels(t, c):
    """``t`` zero-padded along dim 1 to ``c`` channels (itself if it has
    them), contiguous."""
    if t.shape[1] == c:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], c - t.shape[1])
                                     + tuple(t.shape[2:]))], 1).contiguous()


def pad_stage(x, skip, p, plan):
    """The input, the skip and a stage's weights zero-padded to ``plan``'s
    widths: x's channels (and the transpose conv's input rows) to
    plan['cin'], skip channels (and conv1's skip columns) to plan['cs'],
    the transpose conv's output channels (up_weight, up_bias; conv1's up
    columns) to plan['cu']. The padded up channels are 0 (zero weights and
    bias) and every padded column multiplies zeros, so the padded stage
    computes the true one. Returns (x, skip, p), themselves when nothing is
    padded."""
    cin, cu, cs = x.shape[1], p['up_weight'].shape[1], skip.shape[1]
    if (cin, cu, cs) == (plan['cin'], plan['cu'], plan['cs']):
        return x, skip, p
    w1, wu = p['conv1_weight'], p['up_weight']
    wu = _pad_channels(wu.transpose(0, 1), plan['cin']).transpose(0, 1)
    return _pad_channels(x, plan['cin']), _pad_channels(skip, plan['cs']), \
        dict(p, up_weight=_pad_channels(wu, plan['cu']),
             up_bias=_pad_channels(p['up_bias'][None], plan['cu'])[0],
             conv1_weight=torch.cat([_pad_channels(w1[:, :cu], plan['cu']),
                                     _pad_channels(w1[:, cu:], plan['cs'])],
                                    1))


def unpad_grads(g, cin, cu, cs):
    """A padded stage's gradients (``g_x``, ``g_skip``, ``up_weight``,
    ``up_bias``, ``conv1_weight``; any other key as it is) cut back to the
    true widths Cin, Cu and Cs."""
    out = dict(g)
    pcu = g['up_bias'].shape[0]
    out.update(g_x=g['g_x'][:, :cin], g_skip=g['g_skip'][:, :cs],
               up_weight=g['up_weight'][:cin, :cu],
               up_bias=g['up_bias'][:cu],
               conv1_weight=torch.cat([g['conv1_weight'][:, :cu],
                                       g['conv1_weight'][:, pcu:pcu + cs]],
                                      1))
    return out


def _check_igemm(x, skip, p, what='decoder backward kernel', bwd=True,
                 gn_in=None):
    """What the igemm sequences take besides ``_check``: the widths of
    ``stage_plan`` (returned) and 16-byte aligned planes (TMA)."""
    _check(x, skip, p, what, gn_in)
    plan = stage_plan(x.shape[1], p['up_weight'].shape[1], skip.shape[1],
                      bwd)
    if x.data_ptr() % 16 or skip.data_ptr() % 16:
        raise ValueError(f'{what} needs 16-byte aligned planes')
    return plan


def _stage_bwd_tail(x, skip, p, gn_in=None, head=None, g=None,
                    wgrad_planes=None, gs=16):
    """Stage backward, tail half (kernel #6): recompute the stage, then the
    head (with ``head``; ``g`` the logits' gradient) or GN2+ReLU (``g`` the
    gradient of the stage's normalised output, taken in bf16) down to
    g_raw1. Returns a dict with g_c1 (bf16), the recomputed up / xin, and
    the gradients of conv2, the GroupNorms and the head in torch layouts.
    ``wgrad_planes``: the planes conv2's weight gradient reduces over (all
    of them unless a planted fault asks for fewer). ``gn_in`` and ``gs`` as
    ``_stage`` takes them. A stage whose Cin, Cu or Cs is not an igemm
    width runs zero-padded (``stage_plan``); the returned ``up`` keeps the
    padded channels, which ``_stage_bwd_input`` takes, and ``xin`` has the
    true Cin."""
    global bwd_tail_launches
    cin0 = x.shape[1]
    x, skip, p = pad_stage(x, skip, p, _check_igemm(x, skip, p, gn_in=gn_in))
    pl, cin, h, w = x.shape
    b, cs = skip.shape[:2]
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    _check_layout(cout, gs)
    dt, dev = x.dtype, x.device
    hh, ww = 2 * h, 2 * w
    tiles = _tiles(hh, ww)
    slots = _wgrad_slots(dev, 9, cout)

    def e(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    t = dict(_igemm_stage_weights(p, dt), x=x, skip=skip, xin=x,
             w2_d=_igemm_dgrad_weight(p['conv2_weight']))
    if gn_in is not None:
        t.update(gn_part=gn_in[0], gn_gamma=gn_in[1], gn_beta=gn_in[2],
                 xin=e((pl, cin, h, w), dt))
    plane = (pl, cout, hh, ww)
    t['scr_a'], t['scr_b'] = _tma_scratch(pl, (cin, cu, cout, cs), hh, ww,
                                          dev)
    t.update(up=e((pl, cu, hh, ww), dt), ys=e((b, cout, hh, ww)),
             c1=e(plane, dt), c2=e(plane, dt), a1=e(plane, dt),
             g_raw2=e(plane, dt), g_a1=e(plane, dt), g_c1=e(plane, dt),
             part1=e((pl, cout // 16, tiles, 2)),
             part2=e((pl, cout // 16, tiles, 2)),
             gpart=e((pl, cout, -(-hh * ww // 1024), 2)),
             gsum=e((pl, cout, 2)), gab=e((pl, cout // 16, 2)),
             igpart=e((slots, 9, cout, wgrad_width(cout, 9))),
             g_w2=e((9, cout, cout)),
             g_g1w=e((cout,)), g_g1b=e((cout,)), g_g2w=e((cout,)),
             g_g2b=e((cout,)))
    if head is not None:
        t.update(head_wd=_dgrad_weight(head['weight'].to(dt).float()),
                 g_out=g.to(dt).contiguous(), g_a2=e(plane, dt),
                 a2=e(plane, dt), bpart=e((pl,)),
                 scr_g=e((pl * hh * (-(-ww // 8) * 8),), dt),
                 g_hw=e((9, cout, 16)), g_hb=e((1,)))
    else:
        t['g_a2'] = g.to(dt).contiguous()
    gn_nparts = 0 if gn_in is None else gn_in[0].shape[2]
    _call('decoder_stage_bwd_tail', _TAIL_SLOTS, t,
          (pl, cin, h, w, gn_nparts, b, cs, cu, cout, 0,
           pl if wgrad_planes is None else wgrad_planes, slots, 0, 0, gs,
           _gn_in_size(gn_in)), x)
    bwd_tail_launches += 1
    xin = t['xin'] if cin == cin0 else t['xin'][:, :cin0].contiguous()
    out = dict(g_c1=t['g_c1'], up=t['up'], xin=xin,
               conv2_weight=_from_taps(t['g_w2'], cout, cout),
               gn1_weight=t['g_g1w'], gn1_bias=t['g_g1b'],
               gn2_weight=t['g_g2w'], gn2_bias=t['g_g2b'])
    if head is not None:
        out.update(head_weight=_from_taps(t['g_hw'][..., :1], cout, 1),
                   head_bias=t['g_hb'])
    return out


def _stage_bwd_input(g_c1, up, xin, skip, p):
    """Stage backward, input half (kernel #7): from g_raw1 (bf16), the
    gradients of the stage input (bf16), the skip (float32, from each
    image's summed planes), conv1 and the transpose conv, in torch
    layouts, at the stage's true widths (``up`` at them or at the padded
    ones)."""
    global bwd_input_launches
    cin0, cu0, cs0 = xin.shape[1], p['up_weight'].shape[1], skip.shape[1]
    plan = _check_igemm(xin, skip, p)
    xin, skip, p = pad_stage(xin, skip, p, plan)
    up = _pad_channels(up, plan['cu'])
    pl, cin, h, w = xin.shape
    b, cs, hh, ww = skip.shape
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    dt, dev = xin.dtype, xin.device
    pitch = -(-w // 8) * 8
    s1 = _wgrad_slots(dev, 9, cu)
    s2 = _wgrad_slots(dev, 9, cs)
    s3 = _wgrad_slots(dev, 1, 4 * cu)

    def e(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    t = dict(_igemm_input_weights(p), g_c1=g_c1, up=up, xin=xin, skip=skip,
             gph=e((pl, 4, cu, h, pitch), dt), g_img=e((b, cout, hh, ww), dt),
             igpart=e(max(s1 * 9 * cu * wgrad_width(cout, 9),
                          s2 * 9 * cs * wgrad_width(cout, 9),
                          s3 * 4 * cu * wgrad_width(cin, 1))),
             bpart=e((pl, cu)), g_xin=e((pl, cin, h, w), dt),
             g_skip=e((b, cs, hh, ww)), g_w1u=e((9, cu, cout)),
             g_w1s=e((9, cs, cout)), g_up_w=e((4 * cu, cin)),
             g_up_b=e((cu,)))
    t['scr_a'], t['scr_b'] = _tma_scratch(pl, (cin, cu, cout, cs), hh, ww,
                                          dev)
    _call('decoder_stage_bwd_input', _INPUT_SLOTS, t,
          (pl, cin, h, w, 0, b, cs, cu, cout, pitch, pl, s1, s2, s3, 16, 16),
          xin)
    bwd_input_launches += 1
    return unpad_grads(dict(
        g_x=t['g_xin'], g_skip=t['g_skip'], up_bias=t['g_up_b'],
        up_weight=_tconv_wgrad_to_torch(t['g_up_w'], cin, cu),
        conv1_weight=torch.cat([_from_taps(t['g_w1u'], cu, cout),
                                _from_taps(t['g_w1s'], cs, cout)], dim=1)),
        cin0, cu0, cs0)


def _unflatten(flat):
    p1 = dict(zip(STAGE_KEYS, flat[:8]))
    p2 = dict(zip(STAGE_KEYS, flat[8:16]))
    return p1, p2, dict(weight=flat[16], bias=flat[17])


def _forward(x, skip1, skip2, params1, params2, head_params, gs=(16, 16)):
    """Both stage launches (the stages in the kernels' layout, ``gs`` their
    GroupNorm group sizes); returns (logits, stage-1 raw conv2, partials)."""
    c2, part2 = _stage(x, skip1, params1, gs=gs[0])
    gn_in = (part2, params1['gn2_weight'].float().contiguous(),
             params1['gn2_bias'].float().contiguous(), gs[0])
    return _stage(c2, skip2, params2, gn_in=gn_in, head=head_params,
                  gs=gs[1]), c2, part2


class _FusedDecoder(torch.autograd.Function):
    """The kernel chain with the kernel backward. Only the stage inputs
    (x, the skips and stage 1's raw conv2 with its GroupNorm partials) are
    kept for the backward, which recomputes everything else."""

    @staticmethod
    def forward(ctx, x, skip1, skip2, gs, *flat):
        out, c2, part2 = _forward(x, skip1, skip2, *_unflatten(flat), gs)
        ctx.save_for_backward(x, skip1, skip2, *flat)
        ctx.c2, ctx.part2, ctx.gs = c2, part2, gs
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, skip1, skip2, *flat = ctx.saved_tensors
        p1, p2, head = _unflatten(flat)
        gs = ctx.gs
        gn_in = (ctx.part2, p1['gn2_weight'].float().contiguous(),
                 p1['gn2_bias'].float().contiguous(), gs[0])
        t2 = _stage_bwd_tail(ctx.c2, skip2, p2, gn_in=gn_in, head=head,
                             g=g_out, gs=gs[1])
        i2 = _stage_bwd_input(t2['g_c1'], t2['up'], t2['xin'], skip2, p2)
        t1 = _stage_bwd_tail(x, skip1, p1, g=i2['g_x'], gs=gs[0])
        i1 = _stage_bwd_input(t1['g_c1'], t1['up'], t1['xin'], skip1, p1)
        grads = [{**t, **i}[k] for t, i in ((t1, i1), (t2, i2))
                 for k in STAGE_KEYS]
        grads += [t2['head_weight'], t2['head_bias']]
        grads = [g.to(prm.dtype) for g, prm in zip(grads, flat)]
        return (i1['g_x'].to(x.dtype), i1['g_skip'].to(skip1.dtype),
                i2['g_skip'].to(skip2.dtype), None, *grads)


def fused_vlg_decoder(x, skip1, skip2, params1, params2, head_params,
                      bwd='whole'):
    """Full up1 -> up2 -> head decoder tail, differentiable.

    x: (P, C, h, w) class planes (P = B*N); skip1: (B, Cs1, 2h, 2w); skip2:
    (B, Cs2, 4h, 4w), both already resized to their stage's output size.
    Returns (P, 1, 4h, 4w) logits in x's dtype. ``bwd``: the backward's
    route, 'whole' (kernels #6/#7, which recompute every statistic) or
    'banded' (``ops.fused_decoder_banded``: three passes per stage from the
    forward's saved statistics; the JAX package's route under
    ``SEMIVL_FORCE_BANDED_BWD=1``). Without gradients both routes run the
    same forward. Off the CPU, and on the banded route, the stages run in
    GroupNorm's kernel layout (``pad_decoder``)."""
    if bwd not in ('whole', 'banded'):
        raise ValueError(f'bwd {bwd!r}: whole or banded')
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, skip1, skip2, *params1.values(),
                                  *params2.values(), *head_params.values()))
    if not x.is_cuda and not (grad and bwd == 'banded'):
        return fused_vlg_decoder_plain(x, skip1, skip2, params1, params2,
                                       head_params)
    check_planes(x.shape[0])
    for p, cin in ((params1, x.shape[1]),
                   (params2, params1['conv2_weight'].shape[0])):
        _check_widths(cin, p['conv2_weight'].shape[0], p is params2)
    p1, p2, head, gs = pad_decoder(params1, params2, head_params)
    flat = ([p1[k] for k in STAGE_KEYS] + [p2[k] for k in STAGE_KEYS]
            + [head['weight'], head['bias']])
    if grad and bwd == 'banded':
        from semivl_tpu_torch.ops import fused_decoder_banded
        return fused_decoder_banded.BandedDecoder.apply(x, skip1, skip2, gs,
                                                        *flat)
    if grad:
        return _FusedDecoder.apply(x, skip1, skip2, gs, *flat)
    return _forward(x, skip1, skip2, p1, p2, head, gs)[0]
