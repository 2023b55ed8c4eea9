"""One VLG Up stage, forward only: the Hopper kernel and its plain version.

Counterpart of ``semivl_tpu/ops/fused_up.py::fused_up_stage`` (the Pallas
``_up_fused_kernel``, reached by ``tools/fused_up_bench.py``; no model
routes to it): the 2x2 transpose conv, conv3x3 over [up, skip] (the skip
per image, shared by the image's N planes), GroupNorm (``max(C // 16, 1)``
groups) -> ReLU -> conv3x3 -> GroupNorm -> ReLU, and optionally the
1-channel 3x3 head conv with bias as an epilogue.

Planes are NCHW; ``stage_params`` carries the torch-layout names of
``models.vlg_head.Up.stage_params`` (``up_weight`` (Cin, Cu, 2, 2),
``up_bias``, ``conv1_weight`` (Cout, Cu + Cs, 3, 3), ``gn1_weight``,
``gn1_bias``, ``conv2_weight``, ``gn2_weight``, ``gn2_bias``; from a JAX
``Up`` tree: ``convert.up_stage_params``), the head ``{'weight': (1, Cout,
3, 3), 'bias': (1,)}``. CUDA tensors launch ``decoder_stage_fwd`` of
``csrc/fused_decoder.cu``, the decoder forward's stage, ending in
GN2+ReLU or the head (bf16; the output in GroupNorm's kernel layout,
``fused_decoder.pad_outputs``, and cut back; the input, skip and up
channels zero-padded to the widths of its tensor-core products,
``fused_decoder.stage_plan``) or raise; CPU tensors take
``fused_up_stage_plain``. ``fused_up_stage_rounded`` is the kernel's own
arithmetic in plain PyTorch, the reference it is held to on the card.
"""

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)


def fused_up_stage_plain(x, skip, stage_params, head_params=None):
    """The JAX ``Up`` chain in x's dtype (the transpose conv and both convs
    stored in that dtype, GroupNorm statistics in float32), plus the head:
    (P, Cout, 2h, 2w), or (P, 1, 2h, 2w) with ``head_params``."""
    y = fused_decoder.up_stage_plain(x, skip, stage_params)
    if head_params is None:
        return y
    dt = y.dtype
    return F.conv2d(y, head_params['weight'].to(dt),
                    head_params['bias'].to(dt), padding=1)


def fused_up_stage_rounded(x, skip, stage_params, head_params=None,
                           dtype=torch.float32):
    """The kernel's arithmetic in plain PyTorch: sums and GroupNorm in
    ``dtype`` over weights rounded to bf16, a bf16 rounding wherever the
    kernel stores bf16 (the transpose conv output, the raw conv1 after its
    up and skip halves are summed, the raw conv2, both activations, the
    logits). Output in x's dtype."""
    y = fused_decoder.up_stage_rounded(x.to(dtype), skip, stage_params, dtype)
    if head_params is not None:
        y = fused_decoder.head_rounded(y, head_params)
    return y.to(x.dtype)


def _check(x, skip, p, head_params):
    """The stage's widths (``fused_decoder.stage_plan``, returned) and, with
    a head, its weight's shape."""
    plan = fused_decoder._check_igemm(x, skip, p, 'fused_up_stage kernel',
                                      bwd=False)
    if head_params is not None and tuple(head_params['weight'].shape) != (
            1, p['conv2_weight'].shape[0], 3, 3):
        raise ValueError('head weight must be (1, Cout, 3, 3)')
    return plan


def _kernel(x, skip, p, head_params, skip_half=True):
    """One launch of ``decoder_stage_fwd`` ending in GN2+ReLU (``out`` set,
    no head) or the head. ``skip_half=False`` leaves conv1's skip half out
    (a planted fault inside the kernel's sequence)."""
    global launches
    fused_decoder._check_widths(x.shape[1], p['conv2_weight'].shape[0],
                                what='fused_up_stage kernel')
    p, head_params, gs, layout = fused_decoder.pad_outputs(p, head_params)
    x, skip, p = fused_decoder.pad_stage(x, skip, p, _check(x, skip, p,
                                                            head_params))
    pl, cin, h, w = x.shape
    b, cs = skip.shape[:2]
    cu = p['up_weight'].shape[1]
    cout = p['conv2_weight'].shape[0]
    t = fused_decoder.stage_tensors(x, skip, p, head_params)
    if head_params is None:
        t['out'] = torch.empty_like(t['c2'])
    fused_decoder._call('decoder_stage_fwd', fused_decoder._FWD_SLOTS, t,
                        (pl, cin, h, w, 0, b, cs, cu, cout, int(skip_half),
                         gs, 16), x, lib='fused_decoder')
    launches += 1
    if head_params is None and layout is not None:
        return t['out'][:, layout[0].to(x.device)]
    return t['out']


def fused_up_stage(x, skip, stage_params, head_params=None):
    """One Up stage on channel-first planes, forward only.

    x: (P, Cin, h, w) with P = B * N; skip: (B, Cs, 2h, 2w), already at the
    output size. Returns (P, Cout, 2h, 2w) in x's dtype, or with
    ``head_params`` the (P, 1, 2h, 2w) head logits. On the card the
    kernel takes bf16 planes and every Cout that JAX's GroupNorm splits
    (``fused_decoder.gn_layout``); like the TPU kernel it has no
    gradient."""
    if not x.is_cuda:
        return fused_up_stage_plain(x, skip, stage_params, head_params)
    tensors = [x, skip, *stage_params.values(),
               *(head_params or {}).values()]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError('fused_up_stage is forward only: call it under '
                         'torch.no_grad() or with inputs that need no '
                         'gradient')
    return _kernel(x.contiguous(), skip.contiguous(), stage_params,
                   head_params)
