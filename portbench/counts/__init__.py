"""Operations and bytes of the benchmark's work, counted from shapes.

The model counts (``vit``, ``head``, ``resnet``, ``train_step``,
``eval_image``) list each product of the published architecture with its
forward operations (a multiply-add is two) and whether its backward
computes the input's gradient (``dx``) and the weight's (``dw``); a
backward product costs what its forward does. Elementwise work,
normalisations and softmaxes are not counted, nor is recomputation. The
call counts (``attention_call``, ``decoder_call``) give the work of one
call of the port's attention and decoder entries from the shapes at that
call, for their roofline shares: every input read once, every output
written once.
"""

PEAK_FLOPS = 989e12     # NVIDIA H100 SXM, dense bf16 (data sheet)
PEAK_BYTES = 3.35e12    # HBM3, bytes per second
BF16 = 2


class Work:
    """Forward and backward operations of a list of products."""

    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0

    def op(self, flops, dx=True, dw=False):
        self.fwd += flops
        self.bwd += flops * (int(dx) + int(dw))

    def add(self, other, times=1):
        self.fwd += other.fwd * times
        self.bwd += other.bwd * times


def vit(cfg, h, w, attn_trainable=True, grad=True):
    """One image through the MaskCLIP ViT (cfg: the architecture's
    ``backbone``). Only the attention projections train (the frozen
    backbone's ``exclude_keys``); the last block's main path feeds only the
    unused global embedding, so its backward is not counted."""
    ps, c = cfg['patch_size'], cfg['embed_dims']
    hid = cfg['mlp_ratio'] * c
    gh, gw = -(-h // ps), -(-w // ps)
    tokens = gh * gw + 1
    nl = cfg['num_layers']
    outs = cfg['out_indices'] if cfg.get('out_indices') is not None else [nl]
    wk = Work()
    wk.op(2 * (tokens - 1) * c * 3 * ps * ps, dx=False)
    for i in range(nl):
        live = grad and i < nl - 1
        wk.op(2 * tokens * c * 3 * c, dx=grad, dw=grad and attn_trainable)
        wk.op(4 * tokens * tokens * c, dx=live, dw=live)   # QK^T and PV
        wk.op(2 * tokens * c * c, dx=live, dw=live and attn_trainable)
        wk.op(4 * tokens * c * hid, dx=live)
        if i in outs or i == nl - 1:                     # the v-path
            wk.op(2 * tokens * c * c, dx=grad, dw=grad and attn_trainable)
            wk.op(4 * tokens * c * hid, dx=grad)
    wk.op(2 * tokens * c * cfg['clip_dim'], dx=grad)
    return wk, (gh, gw)


def resnet(cfg, h, w):
    """ResNetV1c's deep stem and ``num_stages`` bottleneck stages on one
    image (all trained)."""
    wk = Work()
    oh, ow = (h + 1) // 2, (w + 1) // 2
    wk.op(2 * oh * ow * 32 * 3 * 9, dx=False, dw=True)
    wk.op(2 * oh * ow * 32 * 32 * 9, dw=True)
    wk.op(2 * oh * ow * 64 * 32 * 9, dw=True)
    oh, ow = (oh + 1) // 2, (ow + 1) // 2
    cin = 64
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[cfg['depth']]
    for s in range(cfg['num_stages']):
        p = 64 * 2 ** s
        for b in range(blocks[s]):
            if s > 0 and b == 0:
                oh, ow = (oh + 1) // 2, (ow + 1) // 2
            wk.op(2 * oh * ow * cin * p, dw=True)
            wk.op(2 * oh * ow * p * p * 9, dw=True)
            wk.op(2 * oh * ow * p * 4 * p, dw=True)
            if b == 0:
                wk.op(2 * oh * ow * cin * 4 * p, dw=True)
            cin = 4 * p
    return wk, (oh, ow)


def decoder_tail(cfg, n, h, w):
    """The two Up stages and the 3x3 head over ``n`` planes of one image
    (``fused_vlg_decoder``); returns (Work, {name: elements}) with the
    element counts of its inputs, outputs and weights."""
    wk = Work()
    cin = cfg['channels']
    elems = {'x': n * cin * h * w, 'weights': 0}
    hh, ww = h, w
    for j, (cout, cs) in enumerate(zip(cfg['up_channels'],
                                       cfg['skip_channels'])):
        cu = cin - cs
        wk.op(2 * n * hh * ww * cin * cu * 4, dw=True)
        hh, ww = 2 * hh, 2 * ww
        wk.op(2 * n * hh * ww * cu * cout * 9, dw=True)
        wk.op(2 * hh * ww * cs * cout * 9, dw=True)      # skip, once
        wk.op(2 * n * hh * ww * cout * cout * 9, dw=True)
        elems[f'skip{j + 1}'] = cs * hh * ww
        elems['weights'] += cin * cu * 4 + cu + cout * (cin * 9 + 4) \
            + cout * cout * 9
        cin = cout
    wk.op(2 * n * hh * ww * cin * 9, dw=True)
    elems['weights'] += cin * 9 + 1
    elems['out'] = n * hh * ww
    return wk, elems


def head(cfg, n, grid, skip_grids, out_hw):
    """The VLG head on one image: ``n`` text rows, the dense embedding's
    ``grid`` (h, w), ``skip_grids`` [(Cin, h, w)] of the skip maps in the
    order the head projects them, logits resized to ``out_hw``."""
    h, w = grid
    c, ct = cfg['channels'], cfg['text_channels']
    k = cfg['conv1_ksize']
    wk = Work()
    wk.op(2 * h * w * cfg['text_in_channels'] * n)
    wk.op(2 * n * h * w * c * k * k, dw=True)
    wk.op(2 * n * h * w * c * c, dw=True)
    wk.op(3 * 2 * n * h * w * c * c * 9, dw=True)
    wk.op(2 * n * c * c, dw=True)
    wk.op(2 * n * h * w * 5 * c * c, dw=True)
    wk.op(2 * n * cfg['text_in_channels'] * ct, dx=False, dw=True)
    ph, pw = cfg['pool_size']
    hp, wp = h // ph, w // pw
    d = c + ct
    for _ in range(cfg['num_layers']):
        wk.op(2 * n * c * (hp * h * w + hp * wp * w))      # pool
        t = hp * wp
        wk.op(2 * t * n * d * 3 * d, dw=True)
        wk.op(4 * t * n * n * d, dw=True)
        wk.op(2 * t * n * d * d, dw=True)
        wk.op(4 * t * n * d * 4 * c, dw=True)
        wk.op(2 * n * c * (h * hp * wp + h * w * wp))      # unpool
    for (cin, sh, sw), cs, scale in zip(skip_grids, cfg['skip_channels'],
                                        (2, 4)):
        wk.op(2 * sh * sw * cin * cs * 9, dw=True)
        oh, ow = scale * h, scale * w
        wk.op(2 * cs * (oh * sh * sw + oh * sw * ow))      # resize
    tail, _ = decoder_tail(cfg, n, h, w)
    wk.add(tail)
    oh, ow = out_hw
    wk.op(2 * n * (oh * 4 * h * 4 * w + oh * 4 * w * ow))  # final resize
    return wk


def _skip_grids(arch, grid, conv_grid):
    """The head's skip maps: the ViT's out_indices below its depth in
    reverse, then the conv encoder's."""
    b = arch['backbone']
    vit_levels = [i for i in b['out_indices'] if i < b['num_layers']][::-1]
    grids = [(b['embed_dims'], *grid) for _ in vit_levels]
    if arch['decode_head'].get('skip_from_conv_feat'):
        grids.append((256 * 2 ** (arch['conv_encoder']['num_stages'] - 1),
                      *conv_grid))
    return grids


def segmentor(arch, n, h, w, grad):
    """One image through the VLG segmentor (ViT, conv encoder, head)."""
    wk = Work()
    v, grid = vit(arch['backbone'], h, w, grad=grad)
    wk.add(v)
    conv_grid = None
    if arch.get('conv_encoder'):
        r, conv_grid = resnet(arch['conv_encoder'], h, w)
        if not grad:
            r.bwd = 0.0
        wk.add(r)
    hd = head(arch['decode_head'], n, grid, _skip_grids(arch, grid,
                                                        conv_grid), (h, w))
    if not grad:
        hd.bwd = 0.0
    wk.add(hd)
    return wk


def guidance(arch, n_text, h, w):
    """One image through the frozen guidance encoder and its labels."""
    wk, (gh, gw) = vit(arch['clip_encoder'], h, w, grad=False)
    wk.op(2 * gh * gw * 512 * n_text, dx=False)
    wk.op(2 * n_text * (h * gh * gw + h * gw * w), dx=False)
    return wk


def train_step(arch, n_text, n_mcc_text, labeled, crop):
    """Operations of one SemiVL iteration on ``labeled`` + ``labeled``
    crops: the teacher on the unlabeled mixed-in images, the guidance
    encoder on 2B, student pass 1 on [x | w] with the perturbed w half
    decoded again, student pass 2 on [s1 | s2], and the backward of both
    student passes."""
    b = labeled
    wk = Work()
    wk.add(segmentor(arch, n_text, crop, crop, grad=False), b)   # teacher
    wk.add(guidance(arch, n_mcc_text, crop, crop), 2 * b)
    wk.add(segmentor(arch, n_text, crop, crop, grad=True), 4 * b)
    _, grid = vit(arch['backbone'], crop, crop)
    conv_grid = resnet(arch['conv_encoder'], crop, crop)[1] \
        if arch.get('conv_encoder') else None
    wk.add(head(arch['decode_head'], n_text, grid,
                _skip_grids(arch, grid, conv_grid), (crop, crop)), b)  # FP
    return wk.fwd + wk.bwd


def eval_windows(h, w, crop, stride):
    hg = max(h - crop + stride - 1, 0) // stride + 1
    wg = max(w - crop + stride - 1, 0) // stride + 1
    return hg * wg


def eval_image(arch, n_text, h, w, crop, stride):
    """Operations of one image of ``zegclip_sliding_window``: every window
    through the segmentor and the canvas's resize (identity at the label's
    size, not counted)."""
    return segmentor(arch, n_text, crop, crop, grad=False).fwd \
        * eval_windows(h, w, crop, stride)


def attention_call(b, length, c, backward):
    """(flops, bytes) of one self-attention call over the packed (B, L, 3C)
    in_proj output: QK^T and PV forward; dV, dP, dQ, dK backward."""
    if backward:
        return 8 * b * length * length * c, BF16 * b * length * (3 * c + c
                                                                 + 3 * c)
    return 4 * b * length * length * c, BF16 * b * length * (3 * c + c)


def decoder_call(cfg, planes, images, h, w, backward):
    """(flops, bytes) of one ``fused_vlg_decoder`` call on ``planes``
    planes of ``images`` images at the (h, w) grid (cfg: the head's
    architecture)."""
    wk, el = decoder_tail(cfg, planes // images, h, w)
    skips = images * (el['skip1'] + el['skip2'])
    x = el['x'] * images
    out = el['out'] * images
    if backward:
        return wk.bwd * images, BF16 * (out + x + skips + el['weights']
                                        + x + skips + el['weights'])
    return wk.fwd * images, BF16 * (x + skips + el['weights'] + out)


def bound_seconds(flops, nbytes):
    """The least time the chip could take: operations at the bf16 peak or
    bytes at the memory's, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_percent(bound_s, kernel_s):
    """A share of the roofline in %, None where no kernel time was read."""
    if not kernel_s:
        return None
    return 100.0 * bound_s / kernel_s


def mfu_percent(flops, seconds):
    return 100.0 * flops / seconds / PEAK_FLOPS if seconds > 0 else None
