"""The plain reference of the benchmark's SemiVL models, in float32.

A functional copy of the published architecture (reference repository
``model/vlm.py``, ``model/backbone/maskclip_vit.py``,
``model/decode_heads/vlg_head.py``, mmseg's ResNetV1c) written with plain
``torch`` operations: no kernel, no fused path, no cache. Parameters live
in one dict keyed by the reference's torch names, so that the benchmark
hands the same seeded tensors to the program and to this reference.

Every product (linear, convolution, attention, the similarity map) goes
through a ``Precision``: ``Precision('fp32')`` computes in float32 (the
reference; the caller turns TF32 off), ``Precision('fp8')`` rounds both
operands of each product to float8 e4m3 with a per-tensor scale first (the
control: the nearest precision below the bfloat16 the configurations
train in). Resizes, softmaxes and normalisations stay float32 in both, as
they are in the program.

Memory: activations that the backward keeps are recomputed per ViT block
and per image of the decode head (``torch.utils.checkpoint``), so that a
float32 step of four plus four 801 x 801 crops fits one card.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0   # the largest finite float8 e4m3 value


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, name='fp32'):
        if name not in ('fp32', 'fp8'):
            raise ValueError(f'precision {name!r}: fp32 or fp8')
        self.name = name

    def __call__(self, t):
        if self.name == 'fp32':
            return t
        s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        tq = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
        return t + (tq - t.detach())   # the gradient passes straight through


# ---------------------------------------------------------------- resize

def _source_coords(out_size, in_size, align_corners):
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1)
        return i * (in_size - 1) / (out_size - 1)
    scale = in_size / out_size
    return i * scale + 0.5 * scale - 0.5


def _cubic(x, a=-0.75):
    x = np.abs(x)
    out = np.zeros_like(x)
    m1, m2 = x <= 1, (x > 1) & (x < 2)
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


@functools.lru_cache(maxsize=128)
def axis_matrix(out_size, in_size, mode, align_corners):
    """(out, in) float64 interpolation weights of ``F.interpolate``."""
    if out_size == in_size:
        return np.eye(out_size)
    src = _source_coords(out_size, in_size, align_corners)
    w = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    if mode == 'bilinear':
        if not align_corners:
            src = np.clip(src, 0.0, None)
        x0 = np.floor(src).astype(np.int64)
        frac = src - x0
        np.add.at(w, (rows, np.clip(x0, 0, in_size - 1)), 1.0 - frac)
        np.add.at(w, (rows, np.clip(x0 + 1, 0, in_size - 1)), frac)
    elif mode == 'bicubic':
        x0 = np.floor(src).astype(np.int64)
        for t in (-1, 0, 1, 2):
            idx = x0 + t
            np.add.at(w, (rows, np.clip(idx, 0, in_size - 1)),
                      _cubic(src - idx))
    else:
        raise ValueError(mode)
    return w


def resize_hw(x, out_hw, mode='bilinear', align_corners=False):
    """Resize the last two axes of ``x`` in float32 (float64 kept)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    if (h, w) == (oh, ow):
        return x.to(dt)
    wh = torch.as_tensor(axis_matrix(oh, h, mode, align_corners), dtype=dt,
                         device=x.device)
    ww = torch.as_tensor(axis_matrix(ow, w, mode, align_corners), dtype=dt,
                         device=x.device)
    return torch.matmul(torch.matmul(wh, x.to(dt)), ww.t())


# ------------------------------------------------------------ parameters

def _vit_shapes(p, cfg):
    c, ps = cfg['embed_dims'], cfg['patch_size']
    hidden = cfg['mlp_ratio'] * c
    gh, gw = (s // ps for s in cfg['img_size'])
    out = {f'{p}.patch_embed.projection.weight': (c, 3, ps, ps),
           f'{p}.cls_token': (1, 1, c), f'{p}.pos_embed': (1, gh * gw + 1, c),
           f'{p}.ln0.weight': (c,), f'{p}.ln0.bias': (c,),
           f'{p}.ln1.weight': (c,), f'{p}.ln1.bias': (c,),
           f'{p}.proj.weight': (cfg['clip_dim'], c, 1, 1)}
    for i in range(cfg['num_layers']):
        out.update(_block_shapes(f'{p}.layers.{i}', c, hidden))
    return out


def _block_shapes(p, c, hidden):
    return {f'{p}.ln1.weight': (c,), f'{p}.ln1.bias': (c,),
            f'{p}.ln2.weight': (c,), f'{p}.ln2.bias': (c,),
            f'{p}.attn.attn.in_proj_weight': (3 * c, c),
            f'{p}.attn.attn.in_proj_bias': (3 * c,),
            f'{p}.attn.attn.out_proj.weight': (c, c),
            f'{p}.attn.attn.out_proj.bias': (c,),
            f'{p}.ffn.layers.0.0.weight': (hidden, c),
            f'{p}.ffn.layers.0.0.bias': (hidden,),
            f'{p}.ffn.layers.1.weight': (c, hidden),
            f'{p}.ffn.layers.1.bias': (c,)}


def _cgr_shapes(p, cin, cout, k):
    return {f'{p}.0.weight': (cout, cin, k, k), f'{p}.1.weight': (cout,),
            f'{p}.1.bias': (cout,)}


def _head_shapes(p, cfg):
    c, ct = cfg['channels'], cfg['text_channels']
    k = cfg['conv1_ksize']
    out = {f'{p}.conv1.weight': (c, 1, k, k), f'{p}.conv1.bias': (c,),
           f'{p}.text_proj.0.weight': (ct, cfg['text_in_channels']),
           f'{p}.text_proj.0.bias': (ct,)}
    for i in range(4):
        out.update(_cgr_shapes(f'{p}.aspp.aspp_convs.{i}', c, c,
                               1 if i == 0 else 3))
    out.update({f'{p}.aspp.aspp_convs.4.gap.1.weight': (c, c, 1, 1),
                f'{p}.aspp.aspp_convs.4.gap.2.weight': (c,),
                f'{p}.aspp.aspp_convs.4.gap.2.bias': (c,)})
    out.update(_cgr_shapes(f'{p}.aspp.project', 5 * c, c, 1))
    for i in range(cfg['num_layers']):
        out.update(_block_shapes(f'{p}.layers.{i}.transformer', c + ct,
                                 4 * c))
    for i, (ci, co) in enumerate(zip(cfg['skip_in_channels'],
                                     cfg['skip_channels'])):
        out[f'{p}.skip_proj.{i}.0.weight'] = (co, ci, 3, 3)
        out[f'{p}.skip_proj.{i}.0.bias'] = (co,)
    cin = c
    for j, (cout, cs) in enumerate(zip(cfg['up_channels'],
                                       cfg['skip_channels'])):
        q, cu = f'{p}.up{j + 1}', cin - cs
        out.update({f'{q}.up.weight': (cin, cu, 2, 2), f'{q}.up.bias': (cu,),
                    f'{q}.conv.0.weight': (cout, cin, 3, 3),
                    f'{q}.conv.1.weight': (cout,), f'{q}.conv.1.bias': (cout,),
                    f'{q}.conv.3.weight': (cout, cout, 3, 3),
                    f'{q}.conv.4.weight': (cout,),
                    f'{q}.conv.4.bias': (cout,)})
        cin = cout
    out[f'{p}.head.weight'] = (1, cin, 3, 3)
    out[f'{p}.head.bias'] = (1,)
    return out


RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STEM_WIDTHS = (32, 32, 64)


def _bn(p, c):
    return {f'{p}.weight': (c,), f'{p}.bias': (c,)}


def _resnet_shapes(p, cfg):
    w1, w2, w3 = STEM_WIDTHS
    out = {f'{p}.stem.0.weight': (w1, 3, 3, 3), f'{p}.stem.3.weight':
           (w2, w1, 3, 3), f'{p}.stem.6.weight': (w3, w2, 3, 3)}
    out.update(_bn(f'{p}.stem.1', w1))
    out.update(_bn(f'{p}.stem.4', w2))
    out.update(_bn(f'{p}.stem.7', w3))
    cin = w3
    for s in range(cfg['num_stages']):
        planes = 64 * 2 ** s
        for b in range(RESNET_BLOCKS[cfg['depth']][s]):
            q = f'{p}.layer{s + 1}.{b}'
            out.update({f'{q}.conv1.weight': (planes, cin, 1, 1),
                        f'{q}.conv2.weight': (planes, planes, 3, 3),
                        f'{q}.conv3.weight': (4 * planes, planes, 1, 1)})
            out.update(_bn(f'{q}.bn1', planes))
            out.update(_bn(f'{q}.bn2', planes))
            out.update(_bn(f'{q}.bn3', 4 * planes))
            if b == 0:
                out[f'{q}.downsample.0.weight'] = (4 * planes, cin, 1, 1)
                out.update(_bn(f'{q}.downsample.1', 4 * planes))
            cin = 4 * planes
    return out


def param_shapes(arch):
    """{name: shape} of every parameter of the model ``arch`` describes
    (the configuration file's ``architecture``)."""
    out = _vit_shapes('backbone', arch['backbone'])
    out.update(_head_shapes('decode_head', arch['decode_head']))
    if arch.get('conv_encoder'):
        out.update(_resnet_shapes('conv_encoder', arch['conv_encoder']))
    if arch.get('clip_encoder'):
        out.update(_vit_shapes('clip_encoder', arch['clip_encoder']))
    return out


def buffer_shapes(arch):
    """{name: shape} of the BatchNorm running statistics."""
    return {n[:-len('weight')] + s: shp for n, shp in param_shapes(arch).items()
            if n.startswith('conv_encoder') and len(shp) == 1
            and n.endswith('weight') for s in ('running_mean', 'running_var')}


def init_buffers(arch, device):
    return {n: (torch.zeros if n.endswith('mean') else torch.ones)(
        shp, device=device) for n, shp in buffer_shapes(arch).items()}


def is_trainable(name, arch):
    """The published freeze rule: the guidance encoder is frozen; with
    ``freeze_backbone`` the backbone is too, but for names holding one of
    ``exclude_keys``."""
    if name.startswith('clip_encoder'):
        return False
    if arch.get('freeze_backbone') and name.startswith('backbone'):
        return any(k in name for k in arch.get('exclude_keys') or ())
    return True


# ------------------------------------------------------------------ ViT

def _layer_norm(x, P, p, eps):
    return F.layer_norm(x, x.shape[-1:], P[f'{p}.weight'], P[f'{p}.bias'],
                        eps)


def _linear(x, P, p, q):
    b = P.get(f'{p}.bias')
    return F.linear(q(x), q(P[f'{p}.weight']), b)


def _attention(x, P, p, heads, q):
    """torch ``MultiheadAttention`` math in float32; returns (out, v)."""
    c = x.shape[-1]
    qkv = F.linear(q(x), q(P[f'{p}.in_proj_weight']), P[f'{p}.in_proj_bias'])
    qq, k, v = qkv.split(c, dim=-1)
    b, n, d = x.shape[0], x.shape[1], c // heads

    def split(t):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    s = torch.matmul(q(split(qq) * d ** -0.5), q(split(k)).transpose(-1, -2))
    a = torch.matmul(q(torch.softmax(s, dim=-1)), q(split(v)))
    a = a.transpose(1, 2).reshape(b, n, c)
    return _linear(a, P, f'{p}.out_proj', q), v


def _block(x, P, p, heads, eps, q, need_v):
    """Pre-LN block with the MaskCLIP v-path (module docstring of the
    reference's maskclip_vit.py:110-118)."""
    def ffn(t):
        h = F.gelu(_linear(_layer_norm(t, P, f'{p}.ln2', eps), P,
                           f'{p}.ffn.layers.0.0', q))
        return _linear(h, P, f'{p}.ffn.layers.1', q)

    a, v = _attention(_layer_norm(x, P, f'{p}.ln1', eps), P, f'{p}.attn.attn',
                      heads, q)
    out = x + a
    out = out + ffn(out)
    if not need_v:
        return out, None
    v = _linear(v, P, f'{p}.attn.attn.out_proj', q) + x
    return out, v + ffn(v)


def l2n(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def vit_forward(P, p, cfg, img, q, ckpt=False):
    """(B, H, W, 3) -> (feats tuple of NHWC grids, global embedding)."""
    b, h, w, _ = img.shape
    ps, heads = cfg['patch_size'], cfg['num_heads']
    eps = cfg.get('norm_eps', 1e-6)
    nl = cfg['num_layers']
    out_indices = tuple(cfg['out_indices']) if cfg.get('out_indices') \
        is not None else (nl,)
    x = F.pad(img.permute(0, 3, 1, 2), (0, (-w) % ps, 0, (-h) % ps))
    gh, gw = x.shape[2] // ps, x.shape[3] // ps
    x = F.conv2d(q(x), q(P[f'{p}.patch_embed.projection.weight']), stride=ps)
    x = x.flatten(2).transpose(1, 2)
    c = x.shape[-1]
    x = torch.cat([P[f'{p}.cls_token'].expand(b, 1, c), x], dim=1)
    pos = P[f'{p}.pos_embed']
    ph, pw = (s // ps for s in cfg['img_size'])
    if (gh, gw) != (ph, pw):
        grid = pos[0, 1:].reshape(ph, pw, c).permute(2, 0, 1)
        grid = resize_hw(grid, (gh, gw), 'bicubic', False)
        pos = torch.cat([pos[:, :1], grid.permute(1, 2, 0).reshape(
            1, gh * gw, c)], dim=1)
    x = _layer_norm(x + pos, P, f'{p}.ln0', eps)

    def grid(t):
        return t[:, 1:].reshape(b, gh, gw, c)

    feats, v = [], None
    for i in range(nl):
        need_v = i in out_indices or i == nl - 1
        fn = functools.partial(_block, P=P, p=f'{p}.layers.{i}', heads=heads,
                               eps=eps, q=q, need_v=need_v)
        if ckpt and torch.is_grad_enabled():
            x, v = checkpoint(fn, x, use_reentrant=False)
        else:
            x, v = fn(x)
        if i == nl - 1:
            x = _layer_norm(x, P, f'{p}.ln1', eps)
            v = _layer_norm(v, P, f'{p}.ln1', eps)
        if i in out_indices:
            feats.append(grid(v))
    wproj = P[f'{p}.proj.weight'][:, :, 0, 0]
    if nl in out_indices:
        feats.append(l2n(F.linear(q(grid(v)), q(wproj))))
    return tuple(feats), l2n(F.linear(q(x[:, 0]), q(wproj)))


# ---------------------------------------------------------------- ResNet

def _batch_norm(x, P, B, p, train, momentum=0.9, eps=1e-5):
    """flax BatchNorm: batch statistics with the biased variance in train
    mode, running statistics updated as ``0.9 r + 0.1 batch``."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0)
        with torch.no_grad():
            B[f'{p}.running_mean'].mul_(momentum).add_((1 - momentum) * mean)
            B[f'{p}.running_var'].mul_(momentum).add_((1 - momentum) * var)
    else:
        mean, var = B[f'{p}.running_mean'], B[f'{p}.running_var']
    scale = torch.rsqrt(var + eps) * P[f'{p}.weight']
    return (x - mean[:, None, None]) * scale[:, None, None] \
        + P[f'{p}.bias'][:, None, None]


def _conv_bn(x, P, B, conv, bn, train, q, stride=1, relu=False):
    w = P[f'{conv}.weight']
    y = _batch_norm(F.conv2d(q(x), q(w), stride=stride,
                             padding=(w.shape[-1] - 1) // 2), P, B, bn, train)
    return F.relu(y) if relu else y


def resnet_forward(P, B, p, cfg, img, train, q):
    """ResNetV1c (deep stem, bottleneck stages) on NHWC; NHWC outputs."""
    x = img.permute(0, 3, 1, 2)
    x = _conv_bn(x, P, B, f'{p}.stem.0', f'{p}.stem.1', train, q, 2, True)
    x = _conv_bn(x, P, B, f'{p}.stem.3', f'{p}.stem.4', train, q, 1, True)
    x = _conv_bn(x, P, B, f'{p}.stem.6', f'{p}.stem.7', train, q, 1, True)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for s in range(cfg['num_stages']):
        for b in range(RESNET_BLOCKS[cfg['depth']][s]):
            k = f'{p}.layer{s + 1}.{b}'
            stride = 2 if s > 0 and b == 0 else 1
            y = _conv_bn(x, P, B, f'{k}.conv1', f'{k}.bn1', train, q, 1, True)
            y = _conv_bn(y, P, B, f'{k}.conv2', f'{k}.bn2', train, q, stride,
                         True)
            y = _conv_bn(y, P, B, f'{k}.conv3', f'{k}.bn3', train, q)
            if b == 0:
                x = _conv_bn(x, P, B, f'{k}.downsample.0', f'{k}.downsample.1',
                             train, q, stride)
            x = F.relu(y + x)
        if s in cfg['out_indices']:
            outs.append(x.permute(0, 2, 3, 1))
    return outs


# ----------------------------------------------------------- VLG head

def _conv(x, P, p, q, dilation=1, bias=True):
    w = P[f'{p}.weight']
    return F.conv2d(q(x), q(w), P[f'{p}.bias'] if bias else None,
                    padding=(w.shape[-1] - 1) // 2 * dilation,
                    dilation=dilation)


def _gn_relu(x, P, p):
    c = x.shape[1]
    return F.relu(F.group_norm(x, max(c // 16, 1), P[f'{p}.weight'],
                               P[f'{p}.bias'], eps=1e-5))


def _pool_matrix(out_size, in_size, win, like):
    w = torch.zeros(out_size, in_size, device=like.device, dtype=like.dtype)
    for i in range(out_size):
        w[i, i * win:(i + 1) * win] = 1.0 / win
    return w


def _up_stage(x, skip, P, p, q):
    """Transpose conv 2x2/2, concat with the image's skip, two 3x3 conv +
    GroupNorm + ReLU; x is (N, Cin, h, w) planes of one image."""
    wu = P[f'{p}.up.weight']
    up = torch.einsum('bchw,coij->bohiwj', q(x), q(wu))
    n, cu, h = up.shape[0], up.shape[1], x.shape[2]
    up = up.reshape(n, cu, 2 * h, 2 * x.shape[3]) + P[f'{p}.up.bias'][:, None,
                                                                     None]
    y = torch.cat([up, skip.expand(n, -1, -1, -1)], dim=1)
    y = _gn_relu(_conv(y, P, f'{p}.conv.0', q, bias=False), P, f'{p}.conv.1')
    return _gn_relu(_conv(y, P, f'{p}.conv.3', q, bias=False), P,
                    f'{p}.conv.4')


def _head_one(img_feat, skips, text, P, cfg, out_hw, q, concepts):
    """The VLG head on one image: img_feat (h, w, 512), skips a list of
    (Ci, hi, wi) maps, text (N, 512) -> (num_classes, H, W) logits."""
    p = 'decode_head'
    h, w = img_feat.shape[:2]
    n = text.shape[0]
    text_n = l2n(text)
    x = torch.einsum('hwc,nc->nhw', q(l2n(img_feat)), q(text_n))[:, None]
    # 2. spatial reasoning: 7x7 conv + residual GroupNorm ASPP per plane
    x = _conv(x, P, f'{p}.conv1', q)
    a = f'{p}.aspp.aspp_convs'
    branches = [_gn_relu(_conv(x, P, f'{a}.{i}.0', q, dilation=r, bias=False),
                         P, f'{a}.{i}.1')
                for i, r in enumerate((1, 6, 12, 18))]
    pooled = _gn_relu(_conv(x.mean(dim=(2, 3), keepdim=True), P,
                            f'{a}.4.gap.1', q, bias=False), P, f'{a}.4.gap.2')
    branches.append(pooled.expand_as(x))
    x = x + _gn_relu(_conv(torch.cat(branches, 1), P, f'{p}.aspp.project.0',
                           q, bias=False), P, f'{p}.aspp.project.1')
    # 3. semantic reasoning across the class axis at pooled locations
    tokens_t = F.relu(_linear(text_n, P, f'{p}.text_proj.0', q))
    c = x.shape[1]
    ph, pw = cfg['pool_size']
    hp, wp = h // ph, w // pw
    mh = _pool_matrix(hp, h, ph, x)
    mw = _pool_matrix(wp, w, pw, x)
    uh = torch.as_tensor(axis_matrix(h, hp, 'bilinear', True),
                         dtype=x.dtype, device=x.device)
    uw = torch.as_tensor(axis_matrix(w, wp, 'bilinear', True),
                         dtype=x.dtype, device=x.device)
    for i in range(cfg['num_layers']):
        t = torch.einsum('ph,qw,nchw->pqnc', q(mh), q(mw), q(x))
        t = torch.cat([t, tokens_t.expand(hp, wp, n, -1)], dim=-1)
        t, _ = _block(t.reshape(hp * wp, n, -1), P,
                      f'{p}.layers.{i}.transformer', cfg['num_heads'], 1e-6,
                      q, False)
        t = t[..., :c].reshape(hp, wp, n, c)
        x = x + torch.einsum('hp,wq,pqnc->nchw', uh, uw, t)
    # 4. skip projections, the two Up stages and the head, per plane
    s = [F.relu(_conv(f[None], P, f'{p}.skip_proj.{i}.0', q))
         for i, f in enumerate(skips)]
    s1 = resize_hw(s[0], (2 * h, 2 * w), 'bilinear', True)
    s2 = resize_hw(s[1], (4 * h, 4 * w), 'bilinear', True)
    x = _up_stage(x, s1, P, f'{p}.up1', q)
    x = _up_stage(x, s2, P, f'{p}.up2', q)
    x = _conv(x, P, f'{p}.head', q)[:, 0]
    # 5. concepts max-aggregated to classes
    if concepts is not None:
        x = torch.stack([x[idx].amax(0) for idx in concepts])
    # 6. resize to the output size
    return resize_hw(x, out_hw, 'bilinear', cfg['align_corners'])


def head_forward(P, cfg, feats, text, conv_feats, out_hw, q, ckpt=False,
                 concepts=None):
    """The VLG head over a batch, one image at a time (every operation of
    the head acts within one image)."""
    skips = list(feats[:-1])[::-1]
    if cfg.get('skip_from_conv_feat'):
        skips += list(conv_feats)[::-1]
    outs = []
    for b in range(feats[-1].shape[0]):
        args = [feats[-1][b]] + [s[b].permute(2, 0, 1) for s in skips]

        def one(img_feat, *sk):
            return _head_one(img_feat, list(sk), text, P, cfg, out_hw, q,
                             concepts)

        if ckpt and torch.is_grad_enabled():
            outs.append(checkpoint(one, *args, use_reentrant=False))
        else:
            outs.append(one(*args))
    return torch.stack(outs)


# ------------------------------------------------------------------ VLM

def renorm_clip(img):
    def c(v):
        return torch.tensor(v, dtype=img.dtype, device=img.device)
    return (img * c(IMAGENET_STD) + c(IMAGENET_MEAN) - c(CLIP_MEAN)) \
        / c(CLIP_STD)


def dropout2d(x, rate, generator):
    """Whole channels of NHWC ``x`` zeroed with probability ``rate``, the
    rest scaled by 1 / (1 - rate); the draws are one uniform per sample and
    channel from ``generator``."""
    u = torch.rand((x.shape[0], 1, 1, x.shape[-1]), generator=generator,
                   device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros_like(x))


def vlm_forward(P, B, arch, img, text, q, need_fp=False, generator=None,
                train=False, ckpt=False, concepts=None):
    """Logits (B, num_classes, H, W); with ``need_fp`` also those of the
    second half of the batch decoded from channel-dropped feature maps."""
    vit_in = renorm_clip(img) if arch.get('renorm_clip_img') else img
    feats, _ = vit_forward(P, 'backbone', arch['backbone'], vit_in, q, ckpt)
    conv_feats = None
    if arch.get('conv_encoder'):
        conv_feats = resnet_forward(P, B, 'conv_encoder',
                                    arch['conv_encoder'], img, train, q)
    b = img.shape[0]
    rate = arch['fp_rate']
    if need_fp:
        feats = tuple(torch.cat([f, dropout2d(f[b // 2:], rate, generator)])
                      for f in feats)
        if conv_feats is not None:
            conv_feats = [torch.cat([f, dropout2d(f[b // 2:], rate,
                                                  generator)])
                          for f in conv_feats]
    logits = head_forward(P, arch['decode_head'], feats, text, conv_feats,
                          tuple(img.shape[1:3]), q, ckpt, concepts)
    if need_fp:
        return logits[:b], logits[b:]
    return logits


@torch.no_grad()
def maskclip_labels(P, arch, img, text_mcc, conf_thresh, q, concepts=None):
    """Guidance labels of the frozen CLIP encoder: argmax of softmax(100 x
    the dense similarity, concept maxima per class, resized to the image),
    255 below ``conf_thresh``."""
    vit_in = renorm_clip(img) if arch.get('renorm_clip_img') else img
    feats, _ = vit_forward(P, 'clip_encoder', arch['clip_encoder'], vit_in, q)
    dense = torch.einsum('bhwc,nc->bnhw', q(feats[-1]), q(text_mcc))
    if concepts is not None:
        dense = torch.stack([dense[:, idx].amax(1) for idx in concepts], 1)
    dense = resize_hw(dense, tuple(img.shape[1:3]), 'bilinear',
                      arch['decode_head']['align_corners'])
    conf, label = torch.softmax(100.0 * dense, dim=1).max(dim=1)
    return torch.where(conf < conf_thresh, torch.full_like(label, 255), label)


def concept_index(per_class):
    """Class -> list of concept rows, concepts listed class after class."""
    out, k = [], 0
    for n in per_class:
        out.append(list(range(k, k + n)))
        k += n
    return out
