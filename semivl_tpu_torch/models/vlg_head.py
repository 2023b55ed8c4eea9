"""Vision-language-guided (VLG) decoder head (counterpart of
``semivl_tpu/models/vlg_head.py``).

1. similarity map between the L2-normalised dense CLIP embedding and the
   class text embeddings;
2. 7x7 conv + residual GroupNorm-ASPP over each class plane (B*N planes);
3. SemanticTransformer layers attending across the class axis at every
   pooled location, with a projected text token per class;
4. two Up stages (transpose conv, skip conv, GN/ReLU twice) and the 3x3
   head, through ``ops.fused_decoder.fused_vlg_decoder``;
5. bilinear resize to the output size.

Planes are NCHW inside; parameters carry the reference's torch names
(reference model/decode_heads/vlg_head.py:140-251).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.layers import (
    TransformerBlock,
    l2_normalize,
    linear,
)
from semivl_tpu_torch.ops import fused_decoder
from semivl_tpu_torch.ops.resize import axis_weights, resize_hw


@functools.lru_cache(maxsize=64)
def _pool_matrix(out_size, in_size, win):
    """(out, in) matrix of AvgPool1d(win, stride=win), floor mode: tail
    rows dropped as torch ``nn.AvgPool2d`` does."""
    w = np.zeros((out_size, in_size), np.float32)
    for p in range(out_size):
        w[p, p * win:(p + 1) * win] = 1.0 / win
    return w


def conv(x, layer, dilation=1):
    """``layer`` (an ``nn.Conv2d`` with 'same' padding) in x's dtype."""
    pad = (layer.kernel_size[0] - 1) // 2 * dilation
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), b, padding=pad,
                    dilation=dilation)


def conv_gn_relu(x, conv_layer, gn_layer, dilation=1):
    """Conv -> GroupNorm (float32 statistics) -> ReLU, in x's dtype."""
    return fused_decoder.gn_relu(conv(x, conv_layer, dilation),
                                 gn_layer.weight, gn_layer.bias)


def _cgr(cin, cout, k):
    return nn.Sequential(nn.Conv2d(cin, cout, k, bias=False),
                         nn.GroupNorm(cout // 16, cout), nn.ReLU())


class ASPPModule(nn.Module):
    """Residual GroupNorm ASPP, rates 1/6/12/18 (reference
    vlg_head.py:84-113)."""

    def __init__(self, c, rates=(1, 6, 12, 18)):
        super().__init__()
        self.rates = rates
        convs = [_cgr(c, c, 1 if r == 1 else 3) for r in rates]
        pool = nn.Module()
        pool.gap = nn.Sequential(nn.AdaptiveAvgPool2d(1), *_cgr(c, c, 1))
        self.aspp_convs = nn.ModuleList(convs + [pool])
        self.project = _cgr(5 * c, c, 1)

    def forward(self, x):
        feats = [conv_gn_relu(x, m[0], m[1], r)
                 for m, r in zip(self.aspp_convs, self.rates)]
        gap = self.aspp_convs[-1].gap
        pooled = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        pooled = conv_gn_relu(pooled, gap[1], gap[2])
        # bilinear align_corners=True upsample of a 1x1 map == broadcast
        feats.append(pooled.expand_as(x))
        y = conv_gn_relu(torch.cat(feats, dim=1), self.project[0],
                         self.project[1])
        return x + y


class Up(nn.Module):
    """Transpose-conv 2x upsample + skip concat + double conv
    (reference vlg_head.py:116-137); run by ``fused_vlg_decoder``."""

    def __init__(self, in_channels, out_channels, skip_channels):
        super().__init__()
        up_c = in_channels - skip_channels
        self.up = nn.ConvTranspose2d(in_channels, up_c, 2, stride=2)
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.GroupNorm(out_channels // 16, out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.GroupNorm(out_channels // 16, out_channels), nn.ReLU())

    def stage_params(self):
        c = self.conv
        return dict(up_weight=self.up.weight, up_bias=self.up.bias,
                    conv1_weight=c[0].weight, gn1_weight=c[1].weight,
                    gn1_bias=c[1].bias, conv2_weight=c[3].weight,
                    gn2_weight=c[4].weight, gn2_bias=c[4].bias)


class SemanticTransformer(nn.Module):
    """Attention across the class axis at pooled locations
    (reference vlg_head.py:27-67), pool and unpool as products with
    constant matrices (JAX ``impl='einsum'``)."""

    def __init__(self, channels, text_channels, num_heads, pool_size,
                 dtype=torch.float32):
        super().__init__()
        self.pool_size = tuple(pool_size)
        self.transformer = TransformerBlock(
            channels + text_channels, num_heads, 4 * channels, 1e-6,
            dtype=dtype)

    def forward(self, x, text_tokens):
        # x: (B, N, C, H, W) class planes; text_tokens: (B, N, Ct)
        b, n, c, h, w = x.shape
        ph, pw = self.pool_size
        hp, wp = h // ph, w // pw
        p_h = torch.from_numpy(_pool_matrix(hp, h, ph)).to(x)
        p_w = torch.from_numpy(_pool_matrix(wp, w, pw)).to(x)
        tokens = torch.einsum('ph,qw,bnchw->bpqnc', p_h, p_w, x)
        text = text_tokens[:, None, None].expand(b, hp, wp, n, -1)
        tokens = torch.cat([tokens, text.to(tokens.dtype)], dim=-1)
        tokens, _ = self.transformer(tokens.reshape(b * hp * wp, n, -1))
        t5 = tokens[..., :c].reshape(b, hp, wp, n, c).float()
        # unpool: bilinear align_corners=True back to (h, w), float32
        u_h = axis_weights(h, hp, 'bilinear', True, x.device)
        u_w = axis_weights(w, wp, 'bilinear', True, x.device)
        y = torch.einsum('hp,wq,bpqnc->bnchw', u_h, u_w, t5)
        return x + y.to(x.dtype)


class VLGHead(nn.Module):

    def __init__(self, img_size, num_classes, text_in_channels=512,
                 text_channels=128, up_channels=(64, 32),
                 skip_in_channels=(768, 768), skip_channels=(32, 16),
                 num_layers=2, num_heads=4, channels=128, pool_size=(4, 4),
                 conv1_ksize=7, align_corners=False, dtype=torch.float32):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.align_corners = align_corners
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, channels, conv1_ksize,
                               padding=(conv1_ksize - 1) // 2)
        self.aspp = ASPPModule(channels)
        self.text_proj = nn.Sequential(
            nn.Linear(text_in_channels, text_channels), nn.ReLU())
        self.layers = nn.ModuleList(
            SemanticTransformer(channels, text_channels, num_heads,
                                pool_size, dtype)
            for _ in range(num_layers))
        self.skip_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(ci, co, 3, padding=1), nn.ReLU())
            for ci, co in zip(skip_in_channels, skip_channels))
        self.up1 = Up(channels, up_channels[0], skip_channels[0])
        self.up2 = Up(up_channels[0], up_channels[1], skip_channels[1])
        self.head = nn.Conv2d(up_channels[1], 1, 3, padding=1)

    def forward(self, feats, text_feats, output_size=None):
        """feats: NHWC maps (pyramid..., dense CLIP embedding last);
        text_feats: (N, Ct) or (B, N, Ct). Returns float32
        (B, num_classes, out_h, out_w) logits."""
        dt = self.dtype
        img_feats = feats[-1]
        skip_feats = list(feats[:-1])[::-1]
        b, h, w, _ = img_feats.shape
        if text_feats.ndim == 2:
            text_feats = text_feats[None].expand(b, -1, -1)
        n = text_feats.shape[1]
        if n != self.num_classes:
            raise NotImplementedError(
                'concept -> class aggregation (N != num_classes) is not '
                'ported; use a single-prompt text embedding')

        # 1. similarity map (reference vlg_head.py:214-217)
        img_n = l2_normalize(img_feats.to(dt), dim=-1)
        text_n = l2_normalize(text_feats.to(dt), dim=-1)
        x = torch.einsum('bhwc,bnc->bnhw', img_n, text_n)

        # 2. spatial reasoning on (B*N, 1, h, w) planes
        x = conv(x.reshape(b * n, 1, h, w), self.conv1)
        x = self.aspp(x)

        # 3. semantic reasoning; text_proj takes the normalised text
        text_tokens = F.relu(linear(text_n, self.text_proj[0]))
        x = x.reshape(b, n, -1, h, w)
        for layer in self.layers:
            x = layer(x, text_tokens)

        # 4. skip projections, resized to each stage's output size
        s1, s2 = (F.relu(conv(f.permute(0, 3, 1, 2).to(dt), m[0]))
                  for f, m in zip(skip_feats, self.skip_proj))
        s1 = resize_hw(s1, (2 * h, 2 * w), 'bilinear', True)
        s2 = resize_hw(s2, (4 * h, 4 * w), 'bilinear', True)
        head = dict(weight=self.head.weight, bias=self.head.bias)
        logits = fused_decoder.fused_vlg_decoder(
            x.reshape(b * n, -1, h, w).contiguous(), s1.contiguous(),
            s2.contiguous(), self.up1.stage_params(),
            self.up2.stage_params(), head)
        x = logits.reshape(b, n, 4 * h, 4 * w)

        # 5. resize to the output size (reference vlg_head.py:246-249)
        out_hw = output_size or (self.img_size, self.img_size)
        return resize_hw(x.float(), out_hw, 'bilinear', self.align_corners)
