"""Transformer building blocks (counterpart of
``semivl_tpu/models/layers.py``).

Parameters are float32 and named as the reference's torch modules
(mmcv ``TransformerEncoderLayer``: ``ln1``, ``attn.attn.in_proj_weight``,
``attn.attn.out_proj``, ``ffn.layers.0.0``, ``ffn.layers.1``); each module
computes in its ``dtype`` (bfloat16 on the card), with LayerNorm statistics
and the attention softmax in float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.ops import attention


def l2_normalize(x, dim=-1, eps=1e-12):
    """L2 normalisation in float32, output in the input dtype."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(norm, min=eps)).to(x.dtype)


def linear(x, layer):
    """``layer`` (an ``nn.Linear``) applied in x's dtype."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32, output cast to ``dtype``."""

    def __init__(self, dim, eps=1e-6, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class _PackedProj(nn.Module):
    """``nn.MultiheadAttention``'s parameter names: one (3C, C) in_proj and
    an out_proj ``Linear``."""

    def __init__(self, dim, qkv_bias=True):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = (nn.Parameter(torch.zeros(3 * dim)) if qkv_bias
                             else None)
        self.out_proj = nn.Linear(dim, dim)


class Attention(nn.Module):
    """Packed-QKV multi-head self-attention (torch MultiheadAttention math).

    The attention goes through the dispatcher ``ops.attention.qkv_attention``
    with this layer's ``impl`` ('auto' unless ``set_attention_impl`` sets
    another), which routes it as JAX ``ops/attention.py::
    multi_head_attention`` does: to the packed kernels, the head-split
    kernels or the plain math. The kernels
    read q, k and v in place from the one in_proj output (row stride 3C) and
    return one (B, L, 3C) gradient for it."""

    def __init__(self, dim, num_heads, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.impl = 'auto'
        self.attn = _PackedProj(dim, qkv_bias)

    def forward(self, x, return_v=False):
        p = self.attn
        b = None if p.in_proj_bias is None else p.in_proj_bias.to(x.dtype)
        qkv = F.linear(x, p.in_proj_weight.to(x.dtype), b)
        out = linear(attention.qkv_attention(qkv, self.num_heads, self.impl),
                     p.out_proj)
        if return_v:
            v = qkv[..., 2 * qkv.shape[-1] // 3:]
            return out, linear(v, p.out_proj)
        return out, None


def set_attention_impl(model, impl):
    """Route every attention layer of ``model`` through ``impl`` ('auto',
    'xla' or 'pallas'), as the run config key ``attention_impl`` asks (JAX
    ``train/loop.py:245-247`` sets a process-wide default instead)."""
    if impl not in attention.IMPLS:
        raise ValueError(f'attention_impl {impl!r}: one of {attention.IMPLS}')
    for m in model.modules():
        if isinstance(m, Attention):
            m.impl = impl


def gelu_exact(x):
    """Exact erf GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x, approximate='none')


def quick_gelu(x):
    """CLIP's QuickGELU: x * sigmoid(1.702 x) (JAX ``layers.quick_gelu``)."""
    return x * torch.sigmoid(1.702 * x)


class Mlp(nn.Module):
    """fc1 -> ``act`` (exact GELU) -> fc2, under mmcv FFN names
    (``layers.0.0``, ``layers.1``) or, with ``mmcv_names=False``, JAX's
    (``fc1``, ``fc2``: the CLIP blocks of the ZegCLIP ViTs)."""

    def __init__(self, dim, hidden_dim, act=gelu_exact, mmcv_names=True):
        super().__init__()
        self.act = act
        self.mmcv_names = mmcv_names
        fc1, fc2 = nn.Linear(dim, hidden_dim), nn.Linear(hidden_dim, dim)
        if mmcv_names:
            self.layers = nn.Sequential(nn.Sequential(fc1), fc2)
        else:
            self.fc1, self.fc2 = fc1, fc2

    def forward(self, x):
        fc1, fc2 = ((self.layers[0][0], self.layers[1]) if self.mmcv_names
                    else (self.fc1, self.fc2))
        return linear(self.act(linear(x, fc1)), fc2)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block with the MaskCLIP v-path.

    Regular path: ``x = x + attn(ln1(x)); x = x + ffn(ln2(x))``.
    v-path (``return_v=True``): ``v' = out_proj(v(ln1(x))) + x;
    v'' = v' + ffn(ln2(v'))`` — values propagated without attention mixing
    (reference maskclip_vit.py:110-118)."""

    def __init__(self, dim, num_heads, mlp_hidden, norm_eps=1e-6,
                 qkv_bias=True, dtype=torch.float32, act=gelu_exact,
                 mmcv_names=True):
        super().__init__()
        self.ln1 = LayerNorm(dim, norm_eps, dtype)
        self.ln2 = LayerNorm(dim, norm_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.ffn = Mlp(dim, mlp_hidden, act, mmcv_names)

    def forward(self, x, return_v=False):
        attn_out, v = self.attn(self.ln1(x), return_v)
        if return_v:
            v = v + x
            v = v + self.ffn(self.ln2(v))
        x = x + attn_out
        x = x + self.ffn(self.ln2(x))
        return x, v
