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

from semivl_tpu_torch.ops import flash_attention


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

    q, k and v stay views of the one in_proj output (row stride 3C): the
    attention kernel reads them in place. Every self-attention of the model
    goes through ``flash_attention.flash_mha``: the kernel on the card, the
    plain version on the CPU (JAX ``ops/attention.py::multi_head_attention``
    routes the same way on a TPU)."""

    def __init__(self, dim, num_heads, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.attn = _PackedProj(dim, qkv_bias)

    def forward(self, x, return_v=False):
        p = self.attn
        b = None if p.in_proj_bias is None else p.in_proj_bias.to(x.dtype)
        qkv = F.linear(x, p.in_proj_weight.to(x.dtype), b)
        q, k, v = qkv.chunk(3, dim=-1)
        out = linear(flash_attention.flash_mha(q, k, v, self.num_heads),
                     p.out_proj)
        if return_v:
            return out, linear(v, p.out_proj)
        return out, None


def gelu_exact(x):
    """Exact erf GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x, approximate='none')


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 under mmcv FFN names (``layers.0.0``,
    ``layers.1``)."""

    def __init__(self, dim, hidden_dim):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(dim, hidden_dim)),
                                    nn.Linear(hidden_dim, dim))

    def forward(self, x):
        return linear(gelu_exact(linear(x, self.layers[0][0])),
                      self.layers[1])


class TransformerBlock(nn.Module):
    """Pre-LN encoder block with the MaskCLIP v-path.

    Regular path: ``x = x + attn(ln1(x)); x = x + ffn(ln2(x))``.
    v-path (``return_v=True``): ``v' = out_proj(v(ln1(x))) + x;
    v'' = v' + ffn(ln2(v'))`` — values propagated without attention mixing
    (reference maskclip_vit.py:110-118)."""

    def __init__(self, dim, num_heads, mlp_hidden, norm_eps=1e-6,
                 qkv_bias=True, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, norm_eps, dtype)
        self.ln2 = LayerNorm(dim, norm_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.ffn = Mlp(dim, mlp_hidden)

    def forward(self, x, return_v=False):
        attn_out, v = self.attn(self.ln1(x), return_v)
        if return_v:
            v = v + x
            v = v + self.ffn(self.ln2(v))
        x = x + attn_out
        x = x + self.ffn(self.ln2(x))
        return x, v
