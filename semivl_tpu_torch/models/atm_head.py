"""ZegCLIP's ATM decoder head (counterpart of
``semivl_tpu/models/atm_head.py``).

Per-class queries (the text embedding; with ``use_rd`` the "relationship
descriptor" concat(global_emb * text, text)) cross-attend to the patch
tokens over ``num_layers`` post-norm decoder layers, and the head-mean of
each layer's *pre-softmax* attention logits is that layer's mask
(reference atm_head.py:84-120, 309-380). A concept text (N != num_classes)
is max-aggregated to classes per layer; the last layer's masks are resized
bilinearly in float32 to the output size.

The cross-attention (N queries over H*W keys) is plain PyTorch matmuls: JAX
computes it with einsum outside any Pallas kernel (its dispatcher sends
unequal q and kv lengths to XLA, ``ops/attention.py:95-100``). Parameter
names are the flax scopes' (``q_proj``, ``decoder.<i>.attn.q``,
``decoder.<i>.norm2``, ...).
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.layers import LayerNorm, linear
from semivl_tpu_torch.ops.resize import resize_hw
from semivl_tpu_torch.text.embeddings import (
    aggregate_concept_predictions,
    get_class_to_concept_idxs,
)


class CrossAttention(nn.Module):
    """Separate q/k/v projections (q scaled by d^-1/2 after its
    projection); returns the output and the head-mean of the pre-softmax
    logits in float32, (B, Nq, Nk). The softmax is float32, cast back to
    v's dtype (JAX :27-57)."""

    def __init__(self, dim, kv_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(kv_dim, dim)
        self.v = nn.Linear(kv_dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, xq, xkv):
        b, nq, c = xq.shape
        h = self.num_heads
        d = c // h

        def heads(x):
            return x.reshape(b, x.shape[1], h, d).transpose(1, 2)

        q = heads(linear(xq, self.q)) * (d ** -0.5)
        k = heads(linear(xkv, self.k))
        v = heads(linear(xkv, self.v))
        logits = q @ k.transpose(-1, -2)                     # (B, h, Nq, Nk)
        mask = logits.float().mean(dim=1)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, nq, c)
        return linear(out, self.proj), mask


class TPNDecoderLayer(nn.Module):
    """Post-norm decoder layer, cross-attention only (the reference creates
    a self-attention it never calls; neither JAX nor this has one): the
    LayerNorms in float32 at eps 1e-5, cast back to the compute dtype."""

    def __init__(self, dim, kv_dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.attn = CrossAttention(dim, kv_dim, num_heads)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.linear1 = nn.Linear(dim, 4 * dim)
        self.linear2 = nn.Linear(4 * dim, dim)
        self.norm3 = LayerNorm(dim, 1e-5, dtype)

    def forward(self, tgt, memory):
        tgt2, mask = self.attn(tgt, memory)
        tgt = self.norm2(tgt + tgt2)
        tgt = tgt + linear(F.relu(linear(tgt, self.linear1)), self.linear2)
        return self.norm3(tgt), mask


class ATMSingleHeadSeg(nn.Module):
    """``in_channels`` is the width of the feature map and of the text (the
    512-d CLIP space); ``use_proj`` maps the tokens through ``input_proj``
    and ``proj_norm`` first (JAX's builder defaults it to True, the shipped
    model config sets False); ``text_embedding_name`` names the concept
    list of a concept text."""

    def __init__(self, img_size, num_classes, in_channels=512, embed_dims=512,
                 num_layers=3, num_heads=8, use_stages=1, use_proj=True,
                 use_rd=True, align_corners=False, text_embedding_name='',
                 dtype=torch.float32):
        super().__init__()
        if use_stages != 1:
            raise ValueError('ATMSingleHeadSeg: use_stages must be 1 (the '
                             'multi-stage lateral path is in no config)')
        self.img_size = img_size
        self.num_classes = num_classes
        self.use_proj = use_proj
        self.use_rd = use_rd
        self.align_corners = align_corners
        self.text_embedding_name = text_embedding_name
        self.dtype = dtype
        if use_proj:
            self.input_proj = nn.Linear(in_channels, embed_dims)
            self.proj_norm = LayerNorm(embed_dims, 1e-5, dtype)
        self.q_proj = nn.Linear((2 if use_rd else 1) * in_channels,
                                embed_dims)
        kv_dim = embed_dims if use_proj else in_channels
        self.decoder = nn.ModuleList(
            TPNDecoderLayer(embed_dims, kv_dim, num_heads, dtype)
            for _ in range(num_layers))

    def forward(self, feats, text_feats, conv_feats=None, output_size=None,
                train=False, global_emb=None, return_aux=False):
        """feats: NHWC maps, the last one read (the dense CLIP embedding);
        text_feats: (N, C) or (B, N, C); global_emb: (B, C), the cls
        embedding, read with ``use_rd``. ``conv_feats`` and ``train`` are
        taken and ignored. Returns float32 (B, num_classes, out_h, out_w)
        mask logits; with ``return_aux`` also every layer's masks at the
        feature grid (JAX :147-156)."""
        del conv_feats, train
        dt = self.dtype
        x = feats[-1]
        b, gh, gw, c = x.shape
        memory = x.reshape(b, gh * gw, c).to(dt)
        if self.use_proj:
            memory = self.proj_norm(linear(memory, self.input_proj))
        text = text_feats if text_feats.ndim == 3 else \
            text_feats[None].expand(b, -1, -1)
        text = text.to(dt)
        n = text.shape[1]
        if self.use_rd:
            if global_emb is None:
                raise ValueError('ATMSingleHeadSeg: use_rd reads the '
                                 'global (cls) embedding')
            q = torch.cat([global_emb.to(dt)[:, None] * text, text], dim=-1)
        else:
            q = text
        q = linear(q, self.q_proj)
        cls2con = (get_class_to_concept_idxs(self.text_embedding_name)
                   if n != self.num_classes else None)
        masks = []
        for layer in self.decoder:
            q, attn = layer(q, memory)
            mask = attn.reshape(b, n, gh, gw)
            if cls2con is not None:
                mask = aggregate_concept_predictions(mask, cls2con)
            masks.append(mask)
        out_hw = output_size or (self.img_size, self.img_size)
        pred = resize_hw(masks[-1], out_hw, 'bilinear', self.align_corners)
        if return_aux:
            return pred, [resize_hw(m, (gh, gw), 'bilinear',
                                    self.align_corners) for m in masks]
        return pred
