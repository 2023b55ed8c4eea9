"""Training-free MaskCLIP heads (counterpart of
``semivl_tpu/models/maskclip_heads.py``; reference
third_party/maskclip/models/decode_heads/{maskclip_head.py,
maskclip2_head.py}). They classify dense CLIP features with text
embeddings, in float32, as plain products: JAX computes them outside any
kernel, and no config or builder reaches them.

- ``MaskClip2Head``: a 1x1 convolution with the text embeddings, then a
  bilinear resize (maskclip2_head.py:29-33).
- ``MaskClipHead`` (the ViT path): the bias-free CLIP projection of the
  v-features, L2 normalisation, the text product, then the optional
  *prompt denoising* (classes whose best confidence anywhere is below
  ``pd_thresh`` get -100) and *key smoothing* (pixels below ``ks_thresh``
  take the key-affinity average of the probabilities;
  maskclip_head.py:71-155).
"""

import torch
from torch import nn

from semivl_tpu_torch.models.layers import l2_normalize, linear
from semivl_tpu_torch.ops.resize import resize


class MaskClip2Head(nn.Module):
    """The text product and a bilinear resize to the image size."""

    def __init__(self, img_size, align_corners=False):
        super().__init__()
        self.img_size = img_size
        self.align_corners = align_corners

    def forward(self, feat, text_embeddings, output_size=None):
        """feat: (B, h, w, Ct) L2-normalised dense CLIP embedding ->
        (B, N, H, W) float32 logits."""
        logits = torch.einsum('bhwc,nc->bhwn', feat,
                              text_embeddings.to(feat.dtype))
        out_hw = output_size or (self.img_size, self.img_size)
        logits = resize(logits.float(), out_hw, mode='bilinear',
                        align_corners=self.align_corners)
        return logits.permute(0, 3, 1, 2)


class MaskClipHead(nn.Module):
    """The ViT-path MaskCLIP head with key smoothing and prompt denoising;
    ``proj`` is JAX's bias-free Dense (its weight (text_channels,
    in_channels))."""

    def __init__(self, in_channels=768, text_channels=512, ks_thresh=0.0,
                 pd_thresh=0.0):
        super().__init__()
        self.proj = nn.Linear(in_channels, text_channels, bias=False)
        self.ks_thresh = ks_thresh
        self.pd_thresh = pd_thresh

    def forward(self, v_feat, text_embeddings, k_feat=None):
        """v_feat: (B, h, w, C) v-path features (before the projection);
        k_feat: (B, h, w, C) attention keys for key smoothing (optional).
        Returns (B, N, h, w) float32 class logits."""
        feat = l2_normalize(linear(v_feat.float(), self.proj), dim=-1)
        output = torch.einsum('bhwc,nc->bnhw', feat,
                              text_embeddings.float())
        if self.pd_thresh > 0:
            # prompt denoising (maskclip_head.py:130-135)
            probs = torch.softmax(output * 100.0, dim=1)
            max_cls_conf = probs.flatten(2).amax(dim=-1)
            suppress = (max_cls_conf < self.pd_thresh)[:, :, None, None]
            output = torch.where(suppress, -100.0, output)
        if k_feat is not None and self.ks_thresh > 0:
            # key smoothing (maskclip_head.py:137-153)
            b, n, h, w = output.shape
            probs = torch.softmax(output * 100.0, dim=1)
            probs = probs.reshape(b, n, h * w).transpose(1, 2)   # (B, HW, N)
            k = l2_normalize(k_feat.reshape(b, h * w, -1).float(), dim=-1)
            weight = torch.einsum('bqc,bkc->bqk', k, k)
            low_conf = probs.amax(dim=-1, keepdim=True) < self.ks_thresh
            smoothed = torch.einsum('bqk,bkn->bqn', weight, probs)
            probs = torch.where(low_conf, smoothed, probs)
            output = probs.transpose(1, 2).reshape(b, n, h, w)
        return output
