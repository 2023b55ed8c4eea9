"""The UniMatch DeepLabV3+ segmentor, the ``dlv3p-r101`` and ``dlv3p-xc65``
baselines (counterpart of ``semivl_tpu/models/deeplabv3plus.py``).

Reference third_party/unimatch/model/semseg/deeplabv3plus.py:9-126: a
ResNet-50/101 (the UniMatch stem, last stage dilated by default) or an
Xception-65 encoder, the BatchNorm ASPP over its last map (``head``, 256
channels), a 48-channel 1x1 reduction of its first map (``reduce``), the
two concatenated and fused by two 3x3 convs of 256 channels (``fuse1``,
``fuse2``) and a 1x1 class conv (``classifier``); every resize is bilinear
with ``align_corners=True``. Its own feature perturbation drops whole
channels of c1 and of c4 (``dropout2d`` at ``fp_rate``, two draws from
the explicit generator, c1's first).

Names are the flax scopes' (``encoder``, ``head``, ``reduce``, ``fuse1``,
``fuse2``; JAX's ``classifier_dense`` is ``classifier`` here), so that the
optimizer resolves every leaf as JAX does: no name starts with
``backbone``, so the ``original`` SGD puts every leaf, the encoder's too,
at ``lr x lr_multi``, as JAX's rule does (ROADMAP, design differences).

The call contract is the VLM's: ``text_feats`` is taken and ignored.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.dlv3p_head import BNASPPModule
from semivl_tpu_torch.models.resnet import ConvBNReLU, ResNetV1c
from semivl_tpu_torch.models.xception import Xception65
from semivl_tpu_torch.ops.dropout import dropout2d
from semivl_tpu_torch.ops.resize import resize_hw

HIGH_CHANNELS = 2048   # c4 of both encoders
REDUCE_CHANNELS = 48
FUSE_CHANNELS = 256


class DeepLabV3Plus(nn.Module):

    def __init__(self, num_classes, backbone='resnet101',
                 replace_stride_with_dilation=(False, False, True),
                 dilations=(6, 12, 18), fp_rate=0.5, dtype=torch.float32):
        super().__init__()
        self.fp_rate = fp_rate
        self.dtype = dtype
        if 'resnet' in backbone:
            self.encoder = ResNetV1c(
                depth=int(backbone.replace('resnet', '')), num_stages=4,
                out_indices=(0, 3), stem_widths=(64, 64, 128),
                replace_stride_with_dilation=tuple(
                    replace_stride_with_dilation), dtype=dtype)
        elif backbone == 'xception':
            self.encoder = Xception65(dtype=dtype)
        else:
            raise ValueError(backbone)
        aspp = HIGH_CHANNELS // 8
        self.head = BNASPPModule(HIGH_CHANNELS, aspp, tuple(dilations))
        self.reduce = ConvBNReLU(256, REDUCE_CHANNELS, 1)
        self.fuse1 = ConvBNReLU(REDUCE_CHANNELS + aspp, FUSE_CHANNELS, 3)
        self.fuse2 = ConvBNReLU(FUSE_CHANNELS, FUSE_CHANNELS, 3)
        self.classifier = nn.Conv2d(FUSE_CHANNELS, num_classes, 1)

    def _decode(self, c1, c4, train, out_hw):
        """NHWC c1, c4 -> float32 (B, num_classes, out_h, out_w)."""
        c1, c4 = (f.permute(0, 3, 1, 2) for f in (c1, c4))
        c4 = self.head(c4, train)
        c4 = resize_hw(c4, c1.shape[2:], 'bilinear', True)
        c1 = self.reduce(c1, train)
        x = self.fuse2(self.fuse1(torch.cat([c1, c4.to(c1.dtype)], dim=1),
                                  train), train)
        x = F.conv2d(x, self.classifier.weight.to(x.dtype),
                     self.classifier.bias.to(x.dtype))
        return resize_hw(x.float(), out_hw, 'bilinear', True)

    def forward(self, img, text_feats=None, need_fp=False, generator=None,
                train=False, only_fp=False, fp_slice=None):
        """img: (B, H, W, 3) normalised float. Returns float32 (B,
        num_classes, H, W) logits. ``need_fp``: also the perturbed decode
        of rows ``fp_slice`` (default the second half, the unlabeled
        ``img_w``) in the same decoder pass, ``(logits, logits_fp)``;
        ``only_fp``: the perturbed decode of the whole batch alone.
        ``train``: BatchNorm on the batch's statistics, updating the
        running ones."""
        del text_feats
        out_hw = tuple(img.shape[1:3])
        c1, c4 = self.encoder(img, train=train)
        if only_fp:
            return self._decode(dropout2d(c1, self.fp_rate, generator),
                                dropout2d(c4, self.fp_rate, generator),
                                train, out_hw)
        if not need_fp:
            return self._decode(c1, c4, train, out_hw)
        b = img.shape[0]
        lo, hi = fp_slice if fp_slice is not None else (b // 2, b)
        c1_p = dropout2d(c1[lo:hi], self.fp_rate, generator)
        c4_p = dropout2d(c4[lo:hi], self.fp_rate, generator)
        outs = self._decode(torch.cat([c1, c1_p]), torch.cat([c4, c4_p]),
                            train, out_hw)
        return outs[:b], outs[b:]
