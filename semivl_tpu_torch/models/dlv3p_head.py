"""DeepLabV3+ decode head of the VLM (counterpart of
``semivl_tpu/models/dlv3p_head.py``), the head of exp 41's ``vlm-dlv3p-*``
ablation models.

The UniMatch BatchNorm ASPP (reference third_party/unimatch/model/semseg/
deeplabv3plus.py:76-126: a 1x1 branch, three dilated 3x3 branches and an
image-pooling branch, each ``in / 8`` channels wide, then a 1x1 projection)
over the encoder's last map, a 1x1 projection of its first map (the ViT's
layer-4 skip) to 48 channels, the concatenation fused by two 3x3 convs of
256 channels, and a 1x1 class conv (reference model/decode_heads/
dlv3p_head.py:26-65). Every conv but the classifier is ``ConvBNReLU``
(flax BatchNorm statistics, cross-rank in a process group); the head ignores
the text embeddings, as JAX's does. Parameter and buffer names are the flax
scopes' (``aspp.b0`` ... ``aspp.b4``, ``aspp.project``, ``c1_proj``,
``fuse1``, ``fuse2``, ``classifier``), so the optimizer's substring
multipliers resolve each leaf as JAX resolves its path.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.resnet import ConvBNReLU
from semivl_tpu_torch.ops.resize import resize_hw

FUSE_CHANNELS = 256   # JAX's fuse convs (dlv3p_head.py:80-83)


class BNASPPModule(nn.Module):
    """ASPP with BatchNorm: branches ``b0`` (1x1), ``b1``-``b3`` (3x3 at the
    ``dilations``), ``b4`` (1x1 over the spatial mean, broadcast back), then
    ``project`` (1x1) over their concatenation; NCHW."""

    def __init__(self, cin, cout, dilations=(6, 12, 18)):
        super().__init__()
        self.b0 = ConvBNReLU(cin, cout, 1)
        for i, d in enumerate(dilations):
            setattr(self, f'b{i + 1}', ConvBNReLU(cin, cout, 3, dilation=d))
        self.b4 = ConvBNReLU(cin, cout, 1)
        self.project = ConvBNReLU(5 * cout, cout, 1)
        self.n_dilated = len(dilations)

    def forward(self, x, train=False):
        feats = [self.b0(x, train)]
        feats += [getattr(self, f'b{i + 1}')(x, train)
                  for i in range(self.n_dilated)]
        pooled = self.b4(x.mean(dim=(2, 3), keepdim=True), train)
        feats.append(pooled.expand(-1, -1, *x.shape[2:]))
        return self.project(torch.cat(feats, dim=1), train)


class DLV3PHead(nn.Module):

    def __init__(self, img_size, num_classes, in_channels=512, channels=256,
                 c1_in_channels=768, c1_channels=48, dilations=(6, 12, 18),
                 align_corners=False, dtype=torch.float32):
        super().__init__()
        del channels   # JAX fuses at FUSE_CHANNELS whatever this says
        self.img_size = img_size
        self.align_corners = align_corners
        self.dtype = dtype
        aspp_c = in_channels // 8
        self.aspp = BNASPPModule(in_channels, aspp_c, tuple(dilations))
        self.c1_proj = ConvBNReLU(c1_in_channels, c1_channels, 1)
        self.fuse1 = ConvBNReLU(c1_channels + aspp_c, FUSE_CHANNELS, 3)
        self.fuse2 = ConvBNReLU(FUSE_CHANNELS, FUSE_CHANNELS, 3)
        self.classifier = nn.Conv2d(FUSE_CHANNELS, num_classes, 1)

    def forward(self, feats, text_feats=None, conv_feats=None,
                output_size=None, train=False, global_emb=None):
        """feats: (c1, c4) NHWC, the ViT's layer-4 map and its last map (the
        dense CLIP embedding of the MaskCLIP ViT). ``train``: BatchNorm on
        the batch's statistics, updating the running ones; the text and the
        global embedding are taken and ignored. Returns float32 (B,
        num_classes, out_h, out_w) logits."""
        del text_feats, conv_feats, global_emb
        dt = self.dtype
        c1, c4 = (f.permute(0, 3, 1, 2).to(dt) for f in feats[:2])
        c4 = self.aspp(c4, train)
        c1 = self.c1_proj(c1, train)
        c4 = resize_hw(c4, c1.shape[2:], 'bilinear', self.align_corners)
        x = self.fuse2(self.fuse1(torch.cat([c1, c4.to(c1.dtype)], dim=1),
                                  train), train)
        x = F.conv2d(x, self.classifier.weight.to(dt),
                     self.classifier.bias.to(dt))
        out_hw = output_size or (self.img_size, self.img_size)
        return resize_hw(x.float(), out_hw, 'bilinear', self.align_corners)
