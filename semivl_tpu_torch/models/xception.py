"""Aligned Xception-65, the encoder of the UniMatch ``dlv3p-xc65`` baseline
(counterpart of ``semivl_tpu/models/xception.py``).

The DeepLab-style Xception with separable convs (reference third_party/
unimatch/model/backbone/xception.py): a stem of two 3x3 convs (32 and 64
channels, the first with stride 2), entry blocks to 128, 256 and 728
channels, 16 middle blocks at 728, an exit block to 1024 and three
separable convs to 1536, 1536 and 2048, at output stride 16 (the later
blocks dilated by 16 / output stride). ``c1`` is block 2's hook, the map
after its second separable conv (256 channels, stride 4).

A separable conv is a depthwise 3x3 conv (``groups = C_in``, the block's
dilation) and a pointwise 1x1 conv, each followed by BatchNorm; the ReLU
comes first (``activate_first``) or after each BatchNorm. Every BatchNorm
takes flax's statistics at the reference's fixed momentum 0.0003 (the
port's ``momentum`` 0.9997, the weight of the old statistic) and eps
1e-5, across the ranks of a process group in train mode, as every port
BatchNorm (``models.resnet.BatchNorm``). Names are the flax scopes'
(``conv1``, ``bn1``, ``block2.sepconv3.depthwise``, ``block2.skipbn``,
``conv5.bn2``), a BatchNorm directly under its scope name. NHWC in,
(c1, c4) NHWC out; convolutions run in the module's dtype, BatchNorm in
float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.models.resnet import BatchNorm, _conv_bn

BN_MOMENTUM = 1.0 - 0.0003   # torch momentum 0.0003 (xception.py:5)


def _bn(channels):
    return BatchNorm(channels, momentum=BN_MOMENTUM)


class SeparableConv(nn.Module):
    """(ReLU ->) depthwise 3x3 -> BN (-> ReLU) -> pointwise 1x1 -> BN
    (-> ReLU) over NCHW (reference xception.py:9-34)."""

    def __init__(self, cin, cout, stride=1, dilation=1, activate_first=True):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.activate_first = activate_first
        self.depthwise = nn.Conv2d(cin, cin, 3, groups=cin, bias=False)
        self.bn1 = _bn(cin)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = _bn(cout)

    def forward(self, x, train=False):
        if self.activate_first:
            x = F.relu(x)
        after = not self.activate_first
        x = _conv_bn(x, self.depthwise, self.bn1, train, relu=after,
                     stride=self.stride, dilation=self.dilation)
        return _conv_bn(x, self.pointwise, self.bn2, train, relu=after)


class XceptionBlock(nn.Module):
    """Three separable convs plus the (projected) input (reference
    xception.py:37-81); returns (out, hook), the hook the map after the
    second separable conv."""

    def __init__(self, cin, cout, stride=1, atrous=1, grow_first=True):
        super().__init__()
        self.stride = stride
        if cout != cin or stride != 1:
            self.skip = nn.Conv2d(cin, cout, 1, bias=False)
            self.skipbn = _bn(cout)
        else:
            self.skip = None
        mid = cout if grow_first else cin
        self.sepconv1 = SeparableConv(cin, mid, dilation=atrous)
        self.sepconv2 = SeparableConv(mid, cout, dilation=atrous)
        self.sepconv3 = SeparableConv(cout, cout, stride=stride,
                                      dilation=atrous)

    def forward(self, x, train=False):
        skip = x
        if self.skip is not None:
            skip = _conv_bn(x, self.skip, self.skipbn, train,
                            stride=self.stride)
        y = self.sepconv2(self.sepconv1(x, train), train)
        hook = y
        return self.sepconv3(y, train) + skip, hook


class Xception65(nn.Module):
    """``forward(img, train)``: NHWC (B, H, W, 3) -> (c1, c4) NHWC, 256
    channels at stride 4 and 2048 at ``output_stride`` (16 or 8)."""

    def __init__(self, output_stride=16, dtype=torch.float32):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f'output_stride {output_stride} (8 or 16)')
        self.dtype = dtype
        strides = (2, 2, 1) if output_stride == 16 else (2, 1, 1)
        rate = 16 // output_stride
        self.conv1 = nn.Conv2d(3, 32, 3, bias=False)
        self.bn1 = _bn(32)
        self.conv2 = nn.Conv2d(32, 64, 3, bias=False)
        self.bn2 = _bn(64)
        self.block1 = XceptionBlock(64, 128, stride=2)
        self.block2 = XceptionBlock(128, 256, stride=strides[0])
        self.block3 = XceptionBlock(256, 728, stride=strides[1])
        for i in range(4, 20):
            setattr(self, f'block{i}', XceptionBlock(728, 728, atrous=rate))
        self.block20 = XceptionBlock(728, 1024, stride=strides[2],
                                     atrous=rate, grow_first=False)
        self.conv3 = SeparableConv(1024, 1536, dilation=rate,
                                   activate_first=False)
        self.conv4 = SeparableConv(1536, 1536, dilation=rate,
                                   activate_first=False)
        self.conv5 = SeparableConv(1536, 2048, dilation=rate,
                                   activate_first=False)

    def forward(self, img, train=False):
        x = img.permute(0, 3, 1, 2).to(self.dtype)
        x = _conv_bn(x, self.conv1, self.bn1, train, relu=True, stride=2)
        x = _conv_bn(x, self.conv2, self.bn2, train, relu=True)
        x, _ = self.block1(x, train)
        x, c1 = self.block2(x, train)
        for i in range(3, 21):
            x, _ = getattr(self, f'block{i}')(x, train)
        for name in ('conv3', 'conv4', 'conv5'):
            x = getattr(self, name)(x, train)
        return c1.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)
