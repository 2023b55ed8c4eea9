"""ResNetV1c skip encoder of the Cityscapes model, the dilated ResNet of the
UniMatch DeepLabV3+ baseline, and the conv + BatchNorm + ReLU unit they
share with the DeepLabV3+ heads (counterparts of
``semivl_tpu/models/resnet.py::ResNetV1c`` and ``::ConvBNReLU``).

mmseg's ResNetV1c as the VLG ``conv_encoder`` (reference
configs/_base_/models/vlm-vlg-aspp-s2p4-skr04-ftap-mcvitb.py:50-60): the
deep 3x3 stem (32, 32, 64 channels, the first with stride 2), a 3x3 / 2 max
pool with padding 1, then bottleneck stages; exp 44 runs one stage of the
depth-101 network (3 blocks, 256 output channels), so an 801^2 crop gives a
201^2 map. Parameter and buffer names are mmseg's (``stem.0`` conv,
``stem.1`` BatchNorm, ``layer1.0.conv1`` / ``bn1`` ... ``downsample.0/1``).
The UniMatch ResNet-50/101 of ``dlv3p-r101`` (reference third_party/
unimatch/model/backbone/resnet.py:17-163) is the same network with the
stem at (64, 64, 128) channels, four stages and
``replace_stride_with_dilation``: a stage whose stride is replaced runs
its first block at the previous dilation and its later blocks at the
doubled one, as torchvision (and JAX's module) do.

BatchNorm follows flax, not ``torch.nn.BatchNorm2d``: in train mode it
normalises with the batch's biased variance E[x^2] - E[x]^2 (float32,
clamped at 0) and updates the running statistics with that same biased
variance, ``r <- 0.9 r + 0.1 batch`` (torch's module would store the
unbiased variance); in eval mode it uses the running statistics.
Convolutions run in the module's ``dtype``, BatchNorm in float32 (in
float64 given float64).

Inside a process group, train mode takes E[x] and E[x^2] over every rank's
batch (the reference's SyncBN; flax ``BatchNorm(axis_name='data' if
train)``, ``semivl_tpu/models/resnet.py:47-49``): the mean over ranks of
each rank's two statistics, in one differentiable all-reduce whose
backward averages their cotangents over the ranks, as JAX's transpose of
``pmean`` does. The running statistics then come out equal on every rank.
Eval mode issues no collective.
"""

import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.parallel import dist

BN_MOMENTUM = 0.9   # flax convention: weight of the old running statistic
BN_EPS = 1e-5
_DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over NCHW with flax's statistics (module
    docstring); the running mean and variance are buffers, updated in place
    by every train-mode call. ``momentum``: the weight of the old running
    statistic (flax's convention; torch's momentum is one minus it)."""

    def __init__(self, channels, momentum=BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x, train=False):
        # float32 statistics, float64 kept (the tests' exact reference)
        x32 = x if x.dtype == torch.float64 else x.float()
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            mean2 = (x32 * x32).mean(dim=(0, 2, 3))
            if dist.active():
                mean, mean2 = dist.mean_over_ranks(
                    torch.cat([mean, mean2])).chunk(2)
            var = (mean2 - mean * mean).clamp(min=0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x32 - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4 channels), BatchNorm after
    each conv, ReLU after the first two and after the residual sum."""

    def __init__(self, cin, planes, stride=1, downsample=False, dilation=1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BatchNorm(4 * planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, 4 * planes, 1, stride=stride, bias=False),
            BatchNorm(4 * planes)) if downsample else None)

    def forward(self, x, train):
        dt = x.dtype
        out = _conv_bn(x, self.conv1, self.bn1, train, relu=True)
        out = _conv_bn(out, self.conv2, self.bn2, train, relu=True,
                       stride=self.stride, dilation=self.dilation)
        out = _conv_bn(out, self.conv3, self.bn3, train)
        identity = x
        if self.downsample is not None:
            identity = _conv_bn(x, self.downsample[0], self.downsample[1],
                                train, stride=self.stride)
        return F.relu(out + identity).to(dt)


def _conv_bn(x, conv, bn, train, relu=False, stride=1, dilation=1):
    """conv in x's dtype (padding (k - 1) / 2 * dilation, the conv's groups)
    -> BatchNorm (float32) -> optional ReLU, in x's dtype."""
    pad = (conv.kernel_size[0] - 1) // 2 * dilation
    y = bn(F.conv2d(x, conv.weight.to(x.dtype), stride=stride, padding=pad,
                    dilation=dilation, groups=conv.groups), train).to(x.dtype)
    return F.relu(y) if relu else y


class ConvBNReLU(nn.Module):
    """A bias-free k x k convolution (stride, dilation) -> ``BatchNorm`` ->
    ReLU (unless ``relu=False``) over NCHW, named ``conv`` and ``bn`` as the
    flax module's scopes; the output is in the input's dtype."""

    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1,
                 relu=True):
        super().__init__()
        self.stride, self.dilation, self.relu = stride, dilation, relu
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, train=False):
        return _conv_bn(x, self.conv, self.bn, train, relu=self.relu,
                        stride=self.stride, dilation=self.dilation)


class ResNetV1c(nn.Module):
    """Deep-stem bottleneck ResNet; ``forward(img, train)`` takes NHWC
    (B, H, W, 3) and returns the NHWC output of each stage in
    ``out_indices`` (stage i has 256 * 2^i channels).
    ``replace_stride_with_dilation[i]`` turns stage i + 1's stride 2 into
    dilation (module docstring)."""

    def __init__(self, depth=101, num_stages=1, out_indices=(0,),
                 stem_widths=(32, 32, 64),
                 replace_stride_with_dilation=(False, False, False),
                 dtype=torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        w1, w2, w3 = stem_widths
        self.stem = nn.Sequential(
            nn.Conv2d(3, w1, 3, stride=2, padding=1, bias=False),
            BatchNorm(w1), nn.ReLU(),
            nn.Conv2d(w1, w2, 3, padding=1, bias=False), BatchNorm(w2),
            nn.ReLU(),
            nn.Conv2d(w2, w3, 3, padding=1, bias=False), BatchNorm(w3),
            nn.ReLU())
        cin = w3
        self.stages = []
        dilation = 1
        for stage in range(num_stages):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation, stride = dilation * stride, 1
            blocks = nn.ModuleList()
            for b in range(_DEPTH_BLOCKS[depth][stage]):
                blocks.append(Bottleneck(
                    cin, planes, stride=stride if b == 0 else 1,
                    downsample=b == 0,
                    dilation=prev_dilation if b == 0 else dilation))
                cin = 4 * planes
            self.add_module(f'layer{stage + 1}', blocks)
            self.stages.append(blocks)

    def forward(self, img, train=False):
        x = img.permute(0, 3, 1, 2).to(self.dtype)
        s = self.stem
        x = _conv_bn(x, s[0], s[1], train, relu=True, stride=2)
        x = _conv_bn(x, s[3], s[4], train, relu=True)
        x = _conv_bn(x, s[6], s[7], train, relu=True)
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        outs = []
        for i, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x, train)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return outs
