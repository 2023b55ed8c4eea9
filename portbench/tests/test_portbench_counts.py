"""The work counts against hand counts and against the operations the
reference's own products perform, and the whole step against XLA's count
of the same step."""


import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.harness import spec
from portbench.reference import model as M
from portbench.tests import tiny

# XLA's cost analysis of the JAX step at 1 + 1 crops (recorded in
# semivl_tpu/tools/reference_denominator.py:54-59, copied here as numbers)
XLA_TFLOP = {'exp43-ade-vitb16-vlg': 9.603, 'exp44-cs-vitb16-vlg': 12.136}


def test_attention_call_by_hand():
    # QK^T and PV: 2 * (2 B L^2 C) forward, four such products backward
    assert counts.attention_call(2, 3, 4, False) == (4 * 2 * 9 * 4,
                                                     2 * 2 * 3 * (12 + 4))
    assert counts.attention_call(2, 3, 4, True)[0] == 8 * 2 * 9 * 4


def test_decoder_stage_by_hand():
    cfg = {'channels': 8, 'up_channels': [4], 'skip_channels': [2]}
    wk, el = counts.decoder_tail(dict(cfg, up_channels=[4, 2],
                                      skip_channels=[2, 1]), 3, 2, 2)
    # stage 1 on 3 planes of 2x2: transpose conv 8 -> 6, conv1 (6 + 2 -> 4)
    # with the skip half once, conv2 4 -> 4; stage 2 at 8x8: 4 -> 3,
    # (3 + 1 -> 2), 2 -> 2; the head 2 -> 1
    s1 = 2 * 3 * 4 * 8 * 6 * 4 + 2 * 3 * 16 * 6 * 4 * 9 + 2 * 16 * 2 * 4 * 9 \
        + 2 * 3 * 16 * 4 * 4 * 9
    s2 = 2 * 3 * 16 * 4 * 3 * 4 + 2 * 3 * 64 * 3 * 2 * 9 + 2 * 64 * 1 * 2 * 9 \
        + 2 * 3 * 64 * 2 * 2 * 9
    head = 2 * 3 * 64 * 2 * 9
    assert wk.fwd == s1 + s2 + head
    assert wk.bwd == 2 * wk.fwd
    assert el['out'] == 3 * 64


def test_segmentor_forward_equals_the_references_products():
    """The tiny segmentor's counted forward against the operations that
    torch's counter sees in the reference's forward (products only). The
    reference convolves each Up stage's skip half once per class plane, as
    the published head concatenates it to every plane; the port, and the
    count, do it once per image, so the test takes the N - 1 repeats
    off."""
    conf = tiny.load('tiny-vlm')
    arch = conf['architecture']
    shapes = M.param_shapes(arch)
    P = {n: torch.randn(s) * 0.1 for n, s in shapes.items()}
    text = torch.randn(21, 512)
    img = torch.randn(1, 64, 64, 3)
    with FlopCounterMode(display=False) as fc:
        M.vlm_forward(P, {}, arch, img, text, M.Precision())
    got = counts.segmentor(arch, 21, 64, 64, grad=False).fwd
    head = arch['decode_head']
    hw, repeats = 4 * 4, 0
    for cout, cs in zip(head['up_channels'], head['skip_channels']):
        hw *= 4
        repeats += 2 * (21 - 1) * hw * cs * cout * 9
    assert got == fc.get_total_flops() - repeats


@pytest.mark.parametrize('name', sorted(XLA_TFLOP))
def test_step_against_xla(name):
    """At 1 + 1 crops the count lies within 10 % of XLA's: XLA counts its
    own lowering (resizes as gathers, the last block's dead main path
    pruned or not), this one the published products."""
    conf = spec.config(name)
    n = spec.text(conf['text']).shape[0]
    nm = spec.text(conf['mcc_text']).shape[0]
    got = counts.train_step(conf['architecture'], n, nm, 1,
                            conf['crop_size']) / 1e12
    assert got == pytest.approx(XLA_TFLOP[name], rel=0.10)
