"""The port's CUDA kernels against their plain PyTorch versions, on the card:
packed and head-split attention, the decoder stages and their backward
routes, and the fused Up stage.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU (a CUDA kernel has no CPU mode). The file imports neither JAX nor the
JAX package, so on the machine with the card it runs without the repo's
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Tolerances (bf16 on both sides, float32 accumulation): attention output
within 2e-2 absolute of the plain version for unit-normal q, k, v (the
plain version rounds the logits and the normalised probabilities to bf16,
the kernel the unnormalised ones) and within 2e-3 relative L2 of
``packed_attention_rounded`` (the kernel's rounding points: only the order
of float32 sums differs); decoder logits within 5e-2 of the logit scale
(bf16 storage between the convolutions, GroupNorm amplifying it) and
within 1e-2 relative L2 of ``fused_vlg_decoder_rounded``; the forward's
saved GroupNorm statistics within 1e-6 of those of its stored raw
convolutions.
The head-split attention rounds where its plain version does: 2e-3 (forward)
and 5e-3 (backward) relative L2, and 5e-3 against the packed kernels on the
same input. The fused Up stage within 1e-2 relative L2 of
``fused_up_stage_rounded``.
Backward: the attention gradient within 2e-2 of its scale (dq, dk, dv are
rounded to bf16 once, p and ds before their products, as in the plain
version); each decoder gradient within 2e-2 relative L2 of autograd
through ``fused_vlg_decoder_rounded`` (a flipped bf16 rounding of a raw
conv output, which GroupNorm amplifies, is the whole difference), with
float64 sums and the forward's stored stage-1 conv2, and, forward and
backward composed, within 6e-2 of it with float64 sums recomputing stage 1
(``composed_ref``; the float32-sum reference itself lies up to 3.4e-2 from
it: PERF.md). Two gloo ranks sharing the card end a tiny step with equal
parameters.
"""

import functools
from unittest import mock

import pytest
import torch

from semivl_tpu_torch.ops import flash_attention, fused_decoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('b,length,heads,valid_len', [
    (2, 1025, 12, None), (128, 21, 4, None), (2, 130, 2, 100),
    (3, 64, 1, None), (2, 2602, 12, None), (1, 869, 12, None)])
def test_attention_kernel_matches_plain(card, b, length, heads, valid_len):
    c = 64 * heads
    qkv = torch.randn(b, length, 3 * c, generator=card, device='cuda',
                      dtype=torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention.packed_attention(qkv, heads, valid_len)
    assert flash_attention.launches == before + 1
    want = flash_attention.packed_attention_plain(qkv, heads, valid_len)
    rounded = flash_attention.packed_attention_rounded(qkv, heads, valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() < 2e-2
    assert rel_l2(got, rounded.float()) < 2e-3


def test_attention_kernel_refuses_other_head_dims(card):
    qkv = torch.zeros(1, 8, 3 * 96, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head_dim 64'):
        flash_attention.packed_attention(qkv, 3)
    f = torch.zeros(1, 8, 3 * 64, device='cuda')
    with pytest.raises(ValueError, match='bf16'):
        flash_attention.packed_attention(f, 1)


def _stage_params(gen, cin, cs, cout, cu=None):
    cu = cin - cs if cu is None else cu

    def u(*shape):
        fan_in = torch.Size(shape[1:]).numel()
        return ((torch.rand(shape, generator=gen, device='cuda') * 2 - 1)
                / fan_in ** 0.5)

    def n(c, mean):
        return mean + 0.2 * torch.randn(c, generator=gen, device='cuda')

    return dict(up_weight=u(cin, cu, 2, 2), up_bias=n(cu, 0.0),
                conv1_weight=u(cout, cu + cs, 3, 3), gn1_weight=n(cout, 1.0),
                gn1_bias=n(cout, 0.0), conv2_weight=u(cout, cout, 3, 3),
                gn2_weight=n(cout, 1.0), gn2_bias=n(cout, 0.0))


def _kernel_chain(x, s1, s2, p1, p2, head, skip_half=True, gn_in2=True):
    """The two stage launches of ``fused_vlg_decoder``'s forward, with two
    plantable faults: ``skip_half=False`` leaves conv1's skip half out
    inside the kernel's sequence, ``gn_in2=False`` has stage 2 read stage
    1's raw conv2 without its GN+ReLU."""
    c2, part2 = fused_decoder._stage(x, s1, p1, skip_half=skip_half)
    gn_in = (part2, p1['gn2_weight'].float().contiguous(),
             p1['gn2_bias'].float().contiguous()) if gn_in2 else None
    return fused_decoder._stage(c2, s2, p2, gn_in=gn_in, head=head,
                                skip_half=skip_half)


# (images, planes per image, base h, w; stage 1 (Cin, Cs, Cout, Cu), stage
# 2's (Cs, Cout, Cu); Cu None: Cin - Cs)
DECODER_CASES = {
    'flagship 32^2': (2, 21, 32, 32, (128, 32, 64, None), (16, 32, None)),
    'ragged 13^2': (1, 3, 13, 13, (128, 32, 64, None), (16, 32, None)),
    'Cityscapes edge crop 28x51': (1, 3, 28, 51, (128, 32, 64, None),
                                   (32, 32, None)),
    'padded Cu 80, Cs 24': (2, 3, 12, 10, (128, 24, 64, 80), (24, 32, 80)),
    'padded Cu 144, Cs 8': (1, 3, 8, 9, (160, 8, 32, 144), (8, 16, 144)),
    'Cin 24, Cout 48': (1, 3, 8, 9, (24, 8, 48, None), (16, 32, None)),
    'Cout 96, Cu 112': (1, 3, 8, 9, (128, 16, 96, 112), (16, 32, None)),
}


@pytest.mark.parametrize('case', list(DECODER_CASES))
def test_decoder_kernel_matches_plain(card, case):
    """The forward (two launches of ``decoder_stage_fwd``, the igemm
    sequence) against the plain bf16 chain within 5e-2 of the logit scale
    and against ``fused_vlg_decoder_rounded`` (its own bf16 points) within
    1e-2 relative L2, bit for bit on a rerun. The cases: flagship widths,
    ragged tiles, the Cityscapes edge-crop grid (widths 56 and 102, not
    multiples of 8: pitch-padded TMA copies), widths the kernel zero-pads
    (Cu 80 -> 96 with Cs 24 -> 32; Cu 144 in column groups of 128 + 16 with
    Cs 8 -> 16; Cin 24 -> 32) and the output widths 48 and 96. Two planted
    faults must fail the second
    limit: conv1's skip half left out inside the kernel's sequence, and
    stage 2 reading its input without GN+ReLU."""
    b, n, h, w, (cin, cs1, c1, cu1), (cs2, c2, cu2) = DECODER_CASES[case]
    p1 = _stage_params(card, cin, cs1, c1, cu1)
    p2 = _stage_params(card, c1, cs2, c2, cu2)
    head = dict(weight=0.2 * torch.randn(1, c2, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    x = torch.randn(b * n, cin, h, w, generator=card, device='cuda')
    s1 = torch.randn(b, cs1, 2 * h, 2 * w, generator=card, device='cuda')
    s2 = torch.randn(b, cs2, 4 * h, 4 * w, generator=card, device='cuda')
    args = [t.bfloat16() for t in (x, s1, s2)]
    before = fused_decoder.launches
    with torch.no_grad():
        got = fused_decoder.fused_vlg_decoder(*args, p1, p2, head)
        assert fused_decoder.launches == before + 2
        again = fused_decoder.fused_vlg_decoder(*args, p1, p2, head)
        want = fused_decoder.fused_vlg_decoder_plain(*args, p1, p2, head)
        ref = fused_decoder.fused_vlg_decoder_rounded(*args, p1, p2, head)
        no_skip = _kernel_chain(*args, p1, p2, head, skip_half=False)
        raw_in = _kernel_chain(*args, p1, p2, head, gn_in2=False)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b * n, 1, 4 * h, 4 * w)
    assert torch.equal(got, again)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err < 5e-2 * max(scale, 1.0), (err, scale)
    assert rel_l2(got, ref.float()) < 1e-2
    assert rel_l2(no_skip, ref.float()) > 1e-2
    assert rel_l2(raw_in, ref.float()) > 1e-2


@pytest.mark.parametrize('b,n,h,w', [(3, 19, 51, 51), (1, 3, 28, 51)])
def test_decoder_forward_saved_stats(card, b, n, h, w):
    """The GroupNorm statistics ``_stage(stats=True)`` hands the banded
    backward (``decoder_gn_stats`` over the conv tiles' partials) equal
    ``gn_stats_plain`` of the raw conv1 and conv2 it stored, to 1e-6
    relative: a wrong tile count or layout of the partials fails."""
    (p1, p2, head), (x, s1, s2), _ = _cityscapes_decoder(card, b, n, h, w)
    made = []

    def tensors(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    real = fused_decoder.stage_tensors
    with torch.no_grad(), mock.patch.object(fused_decoder, 'stage_tensors',
                                            tensors):
        c2, part2, st1 = fused_decoder._stage(x, s1, p1, stats=True)
        gn_in = (part2, p1['gn2_weight'].float().contiguous(),
                 p1['gn2_bias'].float().contiguous())
        _, st2 = fused_decoder._stage(c2, s2, p2, gn_in=gn_in, head=head,
                                      stats=True)
    torch.cuda.synchronize()
    assert len(made) == 2 and made[0]['c2'] is c2
    for t, st in zip(made, (st1, st2)):
        want = (fused_decoder.gn_stats_plain(t['c1'])
                + fused_decoder.gn_stats_plain(t['c2']))
        for got, ref in zip(st, want):
            assert got.shape == ref.shape
            assert ((got - ref).abs().max() <= 1e-6 * ref.abs().max()), (
                got - ref).abs().max()


@pytest.mark.parametrize('cin,c1,c2,cs1,cs2,cu1', [
    (64, 48, 16, 16, 16, None),      # Cout 48; stage 2 Cin 48
    (224, 96, 32, 112, 24, 112),     # Cin 224, Cu and Cs 112, Cout 96
    (64, 8, 40, 16, 4, None),        # one group of 8; two groups of 20
    (64, 112, 128, 16, 16, None),    # Cout 112 (96 + 16), 128 (96 + 32)
    (64, 160, 24, 32, 16, None)])    # Cout 160 (96 + 64); one group of 24
def test_wide_widths_run_on_the_kernels(card, cin, c1, c2, cs1, cs2, cu1):
    """Widths beyond the shipped models' run on the kernels, forward and
    on both backward routes (launches counted): output widths 48 and 96,
    Cin above 128 and Cu and Cs above the backward's widest product (96),
    in column groups; every Cout JAX takes (8, 24, 40, 112, 128, 160),
    in GroupNorm's kernel layout (``pad_decoder``) and column groups of
    the products. The logits within 1e-2 relative L2 of
    ``fused_vlg_decoder_rounded``; every gradient leaf within 2e-2 of
    ``rounded_at`` and, composed, within 6e-2 of ``composed_ref``."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    b, n, h, w = 1, 3, 13, 11
    p1 = _stage_params(card, cin, cs1, c1, cu1)
    p2 = _stage_params(card, c1, cs2, c2)
    head = dict(weight=0.2 * torch.randn(1, c2, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    acts = [torch.randn(b * n, cin, h, w, generator=card, device='cuda'),
            torch.randn(b, cs1, 2 * h, 2 * w, generator=card, device='cuda'),
            torch.randn(b, cs2, 4 * h, 4 * w, generator=card, device='cuda')]
    acts = [t.bfloat16() for t in acts]
    g = torch.randn(b * n, 1, 4 * h, 4 * w, generator=card,
                    device='cuda').bfloat16()
    params = [p1, p2, head]
    before = fused_decoder.launches
    with torch.no_grad():
        got = fused_decoder.fused_vlg_decoder(*acts, *params)
        ref = fused_decoder.fused_vlg_decoder_rounded(*acts, *params)
    assert fused_decoder.launches == before + 2
    assert rel_l2(got, ref.float()) < 1e-2
    at = decoder_grads(rounded_at(acts[0], acts[1], p1), acts, params, g,
                       torch.bfloat16)
    composed = decoder_grads(composed_ref, acts, params, g, torch.bfloat16)
    for route in ('whole', 'banded'):
        counts = (fused_decoder.bwd_tail_launches, fdb.pass_c_launches)
        grads = decoder_grads(functools.partial(
            fused_decoder.fused_vlg_decoder, bwd=route), acts, params, g,
            torch.bfloat16)
        torch.cuda.synchronize()
        assert (fused_decoder.bwd_tail_launches, fdb.pass_c_launches) == (
            (counts[0] + 2, counts[1]) if route == 'whole' else
            (counts[0], counts[1] + 2))
        for a, r, c in zip(grads, at, composed):
            assert a.shape == r.shape, route
            assert rel_l2(a, r.float()) < 2e-2, route
            assert rel_l2(a, c.float()) < 6e-2, route


def _attention_case(card, b, length, heads, d=64):
    c = d * heads
    qkv = torch.randn(b, length, 3 * c, generator=card, device='cuda',
                      dtype=torch.bfloat16)
    g = torch.randn(b, length, c, generator=card, device='cuda',
                    dtype=torch.bfloat16)
    return qkv, g


@pytest.mark.parametrize('b,length,heads,valid_len', [
    (4, 1025, 12, None), (384, 21, 4, None), (2, 130, 2, 100)])
def test_attention_bwd_kernel_matches_plain(card, b, length, heads,
                                            valid_len):
    qkv, g = _attention_case(card, b, length, heads)
    c = 64 * heads
    q, k, v = qkv.split(c, dim=-1)
    vl = length if valid_len is None else valid_len
    out, lse = flash_attention._fwd_kernel(q, k, v, heads, vl, True)
    before = flash_attention.bwd_launches
    got = flash_attention.flash_mha_bwd(qkv, out, lse, g, heads, valid_len)
    assert flash_attention.bwd_launches == before + 1
    want = flash_attention.flash_mha_bwd_plain(qkv, out, g, heads, valid_len)
    torch.cuda.synchronize()
    assert got.shape == qkv.shape and torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err < 2e-2 * scale, (err, scale)
    again = flash_attention.flash_mha_bwd(qkv, out, lse, g, heads, valid_len)
    assert torch.equal(got, again)      # no atomics: bit for bit


def test_packed_attention_autograd_runs_the_kernels(card):
    qkv, g = _attention_case(card, 2, 130, 2)
    qkv.requires_grad_(True)
    f0, b0 = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention.packed_attention(qkv, 2)
    (got,) = torch.autograd.grad(out, qkv, g)
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        f0 + 1, b0 + 1)
    ref = qkv.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(
        flash_attention.packed_attention_plain(ref, 2), ref, g)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() < 2e-2 * scale


def decoder_grads(fn, acts, params, g, dtype):
    """Gradients of every input and parameter of ``fn`` (a decoder chain)
    with activations in ``dtype``: [x, skip1, skip2, up1 params, up2
    params, head weight, head bias]."""
    acts = [t.to(dtype).requires_grad_(True) for t in acts]
    p1, p2, head = ({k: v.detach().requires_grad_(True) for k, v in d.items()}
                    for d in params)
    prms = ([p1[k] for k in fused_decoder.STAGE_KEYS]
            + [p2[k] for k in fused_decoder.STAGE_KEYS]
            + [head['weight'], head['bias']])
    out = fn(*acts, p1, p2, head)
    return torch.autograd.grad(out, acts + prms, g.to(dtype))


def rel_l2(a, ref):
    return ((a.float() - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def rounded_at(x, s1, p1):
    """The whole-plane backward's reference: float64 sums (its float32 sums
    lie 1.3e-2 to 3.4e-2, worst leaf, from its float64 ones at the ragged
    and flagship cases, as far as the limit: tools/decoder_precision.py),
    at the point the kernels' forward reached: stage 1's raw conv2 as
    ``_stage`` stores it, the input the backward reads (``raw2_1``;
    ``stored_raw2`` at the stage's true width)."""
    with torch.no_grad():
        raw2_1 = fused_decoder.stored_raw2(x, s1, p1)
    return functools.partial(fused_decoder.fused_vlg_decoder_rounded,
                             dtype=torch.float64, raw2_1=raw2_1)


# Forward and backward composed: the rounded reference with float64 sums
# recomputing stage 1, independent of what the kernels' forward stored.
composed_ref = functools.partial(fused_decoder.fused_vlg_decoder_rounded,
                                 dtype=torch.float64)


def _stage1_fault(**kw):
    """``fused_decoder._stage`` patched so that stage 1 (no ``gn_in``)
    runs with a planted fault: ``skip_half=False`` (conv1's skip half left
    out inside the kernel's sequence)."""
    real = fused_decoder._stage

    def faulty(x, skip, p, gn_in=None, **k):
        return real(x, skip, p, gn_in=gn_in,
                    **(dict(k, **kw) if gn_in is None else k))
    return mock.patch.object(fused_decoder, '_stage', faulty)


@pytest.mark.parametrize('b,n,h', [(2, 21, 32), (1, 3, 13)])
def test_decoder_bwd_kernels_match_plain(card, b, n, h):
    """Gradients of every input and parameter against autograd through
    ``fused_vlg_decoder_rounded`` (bf16 where the kernels store bf16, the
    gradients too, float64 sums at the forward's stored stage-1 conv2:
    ``rounded_at``): each within 2e-2 relative L2; (1, 3,
    13) leaves ragged tiles in every kernel and widths (26, 52) that TMA
    reads through a padded copy. Two planted faults must fail that limit:
    conv1's dgrad without its top-left tap, and conv2's weight-gradient
    reduction without the last plane. Composed, every leaf within 6e-2 of
    ``composed_ref``; stage 1's forward without conv1's skip half must
    fail that limit."""
    p1 = _stage_params(card, 128, 32, 64)
    p2 = _stage_params(card, 64, 16, 32)
    head = dict(weight=0.2 * torch.randn(1, 32, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    params = [p1, p2, head]
    acts = [torch.randn(b * n, 128, h, h, generator=card, device='cuda'),
            torch.randn(b, 32, 2 * h, 2 * h, generator=card, device='cuda'),
            torch.randn(b, 16, 4 * h, 4 * h, generator=card, device='cuda')]
    acts = [t.bfloat16() for t in acts]
    g = torch.randn(b * n, 1, 4 * h, 4 * h, generator=card,
                    device='cuda').bfloat16()
    counts = (fused_decoder.launches, fused_decoder.bwd_tail_launches,
              fused_decoder.bwd_input_launches)
    got = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                        torch.bfloat16)
    assert (fused_decoder.launches, fused_decoder.bwd_tail_launches,
            fused_decoder.bwd_input_launches) == tuple(
                c + 2 for c in counts)
    ref = decoder_grads(rounded_at(acts[0], acts[1], p1), acts, params, g,
                        torch.bfloat16)
    again = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                          torch.bfloat16)
    torch.cuda.synchronize()
    names = ['x', 'skip1', 'skip2'] + [
        f'up{i}.{k}' for i in (1, 2) for k in fused_decoder.STAGE_KEYS] + [
        'head.weight', 'head.bias']
    composed = decoder_grads(composed_ref, acts, params, g, torch.bfloat16)
    for name, a, r, a2, c in zip(names, got, ref, again, composed):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert rel_l2(a, r.float()) < 2e-2, name
        assert rel_l2(a, c.float()) < 6e-2, name
        assert torch.equal(a, a2), name   # no atomics: bit for bit
    with _stage1_fault(skip_half=False):
        bad = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                            torch.bfloat16)
    assert max(rel_l2(a, c.float()) for a, c in zip(bad, composed)) > 6e-2

    real = fused_decoder._stage_bwd_input

    def without_a_tap(g_c1, up, xin, skip, p):
        w = p['conv1_weight'].detach().clone()
        w[:, :, 0, 0] = 0
        return real(g_c1, up, xin, skip, dict(p, conv1_weight=w))

    with mock.patch.object(fused_decoder, '_stage_bwd_input', without_a_tap):
        bad = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                            torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2
    real_tail = fused_decoder._stage_bwd_tail

    def without_last_plane(x, *a, **k):
        return real_tail(x, *a, wgrad_planes=x.shape[0] - 1, **k)

    with mock.patch.object(fused_decoder, '_stage_bwd_tail',
                           without_last_plane):
        bad = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                            torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2


# ------------------------------------------------ banded decoder backward

PASS_TOL = 5e-3   # rel-L2 of each pass output against its plain pass


def _cityscapes_decoder(card, b, n, h, w):
    """Cityscapes stage widths (Cin 128 / Cu 96 / Cs 32 / Cout 64, then
    64 / 32 / 32 / 32) on an h x w base grid."""
    p1 = _stage_params(card, 128, 32, 64)
    p2 = _stage_params(card, 64, 32, 32)
    head = dict(weight=0.2 * torch.randn(1, 32, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    acts = [torch.randn(b * n, 128, h, w, generator=card, device='cuda'),
            torch.randn(b, 32, 2 * h, 2 * w, generator=card, device='cuda'),
            torch.randn(b, 32, 4 * h, 4 * w, generator=card, device='cuda')]
    g = torch.randn(b * n, 1, 4 * h, 4 * w, generator=card, device='cuda')
    return [p1, p2, head], [t.bfloat16() for t in acts], g.bfloat16()


def _pass_errors(got, want):
    return {k: rel_l2(got[k], want[k].float()) for k in want}


@pytest.mark.parametrize('b,n,h,w', [(3, 19, 51, 51), (1, 3, 13, 11)])
def test_banded_passes_match_plain(card, b, n, h, w):
    """Passes A, B and C of both stages, each on its own inputs (the
    kernels' outputs of the pass before) against its plain version, both
    storing gy2, gy1 and the stage input's gradient in bf16: every
    output within PASS_TOL relative L2, bit for bit on a second run; the
    forward's saved statistics against the plain forward's. (3, 19, 51):
    the Cityscapes student shape with its odd 51-wide grid; (1, 3, 13, 11):
    ragged, non-square tiles."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    (p1, p2, head), (x, s1, s2), g = _cityscapes_decoder(card, b, n, h, w)
    with torch.no_grad():
        _, c2, st1, st2 = fdb.decoder_fwd_stats(x, s1, s2, p1, p2, head)
        _, plain_st1 = fused_decoder.stage_fwd_stats_plain(x, s1, p1)
        for got, want in zip(st1, plain_st1):
            assert rel_l2(got, want) < 1e-3
        gn_x = (st1[2], st1[3], p1['gn2_weight'], p1['gn2_bias'])
        errs = {}
        for stage, (xin, skip, p, st, gx, hd) in enumerate((
                (c2, s2, p2, st2, gn_x, head), (x, s1, p1, st1, None, None))):
            a = fdb.pass_a(xin, skip, p, st, g, gx, hd)
            errs[f'A{2 - stage}'] = _pass_errors(
                a, fdb.pass_a_plain(xin, skip, p, st, g, gx, hd))
            hw = a['raw2'].shape[2] * a['raw2'].shape[3]
            mg2 = fdb.close_gn(a['sgy2'], a['sgyx2'], p['gn2_weight'], hw)[2:]
            bb = fdb.pass_b(a['raw1'], a['raw2'], a['gy2'], p, st, mg2)
            errs[f'B{2 - stage}'] = _pass_errors(bb, fdb.pass_b_plain(
                a['raw1'], a['raw2'], a['gy2'], p, st, mg2))
            mg1 = fdb.close_gn(bb['sgy1'], bb['sgyx1'], p['gn1_weight'],
                               hw)[2:]
            args = (a['xin'], a['up'], skip, a['raw1'], bb['gy1'], p, st,
                    mg1)
            c = fdb.pass_c(*args)
            errs[f'C{2 - stage}'] = _pass_errors(c, fdb.pass_c_plain(*args))
            for out, again in (
                    (a, fdb.pass_a(xin, skip, p, st, g, gx, hd)),
                    (bb, fdb.pass_b(a['raw1'], a['raw2'], a['gy2'], p, st,
                                    mg2)),
                    (c, fdb.pass_c(*args))):
                assert all(torch.equal(out[k], again[k]) for k in out)
            for k in ('gy2', 'raw1', 'raw2', 'up'):
                assert a[k].dtype == torch.bfloat16, k
            assert bb['gy1'].dtype == c['g_x'].dtype == torch.bfloat16
            g = c['g_x']
    torch.cuda.synchronize()
    for name, e in errs.items():
        assert all(v < PASS_TOL for v in e.values()), (name, e)


def test_banded_backward_matches_rounded_reference(card):
    """The composed banded backward (``bwd='banded'``) against autograd
    through ``fused_vlg_decoder_rounded`` with its bf16 gradient roundings
    (the points where the banded passes store gradients in bf16), held as
    the whole-plane kernels are: every leaf within 2e-2 relative L2 of
    ``rounded_at`` and within 6e-2 of ``composed_ref``; three planted
    faults must fail the first limit: pass B's conv2 weight
    gradient reading its first 16-row band twice, pass A's recompute
    without conv1's skip half (inside its tensor-core product) and pass
    B's conv2 wgrad reduction without the last plane (inside the kernel,
    ``D_WG_PLANES``)."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    params, acts, g = _cityscapes_decoder(card, 1, 19, 51, 51)

    def banded(*a):
        return fused_decoder.fused_vlg_decoder(*a, bwd='banded')

    counts = (fdb.pass_a_launches, fdb.pass_b_launches, fdb.pass_c_launches)
    got = decoder_grads(banded, acts, params, g, torch.bfloat16)
    assert (fdb.pass_a_launches, fdb.pass_b_launches,
            fdb.pass_c_launches) == tuple(v + 2 for v in counts)
    ref = decoder_grads(rounded_at(acts[0], acts[1], params[0]), acts,
                        params, g, torch.bfloat16)
    composed = decoder_grads(composed_ref, acts, params, g, torch.bfloat16)
    torch.cuda.synchronize()
    errs = [rel_l2(a, r.float()) for a, r in zip(got, ref)]
    assert max(errs) < 2e-2, errs
    errs = [rel_l2(a, c.float()) for a, c in zip(got, composed)]
    assert max(errs) < 6e-2, errs
    real = fdb.pass_b

    def band_twice(raw1, raw2, gy2, p, stats, mg2):
        out = real(raw1, raw2, gy2, p, stats, mg2)
        extra = fdb.pass_b_plain(raw1[:, :, :16], raw2[:, :, :16],
                                 gy2[:, :, :16], p, stats, mg2)
        return dict(out, conv2_weight=out['conv2_weight']
                    + extra['conv2_weight'])

    with mock.patch.object(fdb, 'pass_b', band_twice):
        bad = decoder_grads(banded, acts, params, g, torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2
    with mock.patch.object(fdb, 'pass_a', functools.partial(
            fdb.pass_a, skip_half=False)):
        bad = decoder_grads(banded, acts, params, g, torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2

    def without_last_plane(raw1, *a):
        return real(raw1, *a, wgrad_planes=raw1.shape[0] - 1)

    with mock.patch.object(fdb, 'pass_b', without_last_plane):
        bad = decoder_grads(banded, acts, params, g, torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2


def test_decoder_kernels_take_padded_widths(card):
    """Widths the igemm products reach by zero padding (stage 1: Cin 128,
    Cu 80 -> 96, Cs 24 -> 32, Cout 32; stage 2: Cin 32, Cu 32, Cs 8 -> 16,
    Cout 16) through the forward (against the plain chain, 5e-2 of the
    logit scale) and both backward routes (every gradient leaf, at its
    true shape, within 2e-2 relative L2 of autograd through
    ``fused_vlg_decoder_rounded`` with float64 sums, ``rounded_at``, and
    within 6e-2 of ``composed_ref``); an output width that GroupNorm's
    groups do not split (Cout 33) is refused by name, as JAX refuses it."""
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    b, n, h = 2, 3, 12
    p1 = _stage_params(card, 128, 24, 32, cu=80)
    p2 = _stage_params(card, 32, 8, 16, cu=32)
    head = dict(weight=0.2 * torch.randn(1, 16, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    acts = [torch.randn(b * n, 128, h, h, generator=card, device='cuda'),
            torch.randn(b, 24, 2 * h, 2 * h, generator=card, device='cuda'),
            torch.randn(b, 8, 4 * h, 4 * h, generator=card, device='cuda')]
    acts = [t.bfloat16() for t in acts]
    g = torch.randn(b * n, 1, 4 * h, 4 * h, generator=card,
                    device='cuda').bfloat16()
    with torch.no_grad():
        got = fused_decoder.fused_vlg_decoder(*acts, p1, p2, head)
        want = fused_decoder.fused_vlg_decoder_plain(*acts, p1, p2, head)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() < 5e-2 * max(
        scale, 1.0)
    ref = decoder_grads(rounded_at(acts[0], acts[1], p1), acts,
                        [p1, p2, head], g, torch.bfloat16)
    composed = decoder_grads(composed_ref, acts, [p1, p2, head], g,
                             torch.bfloat16)
    counts = (fused_decoder.bwd_tail_launches, fdb.pass_b_launches)
    for route in ('whole', 'banded'):
        grads = decoder_grads(functools.partial(
            fused_decoder.fused_vlg_decoder, bwd=route), acts,
            [p1, p2, head], g, torch.bfloat16)
        torch.cuda.synchronize()
        for a, r, c in zip(grads, ref, composed):
            assert a.shape == r.shape, route
            assert rel_l2(a, r.float()) < 2e-2, route
            assert rel_l2(a, c.float()) < 6e-2, route
    assert (fused_decoder.bwd_tail_launches, fdb.pass_b_launches) == tuple(
        c + 2 for c in counts)
    odd = _stage_params(card, 128, 24, 33)
    with pytest.raises(ValueError, match=r'\(33, 2\)'):
        fused_decoder.fused_vlg_decoder(*acts, odd, p2, head)


def test_banded_passes_refuse_what_they_cannot_read(card):
    from semivl_tpu_torch.ops import fused_decoder_banded as fdb
    p = _stage_params(card, 64, 32, 32)
    raw = torch.zeros(2, 32, 8, 8, device='cuda')
    stats = tuple(torch.ones(2, 32, device='cuda') for _ in range(4))
    mg = (torch.zeros(2, 32, device='cuda'),) * 2
    with pytest.raises(ValueError, match='bf16'):
        fdb.pass_b(raw, raw, raw, p, stats, mg)
    with pytest.raises(ValueError, match='even'):
        odd = torch.zeros(2, 32, 7, 8, device='cuda', dtype=torch.bfloat16)
        fdb.pass_b(odd, odd, odd.float(), p, stats, mg)


# ------------------------------------------------ head-split attention

# (B, L, heads, D, valid_len): the tiny VLM's ViT (4 x 16) and semantic
# transformer (2 x 32), odd counts of 64-wide heads, encoder-length heads of
# 32 (with valid_len) and of 128, and the widths whose products are split
# (48, 80, 96, 112)
HEADS_CASES = [(2, 17, 4, 16, None), (8, 21, 2, 32, None),
               (2, 130, 3, 64, 100), (2, 1025, 24, 32, 1000),
               (1, 300, 8, 128, None), (2, 1536, 4, 48, None),
               (1, 1025, 12, 80, 1000), (2, 869, 8, 96, None),
               (2, 300, 3, 112, 250)]


@pytest.mark.parametrize('b,length,heads,d,valid_len', HEADS_CASES)
def test_heads_kernel_matches_plain(card, b, length, heads, d, valid_len):
    """The head-split forward rounds where its plain version does, so it
    is held to it at 2e-3 relative L2 (float32 sum order only); the
    backward at 5e-3; reruns are bit-identical."""
    qkv, g = _attention_case(card, b, length, heads, d)
    before = (flash_attention.heads_launches,
              flash_attention.heads_bwd_launches)
    out, lse = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    got = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads,
                                              valid_len)
    assert (flash_attention.heads_launches,
            flash_attention.heads_bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = flash_attention.heads_attention_plain(qkv, heads, valid_len)
    want_g = flash_attention.flash_mha_bwd_plain(qkv, out, g, heads,
                                                 valid_len)
    again = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(
        got.float()).all()
    assert rel_l2(out, want.float()) < 2e-3
    assert (out.float() - want.float()).abs().max().item() < 2e-2
    assert rel_l2(got, want_g.float()) < 5e-3
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(got, flash_attention.flash_mha_heads_bwd(
        qkv, out, lse, g, heads, valid_len))


@pytest.mark.parametrize('d', flash_attention.HEAD_DIMS)
@pytest.mark.parametrize('b,length,heads,valid_len', [
    (3, 40, 3, None), (2, 65, 2, None), (1, 2602, 2, None),
    (2, 300, 3, 250)])
def test_heads_forward_layouts(card, d, b, length, heads, valid_len):
    """The head-split forward at every head width (each its own swizzle
    and wgmma descriptors: 32, 64 and 128-byte rows, two boxes at D = 128,
    three to seven at the widths whose p v product is split)
    on one ragged tile (L < 64), one key past a tile of 64 (L = 65), the
    Cityscapes length and a valid_len inside a 128-key tile: within 2e-3
    relative L2 of its plain version, which rounds where it does, and bit
    for bit on a rerun."""
    qkv, _ = _attention_case(card, b, length, heads, d)
    out, lse = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    want = flash_attention.heads_attention_plain(qkv, heads, valid_len)
    again = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert rel_l2(out, want.float()) < 2e-3
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    c = heads * d
    qh, kh = (t.unflatten(-1, (heads, d)).transpose(1, 2)
              for t in qkv.split(c, dim=-1)[:2])
    s = torch.matmul((qh * flash_attention._q_scale(d)).float(),
                     kh.float().transpose(-1, -2))
    s[..., (valid_len or length):] = -1e30
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() < 1e-3


@pytest.mark.parametrize('d', flash_attention.HEAD_DIMS)
@pytest.mark.parametrize('b,length,heads,valid_len', [
    (3, 40, 3, None), (2, 65, 2, None), (1, 2602, 2, None),
    (2, 300, 3, 250), (2, 200, 2, 60)])
def test_heads_backward_layouts(card, d, b, length, heads, valid_len):
    """The backward at every head width (its own swizzle and descriptors,
    several boxes a row above D = 64 and at 48) on one ragged tile (L <
    64), one row past a tile of 64 (L = 65), the Cityscapes length,
    a valid_len inside a tile and one that leaves whole key blocks masked
    (their dk and dv must be written as zeros): within 5e-3 relative L2
    and 2e-2 of the scale of ``flash_mha_bwd_plain`` (the same rounding
    points), bit for bit on a rerun, into a buffer full of NaN."""
    qkv, g = _attention_case(card, b, length, heads, d)
    out, lse = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    want = flash_attention.flash_mha_bwd_plain(qkv, out, g, heads, valid_len)
    with mock.patch.object(torch, 'empty', lambda *a, **k: torch.full(
            *a, float('nan'), **k)):
        got = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads,
                                                  valid_len)
    again = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads,
                                                valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() < 2e-2 * scale
    assert rel_l2(got, want.float()) < 5e-3
    assert torch.equal(got, again)
    if valid_len is not None:
        c = heads * d
        assert (got[:, valid_len:, c:] == 0).all()   # masked keys: dk = dv = 0


def test_heads_kernel_agrees_with_packed(card):
    """12 heads of 64 through both kernel routes: the same function,
    rounded at other points (p before or after normalisation)."""
    qkv, g = _attention_case(card, 2, 1025, 12, 64)
    x = qkv.clone().requires_grad_(True)
    y = qkv.clone().requires_grad_(True)
    heads_out = flash_attention.heads_attention(x, 12)
    packed_out = flash_attention.packed_attention(y, 12)
    (gh,) = torch.autograd.grad(heads_out, x, g)
    (gp,) = torch.autograd.grad(packed_out, y, g)
    torch.cuda.synchronize()
    assert rel_l2(heads_out, packed_out.float()) < 5e-3
    assert rel_l2(gh, gp.float()) < 5e-3


@pytest.mark.parametrize('d', [8, 24, 40, 72])
def test_heads_kernels_take_padded_head_dims(card, d):
    """Head widths that are not a multiple of 16 run zero-padded to the
    next one with their own scale: forward within 2e-3 relative L2 of the
    plain version, backward within 5e-3 and 2e-2 of the scale of
    ``flash_mha_bwd_plain``, as at the kernels' own widths; bit for bit on
    a rerun; the launches counted."""
    heads = 3
    qkv, g = _attention_case(card, 2, 300, heads, d)
    f0, b0 = flash_attention.heads_launches, flash_attention.heads_bwd_launches
    out, lse = flash_attention.flash_mha_heads(qkv, heads, None, True)
    got = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads)
    assert (flash_attention.heads_launches,
            flash_attention.heads_bwd_launches) == (f0 + 1, b0 + 1)
    want = flash_attention.heads_attention_plain(qkv, heads)
    want_g = flash_attention.flash_mha_bwd_plain(qkv, out, g, heads)
    again = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads)
    torch.cuda.synchronize()
    assert out.shape == (2, 300, heads * d) and got.shape == qkv.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(
        got.float()).all()
    assert rel_l2(out, want.float()) < 2e-3
    scale = want_g.float().abs().max().item()
    assert (got.float() - want_g.float()).abs().max().item() < 2e-2 * scale
    assert rel_l2(got, want_g.float()) < 5e-3
    assert torch.equal(got, again)


def test_heads_kernel_refuses_other_head_dims(card):
    """Every width runs; what the kernels refuse is a width that does not
    split into the heads and a tensor that is not bf16."""
    qkv = torch.zeros(1, 8, 3 * 100, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='does not split'):
        flash_attention.heads_attention(qkv, 3)
    f = torch.zeros(1, 8, 3 * 64, device='cuda')
    with pytest.raises(ValueError, match='bf16'):
        flash_attention.heads_attention(f, 4)


@pytest.mark.parametrize('b,length,heads,d,valid_len', [
    (1, 300, 2, 136, None), (2, 200, 3, 192, 150), (1, 257, 2, 256, None)])
def test_wide_heads_kernels_match_plain(card, b, length, heads, d,
                                        valid_len):
    """Widths above 128 on the CUDA-core kernels (136 zero-padded to 144):
    forward within 2e-3 relative L2 of the plain version and backward
    within 5e-3 and 2e-2 of the scale of ``flash_mha_bwd_plain`` (the same
    rounding points, as at the tensor-core widths); bit for bit on a
    rerun; the launches counted; masked keys get zero dk and dv."""
    qkv, g = _attention_case(card, b, length, heads, d)
    f0, b0 = flash_attention.heads_launches, flash_attention.heads_bwd_launches
    out, lse = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    got = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads,
                                              valid_len)
    assert (flash_attention.heads_launches,
            flash_attention.heads_bwd_launches) == (f0 + 1, b0 + 1)
    want = flash_attention.heads_attention_plain(qkv, heads, valid_len)
    want_g = flash_attention.flash_mha_bwd_plain(qkv, out, g, heads,
                                                 valid_len)
    again = flash_attention.flash_mha_heads(qkv, heads, valid_len, True)
    again_g = flash_attention.flash_mha_heads_bwd(qkv, out, lse, g, heads,
                                                  valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(
        got.float()).all()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(got, again_g)
    assert rel_l2(out, want.float()) < 2e-3
    scale = want_g.float().abs().max().item()
    assert (got.float() - want_g.float()).abs().max().item() < 2e-2 * scale
    assert rel_l2(got, want_g.float()) < 5e-3
    if valid_len is not None:
        c = heads * d
        assert (got[:, valid_len:, c:] == 0).all()


def test_dispatcher_routes_on_the_card(card):
    """'pallas' sends heads of 32 to the head-split kernel at any length;
    'auto' only from 1536 tokens on (plain below), and heads of 64 in an
    even count to the packed kernel; heads wider than 128 take the
    head-split kernels too."""
    from semivl_tpu_torch.ops import attention

    def launches():
        return flash_attention.heads_launches, flash_attention.launches

    for length, impl, moved in ((64, 'pallas', (1, 0)), (64, 'auto', (0, 0)),
                                (1536, 'auto', (1, 0))):
        qkv, _ = _attention_case(card, 1, length, 4, 32)
        before = launches()
        attention.qkv_attention(qkv, 4, impl)
        assert tuple(a - b for a, b in zip(launches(), before)) == moved
    qkv, _ = _attention_case(card, 1, 64, 2, 64)
    before = launches()
    attention.qkv_attention(qkv, 2, 'auto')
    assert tuple(a - b for a, b in zip(launches(), before)) == (0, 1)
    # heads of 48 (a split p v product), of 24 (zero-padded to 32) and of
    # 136 (zero-padded to 144, the CUDA-core kernels) as JAX routes them
    for d in (48, 24, 136):
        qkv, _ = _attention_case(card, 1, 1536, 4, d)
        before = launches()
        out = attention.qkv_attention(qkv, 4, 'auto')
        assert tuple(a - b for a, b in zip(launches(), before)) == (1, 0)
        assert torch.isfinite(out.float()).all()


# ------------------------------------------------------ fused Up stage

@pytest.mark.parametrize('b,n,h,w,cin,cs,cout,with_head', [
    (2, 3, 16, 16, 128, 32, 64, False), (2, 3, 16, 16, 64, 16, 32, True),
    (1, 2, 13, 9, 32, 16, 16, False), (1, 2, 13, 9, 32, 16, 16, True),
    (2, 3, 12, 10, 128, 24, 32, True), (1, 3, 8, 8, 160, 16, 16, False)])
def test_fused_up_kernel_matches_plain(card, b, n, h, w, cin, cs, cout,
                                       with_head):
    """The Up stage (flagship widths, the tiny decoder's with ragged tiles,
    and widths it zero-pads: Cs 24 -> 32 with Cu 80 -> 96, Cs 8 -> 16 with
    Cu 144 in two column groups) against ``fused_up_stage_rounded`` (its
    own bf16 points) within 1e-2 relative L2 and against the plain bf16
    chain within 5e-2 of the output scale; bit-identical reruns; two
    planted faults (conv1 without its top-left tap; the kernel's sequence
    without conv1's skip half) fail the first limit."""
    from semivl_tpu_torch.ops import fused_up
    p = _stage_params(card, cin, cs, cout, {(128, 24): 80}.get((cin, cs)))
    x = torch.randn(b * n, cin, h, w, generator=card,
                    device='cuda').bfloat16()
    skip = torch.randn(b, cs, 2 * h, 2 * w, generator=card,
                       device='cuda').bfloat16()
    hd = None
    if with_head:
        hd = dict(weight=0.2 * torch.randn(1, cout, 3, 3, generator=card,
                                           device='cuda'),
                  bias=torch.randn(1, generator=card, device='cuda'))
    before = fused_up.launches
    got = fused_up.fused_up_stage(x, skip, p, hd)
    assert fused_up.launches == before + 1
    again = fused_up.fused_up_stage(x, skip, p, hd)
    ref = fused_up.fused_up_stage_rounded(x, skip, p, hd)
    plain = fused_up.fused_up_stage_plain(x, skip, p, hd)
    w0 = p['conv1_weight'].clone()
    w0[:, :, 0, 0] = 0
    bad = fused_up.fused_up_stage(x, skip, dict(p, conv1_weight=w0), hd)
    bad_seq = fused_up._kernel(x, skip, p, hd, skip_half=False)
    torch.cuda.synchronize()
    assert got.shape == plain.shape == (b * n, 1 if with_head else cout,
                                        2 * h, 2 * w)
    assert torch.equal(got, again)
    assert rel_l2(got, ref.float()) < 1e-2
    scale = plain.float().abs().max().item()
    assert (got.float() - plain.float()).abs().max().item() < 5e-2 * max(
        scale, 1.0)
    assert rel_l2(bad, ref.float()) > 1e-2
    assert rel_l2(bad_seq, ref.float()) > 1e-2


def test_fused_up_kernel_refuses(card):
    """The fused Up stage refuses by name what JAX refuses (Cout 33: JAX's
    GroupNorm assert) and a call that asks for a gradient; Cout 24 (one
    GroupNorm group of 24) runs on the kernel, cut back from GroupNorm's
    kernel layout, within 1e-2 relative L2 of its rounded reference."""
    from semivl_tpu_torch.ops import fused_up
    p = _stage_params(card, 64, 16, 33)
    x = torch.zeros(2, 64, 4, 4, device='cuda', dtype=torch.bfloat16)
    skip = torch.zeros(1, 16, 8, 8, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r'\(33, 2\)'):
        fused_up.fused_up_stage(x, skip, p)
    p = _stage_params(card, 64, 16, 24)
    xr = torch.randn(2, 64, 4, 4, generator=card, device='cuda').bfloat16()
    sr = torch.randn(1, 16, 8, 8, generator=card, device='cuda').bfloat16()
    before = fused_up.launches
    got = fused_up.fused_up_stage(xr, sr, p)
    assert fused_up.launches == before + 1 and got.shape == (2, 24, 8, 8)
    ref = fused_up.fused_up_stage_rounded(xr, sr, p)
    assert rel_l2(got, ref.float()) < 1e-2
    p = _stage_params(card, 64, 16, 32)
    p['conv1_weight'].requires_grad_(True)
    with pytest.raises(ValueError, match='forward only'):
        fused_up.fused_up_stage(x, skip, p)


def test_two_gloo_ranks_on_one_card_stay_equal(card, tmp_path):
    """Two ranks on card 0 (gloo: NCCL takes one rank a card) take one
    SemiVL step of the tiny VLM at 64 px, every attention on the
    head-split kernels: each rank launches them, and both ranks end with
    ``torch.equal`` trainable parameters."""
    import torch_dist_worker
    got = torch_dist_worker.launch('card_step', {}, str(tmp_path))
    for r in got:
        assert min(r['launches']) > 0 and r['loss'] == r['loss']
    assert got[0]['params'].keys() == got[1]['params'].keys()
    for k, v in got[0]['params'].items():
        assert torch.equal(v, got[1]['params'][k]), k
