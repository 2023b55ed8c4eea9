"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
(bf16 storage between the convolutions, GroupNorm amplifying it).
Backward: the attention gradient within 2e-2 of its scale (dq, dk, dv are
rounded to bf16 once, p and ds before their products, as in the plain
version); each decoder gradient within 2e-2 relative L2 of autograd
through ``fused_vlg_decoder_rounded`` (a flipped bf16 rounding of a raw
conv output, which GroupNorm amplifies, is the whole difference).
"""

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
    (3, 64, 1, None)])
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


def _stage_params(gen, cin, cs, cout):
    cu = cin - cs

    def u(*shape):
        fan_in = torch.Size(shape[1:]).numel()
        return ((torch.rand(shape, generator=gen, device='cuda') * 2 - 1)
                / fan_in ** 0.5)

    def n(c, mean):
        return mean + 0.2 * torch.randn(c, generator=gen, device='cuda')

    return dict(up_weight=u(cin, cu, 2, 2), up_bias=n(cu, 0.0),
                conv1_weight=u(cout, cin, 3, 3), gn1_weight=n(cout, 1.0),
                gn1_bias=n(cout, 0.0), conv2_weight=u(cout, cout, 3, 3),
                gn2_weight=n(cout, 1.0), gn2_bias=n(cout, 0.0))


@pytest.mark.parametrize('b,n,h', [(2, 21, 32), (1, 3, 13)])
def test_decoder_kernel_matches_plain(card, b, n, h):
    """Flagship widths; (1, 3, 13) leaves ragged 16x16 tiles."""
    p1 = _stage_params(card, 128, 32, 64)
    p2 = _stage_params(card, 64, 16, 32)
    head = dict(weight=0.2 * torch.randn(1, 32, 3, 3, generator=card,
                                         device='cuda'),
                bias=torch.randn(1, generator=card, device='cuda'))
    x = torch.randn(b * n, 128, h, h, generator=card, device='cuda')
    s1 = torch.randn(b, 32, 2 * h, 2 * h, generator=card, device='cuda')
    s2 = torch.randn(b, 16, 4 * h, 4 * h, generator=card, device='cuda')
    args = [t.bfloat16() for t in (x, s1, s2)]
    before = fused_decoder.launches
    got = fused_decoder.fused_vlg_decoder(*args, p1, p2, head)
    assert fused_decoder.launches == before + 2
    want = fused_decoder.fused_vlg_decoder_plain(*args, p1, p2, head)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b * n, 1, 4 * h, 4 * h)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err < 5e-2 * max(scale, 1.0), (err, scale)


def _attention_case(card, b, length, heads, valid_len):
    c = 64 * heads
    qkv = torch.randn(b, length, 3 * c, generator=card, device='cuda',
                      dtype=torch.bfloat16)
    g = torch.randn(b, length, c, generator=card, device='cuda',
                    dtype=torch.bfloat16)
    return qkv, g


@pytest.mark.parametrize('b,length,heads,valid_len', [
    (4, 1025, 12, None), (384, 21, 4, None), (2, 130, 2, 100)])
def test_attention_bwd_kernel_matches_plain(card, b, length, heads,
                                            valid_len):
    qkv, g = _attention_case(card, b, length, heads, valid_len)
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
    qkv, g = _attention_case(card, 2, 130, 2, None)
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


@pytest.mark.parametrize('b,n,h', [(2, 21, 32), (1, 3, 13)])
def test_decoder_bwd_kernels_match_plain(card, b, n, h):
    """Gradients of every input and parameter against autograd through
    ``fused_vlg_decoder_rounded`` (bf16 where the kernels store bf16,
    float32 sums): each within 2e-2 relative L2; (1, 3, 13) leaves ragged
    tiles in every kernel. A planted fault, conv1's dgrad without its
    top-left tap, must fail that limit."""
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
    ref = decoder_grads(fused_decoder.fused_vlg_decoder_rounded, acts,
                        params, g, torch.bfloat16)
    again = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                          torch.bfloat16)
    torch.cuda.synchronize()
    names = ['x', 'skip1', 'skip2'] + [
        f'up{i}.{k}' for i in (1, 2) for k in fused_decoder.STAGE_KEYS] + [
        'head.weight', 'head.bias']
    for name, a, r, a2 in zip(names, got, ref, again):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert rel_l2(a, r.float()) < 2e-2, name
        assert torch.equal(a, a2), name   # no atomics: bit for bit

    real = fused_decoder._stage_bwd_input

    def without_a_tap(g_c1, up, xin, skip, p):
        w = p['conv1_weight'].detach().clone()
        w[:, :, 0, 0] = 0
        return real(g_c1, up, xin, skip, dict(p, conv1_weight=w))

    with mock.patch.object(fused_decoder, '_stage_bwd_input', without_a_tap):
        bad = decoder_grads(fused_decoder.fused_vlg_decoder, acts, params, g,
                            torch.bfloat16)
    assert max(rel_l2(a, r.float()) for a, r in zip(bad, ref)) > 2e-2
