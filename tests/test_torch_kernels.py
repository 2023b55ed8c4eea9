"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU (a CUDA kernel has no CPU mode). The file imports neither JAX nor the
JAX package, so on the machine with the card it runs without the repo's
JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Tolerances (bf16 on both sides, float32 accumulation): attention output
within 2e-2 absolute for unit-normal q, k, v (the kernel rounds the
unnormalised probabilities to bf16, the plain version the normalised ones);
decoder logits within 5e-2 of the logit scale (bf16 storage between the
convolutions, sums in other orders, GroupNorm amplifying both).
"""

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


@pytest.mark.parametrize('b,length,heads,valid_len,packed', [
    (2, 1025, 12, None, True), (128, 21, 4, None, True),
    (2, 130, 2, 100, True), (3, 64, 1, None, False)])
def test_attention_kernel_matches_plain(card, b, length, heads, valid_len,
                                        packed):
    c = 64 * heads
    qkv = torch.randn(b, length, 3 * c, generator=card, device='cuda',
                      dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = flash_attention.launches
    got = flash_attention.flash_mha(q, k, v, heads, valid_len=valid_len)
    assert flash_attention.launches == before + 1
    want = flash_attention.flash_mha_plain(q, k, v, heads, valid_len)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() < 2e-2


def test_attention_kernel_refuses_other_head_dims(card):
    q = torch.zeros(1, 8, 96, device='cuda', dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head_dim 64'):
        flash_attention.flash_mha(q, q, q, 3)
    f = torch.zeros(1, 8, 64, device='cuda')
    with pytest.raises(ValueError, match='bf16'):
        flash_attention.flash_mha(f, f, f, 1)


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
