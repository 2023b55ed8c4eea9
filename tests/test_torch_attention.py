"""The port's attention dispatcher and head-split attention against the JAX
package on the CPU.

- ``ops.attention.route`` against JAX ``multi_head_attention``'s own
  choice (its kernels and ``_mha_xla`` replaced by recorders, the device
  platform faked as a TPU or a CPU) on a grid of head widths, head counts,
  lengths (1535 / 1536 either side of the 'auto' crossover) and
  cross-attention, under each implementation.
- The head-split plain forward against JAX ``flash_mha(interpret=True)``
  (its ``_fwd_kernel``) within 2e-5, at the shapes of
  ``tests/test_flash_attention.py`` and of the tiny VLM; gradients through
  the port's autograd Function against JAX's custom VJP (``_bwd_kernel``)
  within 1e-4, with and without ``valid_len``. Float32 on both sides.
- The plain version on bf16, the kernels' rounded reference, against the
  forward kernel's two-pass loop written out: the same bf16 roundings, so
  within float32 sum order (1e-3 relative L2).
"""

import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.ops import attention as jax_attention
from semivl_tpu.ops import flash_attention as jax_fa
from semivl_tpu_torch.models.layers import Attention, set_attention_impl
from semivl_tpu_torch.ops import attention, flash_attention

from torch_parity import rel_err

# (C, heads): heads of 64 in even / odd counts, of 16, 32 and 48, and a
# width the heads cannot split
WIDTHS = ((128, 2), (192, 3), (768, 12), (704, 11), (768, 24), (64, 4),
          (64, 2), (96, 2), (100, 3))
LENGTHS = (21, 1535, 1536)


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def _jax_route(q_len, kv_len, c, heads, impl, on_card):
    """Which of packed kernel / head-split kernel / ``_mha_xla`` JAX's
    ``multi_head_attention`` runs, on a TPU (on_card) or a CPU."""
    taken = []

    def record(name):
        def call(x, *a, **k):
            taken.append(name)
            return jnp.zeros(x.shape, x.dtype)
        return call

    q = jnp.zeros((1, q_len, c), jnp.float32)
    kv = jnp.zeros((1, kv_len, c), jnp.float32)
    platform = 'tpu' if on_card else 'cpu'
    with mock.patch.object(jax, 'devices',
                           lambda *a: [_FakeDevice(platform)]), \
            mock.patch.object(jax_fa, '_packed_attention',
                              record('packed')), \
            mock.patch.object(jax_fa, '_fused_attention', record('heads')), \
            mock.patch.object(jax_attention, '_mha_xla', record('plain')):
        jax_attention.multi_head_attention(q, kv, kv, heads, impl=impl)
    assert len(taken) == 1, taken
    return taken[0]


@pytest.mark.parametrize('on_card', [False, True])
@pytest.mark.parametrize('impl', ['auto', 'xla', 'pallas'])
def test_route_matches_jax_table(impl, on_card):
    cases = [(n, n, c, h) for n in LENGTHS for c, h in WIDTHS]
    cases += [(21, 7, 128, 2), (1536, 21, 192, 3)]   # cross-attention
    seen = set()
    for q_len, kv_len, c, heads in cases:
        want = _jax_route(q_len, kv_len, c, heads, impl, on_card)
        got = attention.route(q_len, kv_len, c, heads, impl, on_card)
        assert got == want, (q_len, kv_len, c, heads, impl, on_card)
        seen.add(got)
    assert seen == ({'plain'} if impl == 'xla' or (impl == 'auto' and
                                                   not on_card)
                    else {'plain', 'packed', 'heads'})


def test_route_refuses_unknown_impl():
    with pytest.raises(ValueError, match='impl'):
        attention.route(8, 8, 64, 1, 'flash', True)
    layer = Attention(64, 1)
    with pytest.raises(ValueError, match='attention_impl'):
        set_attention_impl(layer, 'flash')
    assert layer.impl == 'auto'


def test_head_dims_are_the_kernel_instances():
    """``HEAD_DIMS`` names the widths ``csrc/flash_attention_heads.cu``
    instantiates, forward and backward: every multiple of 16 up to 128."""
    path = os.path.join(os.path.dirname(flash_attention.__file__), os.pardir,
                        'csrc', 'flash_attention_heads.cu')
    with open(path) as f:
        src = f.read()
    for macro in ('SEMIVL_HEADS_FWD', 'SEMIVL_HEADS_BWD'):
        got = tuple(int(n) for n in re.findall(rf'^ +{macro}\((\d+)\)$', src,
                                               re.M))
        assert got == flash_attention.HEAD_DIMS, macro
    assert flash_attention.HEAD_DIMS == tuple(range(16, 129, 16))


@pytest.mark.parametrize('d', [8, 24, 48, 112, 136, 144, 192, 256])
def test_heads_kernel_names_a_width_it_does_not_take(d):
    """The kernels' checks take every head width, as JAX's any-width
    kernels do (a width that is not a multiple of 16 zero-padded to the
    next one, those above 128 on the CUDA-core kernels), and pass it on to
    the next check, the tensor's device: the wrappers name no width they
    refuse, forward or backward."""
    qkv = torch.zeros(1, 8, 3 * 2 * d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='bf16 CUDA'):
        flash_attention.flash_mha_heads(qkv, 2)
    out = torch.zeros(1, 8, 2 * d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='bf16 CUDA'):
        flash_attention.flash_mha_heads_bwd(qkv, out, None, out, 2)


@pytest.mark.parametrize('d', [136, 192, 256])
def test_wide_heads_route_to_the_kernels(d):
    """Heads wider than 128: the dispatcher sends them where JAX sends
    them, the head-split kernel under 'pallas' and under 'auto' on the card
    from 1536 tokens on; the wrappers take them through to the device
    check."""
    for length, impl, want in ((1536, 'auto', 'heads'), (1535, 'auto', 'plain'),
                               (64, 'pallas', 'heads')):
        got = attention.route(length, length, 2 * d, 2, impl, True)
        assert got == want == _jax_route(length, length, 2 * d, 2, impl,
                                         True), (length, impl)
    qkv = torch.zeros(1, 1536, 3 * 2 * d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='bf16 CUDA'):
        flash_attention.flash_mha_heads(qkv, 2)


def _attention_at(qkv, heads, scale):
    """Softmax attention of each head in float64 with the given scale."""
    q, k, v = (flash_attention._split_heads(t, heads)
               for t in qkv.chunk(3, dim=-1))
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    return flash_attention._merge_heads(torch.matmul(p, v))


@pytest.mark.parametrize('d', [8, 24, 40, 136, 200])
def test_padded_heads_are_attention_at_the_true_width(d):
    """What the kernels get for a width that is not a multiple of 16: each
    head zero-padded to the next (``pad_heads``), attention there with the
    true width's scale, sliced back (``unpad_heads``), equals attention at
    the true width, forward and backward (float64, 1e-12)."""
    heads, dp = 3, flash_attention.padded_head_dim(d)
    assert dp % 16 == 0 and dp - d < 16
    rs = np.random.RandomState(d)
    qkv = torch.from_numpy(rs.randn(2, 7, 3 * heads * d)).requires_grad_(
        True)
    g = torch.from_numpy(rs.randn(2, 7, heads * d))
    want = _attention_at(qkv, heads, d ** -0.5)
    padded = flash_attention.pad_heads(qkv, heads, 3)
    assert padded.shape == (2, 7, 3 * heads * dp)
    got = flash_attention.unpad_heads(
        _attention_at(padded, heads, d ** -0.5), heads, d)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-12
    (gw,) = torch.autograd.grad(want, qkv, g)
    (gg,) = torch.autograd.grad(got, qkv, g)
    assert (gg - gw).abs().max().item() < 1e-12


def _qkv(seed, b, length, c, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(b, length, 3 * c).astype(dtype), rs.randn(
        b, length, c).astype(dtype)


def _jax_heads(qkv, heads, valid_len=None):
    q, k, v = (jnp.asarray(a) for a in np.split(qkv, 3, axis=-1))
    return jax_fa.flash_mha(q, k, v, heads, interpret=True,
                            valid_len=valid_len)


# (B, L, C, heads): tests/test_flash_attention.py (head_dim 8), the tiny
# VLM's ViT (4 heads of 16) and semantic transformer (2 heads of 32), and an
# odd count of 64-wide heads
SHAPES = [(2, 65, 32, 4), (1, 128, 64, 8), (3, 100, 48, 6), (2, 17, 64, 4),
          (8, 21, 64, 2), (2, 30, 192, 3)]


@pytest.mark.parametrize('b,length,c,heads', SHAPES)
def test_heads_plain_matches_jax(b, length, c, heads):
    qkv, _ = _qkv(length + c, b, length, c)
    want = np.asarray(_jax_heads(qkv, heads))
    t = torch.from_numpy(qkv)
    before = flash_attention.heads_launches
    got = attention.qkv_attention(t, heads, 'pallas')
    q, k, v = (torch.from_numpy(a) for a in np.split(qkv, 3, axis=-1))
    via_qkv = attention.multi_head_attention(q, k, v, heads, 'pallas')
    assert flash_attention.heads_launches == before   # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(via_qkv, got)
    if c // heads != 64 or heads % 2:
        assert attention.route(length, length, c, heads, 'pallas',
                               False) == 'heads'


@pytest.mark.parametrize('b,length,c,heads,valid_len', [
    (1, 40, 32, 4, None), (2, 17, 64, 4, None), (8, 21, 64, 2, 18),
    (2, 70, 192, 3, 61)])
def test_heads_grad_matches_jax(b, length, c, heads, valid_len):
    """Autograd through the port's Function (CPU: the plain backward) and
    through the plain forward, against jax.vjp of the head-split kernels
    in interpret mode."""
    qkv, g = _qkv(length + 7, b, length, c)
    _, vjp = jax.vjp(lambda a: _jax_heads(a, heads, valid_len),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    before = flash_attention.heads_bwd_launches
    for fn in (flash_attention.heads_attention,
               flash_attention.heads_attention_plain):
        x = torch.from_numpy(qkv).requires_grad_(True)
        (got,) = torch.autograd.grad(fn(x, heads, valid_len), x,
                                     torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert flash_attention.heads_bwd_launches == before


def _rel_l2(a, ref):
    a, ref = a.double(), ref.double()
    return ((a - ref).norm() / ref.norm()).item()


def _two_pass_loop(qkv, heads, valid_len):
    """The head-split forward kernel's loop written out: q times the bf16
    scale rounded to bf16, pass 1 the running max and rescaled sum over
    the kernel's key tiles (``_BK``), pass 2 p = exp(s - max) / sum rounded
    to bf16 before p v, the output rounded to bf16."""
    b, length, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = flash_attention._q_scale(d)
    x = qkv.float()
    out = torch.empty(b, length, c)
    for bi in range(b):
        for h in range(heads):
            q, k, v = (x[bi, :, j * c + d * h:][:, :d] for j in range(3))
            q = (q * scale).bfloat16().float()
            m = torch.full((length,), float('-inf'))
            row_sum = torch.zeros(length)
            bk = flash_attention._BK
            tiles = range(0, valid_len, bk)
            for k0 in tiles:
                s = q @ k[k0:k0 + bk].T
                s[:, torch.arange(k0, k0 + s.shape[1]) >= valid_len] = -1e30
                m_new = torch.maximum(m, s.amax(1))
                row_sum = (row_sum * torch.exp(m - m_new)
                           + torch.exp(s - m_new[:, None]).sum(1))
                m = m_new
            acc = torch.zeros(length, d)
            for k0 in tiles:
                s = q @ k[k0:k0 + bk].T
                s[:, torch.arange(k0, k0 + s.shape[1]) >= valid_len] = -1e30
                p = torch.exp(s - m[:, None]) / row_sum[:, None]
                acc = acc + p.bfloat16().float() @ v[k0:k0 + bk]
            out[bi, :, d * h:d * (h + 1)] = acc
    return out.bfloat16()


@pytest.mark.parametrize('length,c,heads,valid_len', [
    (17, 64, 4, None), (21, 64, 2, None), (150, 96, 3, 140),
    (130, 256, 2, None)])
def test_heads_rounded_reference(length, c, heads, valid_len):
    """On bf16 inputs the plain forward is the kernel's two-pass loop (to
    the order of float32 sums: 1e-3 relative L2) and the gradient through
    the autograd Function is ``flash_mha_bwd_plain``; both stay within bf16
    rounding (5e-3 relative L2) of the float32 plain version."""
    qkv, g = _qkv(length + 3, 2, length, c)
    qkv, g = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16()
    x = qkv.clone().requires_grad_(True)
    out = flash_attention.heads_attention(x, heads, valid_len)
    (got,) = torch.autograd.grad(out, x, g)
    out = out.detach()
    assert out.dtype == got.dtype == torch.bfloat16
    assert _rel_l2(out, _two_pass_loop(qkv, heads, valid_len or length)) \
        < 1e-3
    assert torch.equal(out, flash_attention.heads_attention_plain(
        qkv, heads, valid_len))
    assert torch.equal(got, flash_attention.flash_mha_bwd_plain(
        qkv, out, g, heads, valid_len))
    x32 = qkv.float().requires_grad_(True)
    out32 = flash_attention.heads_attention_plain(x32, heads, valid_len)
    (want,) = torch.autograd.grad(out32, x32, g.float())
    assert _rel_l2(out, out32.detach()) < 5e-3
    assert _rel_l2(got, want) < 5e-3


def test_dispatcher_cross_attention_and_default():
    """Cross-attention runs the plain math under every impl; a layer runs
    'auto' unless ``set_attention_impl`` names another, and setting one
    layer leaves the others as they were."""
    rs = np.random.RandomState(9)
    q = torch.from_numpy(rs.randn(2, 21, 64).astype(np.float32))
    kv = torch.from_numpy(rs.randn(2, 7, 64).astype(np.float32))
    want = np.asarray(jax_attention._mha_xla(
        jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
        jnp.asarray(kv.numpy()), 2))
    for impl in ('auto', 'xla', 'pallas'):
        got = attention.multi_head_attention(q, kv, kv, 2, impl)
        assert rel_err(got.numpy(), want) < 1e-5
    layers = [Attention(64, 2), Attention(64, 2)]
    set_attention_impl(layers[0], 'pallas')
    assert [m.impl for m in layers] == ['pallas', 'auto']
    taken = []
    real = flash_attention.heads_attention

    def record(*args):
        taken.append('heads')
        return real(*args)

    qkv = torch.cat([q, q, q], dim=-1)
    with mock.patch.object(flash_attention, 'heads_attention', record):
        got = attention.qkv_attention(qkv, 2, layers[0].impl)
        attention.qkv_attention(qkv, 2, layers[1].impl)
    assert taken == ['heads']   # only the 'pallas' layer's call
    assert rel_err(got.numpy(), np.asarray(_jax_heads(qkv.numpy(), 2))) < 1e-5
