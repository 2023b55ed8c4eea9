"""The port's fused Up stage (``ops.fused_up``) against the JAX package on
the CPU: its plain version against JAX ``fused_up_stage(interpret=True)``
(the Pallas ``_up_fused_kernel``) and against the flax ``Up`` module, at the
geometries of ``tests/test_fused_up.py`` (including Cout = 24, one
24-channel GroupNorm group) and with the fused head, float32 on both sides,
within the 2e-5 (3e-5 with the head) that test holds the JAX kernel to; the
rounded reference's structure; the bench tool on the CPU.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.models.vlg_head import Up
from semivl_tpu.ops.fused_up import fused_up_stage as jax_fused_up_stage
from semivl_tpu_torch import convert
from semivl_tpu_torch.ops import fused_decoder, fused_up
from semivl_tpu_torch.tools import fused_up_bench


def _jax_up(b, n, h, w, cin, cs, cout, seed=0):
    """Inputs and randomised flax ``Up`` params as the JAX test makes them;
    returns NHWC x and skip, the variables and the module."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(b * n, h, w, cin), jnp.float32)
    skip = jnp.asarray(rng.randn(b, 2 * h, 2 * w, cs), jnp.float32)
    module = Up(cout, cs, dtype=jnp.float32)
    params = module.init(jax.random.PRNGKey(0), x, skip)['params']
    params = jax.tree.map(lambda p: p + 0.1 * jnp.asarray(
        np.random.RandomState(1).randn(*p.shape), p.dtype), params)
    return x, skip, params, module


def _cf(a):
    return jnp.transpose(a, (0, 3, 1, 2))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize('b,n,h,w,cin,cs,cout', [
    (2, 3, 16, 16, 64, 16, 32),     # up2-like
    (1, 2, 16, 16, 128, 32, 64),    # up1-like
    (1, 2, 16, 16, 64, 16, 24),     # Cout 24: one GroupNorm group of 24
    (1, 2, 6, 16, 32, 16, 16)])     # non-square, Cout 16
def test_fused_up_plain_matches_jax(b, n, h, w, cin, cs, cout):
    x, skip, params, module = _jax_up(b, n, h, w, cin, cs, cout)
    want_flax = np.asarray(_cf(module.apply({'params': params}, x, skip)))
    want_kernel = np.asarray(jax_fused_up_stage(_cf(x), _cf(skip), params,
                                                interpret=True))
    p = convert.up_stage_params(jax.tree.map(np.asarray, params))
    before = fused_up.launches
    got = fused_up.fused_up_stage(_t(_cf(x)), _t(_cf(skip)), p).numpy()
    assert fused_up.launches == before   # CPU: plain version
    assert got.shape == (b * n, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_flax, rtol=2e-5, atol=2e-5)


def test_fused_up_head_matches_jax():
    """The head epilogue: Up -> 3x3 head conv to one channel, plus bias."""
    b, n, h, w, cin, cs, cout = 1, 3, 16, 16, 64, 16, 32
    x, skip, params, module = _jax_up(b, n, h, w, cin, cs, cout, seed=3)
    head = nn.Conv(1, (3, 3), padding=((1, 1), (1, 1)))
    hv = head.init(jax.random.PRNGKey(1),
                   jnp.zeros((1, 2 * h, 2 * w, cout), jnp.float32))
    hp = jax.tree.map(lambda p: p + 0.2 * jnp.asarray(
        np.random.RandomState(5).randn(*p.shape), p.dtype), hv['params'])
    want_flax = np.asarray(_cf(head.apply(
        {'params': hp}, module.apply({'params': params}, x, skip))))
    want_kernel = np.asarray(jax_fused_up_stage(
        _cf(x), _cf(skip), params, head_params=hp, interpret=True))
    p, hd = convert.up_stage_params(jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, hp))
    got = fused_up.fused_up_stage(_t(_cf(x)), _t(_cf(skip)), p, hd).numpy()
    assert got.shape == (b * n, 1, 2 * h, 2 * w)
    np.testing.assert_allclose(got, want_kernel, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, want_flax, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize('with_head', [False, True])
def test_fused_up_rounded_reference(monkeypatch, with_head):
    """Without its roundings it is the plain stage in float32 (1e-5); with
    them it stays within bf16 storage (1e-2 relative L2) of it."""
    x, skip, p = fused_up_bench.make_stage(8, 32, 16, 32, batch=2,
                                           classes=2, device='cpu',
                                           dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    hd = dict(weight=0.2 * torch.randn(1, 32, 3, 3, generator=gen),
              bias=torch.randn(1, generator=gen)) if with_head else None
    want = fused_up.fused_up_stage_plain(x, skip, p, hd)
    rounded = fused_up.fused_up_stage_rounded(x, skip, p, hd)
    rel = ((rounded - want).norm() / want.norm()).item()
    assert 0 < rel < 1e-2
    monkeypatch.setattr(fused_decoder, '_round_bf16', lambda t: t)
    got = fused_up.fused_up_stage_rounded(x, skip, p, hd)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5


def test_fused_up_refuses_what_it_cannot_run():
    """On the CPU the kernel itself refuses (its wrapper routes CPU tensors
    to the plain version); Cout 24 is outside the kernel's set."""
    x, skip, p = fused_up_bench.make_stage(4, 64, 16, 24, batch=1, classes=2,
                                           device='cpu')
    with pytest.raises(ValueError, match='bf16 CUDA'):
        fused_up._kernel(x, skip, p, None)
    assert fused_up.fused_up_stage(x, skip, p).shape == (2, 24, 8, 8)


def test_fused_up_bench_on_cpu(capsys):
    rows = fused_up_bench.main(['--device', 'cpu', '--batch', '1',
                                '--classes', '2', '--iters', '1'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(':')[0] for ln in lines] == ['up1', 'up2']
    for ln, r in zip(lines, rows):
        for col in ('plain', 'fused', 'speedup', 'mean|err|', 'cudnn'):
            assert col in ln
        assert r['mean_err'] == 0.0 and r['signal'] > 0   # CPU: both plain
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            fused_up_bench.main(['--iters', '1'])
