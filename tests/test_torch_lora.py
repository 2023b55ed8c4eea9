"""The port's LoRA attention (``models.layers.LoRAAdapter`` and
``Attention(lora_rank=...)``) against JAX's ``semivl_tpu/models/layers.py``
on the CPU, float32, the same numpy-seeded weights carried by
``convert.export_attention``: the output, the MaskCLIP v-path and the
gradients of the input and of every leaf (the adapters' too), for each
target set.

Tolerance: 1e-5 of each output's or gradient's own scale (float32 sums in
other orders through two products and a softmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.models.layers import Attention as JaxAttention
from semivl_tpu_torch import convert
from semivl_tpu_torch.models.layers import Attention, LoRAAdapter

from torch_parity import init_params, rel_err
from torch_parity import few_threads  # noqa: F401 (autouse)

B, L, C, HEADS, RANK = 2, 17, 128, 2, 4
TOL = 1e-5


def _pair(targets, seed=0, scaling=0.5):
    """(jax module, numpy params with nonzero ``lora_b``, port layer with
    the same weights)."""
    jm = JaxAttention(num_heads=HEADS, lora_rank=RANK, lora_scaling=scaling,
                      lora_targets=targets)
    params = init_params(jm, seed, jnp.zeros((1, L, C)))
    pm = Attention(C, HEADS, lora_rank=RANK, lora_scaling=scaling,
                   lora_targets=targets)
    sd = {}
    convert.export_attention(sd, '', params)
    pm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}, strict=True)
    return jm, params, pm


@pytest.mark.parametrize('targets', ['qkvo', 'qv', 'k', 'o'])
def test_lora_attention_matches_jax(targets):
    """Forward, v-path and every gradient against JAX's
    ``Attention(lora_rank=...)``."""
    jm, params, pm = _pair(targets)
    assert {k for k in params if k.startswith('lora_')} == {
        f'lora_{t}' for t in targets}
    rs = np.random.RandomState(1)
    x = rs.randn(B, L, C).astype(np.float32)
    g = rs.randn(B, L, C).astype(np.float32)

    def loss(p, x):
        out, (_, _, v), _ = jm.apply({'params': p}, x, return_qkv=True)
        return jnp.sum(out * g), (out, v)

    (_, (out, v)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    w = params['out_proj']
    v_out = np.asarray(v) @ w['kernel'] + w['bias']

    xt = torch.from_numpy(x).requires_grad_(True)
    got, got_v = pm(xt, return_v=True)
    (got * torch.from_numpy(g)).sum().backward()
    assert rel_err(got.detach().numpy(), out) < TOL
    assert rel_err(got_v.detach().numpy(), v_out) < TOL
    assert rel_err(xt.grad.numpy(), gx) < TOL
    want = {}
    convert.export_attention(want, '', jax.tree.map(np.asarray, gp))
    grads = dict(pm.named_parameters())
    assert set(want) == set(grads)
    for name, p in grads.items():
        assert rel_err(p.grad.numpy(), want[name]) < TOL, name


def test_lora_starts_as_identity():
    """A new adapter's ``lora_b`` is zero, so the layer's output equals the
    layer's without adapters; ``lora_a`` is he-uniform over fan-in C (JAX's
    init) and both leaves have JAX's shapes."""
    torch.manual_seed(0)
    plain = Attention(C, HEADS)
    lora = Attention(C, HEADS, lora_rank=RANK)
    lora.attn.load_state_dict(plain.attn.state_dict())
    x = torch.randn(B, L, C)
    assert torch.equal(lora(x)[0], plain(x)[0])
    jshapes = jax.eval_shape(lambda: JaxAttention(
        num_heads=HEADS, lora_rank=RANK).init(
            jax.random.PRNGKey(0), jnp.zeros((1, L, C))))['params']
    for t in 'qkvo':
        adapter = getattr(lora, f'lora_{t}')
        assert isinstance(adapter, LoRAAdapter)
        for leaf in ('lora_a', 'lora_b'):
            assert tuple(getattr(adapter, leaf).shape) == \
                jshapes[f'lora_{t}'][leaf].shape
        assert not adapter.lora_b.any()
        a = adapter.lora_a.detach()
        bound = (6.0 / C) ** 0.5
        assert a.abs().max() <= bound and a.abs().max() > 0.8 * bound
    assert not hasattr(plain, 'lora_q')
