"""The port's MaskCLIP heads (``models.maskclip_heads``) against JAX's
``semivl_tpu/models/maskclip_heads.py`` on the CPU, float32, the same
numpy-seeded features, text and projection.

Tolerance: 1e-5 of the output's scale. The refinements' thresholds are
put in a gap of the confidences they compare (``gap_threshold``), so no
class or pixel sits within float32 rounding of one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.models.maskclip_heads import (MaskClip2Head as JaxHead2,
                                              MaskClipHead as JaxHead)
from semivl_tpu_torch.models.maskclip_heads import MaskClip2Head, MaskClipHead

from torch_parity import MARGIN, gap_threshold, rel_err
from torch_parity import few_threads  # noqa: F401 (autouse)

B, H, W, C, CT, N = 2, 6, 7, 48, 32, 5
TOL = 1e-5


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    v = rs.randn(B, H, W, C).astype(np.float32)
    k = rs.randn(B, H, W, C).astype(np.float32)
    # texts close to one another, so that the x100 softmax is not
    # saturated and the confidences spread
    text = (rs.randn(1, CT) + 0.03 * rs.randn(N, CT)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    proj = (rs.randn(C, CT) / np.sqrt(C)).astype(np.float32)
    return v, k, text, proj


def test_maskclip2_head_matches_jax():
    v, _, text, _ = _inputs()
    feat = v[..., :CT] / np.linalg.norm(v[..., :CT], axis=-1, keepdims=True)
    for size in (None, (13, 11)):
        want = np.asarray(JaxHead2(img_size=16).apply(
            {}, jnp.asarray(feat), jnp.asarray(text), output_size=size))
        got = MaskClip2Head(16)(torch.from_numpy(feat),
                                torch.from_numpy(text), output_size=size)
        assert got.shape == want.shape == (B, N) + (size or (16, 16))
        assert rel_err(got.numpy(), want) < TOL


def _thresholds(v, k, text, proj):
    """Prompt-denoising and key-smoothing thresholds in gaps of the
    class-wise and pixel-wise confidences they compare."""
    feat = v @ proj
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    logits = 100.0 * np.einsum('bhwc,nc->bnhw', feat, text)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    pd, m1 = gap_threshold(p.reshape(B, N, -1).max(-1), 0.2, 0.8)
    pix = np.where((p.reshape(B, N, -1).max(-1) < pd)[:, :, None, None],
                   -100.0, logits / 100.0) * 100.0
    q = np.exp(pix - pix.max(1, keepdims=True))
    q /= q.sum(1, keepdims=True)
    ks, m2 = gap_threshold(q.max(1), 0.2, 0.8)
    assert min(m1, m2) > 10 * MARGIN
    return pd, ks


@pytest.mark.parametrize('refine', ['none', 'pd', 'ks', 'pd+ks'])
def test_maskclip_head_matches_jax(refine):
    """The projection, normalisation and text product, with prompt
    denoising (``pd_thresh``), key smoothing (``ks_thresh``, over the keys'
    (B, HW, HW) affinity), both or neither."""
    v, k, text, proj = _inputs()
    pd, ks = _thresholds(v, k, text, proj)
    pd = pd if 'pd' in refine else 0.0
    ks = ks if 'ks' in refine else 0.0
    want = np.asarray(JaxHead(text_channels=CT, ks_thresh=ks,
                              pd_thresh=pd).apply(
        {'params': {'proj': {'kernel': jnp.asarray(proj)}}},
        jnp.asarray(v), jnp.asarray(text), jnp.asarray(k)))
    head = MaskClipHead(C, CT, ks_thresh=ks, pd_thresh=pd)
    with torch.no_grad():
        head.proj.weight.copy_(torch.from_numpy(proj.T.copy()))
    got = head(torch.from_numpy(v), torch.from_numpy(text),
               torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got.detach().numpy(), want) < TOL
    if refine == 'pd':   # some class suppressed (key smoothing then
        assert (want == -100.0).any()   # turns the logits to probabilities)
