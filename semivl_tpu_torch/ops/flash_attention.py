"""Packed multi-head self-attention: the Hopper kernel and its plain version.

Counterpart of ``semivl_tpu/ops/flash_attention.py::flash_mha`` (packed
path, ``_packed_fwd_kernel``) and of the routing in
``semivl_tpu/ops/attention.py::multi_head_attention``; the plain version is
that module's ``_mha_xla``. ``flash_mha`` takes (B, L, C) tensors, with
q, k and v allowed to be column slices of one (B, L, 3C) projection. CUDA
tensors launch ``csrc/flash_attention.cu`` (bf16, head_dim 64) or raise;
CPU tensors take ``flash_mha_plain``.
"""

import ctypes

import torch

from semivl_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])


def flash_mha_plain(q, k, v, num_heads, valid_len=None):
    """The JAX ``_mha_xla`` math: q scaled by 1/sqrt(d) in its own dtype,
    logits in the input dtype, float32 softmax with keys at or past
    ``valid_len`` masked to -1e30, probabilities cast back before p v."""
    b, lq, c = q.shape
    d = c // num_heads

    def split(x):
        return x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2)

    qh = split(q) * torch.tensor(d ** -0.5, dtype=q.dtype)
    logits = torch.matmul(qh, split(k).transpose(-1, -2)).float()
    if valid_len is not None and valid_len < k.shape[1]:
        kidx = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(kidx >= valid_len, -1e30)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype), split(v))
    return out.transpose(1, 2).reshape(b, lq, c)


def _check(q, k, v, num_heads, valid_len):
    b, l, c = q.shape
    if c != num_heads * 64:
        raise ValueError(f'flash_mha kernel needs head_dim 64: C={c}, '
                         f'{num_heads} heads')
    for name, t in (('k', k), ('v', v)):
        if t.shape != q.shape:
            raise ValueError(f'flash_mha kernel is self-attention only: q '
                             f'{tuple(q.shape)}, {name} {tuple(t.shape)}')
        if t.stride() != q.stride():
            raise ValueError('q, k and v must share strides')
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f'flash_mha kernel takes bf16 CUDA tensors, '
                             f'got {t.dtype} on {t.device}')
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 \
                or t.data_ptr() % 16:
            raise ValueError('flash_mha kernel needs unit column stride and '
                             '16-byte aligned rows')
    if not 1 <= valid_len <= l:
        raise ValueError(f'valid_len {valid_len} outside [1, {l}]')


def flash_mha(q, k, v, num_heads, valid_len=None):
    """(B, L, C) self-attention over ``num_heads`` heads.

    ``valid_len``: keys at positions >= valid_len are masked out."""
    global launches
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, num_heads, valid_len)
    b, l, c = q.shape
    valid_len = l if valid_len is None else int(valid_len)
    _check(q, k, v, num_heads, valid_len)
    lib = _build.load('flash_attention')
    fn = lib.packed_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, l, c), dtype=q.dtype, device=q.device)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             b, l, num_heads, valid_len, q.stride(0), q.stride(1),
             out.stride(0), out.stride(1), 0.125,
             ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, 'packed_attention_fwd')
    launches += 1
    return out
