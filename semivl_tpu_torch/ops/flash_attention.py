"""Multi-head self-attention: the Hopper kernels and their plain versions.

Counterpart of ``semivl_tpu/ops/flash_attention.py::flash_mha``: the packed
path (``_packed_fwd_kernel``, ``_packed_bwd_kernel``: heads of 64 in an
even count) and the head-split path (``_fwd_kernel``, ``_bwd_kernel``: any
other head width). ``ops.attention`` routes between them and the plain
``_mha_xla`` math as JAX ``ops/attention.py::multi_head_attention`` does.

``packed_attention`` and ``heads_attention`` take the packed (B, L, 3C)
in_proj output, read q, k and v in place as its column thirds, and are
differentiable: their ``torch.autograd.Function`` returns one (B, L, 3C)
gradient, so autograd never re-concatenates three.

CUDA tensors launch the forward kernel of their route,
``csrc/flash_attention.cu`` (packed, bf16, head_dim 64) or
``csrc/flash_attention_heads.cu`` (head-split, bf16, any head_dim: the
tensor cores up to 128, the CUDA cores of ``csrc/attention_wide.cuh``
above; a width that is not a multiple of 16 runs zero-padded to the next
one, ``pad_heads``), and the one backward kernel of both routes (the
latter's ``heads_attention_bwd``), or raise; CPU tensors take the plain versions
(``flash_mha_plain`` and ``flash_mha_heads_plain`` forward,
``flash_mha_bwd_plain`` backward). The references the kernels are held to
on the card round to bf16 where the kernels do: ``packed_attention_rounded``
for the packed route; for the head-split route the plain versions
themselves, whose rounding points are the kernels'.
"""

import ctypes

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import _build

launches = 0            # packed forward kernel launches since the last reset
bwd_launches = 0        # packed backward launches (read by chip_smoke.py)
heads_launches = 0      # head-split forward launches
heads_bwd_launches = 0  # head-split backward launches
HEAD_DIMS = tuple(range(16, 129, 16))   # the head-split kernels' wgmma widths

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])


def _split_heads(x, num_heads):
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def flash_mha_plain(q, k, v, num_heads, valid_len=None):
    """The JAX ``_mha_xla`` math: q scaled by 1/sqrt(d) in its own dtype,
    logits in the input dtype, float32 softmax with keys at or past
    ``valid_len`` masked to -1e30, probabilities cast back before p v."""
    d = q.shape[-1] // num_heads
    qh = _split_heads(q, num_heads) * torch.tensor(d ** -0.5, dtype=q.dtype)
    logits = torch.matmul(qh, _split_heads(k, num_heads).transpose(-1, -2))
    logits = logits.float()
    if valid_len is not None and valid_len < k.shape[1]:
        kidx = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(kidx >= valid_len, -1e30)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype), _split_heads(v, num_heads))
    return _merge_heads(out)


def flash_mha_bwd_plain(qkv, out, g, num_heads, valid_len=None):
    """Gradient of ``packed_attention`` w.r.t. the packed (B, L, 3C) qkv, as
    the JAX ``_packed_bwd_kernel`` computes it: p recomputed with a
    full-row float32 softmax, delta = rowsum(g o), ds = p (g v^T - delta),
    dv = p^T g, dq = ds k / sqrt(d), dk = ds^T q / sqrt(d), with p and ds
    rounded to the input dtype before their products and every product
    accumulated in float32."""
    dt = qkv.dtype
    c = qkv.shape[-1] // 3
    d = c // num_heads
    scale = d ** -0.5
    q, k, v = (_split_heads(t, num_heads) for t in qkv.split(c, dim=-1))
    qs = (q * torch.tensor(scale, dtype=dt)).float()
    k32, v32 = k.float(), v.float()
    gh = _split_heads(g.to(dt), num_heads).float()
    s = torch.matmul(qs, k32.transpose(-1, -2))
    length = qkv.shape[1]
    if valid_len is not None and valid_len < length:
        kidx = torch.arange(length, device=qkv.device)
        s = s.masked_fill(kidx >= valid_len, -1e30)
    p = torch.softmax(s, dim=-1)
    delta = (gh * _split_heads(out.to(dt), num_heads).float()).sum(
        -1, keepdim=True)
    ds = p * (torch.matmul(gh, v32.transpose(-1, -2)) - delta)
    p_r, ds_r = p.to(dt).float(), ds.to(dt).float()
    dv = torch.matmul(p_r.transpose(-1, -2), gh)
    dq = torch.matmul(ds_r, k32) * scale
    dk = torch.matmul(ds_r.transpose(-1, -2), q.float()) * scale
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


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


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _fwd_kernel(q, k, v, num_heads, valid_len, with_lse):
    """Launch the forward kernel; returns (out, lse or None)."""
    global launches
    b, l, c = q.shape
    _check(q, k, v, num_heads, valid_len)
    fn = _build.load('flash_attention').packed_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, l, c), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, num_heads, l), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             _build.ptr(lse) if with_lse else ctypes.c_void_p(None),
             b, l, num_heads, valid_len, q.stride(0), q.stride(1),
             out.stride(0), out.stride(1), 0.125, _stream(q))
    _build.check(err, 'packed_attention_fwd')
    launches += 1
    return out, lse


def flash_mha_bwd(qkv, out, lse, g, num_heads, valid_len=None):
    """Backward of ``packed_attention``: the (B, L, 3C) gradient from the
    forward's output ``out``, its row log-sum-exp ``lse`` (float32 (B, H,
    L)) and the output gradient ``g``. It launches the head-split backward
    kernel at head_dim 64, which computes the JAX ``_packed_bwd_kernel``'s
    function (``flash_mha_bwd_plain``)."""
    global bwd_launches
    c = qkv.shape[-1] // 3
    vl = qkv.shape[1] if valid_len is None else int(valid_len)
    _check(*qkv.split(c, dim=-1), num_heads, vl)
    dqkv = _bwd_kernel(qkv, out, lse, g, num_heads, vl)
    bwd_launches += 1
    return dqkv


class _PackedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, num_heads, valid_len):
        c = qkv.shape[-1] // 3
        q, k, v = qkv.split(c, dim=-1)
        if qkv.is_cuda:
            vl = qkv.shape[1] if valid_len is None else int(valid_len)
            out, lse = _fwd_kernel(q, k, v, num_heads, vl, with_lse=True)
        else:
            out, lse = flash_mha_plain(q, k, v, num_heads, valid_len), None
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.valid_len = num_heads, valid_len
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        if qkv.is_cuda:
            dqkv = flash_mha_bwd(qkv, out, lse, g, ctx.num_heads,
                                 ctx.valid_len)
        else:
            dqkv = flash_mha_bwd_plain(qkv, out, g, ctx.num_heads,
                                       ctx.valid_len)
        return dqkv, None, None


def packed_attention_plain(qkv, num_heads, valid_len=None):
    """``packed_attention`` as plain PyTorch, differentiated by autograd."""
    c = qkv.shape[-1] // 3
    return flash_mha_plain(*qkv.split(c, dim=-1), num_heads, valid_len)


def packed_attention(qkv, num_heads, valid_len=None):
    """Self-attention over the packed (B, L, 3C) in_proj output -> (B, L, C).

    Differentiable w.r.t. ``qkv`` (one (B, L, 3C) gradient); without
    autograd the forward kernel alone (no log-sum-exp is written).
    ``valid_len``: keys at positions >= valid_len are masked out."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedAttention.apply(qkv, num_heads, valid_len)
    c = qkv.shape[-1] // 3
    q, k, v = qkv.split(c, dim=-1)
    if not qkv.is_cuda:
        return flash_mha_plain(q, k, v, num_heads, valid_len)
    vl = qkv.shape[1] if valid_len is None else int(valid_len)
    return _fwd_kernel(q, k, v, num_heads, vl, with_lse=False)[0]


# ---------------------------------------------------------------------------
# the kernels' arithmetic in plain PyTorch

_BK = 128   # keys per tile of the forward kernel (BK, csrc/attention_fwd.cuh)


def _fwd_rounded(q, k, v, num_heads, valid_len):
    """The forward kernel's arithmetic: s = (q / 8) k^T in float32, an
    online softmax over ``_BK``-key tiles whose unnormalised p = exp(s - the
    running row max) is rounded to bf16 before p v, the float32 row sum
    divided out at the end, the output rounded to bf16."""
    d = q.shape[-1] // num_heads
    qs = _split_heads(q, num_heads).float() * d ** -0.5
    kh, vh = (_split_heads(t, num_heads).float() for t in (k, v))
    length = k.shape[1]
    pad = -length % _BK
    s = F.pad(torch.matmul(qs, kh.transpose(-1, -2)), (0, pad))
    kidx = torch.arange(length + pad, device=q.device)
    s = s.masked_fill(kidx >= (valid_len or length), -1e30)
    tiles = s.unflatten(-1, (-1, _BK))
    run_max = tiles.amax(-1).cummax(-1).values
    p = torch.exp(tiles - run_max[..., None]).to(torch.bfloat16).float()
    last = run_max[..., -1:]
    weights = (p * torch.exp(run_max - last)[..., None]).flatten(-2)
    row_sum = torch.exp(s - last).sum(-1, keepdim=True)
    out = torch.matmul(weights, F.pad(vh, (0, 0, 0, pad))) / row_sum
    return _merge_heads(out).to(torch.bfloat16).to(q.dtype)


class _RoundedAttention(torch.autograd.Function):
    """Forward ``_fwd_rounded``, backward ``flash_mha_bwd_plain``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, valid_len):
        c = qkv.shape[-1] // 3
        out = _fwd_rounded(*qkv.split(c, dim=-1), num_heads, valid_len)
        ctx.save_for_backward(qkv, out)
        ctx.num_heads, ctx.valid_len = num_heads, valid_len
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out = ctx.saved_tensors
        return (flash_mha_bwd_plain(qkv, out, g, ctx.num_heads,
                                    ctx.valid_len), None, None)


def packed_attention_rounded(qkv, num_heads, valid_len=None):
    """``packed_attention`` as plain PyTorch that rounds to bf16 where the
    kernels do (bf16 ``qkv``): the forward of ``_fwd_rounded``, the backward
    of ``flash_mha_bwd_plain``. The kernels differ from it only in the
    order of float32 sums."""
    return _RoundedAttention.apply(qkv, num_heads, valid_len)


# ---------------------------------------------------------------------------
# head-split route (JAX ``_fused_attention``: ``_fwd_kernel``, ``_bwd_kernel``)

def flash_mha_heads_plain(q, k, v, num_heads, valid_len=None):
    """The JAX ``_fwd_kernel`` math: q scaled by 1/sqrt(d) in its own dtype,
    float32 logits, keys at or past ``valid_len`` masked to -1e30, a
    float32 softmax normalised before the cast to v's dtype, p v summed in
    float32 and cast once. Unlike ``flash_mha_plain`` (``_mha_xla``) the
    logits are never rounded to the input dtype."""
    d = q.shape[-1] // num_heads
    qh = _split_heads(q, num_heads) * torch.tensor(d ** -0.5, dtype=q.dtype)
    s = torch.matmul(qh.float(),
                     _split_heads(k, num_heads).float().transpose(-1, -2))
    if valid_len is not None and valid_len < k.shape[1]:
        kidx = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kidx >= valid_len, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.matmul(p.float(), _split_heads(v, num_heads).float())
    return _merge_heads(out).to(q.dtype)


_HEADS_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 6 + [ctypes.c_float] * 2
                 + [ctypes.c_void_p])


def _q_scale(d):
    """1/sqrt(d) as the bf16 value q is multiplied by (JAX
    ``jnp.asarray(scale, q.dtype)``)."""
    return float(torch.tensor(d ** -0.5, dtype=torch.bfloat16))


def _check_heads(qkv, num_heads, valid_len):
    b, l, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f'head-split attention kernel: C={c} does not split '
                         f'into {num_heads} heads')
    if not qkv.is_cuda or qkv.dtype != torch.bfloat16:
        raise ValueError(f'head-split attention kernel takes bf16 CUDA '
                         f'tensors, got {qkv.dtype} on {qkv.device}')
    if qkv.stride(2) != 1 or qkv.stride(1) % 8 or qkv.stride(0) % 8 \
            or qkv.data_ptr() % 16:
        raise ValueError('head-split attention kernel needs unit column '
                         'stride and 16-byte aligned rows')
    if not 1 <= valid_len <= l:
        raise ValueError(f'valid_len {valid_len} outside [1, {l}]')


def padded_head_dim(d):
    """The kernel width a head of ``d`` runs at: the next multiple of 16
    (``HEAD_DIMS`` up to 128)."""
    return -(-d // 16) * 16


def pad_heads(t, num_heads, parts=1):
    """(B, L, parts H d) -> (B, L, parts H Dp): each head zero-padded to
    Dp = ``padded_head_dim(d)`` columns (``t`` itself when d = Dp). Zero
    columns of q and k add nothing to q k^T and zero columns of v give zero
    outputs, so attention at Dp with the true d's scale, sliced back to d,
    is attention at d."""
    b, l, c = t.shape
    d = c // parts // num_heads
    dp = padded_head_dim(d)
    if dp == d:
        return t
    return F.pad(t.reshape(b, l, parts, num_heads, d), (0, dp - d)).view(
        b, l, parts * num_heads * dp)


def unpad_heads(t, num_heads, d, parts=1):
    """The inverse of ``pad_heads``: (B, L, parts H Dp) -> (B, L, parts H
    d)."""
    b, l, c = t.shape
    dp = c // parts // num_heads
    if dp == d:
        return t
    return t.view(b, l, parts, num_heads, dp)[..., :d].reshape(
        b, l, parts * num_heads * d)


def flash_mha_heads(qkv, num_heads, valid_len=None, with_lse=False):
    """Forward kernel of the head-split route over the packed (B, L, 3C)
    qkv; returns (out (B, L, C), row log-sum-exp float32 (B, H, L) or
    None). A head width that is not a multiple of 16 runs zero-padded to
    the next one (``pad_heads``) at its own scale."""
    global heads_launches
    b, l, c3 = qkv.shape
    c = c3 // 3
    vl = l if valid_len is None else int(valid_len)
    _check_heads(qkv, num_heads, vl)
    d = c // num_heads
    qkv_k = pad_heads(qkv, num_heads, 3)
    cp = qkv_k.shape[-1] // 3
    q, k, v = qkv_k.split(cp, dim=-1)
    out = torch.empty((b, l, cp), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, l), dtype=torch.float32,
                       device=qkv.device) if with_lse else None)
    fn = _build.load('flash_attention_heads').heads_attention_fwd
    fn.argtypes, fn.restype = _HEADS_ARGTYPES, ctypes.c_int
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             _build.ptr(lse) if with_lse else ctypes.c_void_p(None),
             b, l, num_heads, cp // num_heads, vl, qkv_k.stride(0),
             qkv_k.stride(1), out.stride(0), out.stride(1), _q_scale(d),
             _stream(qkv))
    _build.check(err, 'heads_attention_fwd')
    heads_launches += 1
    return unpad_heads(out, num_heads, d), lse


def _bwd_kernel(qkv, out, lse, g, num_heads, valid_len, d=None):
    """Launch ``heads_attention_bwd``, the backward kernel of both routes;
    returns the (B, L, 3C) gradient. ``d``: the head width whose scale the
    kernel takes (qkv's own unless its heads are zero-padded)."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    out, g = out.contiguous(), g.to(qkv.dtype).contiguous()
    if out.shape != (b, l, c) or g.shape != (b, l, c) \
            or lse.shape != (b, num_heads, l) or not lse.is_contiguous():
        raise ValueError('attention backward: out / g (B, L, C) and lse '
                         '(B, H, L) do not match qkv')
    dp = c // num_heads
    d = dp if d is None else d
    q, k, v = qkv.split(c, dim=-1)
    dqkv = torch.empty((b, l, c3), dtype=qkv.dtype, device=qkv.device)
    delta = torch.empty((b, num_heads, l), dtype=torch.float32,
                        device=qkv.device)
    dq, dk, dv = dqkv.split(c, dim=-1)
    fn = _build.load('flash_attention_heads').heads_attention_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    err = fn(*(_build.ptr(t) for t in (q, k, v, out, g, lse, delta, dq, dk,
                                       dv)),
             b, l, num_heads, dp, valid_len, qkv.stride(0), qkv.stride(1),
             g.stride(0), g.stride(1), dqkv.stride(0), dqkv.stride(1),
             _q_scale(d), d ** -0.5, _stream(qkv))
    _build.check(err, 'heads_attention_bwd')
    return dqkv


def flash_mha_heads_bwd(qkv, out, lse, g, num_heads, valid_len=None):
    """Backward kernel of the head-split route: the (B, L, 3C) gradient
    from the forward's output ``out``, its row log-sum-exp ``lse`` and the
    output gradient ``g``. The JAX ``_bwd_kernel`` computes what
    ``_packed_bwd_kernel`` does, so its plain version is
    ``flash_mha_bwd_plain``."""
    global heads_bwd_launches
    vl = qkv.shape[1] if valid_len is None else int(valid_len)
    _check_heads(qkv, num_heads, vl)
    d = qkv.shape[-1] // 3 // num_heads
    dqkv = _bwd_kernel(pad_heads(qkv, num_heads, 3),
                       pad_heads(out.contiguous(), num_heads),
                       lse, pad_heads(g.to(qkv.dtype).contiguous(),
                                      num_heads), num_heads, vl, d)
    heads_bwd_launches += 1
    return unpad_heads(dqkv, num_heads, d, 3)


class _HeadsAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, num_heads, valid_len):
        if qkv.is_cuda:
            out, lse = flash_mha_heads(qkv, num_heads, valid_len, True)
        else:
            c = qkv.shape[-1] // 3
            out, lse = flash_mha_heads_plain(*qkv.split(c, dim=-1), num_heads,
                                             valid_len), None
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.valid_len = num_heads, valid_len
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        if qkv.is_cuda:
            dqkv = flash_mha_heads_bwd(qkv, out, lse, g, ctx.num_heads,
                                       ctx.valid_len)
        else:
            dqkv = flash_mha_bwd_plain(qkv, out, g, ctx.num_heads,
                                       ctx.valid_len)
        return dqkv, None, None


def heads_attention_plain(qkv, num_heads, valid_len=None):
    """``heads_attention`` as plain PyTorch, differentiated by autograd.
    On bf16 inputs it is also the kernels' rounded reference: the kernels
    round where JAX's ``_fwd_kernel`` and ``_bwd_kernel`` do (q times the
    bf16 scale, the normalised p and the output; p and ds before their
    products, as ``flash_mha_bwd_plain``), and differ from it only in the
    order of float32 sums and in taking p as exp(s - lse) from the
    forward's row statistics."""
    c = qkv.shape[-1] // 3
    return flash_mha_heads_plain(*qkv.split(c, dim=-1), num_heads, valid_len)


def heads_attention(qkv, num_heads, valid_len=None):
    """Head-split self-attention over the packed (B, L, 3C) in_proj output
    -> (B, L, C), for any head width (a width that is not a multiple of 16
    zero-padded to the next one; above 128 on the CUDA-core kernels).

    Differentiable w.r.t. ``qkv`` (one (B, L, 3C) gradient); without
    autograd the forward kernel alone (no log-sum-exp is written)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _HeadsAttention.apply(qkv, num_heads, valid_len)
    if not qkv.is_cuda:
        return heads_attention_plain(qkv, num_heads, valid_len)
    return flash_mha_heads(qkv, num_heads, valid_len)[0]
