"""Multi-head attention dispatcher (counterpart of
``semivl_tpu/ops/attention.py``).

Three routes, chosen per call by ``route`` from the shape, the
implementation asked for and whether the tensors are on the card:

- ``'plain'``: the JAX ``_mha_xla`` math in PyTorch
  (``flash_attention.flash_mha_plain``), differentiated by autograd;
- ``'packed'``: the packed kernels (heads of 64 in an even count;
  ``flash_attention.packed_attention``);
- ``'heads'``: the head-split kernels (any other head width;
  ``flash_attention.heads_attention``). They take every width, as JAX's
  ``_fwd_kernel`` and ``_bwd_kernel`` do (a width that is not a multiple
  of 16 zero-padded to the next one; above 128 on CUDA-core kernels): a
  kernel route never falls back to the plain math.

``impl`` is ``'auto'`` (the default), ``'xla'`` (always plain) or
``'pallas'`` (always a kernel where the shape allows one), as in the JAX
package. The JAX package keeps one process-wide default
(``set_default_impl``); here each attention layer carries its own
(``models.layers.set_attention_impl``, applied by ``build_model`` from the
run config's ``attention_impl``), so two models in one process do not share
it. Tensors on the CPU run each kernel route through that kernel's plain
version.
"""

import torch

from semivl_tpu_torch.ops import flash_attention

IMPLS = ('auto', 'xla', 'pallas')
# 'auto' sends head widths other than 64 (or odd head counts) to the
# head-split kernel only from this many tokens on (JAX
# ``_AUTO_PALLAS_MIN_LEN_UNPACKED``)
AUTO_HEADS_MIN_LEN = 1536

def route(q_len, kv_len, channels, num_heads, impl, on_card):
    """'plain', 'packed' or 'heads' for self/cross attention of ``q_len``
    queries over ``kv_len`` keys, ``channels`` split into ``num_heads``:
    JAX ``multi_head_attention``'s table with "on the card" for "on TPU"."""
    if impl not in IMPLS:
        raise ValueError(f'attention impl {impl!r}: one of {IMPLS}')
    if kv_len != q_len or channels % num_heads:
        return 'plain'   # cross-attention or a width the heads cannot split
    packed_ok = channels == 64 * num_heads and num_heads % 2 == 0
    if impl == 'auto':
        if not on_card:
            return 'plain'
        if packed_ok:
            return 'packed'
        return 'heads' if q_len >= AUTO_HEADS_MIN_LEN else 'plain'
    if impl == 'pallas':
        return 'packed' if packed_ok else 'heads'
    return 'plain'


def qkv_attention(qkv, num_heads, impl='auto', valid_len=None):
    """Self-attention over the packed (B, L, 3C) in_proj output -> (B, L,
    C). The kernel routes read q, k and v in place (row stride 3C) and
    return one (B, L, 3C) gradient."""
    c = qkv.shape[-1] // 3
    r = route(qkv.shape[1], qkv.shape[1], c, num_heads, impl, qkv.is_cuda)
    if r == 'packed':
        return flash_attention.packed_attention(qkv, num_heads, valid_len)
    if r == 'heads':
        return flash_attention.heads_attention(qkv, num_heads, valid_len)
    return flash_attention.flash_mha_plain(*qkv.split(c, dim=-1), num_heads,
                                           valid_len)


def multi_head_attention(q, k, v, num_heads, impl='auto', valid_len=None):
    """Self or cross attention over (B, L, C) tensors (torch
    ``MultiheadAttention`` math: q scaled by 1/sqrt(head_dim), float32
    softmax). ``valid_len``: keys at or past it are masked out. A kernel
    route packs q, k and v into one (B, L, 3C) tensor first; callers that
    hold the in_proj output use ``qkv_attention``."""
    r = route(q.shape[1], k.shape[1], q.shape[-1], num_heads, impl,
              q.is_cuda)
    if r == 'plain':
        return flash_attention.flash_mha_plain(q, k, v, num_heads, valid_len)
    return qkv_attention(torch.cat([q, k, v], dim=-1), num_heads, impl,
                         valid_len)
