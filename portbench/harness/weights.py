"""Seeded random weights, made on the device in two large draws.

The same ``(seed, shapes, scales)`` give the same tensors, which the
benchmark loads into the program's model and hands to the reference.
Matrices and kernels are U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (torch's
default bound) times the scale of their top-level module, the cls token,
class, position and prompt embeddings N(0, 0.02), norm scales 1 and biases
0. The scales keep twelve random ViT layers and the decoder's GroupNorm
chains finite in bfloat16 (the configuration file's ``weight_scales``).
"""

import hashlib
import math

import torch

EMBEDDINGS = ('cls_token', 'pos_embed', 'class_embedding',
              'positional_embedding', 'prompt_embeddings')


def sub_seed(seed, tag):
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    h = hashlib.sha256(f'{int(seed)}:{tag}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


def make(shapes, seed, scales, device):
    """{name: float32 tensor on ``device``} for ``shapes`` ({name:
    shape}), in sorted name order."""
    names = sorted(shapes)
    mats = [n for n in names if len(shapes[n]) >= 2
            and not n.endswith(EMBEDDINGS)]
    embs = [n for n in names if n.endswith(EMBEDDINGS)]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 'weights'))
    u = torch.rand(sum(math.prod(shapes[n]) for n in mats), generator=gen,
                   device=device)
    z = torch.randn(sum(math.prod(shapes[n]) for n in embs), generator=gen,
                    device=device)
    out, off = {}, 0
    for n in mats:
        k, shp = math.prod(shapes[n]), tuple(shapes[n])
        bound = scales[n.split('.')[0]] / math.sqrt(math.prod(shp[1:]))
        out[n] = (u[off:off + k].view(shp) * 2 - 1) * bound
        off += k
    off = 0
    for n in embs:
        k = math.prod(shapes[n])
        out[n] = z[off:off + k].view(tuple(shapes[n])) * 0.02
        off += k
    for n in names:
        if n not in out:
            fill = 0.0 if n.endswith('bias') else 1.0
            out[n] = torch.full(tuple(shapes[n]), fill, device=device)
    return out


@torch.no_grad()
def load_into(model, weights):
    """Copy ``weights`` into ``model``'s parameters; the names and shapes
    must be exactly the model's."""
    params = dict(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if got != want:
        missing = sorted(set(want) ^ set(got))[:5]
        odd = sorted(n for n in set(want) & set(got) if want[n] != got[n])[:5]
        raise ValueError(f'the program\'s parameters are not the '
                         f'configuration\'s: names {missing}, shapes {odd}')
    for n, p in params.items():
        p.copy_(weights[n])
