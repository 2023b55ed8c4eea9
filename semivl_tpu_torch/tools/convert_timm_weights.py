"""timm ViT checkpoint conversion (counterpart of
``semivl_tpu/tools/convert_timm_weights.py``).

The reference's UniMatch-with-ViT ablation builds ``vit_base_patch16_224``
with ImageNet weights through timm (model/backbone/timm_vit.py:28-45),
which interpolates the position embedding on load. Here that is explicit:
the 14x14 (+ cls) grid is resized bicubically (``align_corners=False``,
PyTorch's kernel: ``ops.resize``) to the training grid (512 / 16 = 32x32
by default). The result is JAX's ``{'params': ...}`` tree of
``TIMMVisionTransformer`` (``blocks.N.{norm1,norm2}`` -> ``layers_N.{ln1,
ln2}``, ``attn.qkv``/``attn.proj`` -> ``attn.in_proj``/``out_proj``,
``mlp.fc1``/``fc2`` -> ``ffn.fc1``/``fc2``, ``patch_embed.proj`` ->
``patch_embed`` (OIHW -> HWIO), ``norm``), saved as the npz JAX's tool
writes; ``convert.export_timm_vit`` takes its ``params`` into
``models.timm_vit``'s names.

    python -m semivl_tpu_torch.tools.convert_timm_weights \\
        --src vit_base_patch16_224.pth --out timm_vitb16.npz [--img-size 512]
"""

import argparse

import numpy as np
import torch

from semivl_tpu_torch.ops.resize import resize
from semivl_tpu_torch.tools.convert_clip_weights import save_flax_npz


def _t(v):
    return np.asarray(v, np.float32)


def resize_timm_pos_embed(pos_embed, grid, src_grid=None):
    """(1, S*S + 1, C) -> (1, gh*gw + 1, C): the cls token passed through,
    the grid (``src_grid``, square by default) resized bicubically (timm
    ``resize_pos_embed``); numpy in and out."""
    pos_embed = _t(pos_embed)
    n = pos_embed.shape[1] - 1
    if src_grid is None:
        s = int(round(n ** 0.5))
        src_grid = (s, s)
    gh, gw = grid
    if (gh, gw) == tuple(src_grid):
        return pos_embed
    grid_part = pos_embed[:, 1:].reshape(1, *src_grid, -1)
    out = resize(torch.from_numpy(grid_part), (gh, gw), mode='bicubic',
                 align_corners=False)
    out = out.numpy().reshape(1, gh * gw, -1)
    return np.concatenate([pos_embed[:, :1], out], axis=1)


def convert_timm_vit(flat, grid=(32, 32)):
    """Flat timm state dict (numpy) -> ``{'params': ...}`` of JAX's
    ``TIMMVisionTransformer``."""
    def dense(key):
        return {'kernel': _t(flat[key + '.weight']).T,
                'bias': _t(flat[key + '.bias'])}

    def norm(key):
        return {'scale': _t(flat[key + '.weight']),
                'bias': _t(flat[key + '.bias'])}

    p = {
        'cls_token': _t(flat['cls_token']),
        'pos_embed': resize_timm_pos_embed(flat['pos_embed'], grid),
        'patch_embed': {
            'kernel': _t(flat['patch_embed.proj.weight'])
            .transpose(2, 3, 1, 0),
            'bias': _t(flat['patch_embed.proj.bias']),
        },
        'norm': norm('norm'),
    }
    i = 0
    while f'blocks.{i}.norm1.weight' in flat:
        pre = f'blocks.{i}.'
        p[f'layers_{i}'] = {
            'ln1': norm(pre + 'norm1'), 'ln2': norm(pre + 'norm2'),
            'attn': {'in_proj': dense(pre + 'attn.qkv'),
                     'out_proj': dense(pre + 'attn.proj')},
            'ffn': {'fc1': dense(pre + 'mlp.fc1'),
                    'fc2': dense(pre + 'mlp.fc2')},
        }
        i += 1
    return {'params': p}


def load_timm_state_dict(path):
    """A timm ``.pth``/``.bin`` state dict (under ``model`` if it has one)
    -> flat numpy dict, read with ``weights_only=True``."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if 'model' in sd and isinstance(sd['model'], dict):
        sd = sd['model']
    return {k: v.float().numpy() for k, v in sd.items()
            if hasattr(v, 'numpy')}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--src', required=True,
                        help='timm .pth/.bin state dict')
    parser.add_argument('--out', required=True, help='output .npz')
    parser.add_argument('--img-size', type=int, default=512)
    parser.add_argument('--patch-size', type=int, default=16)
    args = parser.parse_args(argv)
    g = args.img_size // args.patch_size
    variables = convert_timm_vit(load_timm_state_dict(args.src), grid=(g, g))
    save_flax_npz(args.out, variables)
    print(f'wrote {args.out} (grid {g}x{g})')
    return variables


if __name__ == '__main__':
    main()
