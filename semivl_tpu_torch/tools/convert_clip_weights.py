"""CLIP ViT-B/16 checkpoint conversion, PyTorch -> the converted tree
(counterpart of ``semivl_tpu/tools/convert_clip_weights.py``).

Takes both source layouts:

- raw OpenAI CLIP checkpoints (``visual.*`` keys; a TorchScript archive or
  a plain state dict), the input of the reference's converter
  (third_party/maskclip/convert_clip_weights.py:13-91);
- the reference's converted ``clip2mmseg_ViT16_clip_backbone.pth``
  layout (``cls_token``, ``pos_embed``, ``patch_embed.projection``,
  ``ln0``, ``ln1``, ``layers.N.{ln1,ln2,attn.attn,ffn.layers}``, ``proj``).

The result is JAX's tree of the MaskCLIP ViT (flax names, kernels (in,
out), the patch kernel HWIO), saved as an npz of '/'-joined paths whose
keys and values equal JAX's tool's, so that the npz either tool writes
loads into either package (``convert.load_pretrained_into`` here, with the
position embedding resized per scope). Only numpy and torch are needed.

    python -m semivl_tpu_torch.tools.convert_clip_weights \\
        --src pretrained/ViT-B-16.pt --out pretrained/clip_vitb16.npz \\
        [--text-out pretrained/clip_text.npz]
"""

import argparse

import numpy as np


def _t(w):
    return np.asarray(w, dtype=np.float32)


def convert_openai_visual(sd):
    """OpenAI CLIP ``visual.*`` state dict -> the mmseg-style flat dict
    (the reference converter's key layout)."""
    out = {}
    for key, val in sd.items():
        if not key.startswith('visual.'):
            continue
        k = key[len('visual.'):]
        if k == 'proj':
            out['proj.weight'] = _t(val).T  # (768, 512) -> (512, 768)
        elif k == 'class_embedding':
            out['cls_token'] = _t(val)[None, None, :]
        elif k == 'positional_embedding':
            out['pos_embed'] = _t(val)[None]
        elif k == 'conv1.weight':
            out['patch_embed.projection.weight'] = _t(val)
        elif k.startswith('ln_pre'):
            out[k.replace('ln_pre', 'ln0')] = _t(val)
        elif k.startswith('ln_post'):
            out[k.replace('ln_post', 'ln1')] = _t(val)
        elif k.startswith('transformer.resblocks.'):
            nk = 'layers.' + k[len('transformer.resblocks.'):]
            nk = (nk.replace('mlp.c_fc', 'ffn.layers.0.0')
                    .replace('mlp.c_proj', 'ffn.layers.1'))
            if '.attn.' in nk:
                nk = nk.replace('.attn.', '.attn.attn.')
            else:
                nk = nk.replace('.ln_', '.ln')
            out[nk] = _t(val)
    return out


def _num_layers(flat):
    n = 0
    while f'layers.{n}.ln1.weight' in flat:
        n += 1
    return n


def mmseg_flat_to_flax(flat, num_layers=12):
    """mmseg-style flat dict -> the MaskCLIP ViT's nested flax params
    (``num_layers`` blocks; None: as many as ``flat`` holds)."""
    if num_layers is None:
        num_layers = _num_layers(flat)
    p = {'cls_token': flat['cls_token'], 'pos_embed': flat['pos_embed'],
         'patch_embed': {'kernel': flat['patch_embed.projection.weight']
                         .transpose(2, 3, 1, 0)}}
    for ln in ('ln0', 'ln1'):
        if f'{ln}.weight' in flat:
            p[ln] = {'scale': flat[f'{ln}.weight'],
                     'bias': flat[f'{ln}.bias']}
    if 'proj.weight' in flat:
        w = flat['proj.weight']
        if w.ndim == 4:  # the reference stores it as a 1x1 conv
            w = w[:, :, 0, 0]
        p['proj'] = {'kernel': w.T}  # (512, 768) -> (768, 512)
    for i in range(num_layers):
        pre = f'layers.{i}.'

        def dense(key):
            return {'kernel': flat[pre + key + '.weight'].T,
                    'bias': flat[pre + key + '.bias']}

        p[f'layers_{i}'] = {
            'ln1': {'scale': flat[pre + 'ln1.weight'],
                    'bias': flat[pre + 'ln1.bias']},
            'ln2': {'scale': flat[pre + 'ln2.weight'],
                    'bias': flat[pre + 'ln2.bias']},
            'attn': {
                'in_proj': {
                    'kernel': flat[pre + 'attn.attn.in_proj_weight'].T,
                    'bias': flat[pre + 'attn.attn.in_proj_bias']},
                'out_proj': dense('attn.attn.out_proj')},
            'ffn': {'fc1': dense('ffn.layers.0.0'),
                    'fc2': dense('ffn.layers.1')},
        }
    return p


def flatten(tree, prefix=''):
    """Nested dicts -> {'a/b/c': array} (JAX ``_flatten``)."""
    flat = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_flax_npz(path, tree):
    np.savez(path, **flatten(tree))


def load_torch_checkpoint(path):
    """A torch ``.pt``/``.pth`` -> flat numpy dict: a TorchScript archive
    (OpenAI's released files) through ``torch.jit.load``, else a saved
    state dict (under ``state_dict`` if it has one) read with
    ``weights_only=True``: tensors and containers only, no other pickled
    object."""
    import torch
    try:
        sd = torch.jit.load(path, map_location='cpu').state_dict()
    except RuntimeError:   # not a TorchScript archive
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        sd = ckpt.get('state_dict', ckpt)
    return {k: v.float().numpy() if hasattr(v, 'numpy') else v
            for k, v in sd.items()}


def convert_openai_text(sd, num_layers=12):
    """OpenAI CLIP text-tower state dict -> JAX ``CLIPTextTransformer``
    params (``convert.clip_text_state_dict`` maps them to the port's)."""
    p = {
        'token_embedding': _t(sd['token_embedding.weight']),
        'positional_embedding': _t(sd['positional_embedding']),
        'ln_final': {'scale': _t(sd['ln_final.weight']),
                     'bias': _t(sd['ln_final.bias'])},
        'text_projection': _t(sd['text_projection']),
    }
    for i in range(num_layers):
        pre = f'transformer.resblocks.{i}.'

        def dense(key):
            return {'kernel': _t(sd[pre + key + '.weight']).T,
                    'bias': _t(sd[pre + key + '.bias'])}

        p[f'layers_{i}_ln1'] = {'scale': _t(sd[pre + 'ln_1.weight']),
                                'bias': _t(sd[pre + 'ln_1.bias'])}
        p[f'layers_{i}_ln2'] = {'scale': _t(sd[pre + 'ln_2.weight']),
                                'bias': _t(sd[pre + 'ln_2.bias'])}
        p[f'layers_{i}_attn'] = {
            'in_proj': {'kernel': _t(sd[pre + 'attn.in_proj_weight']).T,
                        'bias': _t(sd[pre + 'attn.in_proj_bias'])},
            'out_proj': dense('attn.out_proj')}
        p[f'layers_{i}_ffn'] = {'fc1': dense('mlp.c_fc'),
                                'fc2': dense('mlp.c_proj')}
    return p


def _visual_flat(sd):
    """A loaded checkpoint's visual tower as the mmseg-style flat dict."""
    if any(k.startswith('visual.') for k in sd):
        return convert_openai_visual(sd)
    return {k.replace('backbone.', ''): np.asarray(v, np.float32)
            for k, v in sd.items()}


def load_clip_tree(path):
    """A raw OpenAI or ``clip2mmseg`` checkpoint -> the MaskCLIP ViT's
    tree, with as many blocks as it holds (``load_pretrained_into``)."""
    return mmseg_flat_to_flax(_visual_flat(load_torch_checkpoint(path)),
                              num_layers=None)


def convert(src_path, out_path, text_out_path=None):
    """``src_path`` -> the tree of ViT-B/16's 12 blocks, saved to
    ``out_path`` (and, for an OpenAI checkpoint, its text tower's params to
    ``text_out_path``), as JAX's ``convert`` does."""
    sd = load_torch_checkpoint(src_path)
    if text_out_path and 'text_projection' in sd:
        save_flax_npz(text_out_path, convert_openai_text(sd))
    tree = mmseg_flat_to_flax(_visual_flat(sd))
    save_flax_npz(out_path, tree)
    return tree


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--src', required=True,
                        help='OpenAI CLIP .pt or clip2mmseg .pth')
    parser.add_argument('--out', required=True, help='output .npz')
    parser.add_argument('--text-out', default=None,
                        help='also write the text tower\'s params (.npz)')
    args = parser.parse_args(argv)
    tree = convert(args.src, args.out, text_out_path=args.text_out)
    n = sum(int(np.prod(v.shape)) for v in flatten(tree).values())
    print(f'wrote {args.out} ({n / 1e6:.1f}M params)')
    return tree


if __name__ == '__main__':
    main()
