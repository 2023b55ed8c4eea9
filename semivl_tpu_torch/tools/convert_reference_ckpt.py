"""A reference SemiVL checkpoint (torch ``best.pth``) -> the port's model
(counterpart of ``semivl_tpu/tools/convert_reference_ckpt.py``), for
evaluating released checkpoints.

It follows the reference's checkpoint conventions (third_party/unimatch/
eval.py:130-142): ``module.`` DDP prefixes, the optional ``ema_model`` of
released checkpoints, and ``clip_encoder.*`` dropped (evaluation never
needs the guidance encoder). ``convert_vlm_checkpoint`` is JAX's mapping
of the flat reference dict onto the converted tree ({'params', and for the
Cityscapes conv encoder 'batch_stats'}): the MaskCLIP ViT, the VLG head
and the ResNetV1c skip encoder, with torch -> flax layouts (Linear and
1x1-conv weights transposed, conv kernels (O, I, H, W) -> (H, W, I, O),
norm weight/bias -> scale/bias, BatchNorm running statistics ->
``batch_stats``). Another head is refused by name, as JAX refuses it. The
CLI writes the npz JAX's writes; ``load_reference_into`` loads the tree
into a port model through ``convert.load_jax_params``.

    python -m semivl_tpu_torch.tools.convert_reference_ckpt \\
        --src best.pth --out best.npz [--ema]
"""

import argparse

import numpy as np

from semivl_tpu_torch.convert import load_jax_params
from semivl_tpu_torch.tools.convert_clip_weights import save_flax_npz


def _t(v):
    return np.asarray(v, np.float32)


def _conv(flat, key):
    return {'kernel': _t(flat[key + '.weight']).transpose(2, 3, 1, 0),
            **({'bias': _t(flat[key + '.bias'])}
               if key + '.bias' in flat else {})}


def _dense(flat, key):
    return {'kernel': _t(flat[key + '.weight']).T,
            **({'bias': _t(flat[key + '.bias'])}
               if key + '.bias' in flat else {})}


def _norm(flat, key):
    return {'scale': _t(flat[key + '.weight']),
            'bias': _t(flat[key + '.bias'])}


def _block(flat, pre):
    """mmcv TransformerEncoderLayer -> JAX's TransformerBlock tree."""
    return {
        'ln1': _norm(flat, pre + 'ln1'),
        'ln2': _norm(flat, pre + 'ln2'),
        'attn': {
            'in_proj': {'kernel': _t(flat[pre + 'attn.attn.in_proj_weight']).T,
                        'bias': _t(flat[pre + 'attn.attn.in_proj_bias'])},
            'out_proj': _dense(flat, pre + 'attn.attn.out_proj'),
        },
        'ffn': {
            'fc1': _dense(flat, pre + 'ffn.layers.0.0'),
            'fc2': _dense(flat, pre + 'ffn.layers.1'),
        },
    }


def _count(flat, pattern):
    n = 0
    while pattern.format(n) in flat:
        n += 1
    return n


def convert_maskclip_vit(flat, prefix='backbone.', num_layers=None):
    p = {
        'cls_token': _t(flat[prefix + 'cls_token']),
        'pos_embed': _t(flat[prefix + 'pos_embed']),
        'patch_embed': {'kernel': _t(
            flat[prefix + 'patch_embed.projection.weight'])
            .transpose(2, 3, 1, 0)},
        'ln0': _norm(flat, prefix + 'ln0'),
        'ln1': _norm(flat, prefix + 'ln1'),
    }
    if prefix + 'proj.weight' in flat:
        w = _t(flat[prefix + 'proj.weight'])
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        p['proj'] = {'kernel': w.T}
    if num_layers is None:
        num_layers = _count(flat, prefix + 'layers.{}.ln1.weight')
    for i in range(num_layers):
        p[f'layers_{i}'] = _block(flat, f'{prefix}layers.{i}.')
    return p


def _conv_gn(flat, conv_key, gn_key):
    return {'conv': _conv(flat, conv_key), 'gn': _norm(flat, gn_key)}


def convert_vlg_head(flat, prefix='decode_head.', num_layers=None,
                     num_skips=None):
    """The reference's vlg_head.py names -> JAX's VLGHead tree."""
    if num_layers is None:
        num_layers = _count(flat,
                            prefix + 'layers.{}.transformer.ln1.weight')
    if num_skips is None:
        num_skips = _count(flat, prefix + 'skip_proj.{}.0.weight')
    p = {
        'conv1': _conv(flat, prefix + 'conv1'),
        'text_proj': _dense(flat, prefix + 'text_proj.0'),
        'head': _conv(flat, prefix + 'head'),
    }
    aspp = {}
    for i in range(4):
        aspp[f'branch_{i}'] = _conv_gn(
            flat, f'{prefix}aspp.aspp_convs.{i}.0',
            f'{prefix}aspp.aspp_convs.{i}.1')
    aspp['pool'] = {'proj': _conv_gn(
        flat, prefix + 'aspp.aspp_convs.4.gap.1',
        prefix + 'aspp.aspp_convs.4.gap.2')}
    aspp['project'] = _conv_gn(flat, prefix + 'aspp.project.0',
                               prefix + 'aspp.project.1')
    p['aspp'] = aspp
    for i in range(num_layers):
        p[f'layers_{i}'] = {
            'transformer': _block(flat, f'{prefix}layers.{i}.transformer.')}
    for i in range(num_skips):
        p[f'skip_proj_{i}'] = _conv(flat, f'{prefix}skip_proj.{i}.0')
    for name in ('up1', 'up2'):
        p[name] = {
            'up_kernel': _t(flat[f'{prefix}{name}.up.weight'])
            .transpose(2, 3, 0, 1),
            'up_bias': _t(flat[f'{prefix}{name}.up.bias']),
            'conv1': _conv_gn(flat, f'{prefix}{name}.conv.0',
                              f'{prefix}{name}.conv.1'),
            'conv2': _conv_gn(flat, f'{prefix}{name}.conv.3',
                              f'{prefix}{name}.conv.4'),
        }
    return p


def _conv_bn(flat, conv_key, bn_key):
    """(params, batch_stats) of a Conv + BN pair."""
    params = {'conv': _conv(flat, conv_key),
              'bn': {'scale': _t(flat[bn_key + '.weight']),
                     'bias': _t(flat[bn_key + '.bias'])}}
    stats = {'bn': {'mean': _t(flat[bn_key + '.running_mean']),
                    'var': _t(flat[bn_key + '.running_var'])}}
    return params, stats


def convert_resnet_v1c(flat, prefix='conv_encoder.', num_stages=1,
                       blocks=(3, 4, 23, 3)):
    """mmseg ResNetV1c state dict -> (params, batch_stats) trees (the VLG
    conv encoder of the Cityscapes models, skr04)."""
    params, stats = {}, {}
    for name, ck, bk in (('stem1', 'stem.0', 'stem.1'),
                         ('stem2', 'stem.3', 'stem.4'),
                         ('stem3', 'stem.6', 'stem.7')):
        params[name], stats[name] = _conv_bn(flat, prefix + ck, prefix + bk)
    for stage in range(num_stages):
        n_blocks = blocks[stage]
        while f'{prefix}layer{stage + 1}.{n_blocks - 1}.conv1.weight' \
                not in flat and n_blocks > 1:
            n_blocks -= 1
        for b in range(n_blocks):
            bp = f'{prefix}layer{stage + 1}.{b}.'
            blk_p, blk_s = {}, {}
            for i in (1, 2, 3):
                blk_p[f'conv{i}'], blk_s[f'conv{i}'] = _conv_bn(
                    flat, bp + f'conv{i}', bp + f'bn{i}')
            if bp + 'downsample.0.weight' in flat:
                blk_p['downsample'], blk_s['downsample'] = _conv_bn(
                    flat, bp + 'downsample.0', bp + 'downsample.1')
            params[f'layer{stage + 1}_{b}'] = blk_p
            stats[f'layer{stage + 1}_{b}'] = blk_s
    return params, stats


def load_reference_checkpoint(path, ema=False):
    """torch ``best.pth`` -> (flat numpy state dict, epoch): ``ema_model``
    with ``ema`` where the file has one, else ``model`` (else the file's
    top level), ``module.`` stripped, ``clip_encoder.*`` dropped. Read with
    ``weights_only=True``: tensors, containers and numbers only."""
    import torch
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if ema and 'ema_model' in ckpt:
        sd = ckpt['ema_model']
    else:
        sd = ckpt['model'] if 'model' in ckpt else ckpt
    flat = {}
    for k, v in sd.items():
        k = k.replace('module.', '')
        if 'clip_encoder' in k:
            continue
        flat[k] = v.float().numpy() if hasattr(v, 'float') else np.asarray(v)
    return flat, ckpt.get('epoch')


def convert_vlm_checkpoint(flat, num_layers=None, vlg_layers=None,
                           num_skips=None):
    """Flat reference VLM state dict -> the converted tree ({'params',
    and with a conv encoder 'batch_stats'}). Only the VLG decode head is
    converted: another is refused by name (JAX raises too)."""
    if not any(k.startswith('decode_head.conv1') for k in flat):
        raise NotImplementedError(
            'convert_vlm_checkpoint: only the VLG decode head is converted '
            '(the checkpoint has no decode_head.conv1)')
    params = {'backbone': convert_maskclip_vit(flat, 'backbone.', num_layers),
              'decode_head': convert_vlg_head(flat, 'decode_head.',
                                              vlg_layers, num_skips)}
    out = {'params': params}
    if any(k.startswith('conv_encoder.') for k in flat):
        params['conv_encoder'], stats = convert_resnet_v1c(flat)
        out['batch_stats'] = {'conv_encoder': stats}
    return out


def load_reference_into(model, path, ema=False):
    """A reference checkpoint into the port's VLM ``model`` (built without
    the guidance encoder, as the evaluation builds it; strict): returns
    the checkpoint's epoch."""
    flat, epoch = load_reference_checkpoint(path, ema)
    variables = convert_vlm_checkpoint(flat)
    load_jax_params(model, variables['params'], variables.get('batch_stats'))
    return epoch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--src', required=True, help='reference best.pth')
    parser.add_argument('--out', required=True, help='output .npz')
    parser.add_argument('--ema', action='store_true')
    args = parser.parse_args(argv)
    flat, epoch = load_reference_checkpoint(args.src, ema=args.ema)
    save_flax_npz(args.out, convert_vlm_checkpoint(flat))
    print(f'wrote {args.out} (epoch {epoch})')


if __name__ == '__main__':
    main()
