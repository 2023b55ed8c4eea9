"""Weight bridge: a JAX ``semivl_tpu`` parameter tree -> this package.

The JAX tree (nested dicts of numpy arrays, as ``variables['params']``
holds them) is renamed to the reference's torch names, which are this
package's ``state_dict`` keys, with the layout rules of the reference
exporter (reference tools/convert_to_torch.py):

- Dense kernels (in, out) transpose to (out, in);
- conv kernels (H, W, I, O) become (O, I, H, W);
- transpose-conv kernels (kH, kW, I, O) become (I, O, kH, kW);
- norm ``scale``/``bias`` become ``weight``/``bias``.

Only numpy is needed to build the state dict.
"""

import numpy as np
import torch


def _f(v):
    return np.asarray(v, np.float32)


def _conv(out, key, p):
    out[key + '.weight'] = _f(p['kernel']).transpose(3, 2, 0, 1)
    if 'bias' in p:
        out[key + '.bias'] = _f(p['bias'])


def _dense(out, key, p):
    out[key + '.weight'] = _f(p['kernel']).T
    if 'bias' in p:
        out[key + '.bias'] = _f(p['bias'])


def _norm(out, key, p):
    out[key + '.weight'] = _f(p['scale'])
    out[key + '.bias'] = _f(p['bias'])


def _block(out, pre, p):
    """TransformerBlock -> mmcv TransformerEncoderLayer names."""
    _norm(out, pre + 'ln1', p['ln1'])
    _norm(out, pre + 'ln2', p['ln2'])
    out[pre + 'attn.attn.in_proj_weight'] = _f(
        p['attn']['in_proj']['kernel']).T
    out[pre + 'attn.attn.in_proj_bias'] = _f(p['attn']['in_proj']['bias'])
    _dense(out, pre + 'attn.attn.out_proj', p['attn']['out_proj'])
    _dense(out, pre + 'ffn.layers.0.0', p['ffn']['fc1'])
    _dense(out, pre + 'ffn.layers.1', p['ffn']['fc2'])


def export_maskclip_vit(out, p, prefix='backbone.'):
    out[prefix + 'cls_token'] = _f(p['cls_token'])
    out[prefix + 'pos_embed'] = _f(p['pos_embed'])
    out[prefix + 'patch_embed.projection.weight'] = _f(
        p['patch_embed']['kernel']).transpose(3, 2, 0, 1)
    _norm(out, prefix + 'ln0', p['ln0'])
    _norm(out, prefix + 'ln1', p['ln1'])
    # CLIP's visual projection, stored as a 1x1 conv by the reference
    out[prefix + 'proj.weight'] = _f(p['proj']['kernel']).T[:, :, None, None]
    i = 0
    while f'layers_{i}' in p:
        _block(out, f'{prefix}layers.{i}.', p[f'layers_{i}'])
        i += 1


def _conv_gn(out, conv_key, gn_key, p):
    _conv(out, conv_key, p['conv'])
    _norm(out, gn_key, p['gn'])


def export_vlg_head(out, p, prefix='decode_head.'):
    _conv(out, prefix + 'conv1', p['conv1'])
    _dense(out, prefix + 'text_proj.0', p['text_proj'])
    _conv(out, prefix + 'head', p['head'])
    aspp = p['aspp']
    for i in range(4):
        _conv_gn(out, f'{prefix}aspp.aspp_convs.{i}.0',
                 f'{prefix}aspp.aspp_convs.{i}.1', aspp[f'branch_{i}'])
    _conv_gn(out, prefix + 'aspp.aspp_convs.4.gap.1',
             prefix + 'aspp.aspp_convs.4.gap.2', aspp['pool']['proj'])
    _conv_gn(out, prefix + 'aspp.project.0', prefix + 'aspp.project.1',
             aspp['project'])
    i = 0
    while f'layers_{i}' in p:
        _block(out, f'{prefix}layers.{i}.transformer.',
               p[f'layers_{i}']['transformer'])
        i += 1
    i = 0
    while f'skip_proj_{i}' in p:
        _conv(out, f'{prefix}skip_proj.{i}.0', p[f'skip_proj_{i}'])
        i += 1
    for name in ('up1', 'up2'):
        up = p[name]
        out[f'{prefix}{name}.up.weight'] = _f(up['up_kernel']).transpose(
            2, 3, 0, 1)
        out[f'{prefix}{name}.up.bias'] = _f(up['up_bias'])
        _conv_gn(out, f'{prefix}{name}.conv.0', f'{prefix}{name}.conv.1',
                 up['conv1'])
        _conv_gn(out, f'{prefix}{name}.conv.3', f'{prefix}{name}.conv.4',
                 up['conv2'])


def vlm_state_dict(params):
    """JAX VLM params ({'backbone', 'decode_head'}) -> numpy state dict."""
    out = {}
    export_maskclip_vit(out, params['backbone'])
    export_vlg_head(out, params['decode_head'])
    return out


def load_jax_params(model, params):
    """Load JAX VLM params into ``model`` (a ``models.vlm.VLM``) with
    ``strict=True``: every key of the model must be given, and no other."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in vlm_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
