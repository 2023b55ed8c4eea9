"""Weight bridge: a JAX ``semivl_tpu`` parameter tree -> this package.

The JAX tree (nested dicts of numpy arrays, as ``variables['params']``
holds them) is renamed to the reference's torch names, which are this
package's ``state_dict`` keys, with the layout rules of the reference
exporter (reference tools/convert_to_torch.py):

- Dense kernels (in, out) transpose to (out, in);
- conv kernels (H, W, I, O) become (O, I, H, W);
- transpose-conv kernels (kH, kW, I, O) become (I, O, kH, kW);
- norm ``scale``/``bias`` become ``weight``/``bias``;
- BatchNorm statistics (the JAX ``batch_stats`` collection of the conv
  encoder and of the DeepLabV3+ head, ``mean``/``var``) become
  ``running_mean``/``running_var``.

The MaskCLIP, timm and ZegCLIP (VPT and prompt-less) ViTs, the VLG,
DeepLabV3+ and ATM heads and the ResNetV1c conv encoder are covered; the
DeepLabV3+ and ATM heads and the timm and ZegCLIP ViTs keep the flax scope
names (``aspp.b0.conv``, ``layers.3.ln1``, ``norm``, ``prompt_proj``,
``decoder.0.attn.q``). ``dlv3p_state_dict`` carries the UniMatch
DeepLabV3+ segmentor (``model = 'deeplabv3plus'``): its ResNet encoder
under mmseg's names, its Xception-65 under the flax scopes (a depthwise
kernel (3, 3, 1, C) becomes (C, 1, 3, 3)), the head, reduction and fuse
convs as ``ConvBNReLU``, the dense ``classifier_dense`` as the 1x1 conv
``classifier``; ``load_jax_params`` picks the bridge by the model's
type.

Only numpy is needed to build the state dict. ``load_pretrained_into``
loads a converted CLIP backbone tree (``load_flax_npz``: the npz that
``semivl_tpu/tools/convert_clip_weights.py`` writes) into the model's
``backbone`` and frozen ``clip_encoder`` alike, the position embedding
resized per scope (``resize_pos_embed``); it refuses the VPT backbone,
whose layout JAX's loader does not take either.
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


def _block(out, pre, p, ffn=('layers.0.0', 'layers.1')):
    """TransformerBlock -> mmcv TransformerEncoderLayer names (a CLIP
    block's FFN: ``ffn=('fc1', 'fc2')``)."""
    _norm(out, pre + 'ln1', p['ln1'])
    _norm(out, pre + 'ln2', p['ln2'])
    out[pre + 'attn.attn.in_proj_weight'] = _f(
        p['attn']['in_proj']['kernel']).T
    out[pre + 'attn.attn.in_proj_bias'] = _f(p['attn']['in_proj']['bias'])
    _dense(out, pre + 'attn.attn.out_proj', p['attn']['out_proj'])
    _dense(out, pre + 'ffn.' + ffn[0], p['ffn']['fc1'])
    _dense(out, pre + 'ffn.' + ffn[1], p['ffn']['fc2'])


def export_maskclip_vit(out, p, prefix='backbone.'):
    out[prefix + 'cls_token'] = _f(p['cls_token'])
    out[prefix + 'pos_embed'] = _f(p['pos_embed'])
    out[prefix + 'patch_embed.projection.weight'] = _f(
        p['patch_embed']['kernel']).transpose(3, 2, 0, 1)
    # ln0, ln1 and proj exist as pre_norm, final_norm and return_clip_embed
    # say
    for norm in ('ln0', 'ln1'):
        if norm in p:
            _norm(out, prefix + norm, p[norm])
    if 'proj' in p:
        # CLIP's visual projection, stored as a 1x1 conv by the reference
        out[prefix + 'proj.weight'] = _f(
            p['proj']['kernel']).T[:, :, None, None]
    i = 0
    while f'layers_{i}' in p:
        _block(out, f'{prefix}layers.{i}.', p[f'layers_{i}'])
        i += 1


def export_timm_vit(out, p, prefix='backbone.'):
    """JAX ``TIMMVisionTransformer`` params -> ``models.timm_vit`` names."""
    out[prefix + 'cls_token'] = _f(p['cls_token'])
    out[prefix + 'pos_embed'] = _f(p['pos_embed'])
    _conv(out, prefix + 'patch_embed', p['patch_embed'])
    _norm(out, prefix + 'norm', p['norm'])
    i = 0
    while f'layers_{i}' in p:
        _block(out, f'{prefix}layers.{i}.', p[f'layers_{i}'])
        i += 1


def export_vpt_vit(out, p, prefix='backbone.'):
    """JAX ``VPTCLIPVisionTransformer`` params (or the prompt-less
    ``CLIPVisionTransformer``'s, which lack the four prompt leaves) ->
    ``models.zegclip_vit`` names."""
    out[prefix + 'patch_embed.weight'] = _f(
        p['patch_embed']['kernel']).transpose(3, 2, 0, 1)
    for leaf in ('class_embedding', 'positional_embedding', 'proj',
                 'prompt_embeddings', 'deep_prompt_embeddings'):
        if leaf in p:
            out[prefix + leaf] = _f(p[leaf])
    for norm in ('ln_pre', 'ln_post', 'prompt_norm'):
        if norm in p:
            _norm(out, prefix + norm, p[norm])
    if 'prompt_proj' in p:
        _dense(out, prefix + 'prompt_proj', p['prompt_proj'])
    i = 0
    while f'layers_{i}' in p:
        _block(out, f'{prefix}layers.{i}.', p[f'layers_{i}'], ('fc1', 'fc2'))
        i += 1


def export_atm_head(out, p, prefix='decode_head.'):
    """JAX ``ATMSingleHeadSeg`` params -> ``models.atm_head`` names."""
    if 'input_proj' in p:
        _dense(out, prefix + 'input_proj', p['input_proj'])
        _norm(out, prefix + 'proj_norm', p['proj_norm'])
    _dense(out, prefix + 'q_proj', p['q_proj'])
    i = 0
    while f'decoder_{i}' in p:
        layer, pre = p[f'decoder_{i}'], f'{prefix}decoder.{i}.'
        for name in ('q', 'k', 'v', 'proj'):
            _dense(out, f'{pre}attn.{name}', layer['attn'][name])
        for name in ('norm2', 'norm3'):
            _norm(out, pre + name, layer[name])
        for name in ('linear1', 'linear2'):
            _dense(out, pre + name, layer[name])
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


def up_stage_params(up, head=None):
    """A JAX ``Up`` param tree (``up_kernel``, ``up_bias``, ``conv1`` and
    ``conv2`` with ``conv``/``gn``) -> the torch-layout stage dict of
    ``ops.fused_up.fused_up_stage`` (float32 tensors); with ``head`` (a
    JAX conv tree, kernel (3, 3, Cout, 1) and bias) also the head dict."""
    sd = {'up.weight': _f(up['up_kernel']).transpose(2, 3, 0, 1),
          'up.bias': _f(up['up_bias'])}
    _conv_gn(sd, 'conv1', 'gn1', up['conv1'])
    _conv_gn(sd, 'conv2', 'gn2', up['conv2'])
    if head is not None:
        _conv(sd, 'head', head)
    t = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    stage = dict(up_weight=t['up.weight'], up_bias=t['up.bias'],
                 conv1_weight=t['conv1.weight'], gn1_weight=t['gn1.weight'],
                 gn1_bias=t['gn1.bias'], conv2_weight=t['conv2.weight'],
                 gn2_weight=t['gn2.weight'], gn2_bias=t['gn2.bias'])
    if head is None:
        return stage
    return stage, dict(weight=t['head.weight'], bias=t['head.bias'])


def _conv_bn(out, conv_key, bn_key, p, s):
    _conv(out, conv_key, p['conv'])
    _norm(out, bn_key, p['bn'])
    if s is not None:
        out[bn_key + '.running_mean'] = _f(s['bn']['mean'])
        out[bn_key + '.running_var'] = _f(s['bn']['var'])


def export_resnet_v1c(out, p, s=None, prefix='conv_encoder.'):
    """JAX ResNetV1c params ``p`` and batch statistics ``s`` (None: the
    parameters only) -> mmseg names (reference tools/convert_to_torch.py:
    ``stem.0/1``, ``stem.3/4``, ``stem.6/7``, ``layer<i>.<b>.conv<k>`` /
    ``bn<k>``, ``downsample.0/1``)."""
    def stats(*keys):
        node = s
        for k in keys:
            node = None if node is None else node[k]
        return node

    for name, ck, bk in (('stem1', 'stem.0', 'stem.1'),
                         ('stem2', 'stem.3', 'stem.4'),
                         ('stem3', 'stem.6', 'stem.7')):
        _conv_bn(out, prefix + ck, prefix + bk, p[name], stats(name))
    for key in sorted(k for k in p if k.startswith('layer')):
        stage, b = key.split('_')
        bp = f'{prefix}{stage}.{b}.'
        for i in (1, 2, 3):
            _conv_bn(out, bp + f'conv{i}', bp + f'bn{i}', p[key][f'conv{i}'],
                     stats(key, f'conv{i}'))
        if 'downsample' in p[key]:
            _conv_bn(out, bp + 'downsample.0', bp + 'downsample.1',
                     p[key]['downsample'], stats(key, 'downsample'))


def export_dlv3p_head(out, p, s=None, prefix='decode_head.'):
    """JAX ``DLV3PHead`` params ``p`` and batch statistics ``s`` (None: the
    parameters only) -> ``models.dlv3p_head`` names: every ``ConvBNReLU``
    as ``<scope>.conv`` / ``<scope>.bn``, the ``classifier`` conv."""
    def unit(key, *path):
        node, stats = p, s
        for k in path:
            node = node[k]
            stats = None if stats is None else stats[k]
        _conv_bn(out, f'{prefix}{key}.conv', f'{prefix}{key}.bn', node,
                 stats)

    for name in sorted(p['aspp']):
        unit(f'aspp.{name}', 'aspp', name)
    for name in ('c1_proj', 'fuse1', 'fuse2'):
        unit(name, name)
    _conv(out, prefix + 'classifier', p['classifier'])


def _bn(out, key, p, s):
    """A flax BatchNorm (``scale``, ``bias``; statistics ``mean``, ``var``)
    -> ``<key>.weight/bias/running_mean/running_var``."""
    _norm(out, key, p)
    if s is not None:
        out[key + '.running_mean'] = _f(s['mean'])
        out[key + '.running_var'] = _f(s['var'])


def export_xception(out, p, s=None, prefix='encoder.'):
    """JAX ``Xception65`` params and batch statistics -> ``models.xception``
    names: each scope's convolutions by their scope name, each ``_BN``
    wrapper's BatchNorm directly under the wrapper's name."""
    for key, node in p.items():
        stats = None if s is None else s.get(key)
        if 'kernel' in node:
            _conv(out, prefix + key, node)
        elif set(node) == {'bn'}:
            _bn(out, prefix + key, node['bn'],
                None if stats is None else stats['bn'])
        else:
            export_xception(out, node, stats, f'{prefix}{key}.')


def dlv3p_state_dict(params, batch_stats=None):
    """JAX ``DeepLabV3Plus`` params ({'encoder', 'head', 'reduce', 'fuse1',
    'fuse2', 'classifier_dense'}) and ``batch_stats`` -> numpy state dict
    of ``models.deeplabv3plus.DeepLabV3Plus``; the encoder is the ResNet
    when it has a ``stem1``, else the Xception-65."""
    s = batch_stats or {}
    out = {}
    if 'stem1' in params['encoder']:
        export_resnet_v1c(out, params['encoder'], s.get('encoder'),
                          prefix='encoder.')
    else:
        export_xception(out, params['encoder'], s.get('encoder'))
    for name in sorted(params['head']):
        _conv_bn(out, f'head.{name}.conv', f'head.{name}.bn',
                 params['head'][name], s.get('head', {}).get(name))
    for name in ('reduce', 'fuse1', 'fuse2'):
        _conv_bn(out, f'{name}.conv', f'{name}.bn', params[name],
                 s.get(name))
    dense = params['classifier_dense']
    out['classifier.weight'] = _f(dense['kernel']).T[:, :, None, None]
    out['classifier.bias'] = _f(dense['bias'])
    return out


def vlm_state_dict(params, batch_stats=None):
    """JAX VLM params ({'backbone', 'decode_head'} and, in a training tree,
    'clip_encoder'; in the Cityscapes model 'conv_encoder') and the
    ``batch_stats`` collection -> numpy state dict. The backbone is the
    timm ViT when it has a ``norm`` scope, a ZegCLIP ViT when it has a
    ``class_embedding``; the head the ATM one when it has a ``q_proj``, the
    DeepLabV3+ one when it has no ``conv1``."""
    out = {}
    if 'norm' in params['backbone']:
        export_timm_vit(out, params['backbone'])
    elif 'class_embedding' in params['backbone']:
        export_vpt_vit(out, params['backbone'])
    else:
        export_maskclip_vit(out, params['backbone'])
    if 'conv1' in params['decode_head']:
        export_vlg_head(out, params['decode_head'])
    elif 'q_proj' in params['decode_head']:
        export_atm_head(out, params['decode_head'])
    else:
        export_dlv3p_head(out, params['decode_head'],
                          (batch_stats or {}).get('decode_head'))
    if 'conv_encoder' in params:
        export_resnet_v1c(out, params['conv_encoder'],
                          None if batch_stats is None
                          else batch_stats['conv_encoder'])
    if 'clip_encoder' in params:
        export_maskclip_vit(out, params['clip_encoder'],
                            prefix='clip_encoder.')
    return out


def load_jax_params(model, params, batch_stats=None):
    """Load JAX params (and the BatchNorm ``batch_stats``) into ``model``
    (a ``models.vlm.VLM`` or a ``models.deeplabv3plus.DeepLabV3Plus``,
    each through its bridge) with ``strict=True``: every key of the model
    must be given, and no other."""
    from semivl_tpu_torch.models.deeplabv3plus import DeepLabV3Plus
    bridge = (dlv3p_state_dict if isinstance(model, DeepLabV3Plus)
              else vlm_state_dict)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in bridge(params, batch_stats).items()}
    model.load_state_dict(sd, strict=True)
    return model


def unflatten(flat):
    """{'a/b/c': array} -> nested dicts (JAX ``_unflatten``)."""
    tree = {}
    for key, v in flat.items():
        parts = key.split('/')
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def load_flax_npz(path):
    """A converted tree saved as an npz of '/'-joined paths (JAX
    ``tools/convert_clip_weights.py::load_flax_npz``)."""
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})


def resize_pos_embed(pos_embed, target_len):
    """Bicubic-resize a (1, 1 + P, C) position embedding to (1, target_len,
    C), keeping the cls token (JAX ``convert_clip_weights.resize_pos_embed``,
    reference maskclip_vit.py:392-403); numpy in and out."""
    if pos_embed.shape[1] == target_len:
        return pos_embed
    from semivl_tpu_torch.ops.resize import resize_longer_matrix
    old = int(round((pos_embed.shape[1] - 1) ** 0.5))
    new = int(round((target_len - 1) ** 0.5))
    if old * old + 1 != pos_embed.shape[1] or new * new + 1 != target_len:
        raise ValueError(f'position embeddings of square grids only: '
                         f'{pos_embed.shape[1]} -> {target_len}')
    out = resize_longer_matrix(torch.from_numpy(_f(pos_embed)), (new, new),
                               (old, old))
    return out.numpy()


def copy_into(model, sd, what='state dict'):
    """Copy the numpy state dict ``sd`` into ``model``'s parameters and
    buffers of the same names, each in its own dtype; every key must name
    one with its shape."""
    own = model.state_dict()
    for k, v in sd.items():
        if k not in own:
            raise ValueError(f'{what}: the model has no {k!r}')
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f'{what}: {k} {tuple(v.shape)} vs the model\'s '
                             f'{tuple(own[k].shape)}')
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))


def load_pretrained_into(model, path):
    """A converted CLIP backbone tree (a path to its npz, or the tree) into
    ``model``'s ``backbone`` and, where the model has one, its frozen
    ``clip_encoder`` (reference mcvit16.py loads the same checkpoint), the
    position embedding resized to each scope's grid (JAX
    ``load_pretrained_into``). Each scope must take every leaf of the tree
    and nothing else. A VPT CLIP backbone (exp 41's ZegCLIP row) is refused
    by name: JAX's loader takes the MaskCLIP layout only (it reads
    ``pos_embed``, which the VPT tree lacks)."""
    own = model.state_dict()
    if 'backbone.prompt_embeddings' in own:
        raise NotImplementedError(
            'load_pretrained_into: the VPTCLIPVisionTransformer backbone has '
            'no pretrained loader (JAX loads the MaskCLIP layout only)')
    tree = load_flax_npz(path) if isinstance(path, str) else path
    for scope in ('backbone', 'clip_encoder'):
        prefix = scope + '.'
        if not any(k.startswith(prefix) for k in own):
            continue
        src = dict(tree, pos_embed=resize_pos_embed(
            np.asarray(tree['pos_embed']), own[prefix + 'pos_embed'].shape[1]))
        sd = {}
        export_maskclip_vit(sd, src, prefix)
        missing = {k for k in own if k.startswith(prefix)} - set(sd)
        if missing:
            raise ValueError(f'{scope}: the pretrained tree lacks '
                             f'{sorted(missing)[:4]}')
        copy_into(model, sd, scope)
    return model
