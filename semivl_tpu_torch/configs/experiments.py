"""Experiment/config generator.

Preserves the reference's two-tier config system (reference
experiments.py:60-497): ``config_from_vars`` maps ~40 keyword arguments to a
flat YAML-able dict plus a self-describing run name, and
``generate_experiment_cfgs`` enumerates the paper grid for experiment IDs
40 (SemiVL VOC), 41 (VOC ablations), 42 (COCO), 43 (ADE20K),
44 (Cityscapes). Key names, run names and YAML schema match the reference so
configs stay comparable. A copy of ``semivl_tpu/configs/experiments.py``:
the same configs, key for key, with this package's version; the port's
trainer (``train/loop.py``) reads them on one card.
"""

import itertools
import os
import subprocess
from functools import reduce

import yaml

from semivl_tpu_torch.version import __version__

DATA_DIR = os.environ.get('SEMIVL_DATA_DIR', '~/data/')

_DATA_ROOTS = dict(
    pascal='voc/',
    cityscapes='cityscapes/',
    coco='coco/',
    ade='ADEChallengeData2016/',
)

_NCLASS = dict(pascal=21, cityscapes=19, coco=81, ade=150)

_TEXT_VARIANT_ABBREV = {
    'conceptavg_single': 'cavgs',
    'conceptavg2_single': 'cavg2s',
    'conceptavg3_single': 'cavg3s',
    'conceptavg4_single': 'cavg4s',
    'concept2_single': 'c2s',
    'concept3_single': 'c3s',
    'concept4_single': 'c4s',
    'multi': 'm',
}

_CONF_MODE_ABBREV = {'pixelwise': '', 'pixelratio': '-cpr', 'pixelavg': '-cpa'}
_MCC_REDUCE_ABBREV = {'mean': '', 'mean_valid': '-mv', 'mean_all': '-ma'}
_EVAL_MODE_ABBREV = {
    'original': 'or',
    'sliding_window': 'sw',
    'zegclip_sliding_window': 'zsw',
}


def nested_set(dic, key, value):
    keys = key.split('.')
    for k in keys[:-1]:
        dic = dic.setdefault(k, {})
    dic[keys[-1]] = value


def nested_get(dictionary, keys, default=None):
    return reduce(
        lambda d, key: d.get(key, default) if isinstance(d, dict) else default,
        keys.split('.'), dictionary)


def get_git_revision():
    try:
        return subprocess.check_output(
            ['git', 'rev-parse', 'HEAD'],
            stderr=subprocess.DEVNULL).decode('ascii').strip()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return ''


def human_format(num):
    num = float('{:.3g}'.format(num))
    magnitude = 0
    while abs(num) >= 1000:
        magnitude += 1
        num /= 1000.0
    return '{}{}'.format(
        '{:f}'.format(num).rstrip('0').rstrip('.'),
        ['', 'K', 'M', 'B', 'T'][magnitude])


def _sanitize_name(name):
    # Reference experiments.py:302-305 name cleanup rules.
    for old, new in (('.0_', '_'), ('.0-', '-'), ('.', ''), ('True', 'T'),
                     ('False', 'F'), ('None', 'N'), ('[', ''), (']', ''),
                     ('(', ''), (')', ''), (',', 'j'), (' ', '')):
        name = name.replace(old, new)
    return name


def config_from_vars(
    exp_id,
    gpu_model='a100',
    n_gpus=4,
    n_nodes=1,
    batch_size=2,
    epochs=80,
    iters=None,
    scheduler_max_iters=None,
    dataset='pascal',
    split='92',
    img_scale=(2048, 512),
    scale_ratio_range=(0.5, 2.0),
    crop_size=512,
    labeled_photometric_distortion=False,
    renorm_clip_img=False,
    method='semivl',
    use_fp=True,
    conf_mode='pixelwise',
    conf_thresh=0.95,
    pleval=True,
    disable_dropout=True,
    fp_rate=0.5,
    maskclip_consistency_lambda=0,
    maskclip_class_filter=None,
    mcc_conf_thresh=0.75,
    mcc_loss_reduce='mean',
    mcc_text='same',
    mcc_fix_resize_pos=False,
    pl_text='same',
    opt='adamw',
    lr=1e-4,
    backbone_lr_mult=10.0,
    conv_enc_lr_mult=1.0,
    warmup_iters=0,
    criterion='mmseg',
    criterion_u='mmseg',
    model='mmseg.zegclip-vitb',
    text_embedding_variant='single',
    eval_mode='zegclip_sliding_window',
    eval_every=1,
    nccl_p2p_disable=False,
):
    """Build a flat run config dict with a self-describing name.

    Semantics parity: reference experiments.py:60-309. The returned dict is
    the YAML schema consumed by the trainer CLIs.
    """
    if isinstance(img_scale, tuple):
        img_scale = list(img_scale)

    cfg = {}
    frags = []  # name fragments, joined without separator

    # ---- dataset ----
    cfg['dataset'] = dataset
    frags.append(dataset.replace('pascal', 'voc').replace('cityscapes', 'cs'))
    cfg['data_root'] = os.path.join(DATA_DIR, _DATA_ROOTS[dataset])
    cfg['nclass'] = _NCLASS[dataset]
    if dataset == 'ade':
        cfg['reduce_zero_label'] = True
    cfg['split'] = split
    frags.append(f'-{split}')
    cfg['img_scale'] = img_scale
    if img_scale is not None:
        frags.append(f'-{img_scale}')
    cfg['scale_ratio_range'] = scale_ratio_range
    if scale_ratio_range != (0.5, 2.0):
        frags.append(f'-s{scale_ratio_range[0]}-{scale_ratio_range[1]}')
    cfg['crop_size'] = crop_size
    frags.append(f'-{crop_size}')
    cfg['labeled_photometric_distortion'] = labeled_photometric_distortion
    if labeled_photometric_distortion:
        frags.append('-phd')

    # ---- model ----
    frags.append(f'_{model}'.replace('mmseg.', '').replace('zegclip', 'zcl'))
    cfg['model_args'] = {}
    if model == 'dlv3p-r101':
        cfg['model'] = 'deeplabv3plus'
        cfg['backbone'] = 'resnet101'
        cfg['replace_stride_with_dilation'] = [False, False, True]
        cfg['dilations'] = [6, 12, 18]
    elif model == 'dlv3p-xc65':
        cfg['model'] = 'deeplabv3plus'
        cfg['backbone'] = 'xception'
        cfg['dilations'] = [6, 12, 18]
    else:
        cfg['model'] = model
        cfg['text_embedding_variant'] = text_embedding_variant
        cfg['mcc_text'] = (text_embedding_variant if mcc_text == 'same'
                           else mcc_text)
        cfg['pl_text'] = (text_embedding_variant if pl_text == 'same'
                          else pl_text)
        if text_embedding_variant != 'single':
            frags.append('-t' + _TEXT_VARIANT_ABBREV[text_embedding_variant])
        if mcc_text != 'same':
            frags.append('-mt' + _TEXT_VARIANT_ABBREV[mcc_text])
        if pl_text != 'same':
            frags.append('-pt' + _TEXT_VARIANT_ABBREV[pl_text])

    # ---- method ----
    cfg['method'] = method
    frags.append(f'_{method}'.replace('semivl', 'svl')
                 .replace('unimatch', 'um').replace('supervised', 'sup'))
    if method in ('unimatch', 'semivl'):
        cfg['use_fp'] = use_fp
        if not use_fp:
            frags.append('-nfp')
        cfg['conf_mode'] = conf_mode
        frags.append(_CONF_MODE_ABBREV[conf_mode])
        cfg['conf_thresh'] = conf_thresh
        frags.append(f'-{conf_thresh}')
    cfg['disable_dropout'] = disable_dropout
    if disable_dropout:
        frags.append('-disdrop')
    if method in ('unimatch', 'semivl'):
        cfg['pleval'] = pleval
        if pleval:
            frags.append('-plev')
    cfg['fp_rate'] = fp_rate
    if fp_rate != 0.5:
        frags.append(f'-fpr{fp_rate}')
    cfg['maskclip_consistency_lambda'] = maskclip_consistency_lambda
    if maskclip_consistency_lambda != 0:
        cfg['clip_encoder'] = 'mcvit16'
        frags.append(f'-mcc{maskclip_consistency_lambda}')
    else:
        cfg['clip_encoder'] = None
    cfg['mcc_conf_thresh'] = mcc_conf_thresh
    if mcc_conf_thresh != 0.75:
        frags.append(f'c{mcc_conf_thresh}')
    cfg['mcc_loss_reduce'] = mcc_loss_reduce
    frags.append(_MCC_REDUCE_ABBREV[mcc_loss_reduce])
    cfg['model_args']['maskclip_class_filter'] = {
        None: None,
        1: [9, 18],           # chair and sofa
        2: list(range(1, 21)),  # no background
    }[maskclip_class_filter]
    if maskclip_class_filter is not None:
        frags.append(f'-cf{maskclip_class_filter}')
    if renorm_clip_img:
        cfg['model_args']['renorm_clip_img'] = True
        frags.append('-rnci')
    if mcc_fix_resize_pos and cfg['clip_encoder'] is not None and crop_size != 512:
        cfg['mcc_fix_resize_pos'] = True
        frags.append('-frp')

    # ---- criterion ----
    cfg['criterion'] = dict(name=criterion, kwargs=dict(ignore_index=255))
    if cfg['criterion'] == 'OHEM':  # preserved reference quirk (always False)
        cfg['criterion']['kwargs'].update(dict(thresh=0.7, min_kept=200000))
    if criterion != 'mmseg':
        frags.append(f'-{criterion}'.replace('CELoss', 'ce').replace('OHEM', 'oh'))
    cfg['criterion_u'] = criterion_u
    if criterion_u != 'mmseg':
        frags.append(f'-u{criterion_u}'.replace('CELoss', 'ce'))

    # ---- optimizer ----
    if opt == 'original':
        cfg['lr'] = lr
        cfg['lr_multi'] = 10.0 if dataset != 'cityscapes' else 1.0
    elif opt == 'adamw':
        cfg['optimizer'] = dict(
            type='AdamW', lr=lr, weight_decay=0.01,
            paramwise_cfg=dict(custom_keys={
                'backbone': dict(lr_mult=backbone_lr_mult),
                'text_encoder': dict(lr_mult=0.0),
                'conv_encoder': dict(lr_mult=conv_enc_lr_mult),
                'norm': dict(decay_mult=0.),
                'ln': dict(decay_mult=0.),
                'head': dict(lr_mult=10.),
            }))
    else:
        raise NotImplementedError(opt)
    frags.append(f'_{opt}-{lr:.0e}'.replace('original', 'org'))
    if backbone_lr_mult != 10.0:
        frags.append(f'-b{backbone_lr_mult}')
    if conv_enc_lr_mult != 1.0:
        frags.append(f'-cl{conv_enc_lr_mult}')
    cfg['warmup_iters'] = warmup_iters
    cfg['warmup_ratio'] = 1e-6
    if warmup_iters > 0:
        frags.append(f'-w{human_format(warmup_iters)}')

    # ---- batch ----
    cfg['gpu_model'] = gpu_model
    cfg['n_gpus'] = n_gpus
    cfg['n_nodes'] = n_nodes
    cfg['batch_size'] = batch_size
    if n_gpus != 4 or batch_size != 2 or n_nodes != 1:
        frags.append(f'_{n_nodes}x{n_gpus}x{batch_size}')

    # ---- schedule ----
    assert not (iters is not None and epochs is not None)
    cfg['epochs'] = epochs
    cfg['iters'] = iters
    if epochs is not None and epochs != 80:
        frags.append(f'-ep{human_format(epochs)}')
    if iters is not None:
        frags.append(f'-i{human_format(iters)}')
    if scheduler_max_iters is not None:
        cfg['scheduler_max_iters'] = scheduler_max_iters
        frags.append(f'-smi{scheduler_max_iters}')

    # ---- eval ----
    cfg['eval_mode'] = eval_mode
    if eval_mode == 'zegclip_sliding_window':
        cfg['stride'] = 426
    frags.append('_e' + _EVAL_MODE_ABBREV[eval_mode])
    cfg['eval_every_n_epochs'] = eval_every
    cfg['nccl_p2p_disable'] = nccl_p2p_disable

    cfg['exp'] = exp_id
    cfg['name'] = _sanitize_name(''.join(frags))
    cfg['version'] = __version__
    cfg['git_rev'] = get_git_revision()
    return cfg


def generate_experiment_cfgs(exp_id):
    """Enumerate the paper grid for an experiment ID (reference
    experiments.py:311-460)."""
    cfgs = []

    if exp_id == 40:  # SemiVL on VOC
        splits = [92, 183, 366, 732, 1464]
        variants = [
            dict(model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb', lr=1e-4,
                 backbone_lr_mult=0.01, criterion='CELoss',
                 maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
                 mcc_text='concept4_single', mcc_loss_reduce='mean_all'),
        ]
        for split, kwargs in itertools.product(splits, variants):
            cfgs.append(config_from_vars(
                exp_id=exp_id, split=str(split), conf_thresh=0.95,
                criterion_u=kwargs['criterion'], **kwargs))

    elif exp_id == 41:  # Ablations on VOC
        splits = [92, 1464]
        variants = [
            # UniMatch w/ ZegCLIP
            dict(model='mmseg.vlm-zegclip-rd-pt-vitb', lr=1e-4,
                 backbone_lr_mult=10, criterion='mmseg'),
            # UniMatch w/ ViT
            dict(model='mmseg.vlm-dlv3p-bn11-sk4-ft-tvit-in1k', lr=1e-4,
                 backbone_lr_mult=0.001, criterion='CELoss'),
            # + CLIP Init
            dict(model='mmseg.vlm-dlv3p-bn12-sk4-ft-mcvitb', lr=1e-4,
                 backbone_lr_mult=0.001, criterion='CELoss'),
            # + CLIP Init + SFT
            dict(model='mmseg.vlm-dlv3p-bn12-sk4-ftap-mcvitb', lr=1e-4,
                 backbone_lr_mult=0.01, criterion='CELoss'),
            # + CLIP Init + SFT + VLDec
            dict(model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb', lr=1e-4,
                 backbone_lr_mult=0.01, criterion='CELoss'),
            # + CLIP Init + SFT + VLDec + CLIP Guid.
            dict(model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb', lr=1e-4,
                 backbone_lr_mult=0.01, criterion='CELoss',
                 maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
                 mcc_loss_reduce='mean_all'),
        ]
        for split, kwargs in itertools.product(splits, variants):
            cfgs.append(config_from_vars(
                exp_id=exp_id, split=str(split), conf_thresh=0.95,
                criterion_u=kwargs['criterion'], **kwargs))

    elif exp_id == 42:  # SemiVL on COCO
        splits = ['1_512', '1_64', '1_128', '1_256', '1_32']
        variants = [
            dict(model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb', lr=4e-4,
                 backbone_lr_mult=0.001, criterion='CELoss',
                 maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
                 mcc_loss_reduce='mean_all'),
        ]
        for split, kwargs in itertools.product(splits, variants):
            if 'vlg' in kwargs['model']:
                kwargs['n_nodes'], kwargs['n_gpus'], kwargs['batch_size'] = 1, 8, 1
            cfgs.append(config_from_vars(
                exp_id=exp_id, dataset='coco', split=str(split),
                img_scale=None, epochs=10, conf_thresh=0.95,
                criterion_u=kwargs['criterion'], **kwargs))

    elif exp_id == 43:  # SemiVL on ADE20K
        splits = ['1_128', '1_64', '1_32', '1_16', '1_8']
        variants = [
            dict(model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb', lr=4e-4,
                 backbone_lr_mult=0.001, criterion='CELoss',
                 maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
                 mcc_loss_reduce='mean_all'),
        ]
        for kwargs, split in itertools.product(variants, splits):
            if 'vlg' in kwargs['model']:
                kwargs['n_nodes'], kwargs['n_gpus'], kwargs['batch_size'] = 1, 8, 1
            cfgs.append(config_from_vars(
                exp_id=exp_id, dataset='ade', split=str(split), epochs=40,
                conf_thresh=0.95, criterion_u=kwargs['criterion'], **kwargs))

    elif exp_id == 44:  # SemiVL on Cityscapes
        splits = ['1_30', '1_16', '1_8', '1_4', '1_2']
        variants = [
            dict(model='mmseg.vlm-vlg-aspp-s2p4-skr04-ftap-mcvitb', lr=5e-5,
                 backbone_lr_mult=0.1, criterion='CELoss',
                 maskclip_consistency_lambda=[0.1, 0], mcc_conf_thresh=0.9,
                 mcc_text='concept3_single', mcc_loss_reduce='mean_all',
                 text_embedding_variant='conceptavg3_single',
                 renorm_clip_img=True, conv_enc_lr_mult=0.1),
        ]
        for kwargs, split in itertools.product(variants, splits):
            if 'vlg' in kwargs['model']:
                kwargs['n_nodes'], kwargs['n_gpus'], kwargs['batch_size'] = 1, 8, 1
            if 'criterion_u' not in kwargs:
                kwargs['criterion_u'] = kwargs['criterion']
            cfgs.append(config_from_vars(
                exp_id=exp_id, dataset='cityscapes', split=str(split),
                img_scale=None, crop_size=801,
                # same #iters as 1_16 with 80 epochs
                epochs=None, iters=83760,
                conf_mode='pixelavg', eval_every=10,
                eval_mode='sliding_window', **kwargs))
    else:
        raise NotImplementedError(f'Unknown id {exp_id}')

    return cfgs


def save_experiment_cfgs(exp_id, out_dir='configs/generated'):
    cfgs = generate_experiment_cfgs(exp_id)
    cfg_files = []
    for cfg in cfgs:
        cfg_file = os.path.join(out_dir, f"exp-{cfg['exp']}", f"{cfg['name']}.yaml")
        os.makedirs(os.path.dirname(cfg_file), exist_ok=True)
        with open(cfg_file, 'w') as f:
            yaml.dump(cfg, f, default_flow_style=None, sort_keys=False, indent=2)
        cfg_files.append(cfg_file)
    return cfgs, cfg_files
