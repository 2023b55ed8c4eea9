"""Run configs: the values of the flagship evaluation and training step
(reference exp 40, Pascal VOC; exp 42, COCO; exp 43, ADE20K), of the
Cityscapes model (exp 44) and of the tiny VLM the JAX package's demo
trains."""

from semivl_tpu_torch.configs.models import get_model_config

__all__ = ['ade_cfg', 'ade_train_cfg', 'cityscapes_cfg',
           'cityscapes_train_cfg', 'coco_cfg', 'coco_train_cfg',
           'flagship_cfg', 'flagship_train_cfg', 'get_model_config',
           'tiny_cfg', 'tiny_train_cfg']


def flagship_cfg(crop_size=512):
    """The reference exp-40 run config, as far as inference reads it:
    Pascal VOC with 21 classes, the flagship model, ``single`` text
    embeddings, ``zegclip_sliding_window`` evaluation with stride 426
    (reference experiments.py:134,303-333)."""
    return dict(
        exp=40,
        dataset='pascal',
        nclass=21,
        model='mmseg.vlm-vlg-aspp-s2p4-sk04-ftap-mcvitb',
        crop_size=crop_size,
        stride=426,
        eval_mode='zegclip_sliding_window',
        text_embedding_variant='single',
        pl_text='single',
    )


def flagship_train_cfg(crop_size=512):
    """The reference exp-40 run config as the SemiVL training step reads it
    (reference experiments.py:317-333 with its defaults; JAX
    ``semivl_tpu/configs/experiments.py:240-268``): per-GPU batch of 2
    labeled + 2 unlabeled crops, AdamW lr 1e-4 with the mmseg
    ``paramwise_cfg`` multipliers (backbone lr x0.01), weight decay 0.01,
    poly schedule without warm-up, pixelwise confidence at 0.95, and the
    MaskCLIP consistency loss: lambda 0.1 -> 0 linearly over the run, the
    frozen ``mcvit16`` guidance encoder with the ``concept4_single`` text,
    confidence 0.9, ``mean_all`` reduction."""
    cfg = flagship_cfg(crop_size)
    cfg.update(
        method='semivl',
        batch_size=2,
        criterion=dict(name='CELoss', kwargs=dict(ignore_index=255)),
        criterion_u='CELoss',
        use_fp=True,
        fp_rate=0.5,
        conf_mode='pixelwise',
        conf_thresh=0.95,
        maskclip_consistency_lambda=[0.1, 0],
        clip_encoder='mcvit16',
        mcc_text='concept4_single',
        mcc_conf_thresh=0.9,
        mcc_loss_reduce='mean_all',
        optimizer=dict(
            type='AdamW', lr=1e-4, weight_decay=0.01,
            paramwise_cfg=dict(custom_keys={
                'backbone': dict(lr_mult=0.01),
                'text_encoder': dict(lr_mult=0.0),
                'conv_encoder': dict(lr_mult=1.0),
                'norm': dict(decay_mult=0.),
                'ln': dict(decay_mult=0.),
                'head': dict(lr_mult=10.),
            })),
        warmup_iters=0,
        warmup_ratio=1e-6,
    )
    return cfg


def coco_cfg(crop_size=512):
    """The reference exp-42 run config, as far as inference reads it: the
    flagship model on COCO's 81 classes with the ``single`` text and
    ``zegclip_sliding_window`` at stride 426; exp 42 sets ``img_scale``
    None, so val images keep their size and those smaller than the crop
    take the evaluator's host route (JAX
    ``semivl_tpu/configs/experiments.py:362-376``)."""
    return dict(flagship_cfg(crop_size), exp=42, dataset='coco', nclass=81)


def ade_cfg(crop_size=512):
    """The reference exp-43 run config, as far as inference reads it: the
    flagship model on ADE20K's 150 classes (label 0 is "other", remapped to
    ignore by ``reduce_zero_label``) with the ``single`` text and
    ``zegclip_sliding_window`` at stride 426 (JAX
    ``semivl_tpu/configs/experiments.py:378-391``)."""
    return dict(flagship_cfg(crop_size), exp=43, dataset='ade', nclass=150,
                reduce_zero_label=True)


def _large_vocab_train_cfg(cfg):
    """Exp 42's and 43's SemiVL step on top of their inference config: the
    flagship's training values with a per-GPU batch of 1 labeled + 1
    unlabeled crop (the reference runs 8 GPUs x 1), AdamW lr 4e-4 with the
    backbone at x0.001, and the guidance encoder's text the decoder's
    (``single``); the decoder's backward on the whole-plane kernels."""
    train = flagship_train_cfg(cfg['crop_size'])
    train['optimizer']['lr'] = 4e-4
    train['optimizer']['paramwise_cfg']['custom_keys']['backbone'] = dict(
        lr_mult=0.001)
    return dict(train, **cfg, batch_size=1, mcc_text='single',
                decoder_bwd='whole')


def coco_train_cfg(crop_size=512):
    """The exp-42 run config as the SemiVL training step reads it."""
    return _large_vocab_train_cfg(coco_cfg(crop_size))


def ade_train_cfg(crop_size=512):
    """The exp-43 run config as the SemiVL training step reads it."""
    return _large_vocab_train_cfg(ade_cfg(crop_size))


def cityscapes_cfg(crop_size=801):
    """The reference exp-44 run config, as far as inference reads it:
    Cityscapes with 19 classes, the ``skr04`` model (ViT-B/16 + a
    ResNetV1c-101 skip encoder), ``conceptavg3_single`` decoder text, the
    ViT and guidance-encoder inputs renormalised to CLIP's statistics, and
    ``sliding_window`` evaluation: stride int(crop * 2 / 3), softmax
    probabilities summed over windows, edge windows at their natural size
    (JAX ``semivl_tpu/configs/experiments.py:393-414``)."""
    return dict(
        exp=44,
        dataset='cityscapes',
        nclass=19,
        model='mmseg.vlm-vlg-aspp-s2p4-skr04-ftap-mcvitb',
        crop_size=crop_size,
        eval_mode='sliding_window',
        text_embedding_variant='conceptavg3_single',
        pl_text='conceptavg3_single',
        model_args=dict(renorm_clip_img=True),
    )


def cityscapes_train_cfg(crop_size=801):
    """The exp-44 run config as the SemiVL training step reads it (the
    defaults of JAX ``config_from_vars`` where exp 44 sets nothing): per-GPU
    batch of 1 labeled + 1 unlabeled crop (the reference runs 8 GPUs x 1),
    AdamW lr 5e-5 with backbone and conv_encoder lr x0.1, weight decay 0.01,
    poly schedule without warm-up, ``pixelavg`` confidence at 0.95, and the
    MaskCLIP consistency loss: lambda 0.1 -> 0, the frozen ``mcvit16``
    guidance encoder (its 512 positional grid, resized) with the
    ``concept3_single`` text, confidence 0.9, ``mean_all``. The decoder's
    backward takes the banded route (``decoder_bwd='banded'``), the
    counterpart of the JAX fused route under ``SEMIVL_FORCE_BANDED_BWD=1``
    at this geometry."""
    cfg = cityscapes_cfg(crop_size)
    cfg.update(
        method='semivl',
        batch_size=1,
        criterion=dict(name='CELoss', kwargs=dict(ignore_index=255)),
        criterion_u='CELoss',
        use_fp=True,
        fp_rate=0.5,
        conf_mode='pixelavg',
        conf_thresh=0.95,
        maskclip_consistency_lambda=[0.1, 0],
        clip_encoder='mcvit16',
        mcc_text='concept3_single',
        mcc_conf_thresh=0.9,
        mcc_loss_reduce='mean_all',
        optimizer=dict(
            type='AdamW', lr=5e-5, weight_decay=0.01,
            paramwise_cfg=dict(custom_keys={
                'backbone': dict(lr_mult=0.1),
                'text_encoder': dict(lr_mult=0.0),
                'conv_encoder': dict(lr_mult=0.1),
                'norm': dict(decay_mult=0.),
                'ln': dict(decay_mult=0.),
                'head': dict(lr_mult=10.),
            })),
        warmup_iters=0,
        warmup_ratio=1e-6,
        decoder_bwd='banded',
    )
    return cfg


def tiny_cfg(crop_size=64):
    """The tiny VLM evaluated as the JAX package's demo runs it
    (``semivl_tpu/tools/semi_effect_demo.py:173-199``): the flagship values
    with ``mmseg.tiny-vlm-test``, 64 crops, ``zegclip_sliding_window`` at
    stride 48, and every attention on the kernels (``attention_impl =
    'pallas'``: its heads of 16 and 32 take the head-split route)."""
    cfg = flagship_cfg(crop_size)
    cfg.update(model='mmseg.tiny-vlm-test', stride=48,
               attention_impl='pallas')
    return cfg


def tiny_train_cfg(crop_size=64):
    """The tiny VLM's SemiVL step: the flagship training values with batch
    1 (+ 1 unlabeled), the ``tiny-mcvit-test`` guidance encoder built at the
    crop size (``mcc_fix_resize_pos``) with the ``concept4_single`` text,
    and ``attention_impl = 'pallas'``."""
    cfg = flagship_train_cfg(crop_size)
    cfg.update(model='mmseg.tiny-vlm-test', stride=48, batch_size=1,
               clip_encoder='tiny-mcvit-test', mcc_fix_resize_pos=True,
               mcc_text='concept4_single', attention_impl='pallas')
    return cfg
