"""Run configs: the values of the flagship evaluation (reference exp 40)."""

from semivl_tpu_torch.configs.models import get_model_config

__all__ = ['flagship_cfg', 'get_model_config']


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
