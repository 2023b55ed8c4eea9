"""Numerical parity against the PyTorch reference (counterpart of
``semivl_tpu/tools/parity_check.py``).

Loads a reference checkpoint (a released ``best.pth``) into the port's
model and evaluates the config's val set. With ``--ref-logits DIR`` it
holds the port's logits against the ``.npy`` / ``.pt`` dumps the
reference's ``third_party/unimatch/eval.py --logit-path`` wrote for the
same images: per image the max and mean absolute difference and the
argmax agreement, then their summary. Without it, it reports the mIoU
alone (the number to put beside the paper's table).

    python -m semivl_tpu_torch.tools.parity_check --config cfg.yaml \\
        --ckpt best.pth [--ref-logits ref_dump/] [--limit 20] [--ema] \\
        [--device cpu]
"""

import argparse
import os

import numpy as np
import yaml


def load_reference_logits(ref_dir, label_name):
    """The reference's dump for one label file (``.npy``, else ``.pt``),
    or None."""
    base = os.path.join(ref_dir, label_name)
    if os.path.isfile(base.replace('.png', '.npy')):
        return np.load(base.replace('.png', '.npy'))
    if os.path.isfile(base.replace('.png', '.pt')):
        import torch
        return torch.load(base.replace('.png', '.pt'), map_location='cpu',
                          weights_only=True).numpy()
    return None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', required=True)
    parser.add_argument('--ckpt', required=True)
    parser.add_argument('--ref-logits', default=None)
    parser.add_argument('--limit', type=int, default=None)
    parser.add_argument('--ema', action='store_true')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             'for the plain path)')
    args = parser.parse_args(argv)

    from semivl_tpu_torch.data.dataset import SemiDataset
    from semivl_tpu_torch.device import resolve_device
    from semivl_tpu_torch.evaluation.metrics import (intersection_and_union,
                                                     miou_from_histograms)
    from semivl_tpu_torch.evaluation.predict import Evaluator
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.tools.convert_reference_ckpt import (
        load_reference_into)
    from semivl_tpu_torch.train.loop import model_dtype

    device = resolve_device(args.device)
    with open(args.config) as f:
        cfg = yaml.load(f, Loader=yaml.Loader)
    cfg['clip_encoder'] = None
    cfg.setdefault('pl_text', cfg.get('text_embedding_variant', 'single'))

    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device)
    epoch = load_reference_into(bundle.model, args.ckpt, args.ema)
    print(f'loaded reference checkpoint (epoch {epoch})')

    valset = SemiDataset(cfg, 'val', id_path=cfg.get('val_id_path'))
    ev = Evaluator(bundle.model, bundle.text_feats, cfg, device)
    mode = cfg.get('eval_mode', 'zegclip_sliding_window')

    inter_sum = np.zeros(cfg['nclass'], np.int64)
    union_sum = np.zeros(cfg['nclass'], np.int64)
    diffs = []
    n = min(len(valset), args.limit or len(valset))
    for i in range(n):
        sample = valset.get(i)
        pred, logits = ev.predict(sample['img'][None],
                                  sample['mask'].shape, mode,
                                  return_logits=True)
        inter, union, _ = intersection_and_union(
            pred[0], sample['mask'], cfg['nclass'])
        inter_sum += inter
        union_sum += union
        if args.ref_logits:
            lbl = sample['id'].split(' ')[1].split('/')[-1]
            ref = load_reference_logits(args.ref_logits, lbl)
            if ref is not None:
                ref = ref.reshape(logits.shape)
                d = np.abs(logits - ref)
                agree = float((logits.argmax(1) == ref.argmax(1)).mean())
                diffs.append((d.max(), d.mean(), agree))
                print(f'[{i}] {lbl}: maxdiff={d.max():.4f} '
                      f'meandiff={d.mean():.5f} argmax_agree={agree:.4f}')

    miou, _ = miou_from_histograms(inter_sum, union_sum)
    print(f'mIoU over {n} images: {miou:.2f}')
    summary = dict(miou=miou, images=n)
    if diffs:
        diffs = np.array(diffs)
        summary.update(maxdiff_p95=float(np.percentile(diffs[:, 0], 95)),
                       meandiff=float(diffs[:, 1].mean()),
                       argmax_agreement=float(diffs[:, 2].mean()))
        print(f'logit parity: maxdiff p95={summary["maxdiff_p95"]:.4f} '
              f'mean={summary["meandiff"]:.5f} '
              f'argmax agreement={summary["argmax_agreement"]:.4f}')
    return summary


if __name__ == '__main__':
    main()
