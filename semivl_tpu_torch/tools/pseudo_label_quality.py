"""Pseudo-label quality of the semi-supervision mechanism on synthetic
blob data (counterpart of ``semivl_tpu/tools/pseudo_label_quality.py``).

End-to-end mIoU gains at toy scale lie inside seed noise, so this tool
measures the mechanism itself: with a pretrained, informative guidance
encoder (``semi_effect_demo.pretrain_guidance``) it reports, per seed,
branch and confidence threshold,

- the teacher branch (reference semivl.py:228-232: the live model on the
  weak view, softmax max-confidence): the pseudo-label's precision over
  the pixels above the threshold, and their share (coverage);
- the MaskCLIP guidance branch (semivl.py:234-240, vlm.py:90-110: the
  frozen encoder, the text product, 255 below the threshold): precision
  over the pixels it keeps, and coverage;
- both on the classes the labeled split never shows (3-4), where the
  teacher cannot know the answer and an informative guidance encoder can;
- the CutMix and confidence-weighting interaction: the mixed
  pseudo-label's correctness must be exactly the mix of the sources'
  (box geometry), its precision inside, on and outside the box edge, and
  the share of the student's loss on wrong pseudo-labels with and without
  confidence masking.

It asserts nothing; it prints the table, writes ``summary.json`` and ends
in one JSON line of the invariants (teacher precision monotonic in the
threshold, guidance beating the uninformed null on unseen classes, the
CutMix identity, confidence masking cutting the wrong-label loss share,
boundary precision holding).

    python -m semivl_tpu_torch.tools.pseudo_label_quality --out-root out \\
        [--seeds 3] [--warmup-steps 120] [--device cpu]
"""

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

THRESHOLDS = (0.0, 0.5, 0.75, 0.9, 0.95, 0.99)


def _load_pool(root, ids_path, crop=64):
    """A split's images (normalised) and label maps, cropped to the
    model's size at the top-left corner."""
    from PIL import Image

    from semivl_tpu_torch.data.transforms import normalize
    imgs, masks = [], []
    with open(ids_path) as f:
        for line in f:
            ip, mp = line.split()
            img = np.asarray(Image.open(os.path.join(root, ip)))
            mask = np.asarray(Image.open(os.path.join(root, mp)))
            imgs.append(normalize(img[:crop, :crop]))
            masks.append(mask[:crop, :crop].astype(np.int32))
    return np.stack(imgs), np.stack(masks)


def _precision_coverage(label, conf, gt, sel=None):
    """{threshold: (precision, coverage)}; ``sel`` restricts the pixels."""
    out = {}
    base = np.ones_like(gt, bool) if sel is None else sel
    for t in THRESHOLDS:
        m = base & (conf >= t)
        cov = m.mean() if sel is None else (m.sum() / max(base.sum(), 1))
        prec = float((label[m] == gt[m]).mean()) if m.any() else float('nan')
        out[t] = (prec, float(cov))
    return out


def _dilate4(mask, k):
    """``k`` steps of 4-neighbourhood binary dilation of (B, H, W) bool."""
    out = mask.copy()
    for _ in range(k):
        m = out.copy()
        out[:, 1:, :] |= m[:, :-1, :]
        out[:, :-1, :] |= m[:, 1:, :]
        out[:, :, 1:] |= m[:, :, :-1]
        out[:, :, :-1] |= m[:, :, 1:]
    return out


def _logits(model, text, imgs, device):
    with torch.no_grad():
        return model(torch.from_numpy(imgs).to(device), text).float() \
            .cpu().numpy()


def run_seed(out_root, seed, warmup_steps, device, pretrain_steps=160):
    """One seed: the blob data, the pretrained guidance, the tiny VLM
    warmed up on the labeled pool (Adam 3e-3, cross-entropy over every
    pixel: the teacher early in semi-supervised training), then both
    branches measured on the unlabeled pool. The model computes in the
    loop's dtype (bf16 on the card, whose decoder kernels take bf16;
    float32 on the CPU, as JAX's tool)."""
    from semivl_tpu_torch.convert import copy_into
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.tools.semi_effect_demo import (
        _base_cfg,
        make_blob_dataset,
        pretrain_guidance,
    )
    from semivl_tpu_torch.train.loop import model_dtype

    ds_root = os.path.join(out_root, f'data_s{seed}')
    paths = make_blob_dataset(ds_root, n_labeled=2, n_unlabeled=16,
                              n_val=8, seed=seed)
    guidance = pretrain_guidance(out_root, (72, 88), steps=pretrain_steps,
                                 seed=seed, device=device)
    cfg = _base_cfg(ds_root, paths, 'semivl', epochs=1, guidance=guidance)
    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device,
                         seed=seed)
    model = bundle.model
    with np.load(cfg['init_param_overrides']) as f:
        copy_into(model, {k: f[k] for k in f.files}, 'guidance encoder')
    text = torch.as_tensor(bundle.text_feats).to(device)
    mcc_text = torch.as_tensor(bundle.mcc_text_feats).to(device)

    # a brief supervised warmup on the labeled pool (classes 1-2 only);
    # every leaf of the segmentor trains, as JAX's plain Adam over params
    imgs_l, masks_l = _load_pool(ds_root, paths['labeled'])
    for n, p in model.named_parameters():
        p.requires_grad_(not n.startswith('clip_encoder'))
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=3e-3)
    il = torch.from_numpy(imgs_l).to(device)
    ml = torch.from_numpy(masks_l).long().to(device)
    loss = torch.zeros(())
    for _ in range(warmup_steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(il, text).float(), ml)
        loss.backward()
        opt.step()
        loss = loss.detach()
    print(f'[pl-quality] seed={seed} warmup CE {loss.item():.3f}',
          flush=True)

    # both branches on the unlabeled pool
    imgs_u, gt = _load_pool(ds_root, paths['unlabeled'])
    logits = _logits(model, text, imgs_u, device)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    t_conf, t_label = probs.max(1), probs.argmax(1)

    # the guidance's confidences: its labels at each threshold (the method
    # thresholds inside, vlm.py:90-110)
    iu = torch.from_numpy(imgs_u).to(device)
    with torch.no_grad():
        m_label = model.forward_maskclip(iu, mcc_text, 0.0).cpu().numpy()
        m_conf = np.ones_like(t_conf)
        for t in THRESHOLDS[1:]:
            lab_t = model.forward_maskclip(iu, mcc_text, t).cpu().numpy()
            m_conf = np.where((lab_t == 255) & (m_conf >= t), t - 1e-6,
                              m_conf)

    unseen = np.isin(gt, (3, 4))
    return dict(
        teacher=_precision_coverage(t_label, t_conf, gt),
        teacher_unseen=_precision_coverage(t_label, t_conf, gt, unseen),
        mcc=_precision_coverage(m_label, m_conf, gt),
        mcc_unseen=_precision_coverage(m_label, m_conf, gt, unseen),
        chance=float(np.mean(gt == np.bincount(gt.ravel()).argmax())),
        unseen_frac=float(unseen.mean()),
        cutmix=_cutmix_interaction(model, text, imgs_u, t_label, t_conf, gt,
                                   seed, device),
    )


def _cutmix_interaction(model, text, imgs, t_label, t_conf, gt, seed,
                        device, band_px=2):
    """The CutMix and confidence-weighting interaction (JAX
    ``_cutmix_interaction``): image i mixed with image i + 1 under a box
    (the step's rasteriser held to numpy slicing), (1) the exact
    correctness identity, (2) precision inside / on the edge band (+-
    ``band_px``) / outside the box, (3) the share of the student's
    cross-entropy on wrong mixed pseudo-labels at each threshold."""
    from semivl_tpu_torch.data.transforms import obtain_cutmix_box_coords
    from semivl_tpu_torch.train.step import cutmix_box_from_coords

    rs = np.random.RandomState(seed + 1000)
    b, hw = gt.shape[0], gt.shape[1]
    coords = np.stack([obtain_cutmix_box_coords(hw, rs, p=1.0)
                       for _ in range(b)])
    box = cutmix_box_from_coords(torch.from_numpy(coords), hw).numpy() == 1
    for i, (y, x, h, w) in enumerate(coords):
        expect = np.zeros((hw, hw), bool)
        expect[y:y + h, x:x + w] = True
        if not (box[i] == expect).all():
            raise AssertionError('the step\'s box rasteriser is misaligned')

    def other(a):   # pair image i with image i + 1
        return np.roll(a, -1, axis=0)

    mixed_label = np.where(box, other(t_label), t_label)
    mixed_conf = np.where(box, other(t_conf), t_conf)
    mixed_gt = np.where(box, other(gt), gt)

    correct = t_label == gt
    mixed_correct = mixed_label == mixed_gt
    identity_ok = bool(
        (mixed_correct == np.where(box, other(correct), correct)).all())

    band = _dilate4(box, band_px) & _dilate4(~box, band_px)
    regions = dict(inside=box & ~band, boundary=band,
                   outside=(~box) & ~band)
    region_prec = {
        name: _precision_coverage(mixed_label, mixed_conf, mixed_gt, sel)
        for name, sel in regions.items()}

    img_m = np.where(box[..., None], other(imgs), imgs)
    logits = _logits(model, text, img_m, device)
    logp = logits - logits.max(1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(1, keepdims=True))
    ce = -np.take_along_axis(logp, mixed_label[:, None], axis=1)[:, 0]
    wrong = ~mixed_correct

    def share(sel):
        tot = float((ce * sel).sum())
        return float((ce * (sel & wrong)).sum() / tot) if tot > 0 else \
            float('nan')

    every = np.ones_like(wrong)
    loss_share = {}
    for t in THRESHOLDS:
        kept = mixed_conf >= t
        loss_share[t] = dict(
            all=share(every & kept), boundary=share(band & kept),
            kept_frac=float(kept.mean()))
    return dict(identity_ok=identity_ok, region_prec=region_prec,
                loss_share=loss_share)


def _mean_finite(vals):
    vals = [v for v in vals if np.isfinite(v)]
    return float(np.mean(vals)) if vals else float('nan')


def summarize(per_seed):
    """The per-threshold table over seeds, the invariants and the CutMix
    rows (JAX ``main``'s); prints them and returns the summary."""
    def agg(branch, t, idx):
        vals = [r[branch][t][idx] for r in per_seed]
        vals = [v for v in vals if np.isfinite(v)]
        return (float(np.mean(vals)), float(np.std(vals))) if vals else \
            (float('nan'), 0.0)

    chance = float(np.mean([r['chance'] for r in per_seed]))
    print(f'\n[pl-quality] ==== {len(per_seed)} seeds; majority-class '
          f'chance {chance:.3f} ====')
    print(f'{"thresh":>7} | {"teacher prec":>14} {"cov":>5} | '
          f'{"mcc prec":>14} {"cov":>5} | {"teach-unseen":>12} '
          f'{"mcc-unseen":>12}')
    summary = {'chance': chance, 'rows': []}
    for t in THRESHOLDS:
        tp, tps = agg('teacher', t, 0)
        tc = agg('teacher', t, 1)[0]
        mp, mps = agg('mcc', t, 0)
        mc = agg('mcc', t, 1)[0]
        tup = agg('teacher_unseen', t, 0)[0]
        mup, mups = agg('mcc_unseen', t, 0)
        print(f'{t:>7} | {tp:.3f}+-{tps:.3f} {tc:>9.2f} | '
              f'{mp:.3f}+-{mps:.3f} {mc:>9.2f} | {tup:>12.3f} '
              f'{mup:>9.3f}+-{mups:.3f}')
        summary['rows'].append(dict(
            thresh=t, teacher_prec=tp, teacher_cov=tc, mcc_prec=mp,
            mcc_cov=mc, teacher_unseen_prec=tup, mcc_unseen_prec=mup))

    tprecs = [r['teacher_prec'] for r in summary['rows']
              if np.isfinite(r['teacher_prec'])]
    monotonic = all(b >= a - 0.02 for a, b in zip(tprecs, tprecs[1:]))
    mcc_u = agg('mcc_unseen', 0.75, 0)[0]
    teach_u = agg('teacher_unseen', 0.75, 0)[0]
    # the null for unseen-class precision is an uninformed predictor: the
    # teacher's supervision never held these classes
    uninformed = max(teach_u if np.isfinite(teach_u) else 0.0, 0.05)
    beats_chance = bool(mcc_u > uninformed + 0.4)
    print(f'[pl-quality] teacher precision monotonic in threshold: '
          f'{monotonic}')
    print(f'[pl-quality] unseen-class precision @0.75: guidance {mcc_u:.3f} '
          f'vs teacher {teach_u:.3f} (uninformed null {uninformed:.3f}) '
          f'-> guidance margin {mcc_u - uninformed:+.3f} '
          f'({"OK" if beats_chance else "FAIL"})')
    summary['teacher_prec_monotonic'] = bool(monotonic)
    summary['mcc_unseen_beats_chance'] = beats_chance

    identity_ok = all(r['cutmix']['identity_ok'] for r in per_seed)
    print(f'\n[pl-quality] cutmix label-path alignment (mixed correctness '
          f'== cutmix of correctness, bit-exact): '
          f'{"OK" if identity_ok else "FAIL"}')
    print(f'{"thresh":>7} | {"prec inside":>11} {"boundary":>9} '
          f'{"outside":>8} | {"wrong-loss share all":>20} '
          f'{"boundary":>9} {"kept":>5}')
    cm_rows = []
    for t in THRESHOLDS:
        row = dict(thresh=t, **{
            f'prec_{region}': _mean_finite(
                [r['cutmix']['region_prec'][region][t][0]
                 for r in per_seed])
            for region in ('inside', 'boundary', 'outside')})
        for key, name in (('all', 'wrong_loss_share'),
                          ('boundary', 'wrong_loss_share_boundary'),
                          ('kept_frac', 'kept_frac')):
            row[name] = _mean_finite([r['cutmix']['loss_share'][t][key]
                                      for r in per_seed])
        cm_rows.append(row)
        print(f'{t:>7} | {row["prec_inside"]:>11.3f} '
              f'{row["prec_boundary"]:>9.3f} {row["prec_outside"]:>8.3f} | '
              f'{row["wrong_loss_share"]:>20.3f} '
              f'{row["wrong_loss_share_boundary"]:>9.3f} '
              f'{row["kept_frac"]:>5.2f}')
    share_unweighted = cm_rows[0]['wrong_loss_share']
    share_masked = [r['wrong_loss_share'] for r in cm_rows
                    if r['thresh'] >= 0.9 and
                    np.isfinite(r['wrong_loss_share'])]
    conf_masking_helps = bool(share_masked and
                              min(share_masked) < share_unweighted - 0.02)
    b_prec = [r['prec_boundary'] for r in cm_rows
              if np.isfinite(r['prec_boundary'])]
    g_prec = [np.nanmean([r['prec_inside'], r['prec_outside']])
              for r in cm_rows if np.isfinite(r['prec_boundary'])]
    boundary_holds = bool(b_prec) and all(
        bp > gp - 0.10 for bp, gp in zip(b_prec, g_prec))
    print(f'[pl-quality] pixelwise conf masking cuts wrong-label loss '
          f'share: {share_unweighted:.3f} -> '
          f'{min(share_masked) if share_masked else float("nan"):.3f} '
          f'({"OK" if conf_masking_helps else "FAIL"})')
    print(f'[pl-quality] boundary-band label precision holds vs interior: '
          f'{"OK" if boundary_holds else "FAIL"}')
    summary['cutmix'] = dict(rows=cm_rows, identity_ok=identity_ok,
                             conf_masking_helps=conf_masking_helps,
                             boundary_precision_holds=boundary_holds)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--out-root', default='pl_quality')
    parser.add_argument('--seeds', type=int, default=3)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--warmup-steps', type=int, default=120)
    parser.add_argument('--pretrain-steps', type=int, default=160,
                        help='guidance pretraining steps')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             'for the plain path)')
    args = parser.parse_args(argv)
    from semivl_tpu_torch.device import resolve_device
    device = resolve_device(args.device)

    os.makedirs(args.out_root, exist_ok=True)
    per_seed = [run_seed(args.out_root, s, args.warmup_steps, device,
                         args.pretrain_steps)
                for s in range(args.seed, args.seed + args.seeds)]
    summary = summarize(per_seed)
    with open(os.path.join(args.out_root, 'summary.json'), 'w') as f:
        json.dump(summary, f, indent=1)
    line = {
        'teacher_prec_monotonic': summary['teacher_prec_monotonic'],
        'mcc_unseen_beats_chance': summary['mcc_unseen_beats_chance'],
        'chance': summary['chance'],
        'cutmix_identity_ok': summary['cutmix']['identity_ok'],
        'cutmix_conf_masking_helps':
            summary['cutmix']['conf_masking_helps'],
        'cutmix_boundary_precision_holds':
            summary['cutmix']['boundary_precision_holds']}
    print(json.dumps(line))
    return summary


if __name__ == '__main__':
    main()
