"""The semi-supervision effect demo on synthetic colour-blob data
(counterpart of ``semivl_tpu/tools/semi_effect_demo.py``), through the
port's trainer.

Trains the tiny VLM on a colour segmentation task that is exactly
learnable from pixels (the class is the blob's colour) under three
methods at matched step budgets and over several seeds:

- ``supervised``: the K labeled images only;
- ``unimatch``: plus the unlabeled images through the weak-to-strong
  consistency step (teacher pseudo-labels, CutMix, the feature
  perturbation branch; reference semivl.py:198-325 with lambda_mcc 0);
- ``semivl``: plus the MaskCLIP-consistency branch, whose frozen guidance
  encoder is pretrained here on a separate pool of blob images against
  synthetic "text" embeddings (standing for CLIP's pretraining: informative,
  frozen, never updated by the trainer).

The labeled images show classes 1-2 only; classes 3-4 appear only
unlabeled, so the never-labeled classes' IoU (``unseen_class_iou``) can
only come through the guidance branch. Reports each method's mean and
spread over seeds. ``unseen_class_iou`` reads the class names of the run
config's dataset, where JAX's takes Pascal VOC's whatever the run.

    python -m semivl_tpu_torch.tools.semi_effect_demo --out-root out \\
        [--seeds 3] [--device cpu]
"""

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

CLASS_COLORS = np.array([
    [64, 64, 64],     # 0 background
    [220, 40, 40],    # 1 red
    [40, 200, 60],    # 2 green
    [50, 80, 230],    # 3 blue
    [235, 220, 50],   # 4 yellow
], np.uint8)


def _draw(rs, size, pool):
    """One blob image and its label map, from ``rs`` in JAX's order of
    draws."""
    h, w = size
    mask = np.zeros((h, w), np.uint8)
    img = np.tile(CLASS_COLORS[0], (h, w, 1)).astype(np.int16)
    for _ in range(rs.randint(2, 5)):
        c = pool[rs.randint(0, len(pool))]
        bh, bw = rs.randint(h // 6, h // 2), rs.randint(w // 6, w // 2)
        y, x = rs.randint(0, h - bh), rs.randint(0, w - bw)
        mask[y:y + bh, x:x + bw] = c
        img[y:y + bh, x:x + bw] = CLASS_COLORS[c]
    img = np.clip(img + rs.randint(-12, 13, img.shape), 0, 255)
    return img.astype(np.uint8), mask


def make_blob_dataset(root, n_labeled, n_unlabeled, n_val, size=(72, 88),
                      seed=0, labeled_classes=(1, 2)):
    """PNG images and label maps under ``root`` with a split list per
    kind ({kind: path}); the labeled images draw blobs from
    ``labeled_classes`` only, the others from every class."""
    from PIL import Image
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'imgs')
    mask_dir = os.path.join(root, 'masks')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    all_classes = tuple(range(1, len(CLASS_COLORS)))

    def write_sample(name, pool):
        img, mask = _draw(rs, size, pool)
        Image.fromarray(img).save(os.path.join(img_dir, name + '.png'))
        Image.fromarray(mask).save(os.path.join(mask_dir, name + '.png'))
        return f'imgs/{name}.png masks/{name}.png'

    splits_dir = os.path.join(root, 'splits')
    os.makedirs(splits_dir, exist_ok=True)
    paths = {}
    for kind, n in (('labeled', n_labeled), ('unlabeled', n_unlabeled),
                    ('val', n_val)):
        pool = labeled_classes if kind == 'labeled' else all_classes
        lines = [write_sample(f'{kind[0]}{i}', pool) for i in range(n)]
        p = os.path.join(splits_dir, f'{kind}.txt')
        with open(p, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        paths[kind] = p
    return paths


def nearest_labels(mask, hw):
    """(B, H, W) labels -> (B, h, w) by nearest neighbour at half-pixel
    centres (``jax.image.resize(..., 'nearest')``)."""
    rows = ((torch.arange(hw[0]) + 0.5) * mask.shape[1] / hw[0]).long()
    cols = ((torch.arange(hw[1]) + 0.5) * mask.shape[2] / hw[1]).long()
    return mask[:, rows.to(mask.device)][:, :, cols.to(mask.device)]


def guidance_loss(enc, text, img, mask):
    """The guidance pretraining loss: softmax cross-entropy of the dense
    embedding x text logits (x100) against the label map resized to the
    patch grid, over the 21 text rows."""
    emb = enc(img)['feats'][-1]                     # (B, h', w', 512)
    logits = torch.einsum('bhwc,nc->bhwn', emb.float(), text) * 100.0
    tgt = nearest_labels(mask, logits.shape[1:3])
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tgt[..., None].long()).mean()


def pretrain_guidance(out_root, size, n_pretrain=24, steps=160, seed=0,
                      device=None):
    """Stand in for CLIP's pretraining of the guidance branch: fit the tiny
    MaskCLIP encoder so that its dense embedding x synthetic text logits
    classify blob colours, on a separate pool the trainer never sees (Adam
    1e-3, 4 crops a step). Returns (text ``.npy`` path, encoder npz path;
    the npz holds the trainer's ``init_param_overrides``:
    ``clip_encoder.*`` state-dict names)."""
    from semivl_tpu_torch.configs.models import get_model_config
    from semivl_tpu_torch.data.transforms import normalize
    from semivl_tpu_torch.device import resolve_device
    from semivl_tpu_torch.models.builder import init_weights
    from semivl_tpu_torch.models.vlm import build_backbone
    device = resolve_device(device)
    rs = np.random.RandomState(seed + 777)
    text = rs.randn(21, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    all_classes = tuple(range(1, len(CLASS_COLORS)))
    imgs, masks = [], []
    for _ in range(n_pretrain):
        img, mask = _draw(rs, size, all_classes)
        imgs.append(normalize(img))
        masks.append(mask.astype(np.int64))
    imgs = torch.from_numpy(np.stack(imgs)).to(device)
    masks = torch.from_numpy(np.stack(masks)).to(device)

    enc_cfg = get_model_config('tiny-mcvit-test', img_size=64)['backbone']
    enc = build_backbone(enc_cfg, torch.float32)
    init_weights(enc, torch.Generator().manual_seed(seed))
    enc = enc.to(device)
    text_t = torch.from_numpy(text).to(device)
    opt = torch.optim.Adam(enc.parameters(), lr=1e-3)
    loss = torch.zeros(())
    for _ in range(steps):
        idx = torch.from_numpy(rs.randint(0, n_pretrain, 4)).to(device)
        opt.zero_grad(set_to_none=True)
        loss = guidance_loss(enc, text_t, imgs[idx][:, :64, :64],
                             masks[idx][:, :64, :64])
        loss.backward()
        opt.step()
        loss = loss.detach()
    print(f'[semi-effect] guidance pretrain final CE {loss.item():.3f}')
    # seed-qualified names: one path for every seed would hand each seed
    # the first seed's arrays through a path-keyed cache
    text_path = os.path.join(out_root, f'guidance_text_s{seed}.npy')
    np.save(text_path, text.astype(np.float16))
    enc_path = os.path.join(out_root, f'guidance_encoder_s{seed}.npz')
    np.savez(enc_path, **{f'clip_encoder.{n}': p.detach().cpu().numpy()
                          for n, p in enc.named_parameters()})
    return text_path, enc_path


def _base_cfg(root, paths, method, epochs, guidance=None, lr=3e-3,
              mcc_lambda=(0.1, 0.0), mcc_conf_thresh=0.75):
    """The demo's run config (JAX ``_base_cfg``): the tiny VLM at 64-px
    crops, batch 1, CE losses, confidence 0.95, the guidance branch with
    ``guidance`` (text path, encoder npz)."""
    from semivl_tpu_torch.configs.experiments import config_from_vars
    mcc = list(mcc_lambda) if guidance else 0
    cfg = config_from_vars(
        exp_id=95, model='mmseg.tiny-vlm-test', crop_size=64, batch_size=1,
        epochs=epochs, img_scale=None, method=method,
        criterion='CELoss', criterion_u='CELoss', conf_thresh=0.95,
        maskclip_consistency_lambda=mcc, lr=lr,
        eval_mode='zegclip_sliding_window')
    if guidance:
        text_path, enc_path = guidance
        cfg['clip_encoder'] = 'tiny-mcvit-test'
        cfg['mcc_fix_resize_pos'] = True   # the guidance at the crop size
        cfg['mcc_text'] = text_path
        cfg['mcc_conf_thresh'] = mcc_conf_thresh
        cfg['init_param_overrides'] = enc_path
    else:
        cfg['clip_encoder'] = None
    # nclass stays 21 (the tiny model's text); the blobs use classes 0-4,
    # which dilutes the absolute mIoU alike for every method
    cfg['data_root'] = root
    cfg['stride'] = 48
    cfg['labeled_id_path'] = paths['labeled']
    cfg['unlabeled_id_path'] = paths['unlabeled']
    cfg['val_id_path'] = paths['val']
    return cfg


def _eval_records(save_path):
    """The run's ``metrics.jsonl`` -> {epoch: {metric: value}} of its
    ``eval/`` scalars (one key a record)."""
    recs = {}
    with open(os.path.join(save_path, 'metrics.jsonl')) as f:
        for line in f:
            r = json.loads(line)
            for k, v in r.items():
                if k.startswith('eval/'):
                    recs.setdefault(int(r['step']), {})[k[5:]] = v
    return recs


def _run_dataset(save_path):
    import yaml
    with open(os.path.join(save_path, 'config.yaml')) as f:
        return yaml.load(f, Loader=yaml.Loader)['dataset']


def unseen_class_iou(save_path, unseen_classes, dataset=None):
    """Mean IoU over the never-labeled classes at the best-mIoU epoch, by
    the class names of ``dataset`` (None: the run's ``config.yaml``'s).
    Supervised training and plain pseudo-label consistency are near 0
    there by construction: what IoU there is came through the frozen
    guidance branch (reference semivl.py:234-240)."""
    from semivl_tpu_torch.datasets.classes import CLASSES
    names = CLASSES[dataset or _run_dataset(save_path)]
    recs = _eval_records(save_path)
    epochs = [e for e in recs if 'mIoU' in recs[e]]
    if not epochs:
        return float('nan')
    best_ep = max(epochs, key=lambda e: recs[e]['mIoU'])
    vals = [recs[best_ep].get(f'{names[c]}_IoU') for c in unseen_classes]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else float('nan')


def _summary(methods, all_results, unseen_results):
    """The per-method mean +- spread lines and the gains against
    ``supervised``; returns them as a dict too."""
    out = {}
    for m in methods:
        arr = np.asarray(all_results[m])
        u = np.asarray(unseen_results[m])
        out[m] = dict(miou_mean=float(arr.mean()), miou_std=float(arr.std()),
                      unseen_mean=float(u.mean()), unseen_std=float(u.std()))
        print(f'[semi-effect] {m}: mean {arr.mean():.2f} '
              f'+- {arr.std():.2f}  (per-seed: '
              + ' '.join(f'{v:.2f}' for v in arr) + ')')
        print(f'[semi-effect] {m} never-labeled-class IoU: mean '
              f'{u.mean():.2f} +- {u.std():.2f}  (per-seed: '
              + ' '.join(f'{v:.2f}' for v in u) + ')')
    if 'supervised' in out:
        for m in methods:
            if m == 'supervised':
                continue
            for key, res in (('gain', all_results),
                             ('unseen_gain', unseen_results)):
                g = np.asarray(res[m]) - np.asarray(res['supervised'])
                out[m][key] = float(g.mean())
                sig = 'significant' if g.mean() > g.std() else \
                    'within noise'
                what = ('' if key == 'gain'
                        else ' on never-labeled classes')
                print(f'[semi-effect] {m} vs supervised{what}: gain '
                      f'{g.mean():+.2f} +- {g.std():.2f} ({sig})')
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--out-root', default='semi_effect_demo')
    parser.add_argument('--n-labeled', type=int, default=2)
    parser.add_argument('--n-unlabeled', type=int, default=16)
    parser.add_argument('--n-val', type=int, default=8)
    parser.add_argument('--sup-epochs', type=int, default=240,
                        help='supervised epochs (1 iter/epoch at 2 labeled '
                             'bs2) chosen to match total steps')
    parser.add_argument('--semi-epochs', type=int, default=30)
    parser.add_argument('--eval-every', type=int, default=5)
    parser.add_argument('--seeds', type=int, default=3)
    parser.add_argument('--seed', type=int, default=0,
                        help='first seed (runs seed..seed+seeds-1)')
    parser.add_argument('--methods', default='supervised,unimatch,semivl')
    parser.add_argument('--lr', type=float, default=3e-3)
    parser.add_argument('--mcc', type=float, nargs=2, default=(0.1, 0.0),
                        help='maskclip_consistency_lambda schedule '
                             '(start end); equal values = constant '
                             'guidance pressure')
    parser.add_argument('--mcc-conf-thresh', type=float, default=0.75)
    parser.add_argument('--pretrain-steps', type=int, default=160,
                        help='guidance pretraining steps')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             'for the plain path)')
    args = parser.parse_args(argv)
    from semivl_tpu_torch.device import resolve_device
    from semivl_tpu_torch.train.loop import train
    device = resolve_device(args.device)

    out_root = os.path.abspath(args.out_root)
    os.makedirs(out_root, exist_ok=True)
    methods = args.methods.split(',')
    labeled_classes = (1, 2)
    unseen_classes = tuple(c for c in range(1, len(CLASS_COLORS))
                           if c not in labeled_classes)
    all_results = {m: [] for m in methods}
    unseen_results = {m: [] for m in methods}
    for seed in range(args.seed, args.seed + args.seeds):
        ds_root = os.path.join(out_root, f'data_s{seed}')
        paths = make_blob_dataset(ds_root, args.n_labeled,
                                  args.n_unlabeled, args.n_val, seed=seed)
        guidance = None
        if 'semivl' in methods:
            guidance = pretrain_guidance(out_root, (72, 88),
                                         steps=args.pretrain_steps,
                                         seed=seed, device=device)
        cwd = os.getcwd()
        os.chdir(out_root)   # the run dirs go under exp/ there
        try:
            for method in methods:
                epochs = (args.sup_epochs if method == 'supervised'
                          else args.semi_epochs)
                run_method = ('semivl' if method in ('semivl', 'unimatch')
                              else 'supervised')
                cfg = _base_cfg(ds_root, paths, run_method, epochs,
                                guidance if method == 'semivl' else None,
                                lr=args.lr, mcc_lambda=args.mcc,
                                mcc_conf_thresh=args.mcc_conf_thresh)
                cfg['eval_every_n_epochs'] = args.eval_every
                best, save_path = train(cfg, seed=seed, device=device)
                all_results[method].append(best)
                u = unseen_class_iou(save_path, unseen_classes)
                unseen_results[method].append(u)
                print(f'[semi-effect] seed={seed} {method}: '
                      f'best mIoU {best:.2f}, never-labeled-class IoU '
                      f'{u:.2f} ({save_path})', flush=True)
        finally:
            os.chdir(cwd)

    print(f'[semi-effect] ===== summary over {args.seeds} seeds =====')
    out = _summary(methods, all_results, unseen_results)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
