"""Time ``evaluation.evaluate`` on the card: this checkout's against
another's, in turns, each turn in a process of its own.

    python -m semivl_tpu_torch.tools.eval_bench OTHER_ROOT [--turns 2]

A turn imports the package of one checkout (its kernels built into its own
``_build/``) and evaluates, with seeded random weights scaled as
``chip_smoke.py`` scales them, the full-width flagship (exp 40:
``zegclip_sliding_window`` over 8 synthetic images at VOC val geometry,
short side 512) and the full-width exp-44 model (``sliding_window`` over 2
synthetic 1024x2048 images). For each it reads, after a warm-up run, the
wall time per image (the mean of 3 unprofiled runs) and the device's busy
time from one profiled run (``chip_smoke._profile``: kernels only, whole
windows), so the idle share is 1 - busy / wall. In this checkout's turns
``evaluate`` also runs serial (``eval_prefetch`` and
``eval_device_metrics`` off) beside its default. Turns alternate: other,
this, this, other, ... Prints one JSON line per turn and a summary line
(means over the turns). Card only; run it from the repository's root.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(evaluate, evaluator, ds, cfg, what):
    import time

    import torch

    import chip_smoke

    def run():
        evaluate(evaluator, ds, cfg['eval_mode'], cfg)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof = chip_smoke._profile(run, wall_ms, what, 4)
    return dict(wall_ms_per_image=wall_ms / len(ds),
                busy_ms_per_image=prof['busy_ms'] / len(ds),
                idle_share=prof['idle_share'],
                whole_window=prof['whole_window'])


def worker(root, out):
    """One turn in the checkout at ``root``; its rows into ``out``."""
    sys.path[:0] = [os.path.abspath(root), THIS_ROOT]
    import numpy as np
    import torch

    import chip_smoke
    from semivl_tpu_torch import configs
    from semivl_tpu_torch.evaluation.predict import Evaluator, evaluate
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.ops import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    this = os.path.abspath(root) == THIS_ROOT
    for name, cfg, ds in (
            ('VOC', configs.flagship_cfg(512), chip_smoke.SynthImages(
                seed=2, sizes=((512, 683), (683, 512), (512, 512),
                               (512, 768)) * 2)),
            ('Cityscapes', configs.cityscapes_cfg(), chip_smoke.SynthImages(
                seed=3, sizes=((1024, 2048),) * 2, nclass=19))):
        bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda',
                             seed=0)
        with torch.no_grad():   # as chip_smoke scales them
            for mod, s in ((bundle.model.backbone, 0.05),
                           (bundle.model.decode_head, 0.2)):
                for prm in mod.parameters():
                    if prm.ndim >= 2:
                        prm.mul_(s)
        evaluator = Evaluator(bundle.model, bundle.text_feats, cfg, 'cuda')
        rows[name] = _run(evaluate, evaluator, ds, cfg, f'{name} evaluate')
        if this:
            serial = dict(cfg, eval_prefetch=False, eval_device_metrics=False)
            rows[f'{name} serial'] = _run(evaluate, evaluator, ds, serial,
                                          f'{name} evaluate (serial)')
        del bundle, evaluator
        torch.cuda.empty_cache()
    rows['card'] = chip_smoke.card_line()
    with open(out, 'w') as f:
        json.dump(rows, f)
    assert np.isfinite(rows['VOC']['wall_ms_per_image'])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('other', nargs='?', help='another checkout\'s root')
    ap.add_argument('--turns', type=int, default=2)
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.out)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('eval_bench times the card: no CUDA device')
    builds = [('this', THIS_ROOT)]
    if args.other:
        builds.insert(0, ('other', os.path.abspath(args.other)))
    order = [builds[(t + t // 2) % len(builds)]
             for t in range(args.turns * len(builds))]
    results = {name: [] for name, _ in builds}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, root) in enumerate(order):
            out = os.path.join(tmp, f'{i}.json')
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--worker', root, '--out', out], check=True,
                           cwd=THIS_ROOT)
            with open(out) as f:
                rows = json.load(f)
            print(json.dumps({'turn': i, 'build': name, **rows}), flush=True)
            results[name].append(rows)
    summary = {}
    for name, turns in results.items():
        for case in (k for k in turns[0] if k != 'card'):
            summary[f'{name} {case}'] = {
                k: sum(t[case][k] for t in turns) / len(turns)
                for k in ('wall_ms_per_image', 'busy_ms_per_image',
                          'idle_share')}
    print(json.dumps({'summary': summary,
                      'card': results['this'][0]['card']}), flush=True)


if __name__ == '__main__':
    main()
