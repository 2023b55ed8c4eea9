"""A dry run of data-parallel training on N ranks (the port's counterpart
of ``__graft_entry__.py::dryrun_multichip``, :102):

    python -m semivl_tpu_torch.tools.dryrun_multichip [--ranks 2] \\
        [--device cpu]

It starts N processes as torchrun starts them (NCCL, one card each, or
with ``--device cpu`` gloo ranks on the CPU). Each rank builds the
full-width flagship training bundle (exp 40 at crop 64, seed 0), takes one
SemiVL step on its row of a seeded global batch (one sample a rank),
checks that every rank holds the same trainable parameters after it,
evaluates its stride of N + 1 images (``evaluate_histograms``, the
histograms summed over the ranks) and makes a checkpoint round trip
(rank 0 writes, every rank restores). A rank that fails, or outlives the
timeout, fails the run and every rank is killed; else one line ``ok``,
with the wall time of the step's gradient mean alone (rank 0, mean of 5,
after a barrier).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

CROP = 64
TIMEOUT_S = 600


def _batch(n, crop, seed=0):
    """A seeded global batch of ``n`` samples (exp 40's step inputs)."""
    rs = np.random.RandomState(seed)

    def imgs():
        return rs.randn(n, crop, crop, 3).astype(np.float32)

    boxes = np.tile(np.array([[8, 8, 16, 32]], np.int32), (n, 1))
    ign = np.zeros((n, crop, crop), np.int32)
    return dict(img_x=imgs(),
                mask_x=rs.randint(0, 21, (n, crop, crop)).astype(np.int32),
                img_w=imgs(), img_s1=imgs(), img_s2=imgs(), ignore_mask=ign,
                cutmix_box1=boxes, cutmix_box2=boxes, img_w_other=imgs(),
                img_s1_other=imgs(), img_s2_other=imgs(),
                ignore_mask_other=ign)


class _Images:
    """Seeded uint8 images of 72 x 88 with label maps."""

    def __init__(self, n, seed=1):
        rs = np.random.RandomState(seed)
        self.items = [((rs.rand(72, 88, 3) * 255).astype(np.uint8),
                       rs.randint(0, 21, (72, 88))) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def get(self, i):
        return {'img': self.items[i][0], 'mask': self.items[i][1]}


def run_rank(device, out_dir):
    """One rank's dry run; writes its readings to ``out_dir``."""
    from semivl_tpu_torch.configs import flagship_train_cfg
    from semivl_tpu_torch.evaluation.predict import (Evaluator,
                                                     evaluate_histograms)
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.parallel import dist
    from semivl_tpu_torch.train.checkpoint import CheckpointManager
    from semivl_tpu_torch.train.loop import model_dtype, step_generator
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = dict(flagship_train_cfg(CROP), batch_size=1)
    rank, world, device = dist.setup_distributed(cfg, device)
    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device,
                         seed=0)
    model = bundle.model
    opt, _ = build_optimizer(cfg, model, 100)
    step = make_semivl_train_step(bundle, cfg, opt, 100, device)
    batch = {k: torch.from_numpy(v[rank:rank + 1]).to(device)
             for k, v in _batch(world, CROP).items()}
    metrics = step(batch, step_generator(0, 0, device, rank))
    loss = float(metrics['loss_all'])
    if not (np.isfinite(loss) and step.iteration == 1):
        raise RuntimeError(f'rank {rank}: step gave {metrics}')
    # every rank's trainable parameters equal: each one's sums equal their
    # mean over the ranks
    sums = torch.stack([p.detach().double().sum()
                        for p in model.parameters() if p.requires_grad])
    mean = sums.clone()
    dist.mean_over_ranks_([mean])
    if not torch.equal(sums, mean):
        raise RuntimeError(f'rank {rank}: parameters differ across ranks')
    # the step's gradient mean alone, on this step's gradients
    grads = [p.grad for g in opt.param_groups for p in g['params']
             if p.grad is not None]
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.mean_over_ranks_([g.clone() for g in grads])
    if device.type == 'cuda':
        torch.cuda.synchronize()
    grad_mean_ms = (time.perf_counter() - t0) * 1e3 / 5
    grad_mib = sum(g.numel() * g.element_size() for g in grads) / 2**20

    images = _Images(world + 1)
    seen = []
    inter, union = evaluate_histograms(
        Evaluator(model, bundle.text_feats, cfg, device), images,
        cfg['eval_mode'], cfg, progress=seen.append, process_index=rank,
        process_count=world)
    if seen != list(range(rank, len(images), world)) or union.sum() <= 0 \
            or (inter > union).any():
        raise RuntimeError(f'rank {rank}: evaluation saw {seen}, '
                           f'union {union}')

    root = dist.broadcast_run_name(tempfile.mkdtemp() if rank == 0 else '')
    try:
        ckpt = CheckpointManager(root)
        before = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
        if rank == 0:
            ckpt.save('latest', model, opt, step.iteration,
                      {'epoch': 0, 'epoch_step': 1, 'previous_best': 0.0})
        dist.barrier()
        iteration, extra = ckpt.restore('latest', model, opt)
        same = all(torch.equal(p, before[n])
                   for n, p in model.named_parameters() if n in before)
        if not (iteration == 1 and extra['epoch_step'] == 1 and same):
            raise RuntimeError(f'rank {rank}: checkpoint round trip gave '
                               f'iteration {iteration}, {extra}')
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    dist.shutdown()
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(dict(rank=rank, world=world, loss=loss, images=seen,
                       grad_mean_ms=grad_mean_ms, grad_mib=grad_mib,
                       device=str(device)), f)


def dryrun(n_ranks, device=None):
    """Launch ``n_ranks`` ranks of ``run_rank``; returns rank 0's
    readings."""
    from semivl_tpu_torch.parallel import dist
    work = tempfile.mkdtemp(prefix='dryrun_multichip_')
    try:
        cmd = [sys.executable, '-m', __spec__.name, '--rank-out', work]
        if device:
            cmd += ['--device', device]
        rcs = dist.launch_ranks(cmd, n_ranks, TIMEOUT_S)
        if any(rcs):
            raise RuntimeError(f'dryrun_multichip({n_ranks}): ranks exited '
                               f'{rcs}')
        with open(os.path.join(work, 'rank0.json')) as f:
            return json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--ranks', type=int, default=2)
    parser.add_argument('--device', default=None,
                        help="'cpu' for gloo ranks on the CPU (default: one "
                             'card a rank, NCCL)')
    parser.add_argument('--rank-out', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_out:
        run_rank(args.device, args.rank_out)
        return
    r = dryrun(args.ranks, args.device)
    print(f'dryrun_multichip({args.ranks}): ok, loss={r["loss"]:.4f}, '
          f'eval+ckpt ok; gradient mean of {r["grad_mib"]:.1f} MiB on '
          f'{r["device"]}: {r["grad_mean_ms"]:.2f} ms')


if __name__ == '__main__':
    main()
