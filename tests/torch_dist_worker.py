"""One rank of the port's data-parallel tests (tests/test_torch_dist.py,
and one card test in tests/test_torch_kernels.py), launched as torchrun
launches a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; ``launch`` here starts them), gloo on the CPU:

    python tests/torch_dist_worker.py step|eval|loop|card_step <spec.pt> \
        <out dir>

``step``: one SemiVL step of the pickled port model on this rank's rows of
the global batch, the feature-perturbation masks injected (this rank's
rows); writes the metrics, the averaged gradients, the state after and
the (mean, variance) each train-mode BatchNorm call took over the ranks.
``eval``: ``evaluate_histograms`` over this rank's stride of an in-memory
set; writes the summed histograms. ``loop``: ``train.loop.train`` on the
spec's config (rank 0 may take its own); writes the step's final state and
what this rank wrote into the run dir. ``probe``: the gradient of
``c_r * mean_over_ranks(x_r)``. ``card_step``: one step of the
tiny VLM on card 0, gloo between the ranks; writes the trainable
parameters and the kernels' launches.

Imports no JAX: the spec is made by the test process."""

import os
import sys
from unittest import mock

import torch

from semivl_tpu_torch.parallel import dist


def _rows(batch, rank, world):
    b = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _fake_dropout(keeps, rank):
    """The i-th call of a pass drops the channels of this rank's rows of
    the i-th keep mask (B, 1, 1, C)."""
    calls = [0]

    def dropout2d(x, rate, generator=None):
        keep = keeps[calls[0] % len(keeps)]
        calls[0] += 1
        b = x.shape[0]
        keep = torch.from_numpy(keep[rank * b:(rank + 1) * b])
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype))
    return dropout2d, calls


def run_step(spec, rank, world):
    from semivl_tpu_torch.models.builder import ModelBundle
    from semivl_tpu_torch.train import optim
    from semivl_tpu_torch.train.step import make_semivl_train_step
    model = spec['model']
    bundle = ModelBundle(model=model, text_feats=spec['text'],
                         mcc_text_feats=spec['mcc'])
    opt, _ = optim.build_optimizer(spec['cfg'], model, spec['total'])
    step = make_semivl_train_step(bundle, spec['cfg'], opt, spec['total'],
                                  device='cpu')
    fake, calls = _fake_dropout(spec['keeps'], rank)
    stats, mean_over_ranks = [], dist.mean_over_ranks

    def recording(x):   # BatchNorm's cross-rank E[x], E[x^2]
        y = mean_over_ranks(x)
        m, m2 = y.detach().chunk(2)
        stats.append((m.numpy().copy(), (m2 - m * m).clamp(min=0).numpy()))
        return y

    with mock.patch('semivl_tpu_torch.models.vlm.dropout2d', fake), \
            mock.patch.object(dist, 'mean_over_ranks', recording):
        metrics = step(_rows(spec['batch'], rank, world))
    assert calls[0] == len(spec['keeps']) and step.iteration == 1
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                bn_batch_stats=stats,
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                state={k: v.clone() for k, v in model.state_dict().items()})


class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def get(self, i):
        img, mask = self.items[i]
        return {'img': img, 'mask': mask}


def run_eval(spec, rank, world):
    from semivl_tpu_torch.evaluation.predict import (Evaluator,
                                                     evaluate_histograms)
    seen = []
    ev = Evaluator(spec['model'], spec['text'], spec['cfg'], device='cpu')
    inter, union = evaluate_histograms(
        ev, _ListDataset(spec['items']), spec['cfg']['eval_mode'],
        spec['cfg'], progress=seen.append, process_index=rank,
        process_count=world)
    return dict(inter=inter, union=union, images=seen)


def run_loop(spec, rank, world):
    """The loop on this rank's config; counts what this rank writes."""
    import functools

    from semivl_tpu_torch.train import loop
    from semivl_tpu_torch.utils import code_archive
    steps, worlds = [], []
    writes = dict(metric_writer=0, ckpt_save=0, code_archive=0, debug_grid=0)

    def count(key, fn):
        def wrapped(*a, **k):
            writes[key] += 1
            return fn(*a, **k)
        return wrapped

    def make_step(*a, **k):
        steps.append(make(*a, **k))
        worlds.append(dist.world_size())   # the group the step runs in
        return steps[-1]

    make = loop.make_semivl_train_step
    cfg = spec['cfgs'][rank] if 'cfgs' in spec else spec['cfg']
    with mock.patch.object(loop, 'make_semivl_train_step', make_step), \
            mock.patch.object(loop, 'MetricWriter', count(
                'metric_writer', functools.partial(loop.MetricWriter,
                                                   use_tensorboard=False))), \
            mock.patch.object(loop.CheckpointManager, 'save', count(
                'ckpt_save', loop.CheckpointManager.save)), \
            mock.patch.object(code_archive, 'gen_code_archive', count(
                'code_archive', code_archive.gen_code_archive)), \
            mock.patch.object(loop, 'save_debug_grid_for_batch', count(
                'debug_grid', loop.save_debug_grid_for_batch)):
        best, path = loop.train(cfg, seed=0, device='cpu',
                                resume_from=spec.get('resume_from'),
                                max_iters_override=spec.get('max_iters'))
    step = steps[0]
    return dict(best=best, path=path, iteration=step.iteration,
                writes=writes, world=worlds[0],
                state={k: v.clone() for k, v in
                       step.model.state_dict().items()},
                optimizer=step.optimizer.state_dict())


def run_probe(spec, rank, world):
    """The gradient of this rank's loss c_r * mean_over_ranks(x)."""
    x = torch.tensor(spec['x'][rank], requires_grad=True)
    (dist.mean_over_ranks(x) * torch.tensor(spec['c'][rank])).sum().backward()
    return dict(grad=x.grad)


def run_card_step(spec, rank, world):
    """One SemiVL step of the tiny VLM (every attention on the head-split
    kernels) on this rank's row of a seeded batch, on card 0."""
    from semivl_tpu_torch.configs import tiny_train_cfg
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.tools.dryrun_multichip import _batch
    from semivl_tpu_torch.train.loop import step_generator
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    cfg = dict(tiny_train_cfg(64), batch_size=1)
    device = torch.device('cuda:0')
    bundle = build_model(cfg, dtype=torch.bfloat16, device=device, seed=0)
    opt, _ = build_optimizer(cfg, bundle.model, 10)
    step = make_semivl_train_step(bundle, cfg, opt, 10, device)
    batch = {k: torch.from_numpy(v[rank:rank + 1]).to(device)
             for k, v in _batch(world, 64).items()}
    metrics = step(batch, step_generator(0, 0, device, rank))
    return dict(loss=float(metrics['loss_all']),
                launches=(fa.heads_launches, fa.heads_bwd_launches),
                params={n: p.detach().cpu() for n, p in
                        bundle.model.named_parameters() if p.requires_grad})


RANK_TIMEOUT = 240   # seconds a launch of ranks may take


def launch(task, spec, out, world=2, cwd=None, torchrun=True, attempts=3,
           retry_if=None):
    """Run ``world`` ranks of ``task`` on ``spec`` (pickled into ``out``)
    as torchrun would (``dist.launch_ranks``) and return each rank's
    result (``torchrun=False``: the rank drops torchrun's environment and
    runs without a group). A rank that fails or outlives ``RANK_TIMEOUT``
    fails the launch, and every rank is killed; a failure whose output
    ``retry_if`` accepts is retried on a fresh port."""
    os.makedirs(out, exist_ok=True)
    spec_path = os.path.join(out, 'spec.pt')
    torch.save(dict(spec, no_group=not torchrun), spec_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in dist.ENV_KEYS}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS='2')
    log_path = os.path.join(out, 'ranks.log')
    for _ in range(attempts):
        with open(log_path, 'w') as log:
            rcs = dist.launch_ranks(
                [sys.executable, os.path.abspath(__file__), task, spec_path,
                 out], world, RANK_TIMEOUT, env, cwd or out, log)
        if rcs == [0] * world:
            return [torch.load(os.path.join(out, f'rank{r}.pt'),
                               weights_only=False) for r in range(world)]
        with open(log_path) as f:
            text = f.read()
        if retry_if is None or not retry_if(text):
            break
    raise AssertionError(f'ranks failed, rcs {rcs}:\n{text[-4000:]}')


def main(task, spec_path, out_dir):
    torch.manual_seed(0)
    rank = int(os.environ.get('RANK', 0))
    world = int(os.environ.get('WORLD_SIZE', 1))
    spec = torch.load(spec_path, weights_only=False)
    if spec['no_group']:   # one process as if torchrun had not started it
        for k in dist.ENV_KEYS:
            os.environ.pop(k, None)
        rank, world = 0, 1
    if task == 'card_step':   # two ranks on one card: gloo
        dist.setup_distributed(device='cuda:0', backend='gloo')
    elif task != 'loop':   # the loop joins the group itself
        dist.setup_distributed(device='cpu')
    result = dict(step=run_step, eval=run_eval, loop=run_loop,
                  probe=run_probe, card_step=run_card_step)[task](
                      spec, rank, world)
    if dist.active():
        dist.shutdown()
    torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))


if __name__ == '__main__':
    main(*sys.argv[1:])
