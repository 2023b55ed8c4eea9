"""Training orchestration (the counterpart of
``semivl_tpu/train/loop.py::train``), on one card or data-parallel over
the ranks of a process group.

Equivalent of the reference trainer entry points (semivl.py:61-433): read
the labeled and unlabeled splits through ``data.SemiDataset`` and
``data.ShardedLoader``, run the step of the config's ``method``
(``train.step``: 'semivl' and 'unimatch' on labeled and unlabeled
batches, an epoch of ``len(loader_u)`` steps of ``2 x bs`` images; the
'supervised' baseline on the labeled batches alone, ``len(loader_l)``
steps of ``bs`` images; JAX loop.py:296-317, :420-425, :499) on the card,
evaluate every ``eval_every_n_epochs`` epochs through ``evaluation.evaluate``
and keep ``best`` and ``latest`` checkpoints with exact mid-epoch resume
(``train.checkpoint``). One process drives one card; the run directory, its
``all_args.yaml``, ``config.yaml``, ``debug.log``, ``metrics.jsonl`` and the
windowed metrics follow the JAX loop.

Launched by torchrun (``parallel.dist.setup_distributed``), every rank runs
this loop as JAX's processes run theirs (loop.py:240-632): rank 0's run
name; the run dir's files, the metric stream, the debug grid and the
checkpoints written by rank 0 alone, every rank waiting at a barrier after
each save; each rank's own rows of every global batch
(``ShardedLoader(..., world, process_index=rank, process_count=world)``);
the step's reductions (``train.step``); each rank evaluating its stride of
the val set, the histograms summed over the ranks. A preemption (a signal,
or ``preempt_at_step`` on the rank that sets it) is agreed on: each step
sums the ranks' flags, read every ``preempt_check_every`` steps (10), so
every rank stops after the same step; with one rank the flag acts at once.

The step's randomness is a pure function of the global step: each step's
generator (the on-device augmentation's draws, then the feature
perturbation's) is seeded from (seed + 1234, iteration,
rank) (``step_generator``), as the JAX step folds its base key
``PRNGKey(seed + 1234)`` with ``state.step`` and ``axis_index('data')``
(loop.py:357-363, step.py:231, :453); rank 0's stream is the one-process
run's. The loaders' permutation depends only on (seed, epoch) and a resumed
epoch skips the batches already taken (``start_step``), so a run preempted
and resumed ends where an uninterrupted one does.
"""

import math
import os
import pprint
import signal
import time
import uuid
from collections import deque
from datetime import datetime

import numpy as np
import torch
import yaml

from semivl_tpu_torch.data.dataset import SemiDataset, split_path
from semivl_tpu_torch.data.loader import ShardedLoader
from semivl_tpu_torch.datasets.classes import CLASSES
from semivl_tpu_torch.datasets.palettes import get_palette
from semivl_tpu_torch.evaluation.predict import Evaluator, evaluate
from semivl_tpu_torch.models.builder import build_model
from semivl_tpu_torch.parallel import dist
from semivl_tpu_torch.train.checkpoint import CheckpointManager
from semivl_tpu_torch.train.optim import build_optimizer
from semivl_tpu_torch.train.step import (
    make_semivl_train_step,
    make_supervised_train_step,
)
from semivl_tpu_torch.utils.logging_utils import (
    DictAverageMeter,
    MetricWriter,
    add_file_handler,
    init_log,
)
from semivl_tpu_torch.version import __version__

METRIC_WINDOW = 100   # steps between metric fetches (JAX loop.py:488)


PORTED_DATASETS = ('pascal', 'cityscapes', 'coco', 'ade')   # lists, text
SEMI_METHODS = ('semivl', 'unimatch')
METHODS = SEMI_METHODS + ('supervised',)


def _refuse_unported(cfg):
    """What the port's loop does not run, refused by name: a dataset
    without split lists and text embeddings here, a method that is none of
    JAX's three and the parameter EMA (the steps refuse it too)."""
    if cfg['dataset'] not in PORTED_DATASETS:
        raise NotImplementedError(f'dataset {cfg["dataset"]!r} is not ported '
                                  f'to the PyTorch trainer ({PORTED_DATASETS})')
    method = cfg.get('method', 'semivl')
    if method not in METHODS:
        raise ValueError(f'method {method!r} ({METHODS})')
    if cfg.get('ema_decay'):
        raise NotImplementedError('ema_decay is not ported to the PyTorch '
                                  'trainer')


def _make_run_name(cfg):
    timestr = datetime.now().strftime('%y%m%d-%H%M')
    uid = str(uuid.uuid4())[:5]
    return f'{timestr}_{cfg["name"]}_v{__version__}_{uid}'.replace('.', '-')


def setup_run_dir(cfg, args_dict, logger, device, run_name=None,
                  is_main=True, world=1):
    """``exp/exp-<exp>/<run name>/`` with ``debug.log``, ``all_args.yaml``,
    ``config.yaml`` and the code archive, as the JAX loop writes them
    (every rank logs to ``debug.log``, only the main one writes the rest);
    returns (run name, path)."""
    if run_name is None:
        run_name = _make_run_name(cfg)
    save_path = os.path.join('exp', f'exp-{cfg["exp"]}', run_name)
    os.makedirs(save_path, exist_ok=True)
    add_file_handler(logger, os.path.join(save_path, 'debug.log'))
    if not is_main:
        return run_name, save_path
    all_args = {**cfg, **args_dict, 'run_name': run_name,
                'save_path': save_path, 'exec_version': __version__,
                'n_devices': world, 'device': str(device)}
    logger.info('%s\n', pprint.pformat(all_args))
    with open(os.path.join(save_path, 'all_args.yaml'), 'w') as f:
        yaml.dump(all_args, f, default_flow_style=None, sort_keys=False,
                  indent=2)
    with open(os.path.join(save_path, 'config.yaml'), 'w') as f:
        yaml.dump(cfg, f, default_flow_style=None, sort_keys=False, indent=2)
    try:
        from semivl_tpu_torch.utils.code_archive import gen_code_archive
        gen_code_archive(save_path)
    except Exception as exc:  # archiving must never kill a run
        logger.warning('code archive failed: %s', exc)
    return run_name, save_path


def model_dtype(cfg, device):
    """The computation dtype: ``cfg['dtype']``, else bf16 on the card (the
    kernels' storage, as the JAX package's TPU kernels store bf16) and
    float32 on the CPU (the plain path)."""
    default = 'bfloat16' if device.type == 'cuda' else 'float32'
    return getattr(torch, cfg.get('dtype', default))


def init_state(bundle, cfg, total_iters, pretrained=None):
    """Pretrained CLIP weights and parameter overrides into the bundle's
    model, then the optimizer: (optimizer, schedule)."""
    if pretrained:
        from semivl_tpu_torch.convert import load_pretrained_into
        load_pretrained_into(bundle.model, pretrained)
    if cfg.get('init_param_overrides'):
        # an npz of parameters merged after init (JAX's keys are flax
        # paths, '/'-joined; the port's are its state-dict names)
        from semivl_tpu_torch.convert import copy_into
        with np.load(cfg['init_param_overrides']) as f:
            copy_into(bundle.model, {k: f[k] for k in f.files},
                      'init_param_overrides')
    return build_optimizer(cfg, bundle.model, total_iters)


def step_generator(seed, iteration, device, rank=0):
    """The feature-perturbation generator of global step ``iteration`` on
    ``rank``: a pure function of (seed + 1234, iteration, rank), rank 0's
    that of the one-process run."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed + 1234) * 1_000_003 + int(iteration)
                   + (int(rank) << 40)) % (1 << 63))
    return g


def step_batch(bl, bu):
    """The step's batch from a labeled and an unlabeled (paired) host batch,
    as JAX's ``to_device`` maps them (loop.py:406-418) without its
    ``preempt`` entry (the step takes the flag as an argument): ``img_x``
    and ``mask_x`` from the labeled batch, every unlabeled array but the
    other view's CutMix boxes."""
    return {'img_x': bl.get('img', bl.get('img_u8')), 'mask_x': bl['mask'],
            **{k: v for k, v in bu.items()
               if not (k.startswith('cutmix_box') and k.endswith('_other'))}}


def _on_stream(tensors, event):
    """Make the current stream wait for a side-stream upload."""
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    for t in tensors.values():
        t.record_stream(stream)
    return tensors


def device_prefetch(batch_iter, device, to_batch):
    """Yield (host batch, device batch) with the next batch's upload in
    flight while the current one is used (the counterpart of JAX
    ``parallel/mesh.py::device_prefetch``): on the card from pinned memory
    on a side stream, one batch ahead; ``to_batch`` maps a host batch to
    its dict of arrays."""
    stream = torch.cuda.Stream(device) if device.type == 'cuda' else None

    def upload(host):
        arrays = {k: torch.from_numpy(np.require(v, requirements=('C', 'W')))
                  for k, v in to_batch(host).items()}
        if stream is None:
            return {k: v.to(device) for k, v in arrays.items()}, None
        with torch.cuda.stream(stream):
            dev = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return dev, event

    pending = deque()
    for host in batch_iter:
        pending.append((host, upload(host)))
        if len(pending) > 1:
            h, (dev, event) = pending.popleft()
            yield h, dev if event is None else _on_stream(dev, event)
    while pending:
        h, (dev, event) = pending.popleft()
        yield h, dev if event is None else _on_stream(dev, event)


@torch.no_grad()
def save_debug_grid_for_batch(cfg, bundle, bl, bu, save_path, iters,
                              device):
    """Reference-style debug panel grid (semivl.py:371-406) for sample 0:
    images, predictions, the weak view's pseudo-label and, with the
    guidance encoder, its MaskCLIP labels (JAX ``_save_debug_grid_for_batch``;
    the forwards run here, one image each, the argmax on the device)."""
    from semivl_tpu_torch.utils.plotting import save_debug_grid
    palette = get_palette(cfg['dataset'])
    model = bundle.model
    text = torch.as_tensor(bundle.text_feats).to(device)

    def fwd(img_np):
        x = torch.from_numpy(np.ascontiguousarray(img_np)).to(device)
        return model(x, text).argmax(dim=1).to(torch.uint8).cpu().numpy()

    img_x = np.asarray(bl['img'][:1])
    panels = [('Image L', img_x[0], 'image', None)]
    preds_row = [('Pred L', fwd(img_x)[0], 'label', palette)]
    gt_row = [('GT L', np.asarray(bl['mask'][0]), 'label', palette)]
    img_w = np.asarray(bu['img_w'][:1])
    img_s1 = np.asarray(bu['img_s1'][:1])
    img_s2 = np.asarray(bu['img_s2'][:1])
    pred_w = fwd(img_w)
    panels += [('Image S1', img_s1[0], 'image', None),
               ('Image S2', img_s2[0], 'image', None),
               ('Image W', img_w[0], 'image', None)]
    preds_row += [('Pred S1', fwd(img_s1)[0], 'label', palette),
                  ('Pred S2', fwd(img_s2)[0], 'label', palette),
                  ('Pred W', pred_w[0], 'label', palette)]
    gt_row += [('PL W', pred_w[0], 'label', palette), None, None]
    rows, cols = 3, 4

    def padded(row):
        return row + [None] * (cols - len(row))

    grid = padded(panels) + padded(preds_row) + padded(gt_row)
    if bundle.mcc_text_feats is not None:
        mcc = torch.as_tensor(bundle.mcc_text_feats).to(device)
        mclip = model.forward_maskclip(
            torch.from_numpy(img_w).to(device), mcc,
            float(cfg.get('mcc_conf_thresh', 0.75))).cpu().numpy()
        grid += padded([('MC W', mclip[0], 'label', palette)])
        rows += 1
    save_debug_grid(os.path.join(save_path, 'debug', f'{iters:07d}.png'),
                    grid, rows=rows, cols=cols)


def _log_window(keys, pending, iter_times, window_t0, imgs_per_iter,
                log_avg, writer, logger, i, iters):
    """The windowed metric fetch (JAX loop.py:488-530): one transfer of
    the window's stacked metrics (``keys``), their means, the iteration
    time and the throughput (``imgs_per_iter`` images a step) over the
    window's wall time."""
    fetch_t0 = time.time()
    mat = torch.stack(pending).cpu().numpy()
    fetch_s = time.time() - fetch_t0
    stacked = {f'train/{k}': float(v) for k, v in zip(keys,
                                                      mat.mean(axis=0))}
    stacked['train/metric_fetch_time'] = fetch_s
    stacked['train/iter_time'] = float(np.mean(iter_times))
    # images per step, over the window's wall time (after the fetch, which
    # waits for the window's last step)
    stacked['train/imgs_per_sec_per_chip'] = (
        imgs_per_iter * len(iter_times) / max(time.time() - window_t0, 1e-9))
    log_avg.update(stacked)
    logger.info('Iters: %d %s', i, str(log_avg))
    if writer is not None:
        for k, v in log_avg.avgs.items():
            writer.add_scalar(k, v, iters)
    log_avg.reset()
    return stacked


def train(cfg, args_dict=None, max_iters_override=None, pretrained=None,
          seed=0, resume_from=None, device=None):
    """Run a training job on one card (``device='cpu'`` for the plain path;
    without a card and without it, raises) or, under torchrun's
    environment, as one rank of a process group (NCCL on the card, gloo
    on the CPU; a group that exists already is joined as it is:
    ``parallel.dist.setup_distributed``).
    Returns (best mIoU, run dir).

    ``resume_from``: an existing run dir, whose ``latest`` checkpoint is
    restored (a save made mid-epoch resumes at the same batch)."""
    _refuse_unported(cfg)
    semi = cfg.get('method', 'semivl') in SEMI_METHODS
    rank, world, device = dist.setup_distributed(cfg, device)
    is_main = rank == 0
    grouped = dist.active()
    logger = init_log('global')
    if resume_from:
        save_path = resume_from
        run_name = os.path.basename(os.path.normpath(resume_from))
        os.makedirs(save_path, exist_ok=True)
        add_file_handler(logger, os.path.join(save_path, 'debug.log'))
        logger.info('Resuming run dir %s', save_path)
    else:
        run_name = _make_run_name(cfg)
        if grouped:
            run_name = dist.broadcast_run_name(run_name)
        run_name, save_path = setup_run_dir(cfg, args_dict or {}, logger,
                                            device, run_name, is_main, world)
    writer = MetricWriter(save_path) if is_main else None
    logger.info('Device: %s, rank %d of %d', device, rank, world)
    if grouped:
        dist.barrier()   # every rank at one point before the build (:268)

    bundle = build_model(cfg, dtype=model_dtype(cfg, device), device=device,
                         seed=seed)
    labeled_id_path = cfg.get('labeled_id_path') or split_path(
        cfg['dataset'], cfg['split'], 'labeled')
    unlabeled_id_path = cfg.get('unlabeled_id_path') or split_path(
        cfg['dataset'], cfg['split'], 'unlabeled')
    trainset_u = SemiDataset(cfg, 'train_u', id_path=unlabeled_id_path,
                             seed=seed)
    trainset_l = SemiDataset(cfg, 'train_l', id_path=labeled_id_path,
                             nsample=len(trainset_u.ids), seed=seed + 1)
    valset = SemiDataset(cfg, 'val', id_path=cfg.get('val_id_path'))
    bs = cfg['batch_size']
    loader_l = ShardedLoader(trainset_l, bs, world, seed=seed,
                             process_index=rank, process_count=world)
    loader_u = ShardedLoader(trainset_u, bs, world, seed=seed, pair=True,
                             process_index=rank, process_count=world)
    steps_per_epoch = len(loader_u) if semi else len(loader_l)
    if cfg.get('iters') is not None:
        assert cfg.get('epochs') is None
        cfg = dict(cfg, epochs=math.ceil(cfg['iters'] / steps_per_epoch))
    total_iters = steps_per_epoch * cfg['epochs']
    if max_iters_override:
        total_iters = min(total_iters, max_iters_override)
    logger.info('Train for %d epochs / %d iterations.', cfg['epochs'],
                total_iters)

    optimizer, sched = init_state(bundle, cfg, total_iters, pretrained)
    make_step = (make_semivl_train_step if semi
                 else make_supervised_train_step)
    step_fn = make_step(bundle, cfg, optimizer, total_iters, device)
    ckpt = CheckpointManager(save_path)
    previous_best, start_epoch, resume_skip = 0.0, 0, 0
    if ckpt.exists('latest'):
        step_fn.iteration, extra = ckpt.restore('latest', bundle.model,
                                                optimizer)
        saved_epoch = int(extra.get('epoch', -1))
        resume_skip = int(extra.get('epoch_step', 0))
        # a save made mid-epoch (preemption) resumes inside that epoch
        start_epoch = saved_epoch if resume_skip > 0 else saved_epoch + 1
        previous_best = float(extra.get('previous_best', 0.0))
        logger.info('Resumed at epoch %d, epoch step %d (best %.2f)',
                    start_epoch, resume_skip, previous_best)
    evaluator = Evaluator(bundle.model, bundle.text_feats, cfg, device)

    def save(names, extra):
        """Rank 0 writes the slots, every rank waits for it (:546-560)."""
        if is_main:
            for name in names:
                ckpt.save(name, bundle.model, optimizer, step_fn.iteration,
                          extra)
        if grouped:
            dist.barrier()

    # SIGTERM/SIGINT ask for a 'latest' checkpoint at the next step
    # boundary, then a clean exit; resume picks it up
    preempted = {'flag': False}

    def _on_signal(signum, frame):
        del signum, frame
        preempted['flag'] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread

    def restore_handlers():
        if writer is not None:
            writer.close()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)

    check_every = int(cfg.get('preempt_check_every', 10))
    log_avg = DictAverageMeter()
    metric_keys = None   # the metrics' order in the window's matrix
    profiler = None
    done = False
    for epoch in range(start_epoch, cfg['epochs']):
        if done:
            break
        logger.info('===========> Epoch: %d, LR: %.5f, Previous best: %.2f',
                    epoch, sched(step_fn.iteration), previous_best)
        skip = resume_skip if epoch == start_epoch else 0
        if semi:
            batches = device_prefetch(
                zip(loader_l.epoch(epoch, start_step=skip),
                    loader_u.epoch(epoch, start_step=skip)),
                device, lambda pair: step_batch(*pair))
        else:
            batches = device_prefetch(loader_l.epoch(epoch, start_step=skip),
                                      device, dict)
        epoch_start_step = step_fn.iteration
        pending, iter_times = [], []
        window_t0 = time.time()
        for i, (host, batch) in enumerate(batches):
            t0 = time.time()
            cur_step = epoch_start_step + i
            if cfg.get('profile_dir'):
                profiler = _profile_window(cfg, cur_step, profiler, device,
                                           rank if world > 1 else None)
            # fault injection: a preemption right after this global step,
            # raised before it so that its reduction carries the flag
            if cfg.get('preempt_at_step') is not None \
                    and cur_step == int(cfg['preempt_at_step']):
                preempted['flag'] = True
            metrics = step_fn(batch,
                              step_generator(seed, cur_step, device, rank),
                              preempt=preempted['flag'])
            iters = cur_step
            if metric_keys is None:
                metric_keys = sorted(k for k in metrics
                                     if k != 'preempt_count')
            pending.append(torch.stack(
                [metrics[k].float() for k in metric_keys]))
            iter_times.append(time.time() - t0)
            if i % METRIC_WINDOW == 0:
                _log_window(metric_keys, pending, iter_times, window_t0,
                            (2 if semi else 1) * bs, log_avg, writer, logger,
                            i, iters)
                window_t0 = time.time()
                pending.clear()
                iter_times.clear()
            if i == 0 and is_main and semi and cfg.get('debug_images', True):
                try:
                    save_debug_grid_for_batch(cfg, bundle, *host, save_path,
                                              iters, device)
                except Exception as exc:
                    logger.warning('debug images failed: %s', exc)
            # one rank acts on its own flag at once; ranks read the summed
            # flags at the same steps, so all stop after the same step
            if world == 1:
                stop = preempted['flag']
            else:
                stop = (cur_step % check_every == 0
                        and float(metrics['preempt_count']) > 0)
            if stop:
                save(['latest'], {'epoch': epoch, 'epoch_step': skip + i + 1,
                                  'previous_best': previous_best})
                logger.info('Preemption signal: saved latest checkpoint at '
                            'step %d (epoch %d, epoch step %d), exiting.',
                            cur_step + 1, epoch, skip + i + 1)
                restore_handlers()
                return previous_best, save_path
            if iters + 1 >= total_iters:
                done = True
                break

        if (epoch % cfg.get('eval_every_n_epochs', 1) == 0
                or epoch == cfg['epochs'] - 1 or done):
            eval_mode = cfg['eval_mode']
            eval_t0 = time.time()
            miou, iou_class = evaluate(evaluator, valset, eval_mode, cfg,
                                       process_index=rank,
                                       process_count=world)
            eval_dt = time.time() - eval_t0
            eval_fps = len(valset) / max(eval_dt, 1e-9)
            logger.info('***** Evaluation timing: %d images in %.1fs '
                        '(%.2f imgs/sec)', len(valset), eval_dt, eval_fps)
            logger.info(run_name)
            for cls_idx, iou in enumerate(iou_class):
                logger.info('***** Evaluation ***** >>>> Class [%d %s] '
                            'IoU: %.2f', cls_idx,
                            CLASSES[cfg['dataset']][cls_idx], iou)
            logger.info('***** Evaluation %s ***** >>>> MeanIoU: %.2f\n',
                        eval_mode, miou)
            if writer is not None:
                writer.add_scalar('eval/fps', eval_fps, epoch)
                writer.add_scalar('eval/mIoU', miou, epoch)
                for idx, iou in enumerate(iou_class):
                    writer.add_scalar(
                        f'eval/{CLASSES[cfg["dataset"]][idx]}_IoU', iou,
                        epoch)
            is_best = miou > previous_best
            previous_best = max(miou, previous_best)
            save(['latest', 'best'] if is_best else ['latest'],
                 {'epoch': epoch, 'previous_best': previous_best})
    if profiler is not None:
        profiler.stop()
    restore_handlers()
    return previous_best, save_path


def _profile_window(cfg, cur_step, profiler, device, rank=None):
    """The ``profile_dir`` window (JAX's ``jax.profiler`` trace): a
    ``torch.profiler`` trace from step ``profile_start_step`` (10) for
    ``profile_steps`` (5) steps, exported as a Chrome trace into
    ``profile_dir`` (one file per rank of a multi-rank run)."""
    start = cfg.get('profile_start_step', 10)
    if cur_step == start and profiler is None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    elif cur_step == start + cfg.get('profile_steps', 5) and \
            profiler is not None:
        profiler.stop()
        os.makedirs(cfg['profile_dir'], exist_ok=True)
        suffix = '' if rank is None else f'_rank{rank}'
        profiler.export_chrome_trace(os.path.join(
            cfg['profile_dir'], f'trace_{start}-{cur_step}{suffix}.json'))
        profiler = None
    return profiler
