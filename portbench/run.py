"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic by name (``BENCHMARK.json``),
builds the port's model with the seed's weights, warms every shape up,
measures for ``--seconds`` (``--trace 1``: a profiled window instead, for
the per-layer metrics), frees the program, lets the plain reference work
the same inputs out again, and prints the comparison's numbers beside their
limits as the last lines of standard error and one JSON result as the last
line of standard output. Exits 2 without a result when the cell's cards are
not there, and 3 when a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault('USE_FLAX', '0')
# one process with few threads on the host's shared cores: the port's host
# work is a Python thread and the evaluator's prefetch thread
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
    os.environ.setdefault(_var, '2')

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'semivl_tpu')
GIB = float(1 << 30)


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device='cuda', check_card=True, fault=None,
         resolve=None):
    """The run; returns its exit code. ``check_card=False``, a CPU
    ``device`` and ``resolve`` (workload -> the cell's entry,
    configuration, mix, per-layer metrics and limits) drive the rest of a
    run without a card (the tests)."""
    args = parse(argv)
    from portbench.harness import spec
    w, conf, mix, per_layer, lim = (resolve or _resolve)(args.workload)
    phases = {}
    t = time.perf_counter()
    import torch
    import semivl_tpu_torch  # noqa: F401
    phases['imports'] = time.perf_counter() - t
    if check_card and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < w['chips']):
        log(f'{args.workload} needs {w["chips"]} CUDA card(s); '
            f'{torch.cuda.device_count()} available: no result')
        return 2
    t = time.perf_counter()
    if device == 'cuda':
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    phases['cuda_context'] = time.perf_counter() - t
    t = time.perf_counter()
    if device == 'cuda':
        from semivl_tpu_torch.ops import _build
        _build.build_all()
    phases['kernel_build'] = time.perf_counter() - t
    kind = mix['kind']
    if kind == 'semi_train':
        return _train(args, conf, mix, per_layer, lim, phases, device, fault)
    if kind == 'eval_images':
        return _eval(args, conf, mix, per_layer, lim, phases, device, fault)
    raise ValueError(f'unknown traffic kind {kind!r}')


def _resolve(workload):
    from portbench.harness import spec
    w, conf, mix, _, per_layer = spec.cell(workload)
    return w, conf, mix, per_layer, spec.limits(workload)


def _train(args, conf, mix, per_layer, lim, phases, device, fault):
    from portbench.harness import cells, report
    t = time.perf_counter()
    cell = cells.TrainCell(conf, mix, device)
    phases['model'] = time.perf_counter() - t
    t = time.perf_counter()
    ring = cell.inputs(args.seed)
    phases['inputs'] = time.perf_counter() - t
    t = time.perf_counter()
    step, gen, prog = cell.start(args.seed, ring, fault)
    cells._sync(device)
    phases['first_steps'] = time.perf_counter() - t
    setup_peak = report.peak(device)
    setup_s = time.perf_counter() - T0
    out = {}
    if args.trace:
        reading = cell.traced(step, ring, gen)
        attempted = reading.units
    else:
        win = cell.window(step, ring, gen, args.seconds)
        attempted = win['steps']
        out['train_imgs_per_s'] = (win['train_imgs_per_s'], 'imgs/s')
        out['peak_mem_gib'] = (win['peak'] / GIB, 'GiB')
        out['setup_s'] = (setup_s, 's')
    peak = max(setup_peak, report.peak(device))
    step = gen = None
    cell.model = cell.bundle = None
    cells._free(device)
    ref = _with_reference_precision(lambda: cell.reference(args.seed, ring))
    numbers = cells.compare_train(prog, ref)
    log(f'first steps: program losses {prog["losses"]}')
    log(f'first steps: reference losses {ref["losses"]}')
    return report.finish(args, out, per_layer, reading if args.trace
                         else None, numbers, lim, attempted, 0, peak,
                         phases, setup_s, device)


def _eval(args, conf, mix, per_layer, lim, phases, device, fault):
    from portbench.harness import cells, report
    t = time.perf_counter()
    cell = cells.EvalCell(conf, mix, device)
    phases['model'] = time.perf_counter() - t
    t = time.perf_counter()
    cell.load(args.seed)
    items = cell.images(args.seed)
    sample = cell.samples(args.seed, items)
    phases['inputs'] = time.perf_counter() - t
    t = time.perf_counter()
    cell.warm(items)
    phases['warm_up'] = time.perf_counter() - t
    setup_peak = report.peak(device)
    setup_s = time.perf_counter() - T0
    out = {}
    if args.trace:
        reading = cell.traced(items)
        attempted = reading.units
        win = cell.window(items, 0, sample, fault)   # one flush: the sample
    else:
        win = cell.window(items, args.seconds, sample, fault)
        attempted = win['images']
        out['eval_imgs_per_s'] = (win['eval_imgs_per_s'], 'imgs/s')
        out['eval_image_ms_p95'] = (win['eval_image_ms_p95'], 'ms')
        out['peak_mem_gib'] = (win['peak'] / GIB, 'GiB')
        out['setup_s'] = (setup_s, 's')
    peak = max(setup_peak, report.peak(device))
    failed = len(set(sample) - set(win['stash']))
    cell.evaluator = cell.model = cell.bundle = None
    cells._free(device)
    numbers = _with_reference_precision(
        lambda: cell.reference(args.seed, items, win['stash']))
    return report.finish(args, out, per_layer, reading if args.trace
                         else None, numbers, lim, attempted, failed, peak,
                         phases, setup_s, device)


def _with_reference_precision(fn):
    """Run ``fn`` with TF32 off (the reference is float32), restoring the
    flags after."""
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fn()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


if __name__ == '__main__':
    sys.exit(main())
