"""The readings that the limits of ``correct`` are set from, many seeds in
one process (no measured window):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 \\
        --modes program control <fault>...

For each seed it prints one JSON line per mode with the numbers that a run
compares: ``program`` is the port's timed path as a run drives it,
``control`` the reference computed in float8 in the program's place, and a
fault (``half_batch`` for training: half of each batch left out, the mean
taken over the rest; ``altered`` for evaluation: every answer shifted by one
class where it is produced) is the program with that fault planted. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--modes', nargs='+', default=['program', 'control'])
    args = ap.parse_args(argv)
    from portbench.harness import cells, spec
    from portbench.run import _with_reference_precision
    w, conf, mix, _, _ = spec.cell(args.workload)
    lim = spec.limits(args.workload)
    t0 = time.perf_counter()
    if mix['kind'] == 'semi_train':
        cell = cells.TrainCell(conf, mix)
    else:
        cell = cells.EvalCell(conf, mix)
    print(f'built in {time.perf_counter() - t0:.1f} s', file=sys.stderr)
    worst = {}
    for seed in args.seeds:
        t = time.perf_counter()
        rows = {}
        if mix['kind'] == 'semi_train':
            ring = cell.inputs(seed)
            prog = {}
            for mode in args.modes:
                if mode != 'control':
                    step, _, prog[mode] = cell.start(
                        seed, ring, None if mode == 'program' else mode)
                    del step
                    cells._free(cell.device)
            ref = _with_reference_precision(
                lambda: cell.reference(seed, ring))
            if 'control' in args.modes:
                prog['control'] = _with_reference_precision(
                    lambda: cell.reference(seed, ring, 'fp8'))
            for mode, p in prog.items():
                rows[mode] = cells.compare_train(p, ref)
            rows['losses'] = {m: [x['loss_all'] for x in p['losses']]
                              for m, p in prog.items()}
            rows['losses']['reference'] = [x['loss_all']
                                           for x in ref['losses']]
            del ring
        else:
            cell.load(seed)
            items = cell.images(seed)
            sample = cell.samples(seed, items)
            cell.warm(items)
            for mode in args.modes:
                if mode == 'control':
                    stash = _with_reference_precision(
                        lambda: cells.control_stash(cell, seed, items,
                                                    sample))
                else:
                    stash = cell.window(items, 0, sample, None if mode ==
                                        'program' else mode)['stash']
                rows[mode] = _with_reference_precision(
                    lambda: cell.reference(seed, items, stash))
        cells._free(cell.device)
        for mode, nums in rows.items():
            if mode == 'losses':
                continue
            for k, (v, at) in nums.items():
                worst.setdefault(mode, {}).setdefault(k, []).append(v)
        print(json.dumps({'seed': seed, 'seconds': round(
            time.perf_counter() - t, 1), **rows}), flush=True)
    print(json.dumps({'limits': lim, 'readings': {
        m: {k: [min(v), float(np.median(v)), max(v)] for k, v in d.items()}
        for m, d in worst.items()}}), flush=True)


if __name__ == '__main__':
    main()
