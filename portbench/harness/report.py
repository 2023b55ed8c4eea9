"""The end of a run: the forbidden-module check, the comparison's numbers
beside their limits, and the one-line JSON result."""

import json
import math
import sys

import torch

from portbench.harness import spec


def peak(device):
    """The allocator's peak on ``device`` so far (0 off the card)."""
    if torch.device(device).type != 'cuda':
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def device_info(device, count, peak_bytes, reading=None):
    if torch.device(device).type == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': count, 'memory_peak_bytes': peak_bytes}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': 0}
    if reading is not None:
        info['busy_s'] = reading.busy_s
        info['window_s'] = reading.window_s
    return info


def finish(args, out, per_layer, reading, numbers, lim, attempted, failed,
           peak_bytes, phases, setup_s, device):
    """Print the result; return the exit code."""
    from portbench.run import forbidden_modules, log
    found = forbidden_modules()
    if found:
        log(f'modules of JAX or the JAX package were loaded: {found}; '
            'no result')
        return 3
    metrics = {k: {'value': v, 'unit': u} for k, (v, u) in out.items()}
    if reading is not None:
        for m in per_layer:
            v = spec.reader(m['name'])(reading)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    compared, recorded, correct = {}, {}, failed == 0
    for name, (value, detail) in numbers.items():
        entry = {'value': value}
        if detail:
            entry['at'] = detail
        if name not in lim:
            recorded[name] = entry
            continue
        entry['limit'] = lim[name]
        correct = correct and math.isfinite(value) and value <= lim[name]
        compared[name] = entry
    missing = set(lim) - set(numbers)
    if missing:
        raise ValueError(f'limits for numbers this cell does not read: '
                         f'{sorted(missing)}')
    log('set-up by phase (s): ' + json.dumps(
        {k: round(v, 3) for k, v in phases.items()})
        + f'; setup_s {setup_s:.3f}')
    for name, c in recorded.items():
        log(f'recorded {name}: {c["value"]:.6g}'
            + (f' ({c["at"]})' if 'at' in c else ''))
    for name, c in compared.items():
        log(f'compare {name}: {c["value"]:.6g} limit {c["limit"]:.6g}'
            + (f' ({c["at"]})' if 'at' in c else ''))
    result = {'correct': bool(correct), 'attempted': int(attempted),
              'failed': int(failed), 'metrics': metrics,
              'device': device_info(device, 1, peak_bytes, reading)}
    if reading is not None:
        result['breakdown'] = reading.breakdown()
    result['compared'] = compared
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
