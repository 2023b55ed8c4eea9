"""Times the attention kernels of this checkout against another build of
their sources, in turns, on the card.

``other`` is a directory of CUDA sources (another checkout's
``semivl_tpu_torch/csrc``, e.g. a parent commit unpacked with ``git
archive``), built with this checkout's nvcc flags. At each case of
``chip_smoke.py``'s ``ATTN_CASES`` (``packed_attention_fwd``) and
``HEADS_CASES`` (``heads_attention_fwd``), and for the backward
(``heads_attention_bwd``, both routes) at each of ``ATTN_BWD_CASES`` and
``HEADS_CASES``, both builds run through the same ctypes call in turns
(other, this, this, other), timed by CUDA events and by the profiler's
kernel durations (``chip_smoke.cuda_ms`` and ``device_ms``), with SDPA's
forward or backward beside; ``rel_l2`` is this build's output against the
other's, ``speedup`` the other build's device time over this one's and
``vs_sdpa`` this build's over SDPA's. The backward of both builds takes
the same forward output and log-sum-exp, from this build. A case the other
build refuses (a head width it does not take) is timed for this build
alone; a time the profiler did not keep whole is null. Last, the host
time of one packed forward call at the
flagship encoder's shape: through the Python wrapper, and through the C
entry point alone (three tensor-map encodes, the launch), which bounds
what the encodes cost. Run it from the repository's root:

    python -m semivl_tpu_torch.tools.attention_bench OTHER_CSRC
"""

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.ops import _build
from semivl_tpu_torch.ops import flash_attention as fa

LIBS = ('flash_attention', 'flash_attention_heads')


def entry_points(csrc=None):
    """(packed_attention_fwd, heads_attention_fwd, heads_attention_bwd) of
    this checkout's libraries, or of the sources in ``csrc`` built with the
    same flags."""
    if csrc is None:
        libs = [_build.load(n) for n in LIBS]
    else:
        out_dir = os.path.join(_build.BUILD_DIR, 'other')
        os.makedirs(out_dir, exist_ok=True)
        paths = [os.path.join(out_dir, n + '.so') for n in LIBS]
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', p,
             os.path.join(csrc, n + '.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for n, p in zip(LIBS, paths)]
        for n, proc in zip(LIBS, procs):
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f'nvcc failed for {csrc}/{n}.cu:\n{log}')
        libs = [ctypes.CDLL(p) for p in paths]
    packed, heads = libs[0].packed_attention_fwd, libs[1].heads_attention_fwd
    bwd = libs[1].heads_attention_bwd
    packed.argtypes, heads.argtypes = fa._ARGTYPES, fa._HEADS_ARGTYPES
    bwd.argtypes = fa._BWD_ARGTYPES
    packed.restype = heads.restype = bwd.restype = ctypes.c_int
    return packed, heads, bwd


def launcher(fn, route, qkv, heads, valid):
    """A no-argument call of ``fn`` on ``qkv`` (its arguments bound once)
    and the output it writes."""
    b, length, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.split(c, dim=-1)
    out = torch.empty((b, length, c), dtype=qkv.dtype, device=qkv.device)
    shape = ((b, length, heads) + ((d,) if route == 'heads' else ())
             + (valid or length,))
    args = ([_build.ptr(t) for t in (q, k, v, out)] + [ctypes.c_void_p(None)]
            + list(shape) + [q.stride(0), q.stride(1), out.stride(0),
                             out.stride(1), fa._q_scale(d), fa._stream(qkv)])

    def call():
        _build.check(fn(*args), f'{route} attention forward')
    return call, out


def bwd_launcher(fn, qkv, out, lse, g, heads, valid):
    """A no-argument call of the backward ``fn`` (``heads_attention_bwd``)
    and the (B, L, 3C) gradient it writes, as ``flash_attention``'s
    ``_bwd_kernel`` binds it."""
    b, length, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, length), dtype=torch.float32,
                        device=qkv.device)
    args = ([_build.ptr(t) for t in (*qkv.split(c, dim=-1), out, g, lse,
                                      delta, *dqkv.split(c, dim=-1))]
            + [b, length, heads, d, valid or length, qkv.stride(0),
               qkv.stride(1), g.stride(0), g.stride(1), dqkv.stride(0),
               dqkv.stride(1), fa._q_scale(d), d ** -0.5, fa._stream(qkv)])

    def call():
        _build.check(fn(*args), 'attention backward')
    return call, dqkv


def host_us(fn, n=200):
    """Host time of one call of ``fn`` in microseconds, over ``n`` calls
    that only queue work on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(qkv, heads):
    """Host microseconds of one packed forward call on ``qkv``: through
    the Python wrapper, and through the C entry point with its arguments
    bound once (its three tensor-map encodes, the launch, one ctypes
    call)."""
    call, _ = launcher(entry_points()[0], 'packed', qkv, heads, None)
    return dict(wrapper_us=host_us(lambda: fa.packed_attention(qkv, heads)),
                entry_point_us=host_us(call))


def _launches(call):
    """Whether ``call`` launches: False where its build refuses the case."""
    try:
        call()
    except RuntimeError:
        return False
    return True


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _ratio(a, b):
    return None if a is None or b is None else a / b


def _in_turns(calls, timers):
    """Each timer of each build's call, other, this, this, other, averaged
    per build (a build left out of ``calls``: None)."""
    got = {k: [] for k in ('this', 'other')}
    for k in ('other', 'this', 'this', 'other'):
        if k in calls:
            got[k].append({m: t(calls[k]) for m, t in timers.items()})
    return {k: {m: _mean([x[m] for x in meas]) for m in timers}
            if meas else None for k, meas in got.items()}


@torch.no_grad()
def run(other):
    """One dict per case, forward then backward: this build's, the other
    build's and SDPA's times, flops, TFLOP/s by device time, ``rel_l2``,
    ``speedup`` and ``vs_sdpa``; then the host split of a packed forward
    call."""
    device = resolve_device(None)
    import chip_smoke
    timers = dict(event_ms=chip_smoke.cuda_ms, device_ms=chip_smoke.device_ms)

    def finish(row, calls, sdpa):
        calls = {k: c for k, c in calls.items() if _launches(c[0])}
        row.update(_in_turns({k: c[0] for k, c in calls.items()}, timers))
        row['sdpa'] = sdpa
        this_ms = row['this']['device_ms']
        other_ms = row['other'] and row['other']['device_ms']
        row['tflops'] = _ratio(row['flops'] / 1e9, this_ms)
        row['rel_l2'] = (chip_smoke._rel_l2(calls['this'][1],
                                            calls['other'][1])
                         if 'other' in calls else None)
        row['speedup'] = _ratio(other_ms, this_ms)
        row['vs_sdpa'] = _ratio(this_ms, sdpa['device_ms'])
        return row

    builds = {'this': entry_points(), 'other': entry_points(other)}
    gen = torch.Generator(device=device).manual_seed(0)
    fwd_cases = ([(name, b, length, heads, 64, valid, 'packed') for
                  name, b, length, heads, valid in chip_smoke.ATTN_CASES]
                 + [case + ('heads',) for case in chip_smoke.HEADS_CASES])
    bwd_cases = ([(name, b, length, heads, 64, valid, 'packed') for
                  name, b, length, heads, valid in chip_smoke.ATTN_BWD_CASES]
                 + [case + ('heads',) for case in chip_smoke.HEADS_CASES])
    rows = []
    for name, b, length, heads, d, valid, route in fwd_cases:
        qkv = torch.randn(b, length, 3 * heads * d, generator=gen,
                          device=device, dtype=torch.bfloat16)
        which = 0 if route == 'packed' else 1
        calls = {k: launcher(fns[which], route, qkv, heads, valid)
                 for k, fns in builds.items()}
        rows.append(finish(
            dict(case=name, route=route, direction='fwd',
                 shape=[b, length, heads * d], heads=heads, valid_len=valid,
                 flops=4 * b * heads * length * (valid or length) * d),
            calls, {m: chip_smoke._sdpa_ms(qkv, heads, valid, timer=t)
                    for m, t in timers.items()}))
    for name, b, length, heads, d, valid, route in bwd_cases:
        c = heads * d
        qkv = torch.randn(b, length, 3 * c, generator=gen, device=device,
                          dtype=torch.bfloat16)
        g = torch.randn(b, length, c, generator=gen, device=device,
                        dtype=torch.bfloat16)
        if route == 'packed':
            out, lse = fa._fwd_kernel(*qkv.split(c, dim=-1), heads,
                                      valid or length, True)
        else:
            out, lse = fa.flash_mha_heads(qkv, heads, valid, True)
        calls = {k: bwd_launcher(fns[2], qkv, out, lse, g, heads, valid)
                 for k, fns in builds.items()}
        with torch.enable_grad():
            sdpa = {m: chip_smoke._sdpa_ms(qkv, heads, valid, g, timer=t)
                    for m, t in timers.items()}
        rows.append(finish(
            dict(case=name, route=route, direction='bwd',
                 shape=[b, length, c], heads=heads, valid_len=valid,
                 flops=8 * b * heads * length * (valid or length) * d),
            calls, sdpa))
    b, length, heads, _ = chip_smoke.ATTN_CASES[0][1:]
    split = host_split(torch.randn(b, length, 3 * 64 * heads, generator=gen,
                                   device=device, dtype=torch.bfloat16), heads)
    return rows, dict(shape=[b, length, 64 * heads], heads=heads, **split)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('other', help='a csrc directory to build and time '
                    'against')
    rows, split = run(ap.parse_args(argv).other)

    def num(x, spec):
        return 'n/a' if x is None else format(x, spec)

    for r in rows:
        other = r['other'] or dict(event_ms=None, device_ms=None)
        print(f'{r["route"]} {r["direction"]} {r["case"]} ({r["shape"][0]}, '
              f'{r["shape"][1]}, {r["shape"][2]})/{r["heads"]}: this event '
              f'{num(r["this"]["event_ms"], ".4f")} device '
              f'{num(r["this"]["device_ms"], ".4f")} ms '
              f'({num(r["tflops"], ".1f")} TFLOP/s); other event '
              f'{num(other["event_ms"], ".4f")} device '
              f'{num(other["device_ms"], ".4f")} ms; sdpa event '
              f'{num(r["sdpa"]["event_ms"], ".4f")} device '
              f'{num(r["sdpa"]["device_ms"], ".4f")} ms; speed-up '
              f'{num(r["speedup"], ".2f")}x, vs sdpa '
              f'{num(r["vs_sdpa"], ".2f")}x; rel-L2 vs other '
              f'{num(r["rel_l2"], ".2e")}', flush=True)
    print(f'host us per packed forward call at {split["shape"]}/'
          f'{split["heads"]}: wrapper {split["wrapper_us"]:.2f}, C entry '
          f'point {split["entry_point_us"]:.2f}', flush=True)
    print(json.dumps(dict(cases=rows, host=split)), flush=True)
    return rows, split


if __name__ == '__main__':
    main()
