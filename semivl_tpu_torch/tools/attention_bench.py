"""Times the attention forward kernels of this checkout against another
build of their sources, in turns, on the card.

``other`` is a directory of CUDA sources (another checkout's
``semivl_tpu_torch/csrc``, e.g. a parent commit unpacked with ``git
archive``), built with this checkout's nvcc flags. At each case of
``chip_smoke.py``'s ``ATTN_CASES`` (``packed_attention_fwd``) and
``HEADS_CASES`` (``heads_attention_fwd``) both builds run through the same
ctypes call in turns (other, this, this, other), timed by CUDA events and
by the profiler's kernel durations (``chip_smoke.cuda_ms`` and
``device_ms``), with SDPA beside; ``rel_l2`` is this build's output against
the other's. Last, the host time of one packed forward call at the
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
    """(packed_attention_fwd, heads_attention_fwd) of this checkout's
    libraries, or of the sources in ``csrc`` built with the same flags."""
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
    packed.argtypes, heads.argtypes = fa._ARGTYPES, fa._HEADS_ARGTYPES
    packed.restype = heads.restype = ctypes.c_int
    return packed, heads


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


@torch.no_grad()
def run(other):
    """One dict per case: this build's, the other build's and SDPA's
    times, flops, TFLOP/s by device time and ``rel_l2``; then the host
    split of a packed forward call."""
    device = resolve_device(None)
    import chip_smoke

    def times(fn):
        return dict(event_ms=chip_smoke.cuda_ms(fn),
                    device_ms=chip_smoke.device_ms(fn))

    builds = {'this': entry_points(), 'other': entry_points(other)}
    gen = torch.Generator(device=device).manual_seed(0)
    cases = ([(name, b, length, heads, 64, valid, 'packed') for
              name, b, length, heads, valid in chip_smoke.ATTN_CASES]
             + [case + ('heads',) for case in chip_smoke.HEADS_CASES])
    rows = []
    for name, b, length, heads, d, valid, route in cases:
        qkv = torch.randn(b, length, 3 * heads * d, generator=gen,
                          device=device, dtype=torch.bfloat16)
        which = 0 if route == 'packed' else 1
        calls = {k: launcher(fns[which], route, qkv, heads, valid)
                 for k, fns in builds.items()}
        got = {k: [] for k in builds}
        for k in ('other', 'this', 'this', 'other'):
            got[k].append(times(calls[k][0]))
        row = dict(case=name, route=route, shape=[b, length, heads * d],
                   heads=heads, valid_len=valid,
                   flops=4 * b * heads * length * (valid or length) * d,
                   sdpa=dict(event_ms=chip_smoke._sdpa_ms(qkv, heads, valid),
                             device_ms=chip_smoke._sdpa_ms(
                                 qkv, heads, valid,
                                 timer=chip_smoke.device_ms)))
        for k, meas in got.items():
            row[k] = {m: sum(x[m] for x in meas) / len(meas)
                      for m in ('event_ms', 'device_ms')}
        row['tflops'] = row['flops'] / row['this']['device_ms'] / 1e9
        row['rel_l2'] = chip_smoke._rel_l2(calls['this'][1],
                                           calls['other'][1])
        rows.append(row)
    b, length, heads, _ = chip_smoke.ATTN_CASES[0][1:]
    split = host_split(torch.randn(b, length, 3 * 64 * heads, generator=gen,
                                   device=device, dtype=torch.bfloat16), heads)
    return rows, dict(shape=[b, length, 64 * heads], heads=heads, **split)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('other', help='a csrc directory to build and time '
                    'against')
    rows, split = run(ap.parse_args(argv).other)
    for r in rows:
        print(f'{r["route"]} {r["case"]} ({r["shape"][0]}, {r["shape"][1]}, '
              f'{r["shape"][2]})/{r["heads"]}: this event '
              f'{r["this"]["event_ms"]:.4f} device '
              f'{r["this"]["device_ms"]:.4f} ms ({r["tflops"]:.1f} '
              f'TFLOP/s); other event {r["other"]["event_ms"]:.4f} device '
              f'{r["other"]["device_ms"]:.4f} ms; sdpa event '
              f'{r["sdpa"]["event_ms"]:.4f} device '
              f'{r["sdpa"]["device_ms"]:.4f} ms; rel-L2 vs other '
              f'{r["rel_l2"]:.2e}', flush=True)
    print(f'host us per packed forward call at {split["shape"]}/'
          f'{split["heads"]}: wrapper {split["wrapper_us"]:.2f}, C entry '
          f'point {split["entry_point_us"]:.2f}', flush=True)
    print(json.dumps(dict(cases=rows, host=split)), flush=True)
    return rows, split


if __name__ == '__main__':
    main()
