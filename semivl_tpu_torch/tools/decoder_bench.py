"""Times the whole-plane decoder backward (kernels #6/#7) of this checkout
against another checkout's, in turns, on the card.

``other`` is the root of another checkout (e.g. a parent commit unpacked
with ``git archive``): its ``semivl_tpu_torch.ops.fused_decoder`` is
imported beside this one's, with its own sources and build directory, so
each build runs through its own wrapper. At each case of ``CASES`` (the
flagship VOC step's decoder at P = 126 and the tiny step's at P = 42) both
builds run in turns (other, this, this, other): both stages' tail calls
(``decoder_stage_bwd_tail``), both input calls (``decoder_stage_bwd_input``)
and the whole backward through autograd (the two forward launches are
outside it), timed by CUDA events and by the profiler's kernel durations
(``chip_smoke.cuda_ms`` and ``device_ms``), with cuDNN's backward of the
same chain beside (``chip_smoke._cudnn_chain``); ``speedup`` is the other
build's device time over this one's, ``vs_cudnn`` this build's over
cuDNN's, and ``rel_l2`` the worst gradient leaf of this build against the
other's. A time the profiler did not keep whole is null. Run it from the
repository's root:

    python -m semivl_tpu_torch.tools.decoder_bench OTHER_ROOT
"""

import argparse
import importlib
import json
import os
import sys

import torch

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.ops import fused_decoder

# (name, images, planes per image, base grid h, channels, up channels,
# skip channels)
CASES = (('flagship VOC step, P=126', 6, 21, 32, 128, (64, 32), (32, 16)),
         ('tiny step, P=42', 2, 21, 4, 32, (32, 16), (16, 16)))


def load_other(root):
    """``semivl_tpu_torch.ops.fused_decoder`` of the checkout at ``root``,
    imported with its own package (its own ``_build``, sources and build
    directory); this checkout's modules are left as they were."""
    ours = {k: v for k, v in sys.modules.items()
            if k == 'semivl_tpu_torch' or k.startswith('semivl_tpu_torch.')}
    for k in ours:
        del sys.modules[k]
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        return importlib.import_module('semivl_tpu_torch.ops.fused_decoder')
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if k == 'semivl_tpu_torch'
                  or k.startswith('semivl_tpu_torch.')]:
            del sys.modules[k]
        sys.modules.update(ours)


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _ratio(a, b):
    return None if a is None or b is None else a / b


def calls(fd, acts, params, g):
    """No-argument calls of ``fd``'s backward on one case: both tails, both
    input halves, and the whole backward through autograd; and the
    gradients of the whole backward (``chip_smoke.decoder_leaves`` order)."""
    import chip_smoke
    x, s1, s2 = acts
    p1, p2, head = params
    with torch.no_grad():
        _, c2, part2 = fd._forward(x, s1, s2, p1, p2, head)
        gn_in = (part2, p1['gn2_weight'].float().contiguous(),
                 p1['gn2_bias'].float().contiguous())
        t2 = fd._stage_bwd_tail(c2, s2, p2, gn_in, head, g)
        i2 = fd._stage_bwd_input(t2['g_c1'], t2['up'], t2['xin'], s2, p2)
        t1 = fd._stage_bwd_tail(x, s1, p1, g=i2['g_x'])

    def tail():
        fd._stage_bwd_tail(c2, s2, p2, gn_in, head, g)
        fd._stage_bwd_tail(x, s1, p1, g=i2['g_x'])

    def inputs():
        fd._stage_bwd_input(t2['g_c1'], t2['up'], t2['xin'], s2, p2)
        fd._stage_bwd_input(t1['g_c1'], t1['up'], t1['xin'], s1, p1)

    xs = [t.detach().requires_grad_(True) for t in acts]
    prms = ([p1[k] for k in fd.STAGE_KEYS] + [p2[k] for k in fd.STAGE_KEYS]
            + [head['weight'], head['bias']])
    out = fd.fused_vlg_decoder(*xs, *params)

    def whole():
        return torch.autograd.grad(out, xs + prms, g, retain_graph=True)

    return dict(tail=tail, input=inputs, whole=whole), whole()


def run(other_root):
    """One dict per case: each build's event and device times of the tail,
    the input half and the whole backward, cuDNN's backward, ``speedup``,
    ``vs_cudnn`` and ``rel_l2``."""
    import chip_smoke
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = {'this': fused_decoder, 'other': load_other(other_root)}
    timers = dict(event_ms=lambda f: chip_smoke.cuda_ms(f, 5),
                  device_ms=lambda f: chip_smoke.device_ms(f, 5))
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, b, n, h, c, ups, skips in CASES:
        p = b * n
        up1, up2, head = chip_smoke._random_decoder(gen, c, ups, skips)
        params = [up1.stage_params(), up2.stage_params(),
                  dict(weight=head.weight, bias=head.bias)]
        acts = [torch.randn(p, c, h, h, generator=gen),
                torch.randn(b, skips[0], 2 * h, 2 * h, generator=gen),
                torch.randn(b, skips[1], 4 * h, 4 * h, generator=gen)]
        acts = [t.to(device).bfloat16() for t in acts]
        g = torch.randn(p, 1, 4 * h, 4 * h, generator=gen).to(
            device).bfloat16()
        made = {k: calls(fd, acts, params, g) for k, fd in builds.items()}
        got = {k: {part: [] for part in ('tail', 'input', 'whole')}
               for k in builds}
        for k in ('other', 'this', 'this', 'other'):
            for part, fn in made[k][0].items():
                got[k][part].append({m: t(fn) for m, t in timers.items()})
        row = dict(case=name, planes=p, base=h)
        for k in builds:
            row[k] = {part: {m: _mean([x[m] for x in meas]) for m in timers}
                      for part, meas in got[k].items()}
        xs = [t.detach().requires_grad_(True) for t in acts]
        prms = [t for d in params for t in d.values()]
        out = chip_smoke._cudnn_chain(up1, up2, head, *xs)

        def cudnn():
            return torch.autograd.grad(out, xs + prms, g, retain_graph=True)

        row['cudnn'] = {m: t(cudnn) for m, t in timers.items()}
        this_ms = row['this']['whole']['device_ms']
        row['speedup'] = _ratio(row['other']['whole']['device_ms'], this_ms)
        row['vs_cudnn'] = _ratio(this_ms, row['cudnn']['device_ms'])
        row['rel_l2'] = max(chip_smoke._rel_l2(a, r) for a, r in zip(
            made['this'][1], made['other'][1]))
        rows.append(row)
        del made, out
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('other', help='root of another checkout to time against')
    rows = run(ap.parse_args(argv).other)

    def num(x, spec='.4f'):
        return 'n/a' if x is None else format(x, spec)

    for r in rows:
        parts = '; '.join(
            f'{part}: this event {num(r["this"][part]["event_ms"])} device '
            f'{num(r["this"][part]["device_ms"])}, other event '
            f'{num(r["other"][part]["event_ms"])} device '
            f'{num(r["other"][part]["device_ms"])}'
            for part in ('tail', 'input', 'whole'))
        print(f'decoder bwd {r["case"]}: {parts}; cudnn event '
              f'{num(r["cudnn"]["event_ms"])} device '
              f'{num(r["cudnn"]["device_ms"])} ms; speed-up (whole, device) '
              f'{num(r["speedup"], ".2f")}x, vs cudnn '
              f'{num(r["vs_cudnn"], ".2f")}x; rel-L2 vs other (worst leaf) '
              f'{r["rel_l2"]:.2e}', flush=True)
    print(json.dumps(dict(cases=rows)), flush=True)
    return rows


if __name__ == '__main__':
    main()
