"""Times the decoder kernels of this checkout against another checkout's,
in turns, on the card: the forward (kernel #5), the backward's
whole-plane route (kernels #6/#7) and banded route (passes #8-#10), and
the fused Up stage (#11).

``other`` is the root of another checkout (e.g. a parent commit unpacked
with ``git archive``): its ``semivl_tpu_torch.ops.fused_decoder``,
``fused_decoder_banded`` and ``fused_up`` are imported beside this one's,
with their own sources and build directory, so each build runs through
its own wrappers.
Both builds run in turns (other, this, this, other), timed by CUDA events
and by the profiler's kernel durations (``chip_smoke.cuda_ms`` and
``device_ms``):

- at each case of ``CASES`` and ``BANDED_CASES``, the forward (#5) under
  no_grad: stage 1 (``fused_decoder._stage``), stage 2 with the head (on
  its own build's stage-1 output and partials) and the two-stage chain
  (``fused_vlg_decoder``), with cuDNN's convolutions for each beside
  (``fused_up_bench.cudnn_stage``, ``chip_smoke._cudnn_chain``), each turn
  in a process of its own as the banded turns below;
- at each case of ``CASES`` (the flagship VOC step's decoder at P = 126
  and the tiny step's at P = 42, the whole-plane route): both stages' tail
  calls (``decoder_stage_bwd_tail``), both input calls
  (``decoder_stage_bwd_input``) and the whole backward through autograd
  (the two forward launches are outside it), with cuDNN's backward of the
  same chain beside (``chip_smoke._cudnn_chain``);
- at each case of ``BANDED_CASES`` (the Cityscapes step's decoder at P =
  57 on a 51^2 base grid, the banded route): passes A, B and C of both
  stages, each on its own build's inputs, and the whole banded backward
  through autograd, with the library's convolutions for each pass's work
  (``chip_smoke._cudnn_pass_calls``) and cuDNN's backward of the chain
  beside. Each turn of this case runs in a process of its own, which runs
  one build's kernels only: once the other build's banded passes have run
  in a process, the profiler on the card's machine drops records of
  PyTorch's copy kernels from every later window, so no device-only time
  would be kept;
- at the stages of ``fused_up_bench.STAGES`` (the flagship's up1 and up2
  at 14 x 21 planes), each without and with the head: ``fused_up_stage``
  under no_grad, with cuDNN's chain for the same stage beside
  (``fused_up_bench.cudnn_stage``, then the head's conv), each turn in a
  process of its own as the banded turns; the first turn of this build
  also takes the profiler's per-kernel device times of one call of each
  part (``kernels``, ms per call by kernel name).

``speedup`` is the other build's device time over this one's (per part
too, ``speedups``), ``vs_cudnn`` this build's over cuDNN's, and ``rel_l2``
the worst gradient leaf of this build's whole backward against the
other's (for the forward, the logits; for the Up stage, per part, the
output of one image's planes).
A time the profiler did not keep whole is null. Run it from the
repository's root:

    python -m semivl_tpu_torch.tools.decoder_bench OTHER_ROOT
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

import torch

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.ops import fused_decoder, fused_decoder_banded, fused_up

# (name, images, planes per image, base grid h, channels, up channels,
# skip channels)
CASES = (('flagship VOC step, P=126', 6, 21, 32, 128, (64, 32), (32, 16)),
         ('tiny step, P=42', 2, 21, 4, 32, (32, 16), (16, 16)))
BANDED_CASES = (('Cityscapes step, banded, P=57', 3, 19, 51, 128, (64, 32),
                 (32, 32)),)


def load_other(root):
    """``semivl_tpu_torch.ops.fused_decoder``, ``fused_decoder_banded`` and
    ``fused_up`` of the checkout at ``root``, imported with their own
    package (its own ``_build``, sources and build directory); this
    checkout's modules are left as they were."""
    ours = {k: v for k, v in sys.modules.items()
            if k == 'semivl_tpu_torch' or k.startswith('semivl_tpu_torch.')}
    for k in ours:
        del sys.modules[k]
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        return tuple(importlib.import_module(f'semivl_tpu_torch.ops.{m}')
                     for m in ('fused_decoder', 'fused_decoder_banded',
                               'fused_up'))
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


def _ratios(row, parts, made):
    """``speedups`` per part and ``speedup`` of the whole backward (the
    other build's device time over this one's), ``vs_cudnn`` and
    ``rel_l2`` (this build's gradients against the other's)."""
    import chip_smoke
    row['speedups'] = {part: _ratio(row['other'][part]['device_ms'],
                                    row['this'][part]['device_ms'])
                       for part in parts}
    row['speedup'] = row['speedups']['whole']
    row['vs_cudnn'] = _ratio(row['this']['whole']['device_ms'],
                             row['cudnn']['device_ms'])
    row['rel_l2'] = max(chip_smoke._rel_l2(a, r) for a, r in zip(
        made['this'][1], made['other'][1]))


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


def banded_calls(fd, fdb, acts, params, g):
    """No-argument calls of ``fdb``'s banded backward on one case: passes
    A, B and C of both stages, each on the inputs its own build's pass
    before gave it, and the whole banded backward through autograd; and
    the gradients of the whole backward."""
    x, s1, s2 = acts
    p1, p2, head = params
    ins = {k: [] for k in 'ABC'}
    with torch.no_grad():
        _, c2, st1, st2 = fdb.decoder_fwd_stats(x, s1, s2, p1, p2, head)
        gn_x = (st1[2], st1[3], p1['gn2_weight'], p1['gn2_bias'])
        g_in = g
        for xin, skip, prm, st, gx, hd in ((c2, s2, p2, st2, gn_x, head),
                                           (x, s1, p1, st1, None, None)):
            ins['A'].append((xin, skip, prm, st, g_in, gx, hd))
            a = fdb.pass_a(*ins['A'][-1])
            hw = a['raw2'].shape[2] * a['raw2'].shape[3]
            mg2 = fdb.close_gn(a['sgy2'], a['sgyx2'], prm['gn2_weight'],
                               hw)[2:]
            ins['B'].append((a['raw1'], a['raw2'], a['gy2'], prm, st, mg2))
            bb = fdb.pass_b(*ins['B'][-1])
            mg1 = fdb.close_gn(bb['sgy1'], bb['sgyx1'], prm['gn1_weight'],
                               hw)[2:]
            ins['C'].append((a['xin'], a['up'], skip, a['raw1'], bb['gy1'],
                             prm, st, mg1))
            g_in = fdb.pass_c(*ins['C'][-1])['g_x']

    def each(fn, args):
        return lambda: [fn(*a) for a in args]

    xs = [t.detach().requires_grad_(True) for t in acts]
    prms = ([p1[k] for k in fd.STAGE_KEYS] + [p2[k] for k in fd.STAGE_KEYS]
            + [head['weight'], head['bias']])
    # fdb's own autograd route (fused_vlg_decoder would import this
    # checkout's banded module for either build)
    out = fdb.BandedDecoder.apply(*xs, (16, 16), *prms)

    def whole():
        return torch.autograd.grad(out, xs + prms, g, retain_graph=True)

    return dict(A=each(fdb.pass_a, ins['A']), B=each(fdb.pass_b, ins['B']),
                C=each(fdb.pass_c, ins['C']), whole=whole), whole()


def _case(gen, device, b, n, h, c, ups, skips):
    """Seeded random decoder weights, activations and the logits' gradient
    of one case."""
    import chip_smoke
    p = b * n
    up1, up2, head = chip_smoke._random_decoder(gen, c, ups, skips)
    params = [up1.stage_params(), up2.stage_params(),
              dict(weight=head.weight, bias=head.bias)]
    acts = [torch.randn(p, c, h, h, generator=gen),
            torch.randn(b, skips[0], 2 * h, 2 * h, generator=gen),
            torch.randn(b, skips[1], 4 * h, 4 * h, generator=gen)]
    acts = [t.to(device).bfloat16() for t in acts]
    g = torch.randn(p, 1, 4 * h, 4 * h, generator=gen).to(device).bfloat16()
    return (up1, up2, head), params, acts, g


def _timed(made, parts, timers, extra):
    """Each build's parts in turns (other, this, this, other), then the
    library's calls ``extra`` once: {build: {part: {timer: ms}}}."""
    got = {k: {part: [] for part in parts} for k in made}
    for k in ('other', 'this', 'this', 'other'):
        for part in parts:
            got[k][part].append({m: t(made[k][0][part])
                                 for m, t in timers.items()})
    row = {k: {part: {m: _mean([x[m] for x in meas]) for m in timers}
               for part, meas in got[k].items()} for k in made}
    row.update({name: {m: t(fn) for m, t in timers.items()}
                for name, fn in extra.items()})
    return row


def banded_turn(case, root=None, library=False):
    """One turn of a banded case in this process: the event and device
    times of passes A, B, C and the whole banded backward of this
    checkout's build (``root`` None) or of the checkout at ``root``, and
    with ``library`` the library's times; and the whole backward's
    gradients."""
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timers = dict(event_ms=lambda f: chip_smoke.cuda_ms(f, 5),
                  device_ms=lambda f: chip_smoke.device_ms(f, 5))
    name, b, n, h, c, ups, skips = case
    mods, params, acts, g = _case(torch.Generator().manual_seed(1),
                                  resolve_device(None), b, n, h, c, ups,
                                  skips)
    fd, fdb = ((fused_decoder, fused_decoder_banded) if root is None
               else load_other(root)[:2])
    fns, grads = banded_calls(fd, fdb, acts, params, g)
    out = {part: {m: t(fn) for m, t in timers.items()}
           for part, fn in fns.items()}
    if library:
        xs = [t.detach().requires_grad_(True) for t in acts]
        prms = [t for d in params for t in d.values()]
        y = chip_smoke._cudnn_chain(*mods, *xs)
        lib = dict(cudnn=lambda: torch.autograd.grad(y, xs + prms, g,
                                                     retain_graph=True),
                   **{f'library_{k}': fn for k, fn in
                      chip_smoke._cudnn_pass_calls(*mods, acts).items()})
        out.update({k: {m: t(fn) for m, t in timers.items()}
                    for k, fn in lib.items()})
    return out, [t.float().cpu() for t in grads]


FWD_PARTS = ('stage 1', 'stage 2 + head', 'chain')


def fwd_turn(case, root=None, library=False):
    """One turn of the forward at ``case`` in this process: the event and
    device times of ``FWD_PARTS`` with this checkout's build (``root``
    None) or the checkout's at ``root``; with ``library`` cuDNN's times of
    the same parts (``library <part>``) and the per-kernel breakdown of the
    chain (``kernels chain``); and the chain's logits on the first image's
    planes."""
    import chip_smoke
    import torch.nn.functional as F
    from semivl_tpu_torch.tools import fused_up_bench as bench
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timers = dict(event_ms=lambda f: chip_smoke.cuda_ms(f, 5),
                  device_ms=lambda f: chip_smoke.device_ms(f, 5))
    name, b, n, h, c, ups, skips = case
    mods, params, acts, _ = _case(torch.Generator().manual_seed(1),
                                  resolve_device(None), b, n, h, c, ups,
                                  skips)
    fd = fused_decoder if root is None else load_other(root)[0]
    (x, s1, s2), (p1, p2, head) = acts, params
    out = {}
    with torch.no_grad():
        c2, part2 = fd._stage(x, s1, p1)
        gn_in = (part2, p1['gn2_weight'].float().contiguous(),
                 p1['gn2_bias'].float().contiguous())
        fns = {'stage 1': lambda: fd._stage(x, s1, p1),
               'stage 2 + head': lambda: fd._stage(c2, s2, p2, gn_in=gn_in,
                                                   head=head),
               'chain': lambda: fd.fused_vlg_decoder(x, s1, s2, p1, p2,
                                                     head)}
        for part, fn in fns.items():
            out[part] = {m: t(fn) for m, t in timers.items()}
        logits = fns['chain']()[:n].float().cpu()
        if library:
            y1 = bench.cudnn_stage(x, s1, p1)

            def stage2():
                y = bench.cudnn_stage(y1, s2, p2)
                return F.conv2d(y, head['weight'].to(y.dtype),
                                head['bias'].to(y.dtype), padding=1)

            lib = {'stage 1': lambda: bench.cudnn_stage(x, s1, p1),
                   'stage 2 + head': stage2,
                   'chain': lambda: chip_smoke._cudnn_chain(*mods, x, s1,
                                                            s2)}
            for part, fn in lib.items():
                out[f'library {part}'] = {m: t(fn) for m, t in
                                          timers.items()}
            out['kernels chain'] = _kernel_ms(fns['chain'])
    return out, logits


def _fwd_row(case, other_root):
    """The forward's row at ``case``: its turns (other, this, this, other)
    each in a process of its own (``fwd_turn``); per part the speed-up
    (device) and this build against cuDNN's; the rel-L2 of this build's
    logits against the other's."""
    import chip_smoke
    got, outs = _turns('--fwd-turn', case, other_root)
    row = dict(case=f'forward (#5), {case[0]}', kind='forward',
               planes=case[1] * case[2], base=case[3])
    _mean_turns(row, got, FWD_PARTS)
    row['speedups'] = {part: _ratio(row['other'][part]['device_ms'],
                                    row['this'][part]['device_ms'])
                       for part in FWD_PARTS}
    row['vs_cudnn'] = {part: _ratio(row['this'][part]['device_ms'],
                                    row[f'library {part}']['device_ms'])
                       for part in FWD_PARTS}
    row['rel_l2'] = chip_smoke._rel_l2(outs['this'], outs['other'])
    return row


def up_parts():
    """(part, stage index, with the head) of the Up stage's turns."""
    from semivl_tpu_torch.tools import fused_up_bench
    return [(name + (' + head' if hd else ''), i, hd)
            for i, (name, *_) in enumerate(fused_up_bench.STAGES)
            for hd in (False, True)]


def _kernel_ms(fn, calls=5):
    """{kernel name: device ms per call of ``fn``} from one profiled
    window (the breakdown of a part; not held to whole windows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def up_turn(root=None, library=False):
    """One turn of the Up stage in this process: the event and device times
    of ``fused_up_stage`` at each of ``up_parts()`` with this checkout's
    build (``root`` None) or the checkout's at ``root``; with ``library``
    cuDNN's times and the per-kernel breakdown; and each part's output on
    the first image's planes."""
    import chip_smoke
    import torch.nn.functional as F
    from semivl_tpu_torch.tools import fused_up_bench as bench
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timers = dict(event_ms=lambda f: chip_smoke.cuda_ms(f, 5),
                  device_ms=lambda f: chip_smoke.device_ms(f, 5))
    fu = fused_up if root is None else load_other(root)[2]
    out, outs = {}, {}
    for part, i, with_head in up_parts():
        _, h, cin, cs, cout = bench.STAGES[i]
        x, skip, p = bench.make_stage(h, cin, cs, cout,
                                      device=resolve_device(None), seed=i)
        gen = torch.Generator().manual_seed(10 + i)
        hd = dict(weight=0.2 * torch.randn(1, cout, 3, 3, generator=gen),
                  bias=torch.randn(1, generator=gen)) if with_head else None
        hd = hd and {k: v.to(x.device) for k, v in hd.items()}

        def fn():
            return fu.fused_up_stage(x, skip, p, hd)

        def lib():
            y = bench.cudnn_stage(x, skip, p)
            return y if hd is None else F.conv2d(
                y, hd['weight'].to(y.dtype), hd['bias'].to(y.dtype),
                padding=1)

        with torch.no_grad():
            out[part] = {m: t(fn) for m, t in timers.items()}
            outs[part] = fn()[:x.shape[0] // skip.shape[0]].float().cpu()
            if library:
                out[f'library {part}'] = {m: t(lib) for m, t in
                                          timers.items()}
                out[f'kernels {part}'] = _kernel_ms(fn)
        del x, skip, p
        torch.cuda.empty_cache()
    return out, outs


def _turns(flag, case, other_root):
    """Run ``decoder_bench`` with ``flag`` (one turn of ``case``) four times,
    other, this, this, other, each in a process of its own, the second
    with ``--library``: {'this': [times], 'other': [times]} and each
    build's last results."""
    got = {'this': [], 'other': []}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, k in enumerate(('other', 'this', 'this', 'other')):
            path = os.path.join(tmp, f'{i}.pt')
            cmd = [sys.executable, '-m', 'semivl_tpu_torch.tools.decoder_bench',
                   flag, json.dumps(case), '--save', path]
            if k == 'other':
                cmd += ['--root', other_root]
            if i == 1:
                cmd += ['--library']
            subprocess.run(cmd, check=True)
            times, res[k] = torch.load(path)
            got[k].append(times)
    return got, res


def _mean_turns(row, got, parts):
    for k, turns in got.items():
        row[k] = {part: {m: _mean([t[part][m] for t in turns])
                         for m in ('event_ms', 'device_ms')}
                  for part in parts}
    row.update({k: v for k, v in got['this'][0].items() if k not in parts})


def _banded_row(case, other_root):
    """A banded case's row: its turns (other, this, this, other) each in a
    process of its own (``banded_turn``), the library's times from the
    first turn of this build."""
    parts = ('A', 'B', 'C', 'whole')
    got, grads = _turns('--banded-turn', case, other_root)
    row = dict(case=case[0], planes=case[1] * case[2], base=case[3])
    _mean_turns(row, got, parts)
    _ratios(row, parts, {k: (None, g) for k, g in grads.items()})
    return row


def _up_row(other_root):
    """The Up stage's row: its turns (other, this, this, other) each in a
    process of its own (``up_turn``); per part the speed-up (device), this
    build against cuDNN's chain, and the rel-L2 of this build's output
    against the other's."""
    import chip_smoke
    parts = [part for part, _, _ in up_parts()]
    got, outs = _turns('--up-turn', 'up', other_root)
    row = dict(case='fused Up stage (#11), P=294')
    _mean_turns(row, got, parts)
    row['speedups'] = {part: _ratio(row['other'][part]['device_ms'],
                                    row['this'][part]['device_ms'])
                       for part in parts}
    row['vs_cudnn'] = {part: _ratio(row['this'][part]['device_ms'],
                                    row[f'library {part}']['device_ms'])
                       for part in parts}
    row['rel_l2'] = {part: chip_smoke._rel_l2(outs['this'][part],
                                              outs['other'][part])
                     for part in parts}
    return row


def run(other_root):
    """One dict per case: each build's event and device times of each part
    (the tail, the input half and the whole backward; or passes A, B, C
    and the whole banded backward), the library's, ``speedup``,
    ``speedups``, ``vs_cudnn`` and ``rel_l2``."""
    import chip_smoke
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    other_fd = load_other(other_root)[0]
    timers = dict(event_ms=lambda f: chip_smoke.cuda_ms(f, 5),
                  device_ms=lambda f: chip_smoke.device_ms(f, 5))
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, b, n, h, c, ups, skips in CASES:
        mods, params, acts, g = _case(gen, device, b, n, h, c, ups, skips)
        made = {k: calls(fd, acts, params, g) for k, fd in (
            ('this', fused_decoder), ('other', other_fd))}
        xs = [t.detach().requires_grad_(True) for t in acts]
        prms = [t for d in params for t in d.values()]
        out = chip_smoke._cudnn_chain(*mods, *xs)
        row = dict(case=name, planes=b * n, base=h, **_timed(
            made, ('tail', 'input', 'whole'), timers, dict(
                cudnn=lambda: torch.autograd.grad(out, xs + prms, g,
                                                  retain_graph=True))))
        _ratios(row, ('tail', 'input', 'whole'), made)
        rows.append(row)
        del made, out
        torch.cuda.empty_cache()
    for case in BANDED_CASES:
        rows.append(_banded_row(case, other_root))
    for case in CASES + BANDED_CASES:
        rows.append(_fwd_row(case, other_root))
    rows.append(_up_row(other_root))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('other', nargs='?',
                    help='root of another checkout to time against')
    ap.add_argument('--banded-turn', help=argparse.SUPPRESS)
    ap.add_argument('--up-turn', help=argparse.SUPPRESS)
    ap.add_argument('--fwd-turn', help=argparse.SUPPRESS)
    ap.add_argument('--root', help=argparse.SUPPRESS)
    ap.add_argument('--save', help=argparse.SUPPRESS)
    ap.add_argument('--library', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.banded_turn:   # one turn of a banded case (_banded_row)
        case = json.loads(args.banded_turn)
        case = tuple(tuple(v) if isinstance(v, list) else v for v in case)
        torch.save(banded_turn(case, args.root, args.library), args.save)
        return None
    if args.up_turn:   # one turn of the Up stage (_up_row)
        torch.save(up_turn(args.root, args.library), args.save)
        return None
    if args.fwd_turn:   # one turn of the forward (_fwd_row)
        case = json.loads(args.fwd_turn)
        case = tuple(tuple(v) if isinstance(v, list) else v for v in case)
        torch.save(fwd_turn(case, args.root, args.library), args.save)
        return None
    if args.other is None:
        ap.error('the root of another checkout is required')
    rows = run(args.other)

    def num(x, spec='.4f'):
        return 'n/a' if x is None else format(x, spec)

    for r in rows:
        if r.get('kind') == 'forward':
            for part, sp in r['speedups'].items():
                print(f'decoder fwd {r["case"]} {part}: this event '
                      f'{num(r["this"][part]["event_ms"])} device '
                      f'{num(r["this"][part]["device_ms"])}, other event '
                      f'{num(r["other"][part]["event_ms"])} device '
                      f'{num(r["other"][part]["device_ms"])}, speed-up '
                      f'{num(sp, ".2f")}x; cudnn device '
                      f'{num(r["library " + part]["device_ms"])}, vs cudnn '
                      f'{num(r["vs_cudnn"][part], ".2f")}x', flush=True)
            print(f'decoder fwd {r["case"]}: rel-L2 of the logits vs other '
                  f'{r["rel_l2"]:.2e}', flush=True)
            continue
        if 'kernels ' + next(iter(r['speedups'])) in r:   # the Up stage
            for part, s in r['speedups'].items():
                print(f'fused up {part}: this event '
                      f'{num(r["this"][part]["event_ms"])} device '
                      f'{num(r["this"][part]["device_ms"])}, other event '
                      f'{num(r["other"][part]["event_ms"])} device '
                      f'{num(r["other"][part]["device_ms"])}, speed-up '
                      f'{num(s, ".2f")}x; cudnn device '
                      f'{num(r["library " + part]["device_ms"])}, vs cudnn '
                      f'{num(r["vs_cudnn"][part], ".2f")}x; rel-L2 vs other '
                      f'{r["rel_l2"][part]:.2e}', flush=True)
            continue
        parts = '; '.join(
            f'{part}: this event {num(r["this"][part]["event_ms"])} device '
            f'{num(r["this"][part]["device_ms"])}, other event '
            f'{num(r["other"][part]["event_ms"])} device '
            f'{num(r["other"][part]["device_ms"])}, speed-up '
            f'{num(r["speedups"][part], ".2f")}x'
            + (f', library device {num(r["library_" + part]["device_ms"])}'
               if 'library_' + part in r else '')
            for part in r['speedups'])
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
