"""Times the fused Up-stage kernel against the plain Up chain and cuDNN's.

The port's counterpart of ``semivl_tpu/tools/fused_up_bench.py``: the
flagship decoder's two Up stages at 14 decoder images x 21 class planes
(up1: x (294, 128, 32, 32), skip (14, 32, 64, 64), Cout 64; up2: x (294,
64, 64, 64), skip (14, 16, 128, 128), Cout 32), bf16, seeded random
weights and inputs, one line per stage:

    up1: plain   X ms   fused   Y ms   speedup Z.ZZx   mean|err| E (signal S)   cudnn C ms

``plain`` is the port's ``Up`` chain (``fused_up_stage_plain``), ``fused``
the kernel (``ops.fused_up.fused_up_stage``), ``cudnn`` the same stage as
cuDNN's transpose conv and convolutions over the skip concatenated to every
plane; mean|err| is the fused output against the plain one, signal the
plain output's mean magnitude. Times are CUDA-event means after warm-up.
It runs on the card and raises without one; ``--device cpu`` runs it on
the CPU, where ``fused`` is the plain version too (no kernel runs there).

    python -m semivl_tpu_torch.tools.fused_up_bench [--device cpu]
"""

import argparse
import time

import torch
import torch.nn.functional as F

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.ops import fused_decoder
from semivl_tpu_torch.ops.fused_up import fused_up_stage, fused_up_stage_plain

# (name, h, Cin, Cs, Cout): the input grid side and the stage's channels
STAGES = (('up1', 32, 128, 32, 64), ('up2', 64, 64, 16, 32))


def make_stage(h, cin, cs, cout, batch=14, classes=21, device='cuda',
               seed=0, dtype=torch.bfloat16, cu=None):
    """Seeded inputs and weights of one stage: x (batch * classes, Cin, h,
    h), skip (batch, Cs, 2h, 2h) in ``dtype``; the stage dict (float32)
    with torch's default conv bounds, biases N(0, 0.1^2) and GroupNorm
    scales 1 + N(0, 0.1^2). The up channels Cu are Cin - Cs (the VLG
    stages) unless given."""
    gen = torch.Generator().manual_seed(seed)
    cu = cin - cs if cu is None else cu

    def u(*shape):
        bound = torch.Size(shape[1:]).numel() ** -0.5
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    def n(c, mean):
        return mean + 0.1 * torch.randn(c, generator=gen)

    p = dict(up_weight=u(cin, cu, 2, 2), up_bias=n(cu, 0.0),
             conv1_weight=u(cout, cu + cs, 3, 3), gn1_weight=n(cout, 1.0),
             gn1_bias=n(cout, 0.0), conv2_weight=u(cout, cout, 3, 3),
             gn2_weight=n(cout, 1.0), gn2_bias=n(cout, 0.0))
    x = torch.randn(batch * classes, cin, h, h, generator=gen)
    skip = torch.randn(batch, cs, 2 * h, 2 * h, generator=gen)
    return (x.to(device, dtype), skip.to(device, dtype),
            {k: v.to(device) for k, v in p.items()})


def cudnn_stage(x, skip, p):
    """The stage as one library call per op: cuDNN's transpose conv, the
    skip repeated over each image's planes and concatenated, cuDNN's
    convolutions, GroupNorm with float32 statistics."""
    dt = x.dtype
    y = F.conv_transpose2d(x, p['up_weight'].to(dt), p['up_bias'].to(dt),
                           stride=2)
    y = torch.cat([y, skip.repeat_interleave(x.shape[0] // skip.shape[0],
                                             dim=0)], dim=1)
    for i in (1, 2):
        y = F.conv2d(y, p[f'conv{i}_weight'].to(dt), padding=1)
        y = fused_decoder.gn_relu(y, p[f'gn{i}_weight'], p[f'gn{i}_bias'])
    return y


def time_ms(fn, device, iters=20, warmup=3):
    """Mean ms of ``fn()`` after warm-up: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


@torch.no_grad()
def run(device=None, batch=14, classes=21, iters=20, warmup=3, seed=0):
    """Both stages: a dict per stage with plain_ms, fused_ms, speedup,
    mean_err, signal, cudnn_ms and fused_calls (the calls of
    ``fused_up_stage`` made)."""
    device = resolve_device(device)
    rows = []
    for i, (name, h, cin, cs, cout) in enumerate(STAGES):
        x, skip, p = make_stage(h, cin, cs, cout, batch, classes, device,
                                seed + i)
        plain_ms = time_ms(lambda: fused_up_stage_plain(x, skip, p), device,
                           iters, warmup)
        fused_ms = time_ms(lambda: fused_up_stage(x, skip, p), device,
                           iters, warmup)
        cudnn_ms = time_ms(lambda: cudnn_stage(x, skip, p), device, iters,
                           warmup)
        ref = fused_up_stage_plain(x, skip, p).float()
        out = fused_up_stage(x, skip, p).float()
        rows.append(dict(
            name=name, plain_ms=plain_ms, fused_ms=fused_ms,
            speedup=plain_ms / fused_ms, cudnn_ms=cudnn_ms,
            mean_err=(out - ref).abs().mean().item(),
            signal=ref.abs().mean().item(), fused_calls=iters + warmup + 1,
            shape=f'x {tuple(x.shape)} skip {tuple(skip.shape)} Cout {cout}'))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help='cuda (the default) or cpu')
    ap.add_argument('--batch', type=int, default=14,
                    help='decoder images (planes = batch x classes)')
    ap.add_argument('--classes', type=int, default=21)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    rows = run(args.device, args.batch, args.classes, args.iters)
    for r in rows:
        print(f'{r["name"]}: plain {r["plain_ms"]:7.3f} ms   fused '
              f'{r["fused_ms"]:7.3f} ms   speedup {r["speedup"]:4.2f}x   '
              f'mean|err| {r["mean_err"]:.4f} (signal {r["signal"]:.3f})   '
              f'cudnn {r["cudnn_ms"]:7.3f} ms', flush=True)
    return rows


if __name__ == '__main__':
    main()
