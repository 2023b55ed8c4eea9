"""How exactly the decoder's tensor-core sequence rounds, on the card.

Two readings, at the flagship stage-1 widths (Cin 128, Cu 96, Cs 32, Cout
64; stage 2: 64, 48, 16, 32):

- per product of the forward's sequence (``fused_decoder._stage``: the
  transpose conv, conv1 with its skip half, GN1+ReLU, conv2), the share of
  its bf16 outputs whose rounding differs from that of the same product
  summed in float64 and in float32 (cuDNN, TF32 off) on the very inputs
  the kernel stored; and the same share between float32 and float64 sums;
- both decoder backward routes' gradients (``fused_vlg_decoder`` under
  autograd, whole-plane and banded) against ``fused_vlg_decoder_rounded``
  with float64 sums at the point the forward reached (stage 1's raw conv2
  as ``_stage`` stored it, ``raw2_1``: chip_smoke's DEC_BWD_TOL) and with
  float64 sums recomputing stage 1 (forward and backward composed:
  DEC_BWD_COMPOSED_TOL), per case and seed: the worst leaf's relative L2
  and that of x; the float32-sum reference's own distance to the float64
  one (a sound computation at lower precision: the control of the
  composed limit); and, on each case's first seed, the composed reading
  of chip_smoke's planted forward faults of stage 1, which that limit
  must catch.

GroupNorm after each conv amplifies every flipped rounding, so these are
the readings behind the decoder's limits. Run it from the repository's
root:

    python -m semivl_tpu_torch.tools.decoder_precision
"""

import json
from unittest import mock

import torch
import torch.nn.functional as F

from semivl_tpu_torch.ops import fused_decoder as fd

# (images, planes per image, base grid, skip widths, seeds) of the
# backward readings: a ragged grid, the flagship's P = 42, the Cityscapes
# P = 57 on 51^2 (phase 4's banded case)
BWD_CASES = ((1, 3, 13, (32, 16), tuple(range(8))),
             (2, 21, 32, (32, 16), (0, 1, 2, 3)),
             (3, 19, 51, (32, 32), (0, 1, 2)))


def _round(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _flips(a, b):
    return (a.double() != b.double()).double().mean().item()


def _case(seed, b, n, h, skips=(32, 16)):
    import chip_smoke
    gen = torch.Generator().manual_seed(seed)
    up1, up2, head = chip_smoke._random_decoder(gen, skips=skips)
    params = [up1.stage_params(), up2.stage_params(),
              dict(weight=head.weight, bias=head.bias)]
    acts = [torch.randn(b * n, 128, h, h, generator=gen),
            torch.randn(b, skips[0], 2 * h, 2 * h, generator=gen),
            torch.randn(b, skips[1], 4 * h, 4 * h, generator=gen)]
    g = torch.randn(b * n, 1, 4 * h, 4 * h, generator=gen)
    return params, [t.cuda().bfloat16() for t in acts], g.cuda().bfloat16()


def forward_flips(seed=0, b=2, n=21, h=32):
    """{product: {'float64': share, 'float32': share}} of the forward's
    stage 1, and 'float32 vs float64' of the same sums."""
    params, (x, s1, _), _ = _case(seed, b, n, h)
    p = params[0]
    made = []
    real = fd.stage_tensors

    def tensors(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    with torch.no_grad(), mock.patch.object(fd, 'stage_tensors', tensors):
        fd._stage(x, s1, p)
    t = made[0]
    w = {k: p[k].detach().to(torch.bfloat16) for k in (
        'up_weight', 'conv1_weight', 'conv2_weight')}
    cu = w['up_weight'].shape[1]
    sums = {}
    with torch.no_grad():
        for dt in (torch.float64, torch.float32):
            up = _round(fd.conv_transpose_2x2(
                x.to(dt), w['up_weight'].to(dt),
                p['up_bias'].detach().to(torch.bfloat16).to(dt)))
            ym = F.conv2d(t['up'].to(dt), w['conv1_weight'][:, :cu].to(dt),
                          padding=1)
            ys = F.conv2d(s1.to(dt), w['conv1_weight'][:, cu:].to(dt),
                          padding=1)
            raw1 = _round((ym.unflatten(0, (b, -1)) + ys[:, None]).flatten(
                0, 1))
            a1 = _round(F.relu(F.group_norm(
                t['c1'].to(dt), raw1.shape[1] // 16,
                p['gn1_weight'].detach().to(dt),
                p['gn1_bias'].detach().to(dt), eps=1e-5)))
            raw2 = _round(F.conv2d(t['a1'].to(dt),
                                   w['conv2_weight'].to(dt), padding=1))
            sums[dt] = dict(up=up, raw1=raw1, a1=a1, raw2=raw2)
    kernel = dict(up=t['up'], raw1=t['c1'], a1=t['a1'], raw2=t['c2'])
    out = {k: {'float64': _flips(v, sums[torch.float64][k]),
               'float32': _flips(v, sums[torch.float32][k])}
           for k, v in kernel.items()}
    out['float32 vs float64'] = {
        k: _flips(sums[torch.float32][k], sums[torch.float64][k])
        for k in kernel}
    return out


def backward_distances():
    """One dict per (case, seed): each route's worst leaf (relative L2)
    against the reference at the stored conv2 and the composed one, the
    float32-sum reference's against the float64 one, and on a case's first
    seed the composed readings of the planted forward faults."""
    import chip_smoke
    names = chip_smoke.decoder_leaves()
    rows = []
    for b, n, h, skips, seeds in BWD_CASES:
        for seed in seeds:
            params, acts, g = _case(seed, b, n, h, skips)
            at, composed = chip_smoke._held_refs(acts, params, g)
            ref32 = chip_smoke.decoder_grads(chip_smoke._rounded(), acts,
                                             params, g)
            row = dict(planes=b * n, base=h, seed=seed)
            for route in ('whole', 'banded'):
                def chain(*a, r=route):
                    return fd.fused_vlg_decoder(*a, bwd=r)
                got = chip_smoke.decoder_grads(chain, acts, params, g)
                row[route] = chip_smoke._gates(got, (at, composed), names)
                if seed == seeds[0]:
                    for what, planted in chip_smoke.FORWARD_FAULTS.items():
                        with planted():
                            bad = chip_smoke.decoder_grads(chain, acts,
                                                           params, g)
                        row[route][what] = chip_smoke._gates(
                            bad, (at, composed), names)['composed']
            row['control: float32 vs float64'] = chip_smoke._gates(
                ref32, (composed, composed), names)['composed']
            rows.append(row)
            print(f'backward P={row["planes"]} on {h}^2 seed {seed}: '
                  + json.dumps({k: v for k, v in row.items()
                                if k not in ('planes', 'base', 'seed')}),
                  flush=True)
    return rows


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flips = forward_flips()
    print('forward stage 1, share of flipped bf16 roundings: '
          + json.dumps({k: {s: float(f'{v:.2e}') for s, v in d.items()}
                        for k, d in flips.items()}), flush=True)
    rows = backward_distances()
    worst = {k: max(r[route][k] for r in rows for route in ('whole',
                                                            'banded'))
             for k in ('at_stored', 'composed')}
    worst['control'] = max(r['control: float32 vs float64'] for r in rows)
    worst['forward faults (least)'] = min(
        v for r in rows for route in ('whole', 'banded')
        for k, v in r[route].items() if k.startswith('stage 1'))
    print('worst over every case, seed and route: ' + json.dumps(worst),
          flush=True)
    print(json.dumps(dict(forward_flips=flips, backward=rows)), flush=True)


if __name__ == '__main__':
    main()
