#!/usr/bin/env python3
"""Drive the PyTorch port (``semivl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. identify the card (torch/CUDA versions, name and power limit);
2. build the CUDA kernels from ``semivl_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) into the ignored ``semivl_tpu_torch/_build``;
3. packed attention kernel against its plain version at the flagship
   shapes (encoder and semantic transformer, and a ``valid_len`` case);
4. fused VLG decoder kernel against its plain version at the flagship
   decoder shapes;
5. the slice: the full-width flagship model (ViT-B/16 + VLG, VOC-21, bf16
   compute, seeded random weights) evaluated with ``zegclip_sliding_window``
   over synthetic uint8 images at VOC val geometry, with the launch counts
   of both kernels read around that run; then one crop batch through the
   kernels and through the plain versions;
6. a ``kernels`` JSON line, and last ``{"ok": true, "device": ...}``.

Comparisons run with TF32 off. Times are CUDA-event means after warm-up.
"""

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
ATTN_TOL = 2e-2             # bf16 output, p rounded at other points
DEC_TOL = 5e-2              # relative to the logit scale, bf16 storage


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


# ------------------------------------------------------------ phase 3

def check_attention(gen):
    import torch.nn.functional as F
    from semivl_tpu_torch.ops import flash_attention as fa
    rows = []
    for name, b, length, heads, valid in (
            ('encoder', 2, 1025, 12, None), ('semantic', 128, 21, 4, None),
            ('encoder valid_len', 2, 1025, 12, 1000)):
        c = 64 * heads
        qkv = torch.randn(b, length, 3 * c, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        got = fa.flash_mha(q, k, v, heads, valid_len=valid)
        want = fa.flash_mha_plain(q, k, v, heads, valid)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: fa.flash_mha(q, k, v, heads, valid_len=valid))
        plain_ms = cuda_ms(lambda: fa.flash_mha_plain(q, k, v, heads, valid))
        qh, kh, vh = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                      for t in (q, k, v))
        mask = None
        if valid is not None:
            mask = (torch.arange(length, device='cuda') < valid).view(
                1, 1, 1, length)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        keys = valid or length
        flops = 4 * b * heads * length * keys * 64
        nbytes = 4 * b * length * c * 2
        bound_ms, by = bound(flops, nbytes)
        log(f'attention {name} ({b}, {length}, {c})/{heads}: max_abs_err '
            f'{err:.3e} (tol {ATTN_TOL}) kernel_ms {ms:.4f} plain_ms '
            f'{plain_ms:.4f} sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} '
            f'({by}) TFLOP/s {flops / ms / 1e9:.1f}')
        assert err <= ATTN_TOL, (name, err)
        rows.append(dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by))
    return rows


# ------------------------------------------------------------ phase 4

def _random_decoder(gen, channels=128, ups=(64, 32), skips=(32, 16)):
    from semivl_tpu_torch.models.vlg_head import Up
    up1 = Up(channels, ups[0], skips[0])
    up2 = Up(ups[0], ups[1], skips[1])
    head = torch.nn.Conv2d(ups[1], 1, 3, padding=1)
    with torch.no_grad():
        for m in (up1, up2, head):
            for name, p in m.named_parameters():
                if p.ndim >= 2:
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                            / p[0].numel() ** 0.5)
                elif name.endswith('bias'):
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))
                else:   # GroupNorm scales
                    p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return up1.cuda(), up2.cuda(), head.cuda()


def _decoder_flops(p, c, h, w, cs, cu, c1, c2, b):
    hw2, hw4 = 4 * h * w, 16 * h * w
    s1 = 2 * p * hw2 * (cu[0] * c + 9 * c1 * (cu[0] + c1)) \
        + 2 * b * hw2 * 9 * c1 * cs[0]
    s2 = 2 * p * hw4 * (cu[1] * c1 + 9 * c2 * (cu[1] + c2) + 9 * c2) \
        + 2 * b * hw4 * 9 * c2 * cs[1]
    return s1 + s2


def check_decoder(gen):
    import torch.nn.functional as F
    from semivl_tpu_torch.ops import fused_decoder as fd
    b, n, c, h = 2, 21, 128, 32
    p = b * n
    up1, up2, head = _random_decoder(gen)
    x = torch.randn(p, c, h, h, generator=gen).cuda().bfloat16()
    s1 = torch.randn(b, 32, 2 * h, 2 * h, generator=gen).cuda().bfloat16()
    s2 = torch.randn(b, 16, 4 * h, 4 * h, generator=gen).cuda().bfloat16()
    p1, p2 = up1.stage_params(), up2.stage_params()
    hp = dict(weight=head.weight, bias=head.bias)
    got = fd.fused_vlg_decoder(x, s1, s2, p1, p2, hp)
    want = fd.fused_vlg_decoder_plain(x, s1, s2, p1, p2, hp)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (p, 1, 4 * h, 4 * h)
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    err = diff.max().item()
    ms = cuda_ms(lambda: fd.fused_vlg_decoder(x, s1, s2, p1, p2, hp), 10)
    plain_ms = cuda_ms(
        lambda: fd.fused_vlg_decoder_plain(x, s1, s2, p1, p2, hp), 10)

    def cudnn_chain():
        y = x
        for up, skip in ((up1, s1), (up2, s2)):
            dt = y.dtype
            t = F.conv_transpose2d(y, up.up.weight.to(dt), up.up.bias.to(dt),
                                   stride=2)
            sk = skip.repeat_interleave(y.shape[0] // skip.shape[0], dim=0)
            y = torch.cat([t, sk], dim=1)
            for i in (0, 3):
                y = F.conv2d(y, up.conv[i].weight.to(dt), padding=1)
                gn = up.conv[i + 1]
                y = F.relu(F.group_norm(y.float(), gn.num_groups, gn.weight,
                                        gn.bias)).to(dt)
        return F.conv2d(y, head.weight.to(y.dtype), head.bias.to(y.dtype),
                        padding=1)

    lib_ms = cuda_ms(cudnn_chain, 10)
    flops = _decoder_flops(p, c, h, h, (32, 16), (96, 48), 64, 32, b)
    nbytes = 2 * (x.numel() + s1.numel() + s2.numel() + got.numel())
    bound_ms, by = bound(flops, nbytes)
    log(f'decoder x {tuple(x.shape)} skips {tuple(s1.shape)} '
        f'{tuple(s2.shape)}: max_abs_err {err:.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} (tol {DEC_TOL} x '
        f'scale) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} cudnn_ms '
        f'{lib_ms:.4f} bound_ms {bound_ms:.4f} ({by}) GFLOP {flops / 1e9:.2f}')
    assert err <= DEC_TOL * max(scale, 1.0), (err, scale)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by)


# ------------------------------------------------------------ phase 5

class SynthVOC:
    """uint8 images at VOC val geometry (short side 512) with label maps."""

    def __init__(self, seed, sizes=((512, 683), (683, 512), (512, 512),
                                    (512, 768))):
        rs = np.random.RandomState(seed)
        self.items = []
        for h, w in sizes:
            img = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
            mask = rs.randint(0, 21, (h, w)).astype(np.uint8)
            mask[:8] = 255
            self.items.append({'img': img, 'mask': mask})

    def __len__(self):
        return len(self.items)

    def get(self, i):
        return self.items[i]


def run_slice():
    from semivl_tpu_torch.configs import flagship_cfg
    from semivl_tpu_torch.evaluation.predict import (
        Evaluator, _chunk_sizes, evaluate)
    from semivl_tpu_torch.models.builder import build_model
    from semivl_tpu_torch.ops import flash_attention as fa
    from semivl_tpu_torch.ops import fused_decoder as fd

    cfg = flagship_cfg(512)
    t0 = time.perf_counter()
    bundle = build_model(cfg, dtype=torch.bfloat16, device='cuda', seed=0)
    model = bundle.model
    with torch.no_grad():   # weight scales that keep 12 layers finite
        for mod, s in ((model.backbone, 0.05), (model.decode_head, 0.2)):
            for prm in mod.parameters():
                if prm.ndim >= 2:
                    prm.mul_(s)
    evaluator = Evaluator(model, bundle.text_feats, cfg, device='cuda')
    ds = SynthVOC(seed=0)
    log(f'slice: built flagship model in {time.perf_counter() - t0:.1f} s, '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params')

    # warm-up pass, which also checks every prediction
    for i in range(len(ds)):
        s = ds.get(i)
        pred = evaluator.predict(s['img'][None], s['mask'].shape,
                                 cfg['eval_mode'])
        assert pred.shape == (1,) + s['mask'].shape, pred.shape
        assert 0 <= pred.min() and pred.max() < cfg['nclass']
    n_crops = n_batches = 0
    for i in range(len(ds)):
        coords = evaluator._zegclip_coords(*ds.get(i)['img'].shape[:2])
        n_crops += len(coords)
        n_batches += len(_chunk_sizes(len(coords)))

    # the main path: counts to 0, evaluate, counts read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fd.launches = 0
    t0 = time.perf_counter()
    miou, iou = evaluate(evaluator, ds, cfg['eval_mode'], cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {'attention': fa.launches, 'decoder': fd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f'slice: evaluate over {len(ds)} images, {n_crops} crops in '
        f'{n_batches} crop batches: mIoU {miou:.4f} in {dt * 1e3:.1f} ms -> '
        f'{dt * 1e3 / n_crops:.2f} ms per 512^2 crop, '
        f'{len(ds) / dt:.3f} images/s, peak memory {peak / 2**20:.1f} MiB')
    log(f'slice: launches {launches} (expected {14 * n_batches} and '
        f'{2 * n_batches})')
    assert np.isfinite(miou) and 0 <= miou <= 100 and iou.shape == (21,)
    assert launches['attention'] == 14 * n_batches, launches
    assert launches['decoder'] == 2 * n_batches, launches

    # one crop batch through the kernels and through the plain versions
    s = ds.get(0)
    img = torch.from_numpy(s['img']).cuda()
    crops = torch.stack([img[y:y + 512, x:x + 512] for y, x in
                         evaluator._zegclip_coords(*s['img'].shape[:2])])
    with torch.no_grad():
        inp = evaluator._to_model_input(crops)
        k_logits = model(inp, evaluator.text)
        with mock.patch.object(fa, 'flash_mha', fa.flash_mha_plain), \
                mock.patch.object(fd, 'fused_vlg_decoder',
                                  fd.fused_vlg_decoder_plain):
            p_logits = model(inp, evaluator.text)
    torch.cuda.synchronize()
    assert k_logits.shape == (crops.shape[0], 21, 512, 512)
    assert torch.isfinite(k_logits).all()
    diff = (k_logits - p_logits).abs()
    scale = p_logits.abs().max().item()
    agree = (k_logits.argmax(1) == p_logits.argmax(1)).float().mean().item()
    log(f'slice: crop batch {tuple(crops.shape)} kernels vs plain: '
        f'max_abs_err {diff.max().item():.3e} mean_abs_err '
        f'{diff.mean().item():.3e} logit scale {scale:.3f} argmax agreement '
        f'{agree:.5f}')
    assert diff.max().item() <= DEC_TOL * scale
    profile_image(evaluator, ds.get(0), cfg)
    return launches


def profile_image(evaluator, sample, cfg, top=12):
    """Device time by kernel for one image (2 crops), against the
    unprofiled wall time of the same call: the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        evaluator.predict(sample['img'][None], sample['mask'].shape,
                          cfg['eval_mode'])
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    # device-side events only (an op's own entry repeats its kernels' time)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    dev_ms = sum(r[0] for r in rows)
    log(f'profile: one {sample["img"].shape[:2]} image: wall {wall_ms:.2f} ms '
        f'(unprofiled), device busy {dev_ms:.2f} ms, idle share '
        f'{1 - dev_ms / wall_ms:.3f}')
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f'profile:   {ms:8.3f} ms {100 * ms / dev_ms:5.1f}% x{count:<5d} '
            f'{key[:90]}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    from semivl_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(f'card: {card}')
    log(f'build: kernels built in {_build.build_all():.1f} s')
    gen = torch.Generator(device='cuda').manual_seed(0)
    attn = check_attention(gen)
    dec = check_decoder(torch.Generator().manual_seed(1))
    launches = run_slice()
    enc = attn[0]
    kernels = [
        dict(name='packed_attention_fwd', route='cuda',
             source='semivl_tpu_torch/csrc/flash_attention.cu',
             replaces='semivl_tpu/ops/flash_attention.py:328',
             launches=launches['attention'], shape='(2, 1025, 768) 12 heads',
             **{k: enc[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                    'bound_ms', 'bound_by', 'library_ms')}),
        dict(name='decoder_stage_fwd', route='cuda',
             source='semivl_tpu_torch/csrc/fused_decoder.cu',
             replaces='semivl_tpu/ops/fused_decoder.py:459',
             launches=launches['decoder'],
             shape='fused_vlg_decoder call (2 stage launches), P=42',
             **{k: dec[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                    'bound_ms', 'bound_by', 'library_ms')}),
    ]
    log(json.dumps({'kernels': kernels}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
