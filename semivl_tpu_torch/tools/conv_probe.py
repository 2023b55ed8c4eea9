"""Probes what bounds ``csrc/decoder_igemm.cuh``'s 3x3 conv kernel on the
card: ``igemm::conv<N, 9>`` alone (a bf16 output with GroupNorm partials,
the shape of the Up stage's convs) at the fused Up stage's shapes (up1, up2
at 14 x 21 planes) and the Cityscapes decoder's (P = 57 on 102^2 and
204^2), timed by CUDA events in three builds of the header:

- ``built``: the header as it is;
- ``no_products``: the same kernel without its wgmma products (the loads,
  the barriers and the epilogue remain);
- ``no_epilogue``: without the epilogue's stores and sums (the loads and
  the products remain);

and the column-shift copies of the source (``shifted_source``). Where the
time falls in the probe builds tells what holds the kernel back. The
probe builds are made from copies of the header in a temporary directory;
nothing of the package is changed. It needs the card and ``nvcc``:

    python -m semivl_tpu_torch.tools.conv_probe
"""

import json
import os
import re
import shutil
import subprocess
import tempfile

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.ops import _build

# (name, N, C, P, H, W, rep): output and input channels, planes, plane
# size; rep > 0: a float32 addend per image of rep planes (conv1's skip
# half, added in the up half's epilogue)
CASES = (('up2 conv2', 32, 32, 294, 128, 128, 0),
         ('up2 conv1, up half', 32, 48, 294, 128, 128, 0),
         ('up2 conv1, up half + skip addend', 32, 48, 294, 128, 128, 21),
         ('up1 conv2', 64, 64, 294, 64, 64, 0),
         ('up1 conv1, up half', 64, 96, 294, 64, 64, 0),
         ('up1 conv1, up half + skip addend', 64, 96, 294, 64, 64, 21),
         ('Cityscapes stage 2 conv2', 32, 32, 57, 204, 204, 0),
         ('Cityscapes stage 1 conv2', 64, 64, 57, 102, 102, 0))

_PRODUCTS = re.compile(r'(\n( *)if \(a\.kc == 64\) conv_step<.*?\n.*?\n.*?'
                       r'conv_step<N, 1, NDY>[^\n]*\n)', re.S)
_EPILOGUE = re.compile(r'\n( *)(conv_epilogue<N>\(a, acc, [^\n]*\);)\n')

_PROBE_MAIN = r'''
#include <cstdio>
#include "decoder_igemm.cuh"
using namespace igemm;

__global__ void fill(bf16* p, size_t n, float s) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i < n) p[i] = __float2bfloat16(s * (float)((i * 2654435761u) % 1000) / 1000.f - 0.5f * s);
}

template <int N>
void run(int id, int P, int C, int H, int W, int rep) {
  const size_t n = (size_t)P * C * H * W;
  const int tiles = ((H + CONV_ROWS - 1) / CONV_ROWS) * ((W + TW - 1) / TW);
  bf16 *src, *scr, *w, *out;
  float *part, *add = nullptr;
  if (rep > 0) {
    cudaMalloc(&add, (size_t)(P / rep) * N * H * W * 4);
    cudaMemset(add, 0, (size_t)(P / rep) * N * H * W * 4);
  }
  cudaMalloc(&src, n * 2);
  cudaMalloc(&scr, 3 * (size_t)P * C * H * tma_pitch(W) * 2);
  cudaMalloc(&w, 9 * N * C * 2);
  cudaMalloc(&out, (size_t)P * N * H * W * 2);
  cudaMalloc(&part, (size_t)P * (N / 16) * tiles * 2 * 4);
  fill<<<(unsigned)((n + 255) / 256), 256>>>(src, n, 2.f);
  fill<<<(9 * N * C + 255) / 256, 256>>>(w, 9 * N * C, 0.1f);
  const Planes s = shifted_source(src, P, C, H, W, scr, 0);
  Epi e{};
  e.mode = EPI_BF16;
  e.out = out;
  e.gn_part = part;
  e.add = add;
  e.add_rep = rep > 0 ? rep : 1;
  int err = 0;
  for (int i = 0; i < 3; ++i) err |= conv<N, 9>(s, w, 1, e, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 10;
  cudaEventRecord(e0);
  for (int i = 0; i < iters; ++i) conv<N, 9>(s, w, 1, e, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float conv_ms, shift_ms;
  cudaEventElapsedTime(&conv_ms, e0, e1);
  cudaEventRecord(e0);
  for (int i = 0; i < iters; ++i) shifted_source(src, P, C, H, W, scr, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(&shift_ms, e0, e1);
  const int last = (int)cudaGetLastError();
  printf("case %d %d %d %.6f %.6f\n", id, err, last, conv_ms / iters, shift_ms / iters);
  cudaFree(src); cudaFree(scr); cudaFree(w); cudaFree(out); cudaFree(part); cudaFree(add);
}

int main() {
%s
  return 0;
}
'''


def _variant(header, what):
    """The header's text with the products or the epilogue compiled out."""
    if what == 'no_products':
        new, n = _PRODUCTS.subn(lambda m: '\n#if 0' + m.group(1) + '#endif\n',
                                header, count=1)
    else:   # keep the products live: the accumulators feed a dead branch
        new, n = _EPILOGUE.subn(
            lambda m: f'\n{m.group(1)}if (acc[0][0] == 12345.f) '
                      f'{m.group(2)}\n', header, count=1)
    if n != 1:
        raise RuntimeError(f'conv_probe: the {what} anchor is not in '
                           'decoder_igemm.cuh')
    return new


def run():
    """{variant: {case: (conv ms, shift copies ms)}} for the three builds."""
    resolve_device(None)
    with open(os.path.join(_build.CSRC, 'decoder_igemm.cuh')) as f:
        header = f.read()
    calls = '\n'.join(f'  run<{n}>({i}, {p}, {c}, {h}, {w}, {r});'
                      for i, (_, n, c, p, h, w, r) in enumerate(CASES))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for what in ('built', 'no_products', 'no_epilogue'):
            d = os.path.join(tmp, what)
            os.makedirs(d)
            shutil.copy(os.path.join(_build.CSRC, 'hopper_common.cuh'), d)
            with open(os.path.join(d, 'decoder_igemm.cuh'), 'w') as f:
                f.write(header if what == 'built' else _variant(header, what))
            with open(os.path.join(d, 'probe.cu'), 'w') as f:
                f.write(_PROBE_MAIN.replace('%s', calls))
            cmd = [_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
                   '-std=c++17', '-O3', '-o', os.path.join(d, 'probe'),
                   os.path.join(d, 'probe.cu')]
            procs[what] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)
        for what, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f'nvcc failed for the {what} probe:\n{log}')
        for what in procs:
            res = subprocess.run([os.path.join(tmp, what, 'probe')],
                                 capture_output=True, text=True, check=True,
                                 timeout=300).stdout
            out[what] = {}
            for line in res.splitlines():
                _, i, err, last, conv_ms, shift_ms = line.split()
                if int(err) or int(last):
                    raise RuntimeError(f'{what} probe, {CASES[int(i)][0]}: '
                                       f'CUDA error {err} / {last}')
                out[what][CASES[int(i)][0]] = (float(conv_ms),
                                               float(shift_ms))
    return out


def main():
    out = run()
    rows = []
    for name, n, c, p, h, w, _ in CASES:
        flops = 2.0 * p * h * w * 9 * c * n
        row = dict(case=name, N=n, C=c, P=p, H=h, W=w, gflop=flops / 1e9,
                   shift_copies_ms=out['built'][name][1])
        for what in out:
            row[f'{what}_ms'] = out[what][name][0]
        row['tflops'] = flops / row['built_ms'] / 1e9
        rows.append(row)
        print(f'{name} (N={n}, C={c}, P={p}, {h}x{w}): built '
              f'{row["built_ms"]:.4f} ms ({row["tflops"]:.1f} TFLOP/s), '
              f'no products {row["no_products_ms"]:.4f}, no epilogue '
              f'{row["no_epilogue_ms"]:.4f}, shift copies '
              f'{row["shift_copies_ms"]:.4f} ms', flush=True)
    print(json.dumps(dict(cases=rows)), flush=True)
    return rows


if __name__ == '__main__':
    main()
