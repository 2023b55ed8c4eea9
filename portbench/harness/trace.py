"""The traced window: spans marked from the benchmark's own files, one
profile of the device, and its reduction to what the per-layer readers
read.

Spans are ``record_function`` ranges. Forward spans come from hooks on
the port's model (the teacher, student 1 and student 2 calls of a step,
the guidance encoder) and the optimizer's step hooks; the attention entry
(``ops.attention.qkv_attention``) and the decoder entry
(``ops.fused_decoder.fused_vlg_decoder``) are wrapped for the traced run
only, forward in a range and backward between two identity autograd nodes
around the call. A kernel belongs to the innermost span open on its
launching thread when it was launched (the profiler's correlation of a
launch with its kernel); kernels launched outside every span by another
thread than the run's (the autograd engine's, the evaluator's prefetch)
belong to the span the cell names for it (``pb.step.backward``,
``pb.eval.prefetch``).
"""

import collections
import contextlib
import json
import os
import sys
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import counts

MAIN = 'host'


class _BwdSpan:
    def __init__(self, name):
        self.name, self.rf = name, None


class _Open(torch.autograd.Function):
    """Identity; its backward opens the span (the call's backward
    starts once the gradient of its output arrives)."""

    @staticmethod
    def forward(ctx, x, span):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.span.rf = record_function(ctx.span.name)
        ctx.span.rf.__enter__()
        return g, None


class _Close(torch.autograd.Function):
    """Identity on the call's input; its backward closes the span."""

    @staticmethod
    def forward(ctx, x, span):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.span.rf is not None:
            ctx.span.rf.__exit__(None, None, None)
            ctx.span.rf = None
        return g, None


class Spans:
    """Marks the traced run's spans and counts the work at the attention
    and decoder boundaries (operations, bytes and the roofline's time)."""

    def __init__(self, head_cfg):
        self.head_cfg = head_cfg
        self.bound_s = collections.Counter()
        self.model_calls = 0

    def _wrap(self, fn, what, work, needs_grad):
        def wrapped(*args, **kwargs):
            x = args[0]
            fwd = work(args, False)
            self.bound_s[what] += counts.bound_seconds(*fwd)
            if needs_grad(args) and torch.is_grad_enabled():
                self.bound_s[what] += counts.bound_seconds(*work(args, True))
                span = _BwdSpan(f'pb.{what}.bwd')
                args = (_Close.apply(x, span),) + tuple(args[1:])
                with record_function(f'pb.{what}.fwd'):
                    out = fn(*args, **kwargs)
                return _Open.apply(out, span)
            with record_function(f'pb.{what}.fwd'):
                return fn(*args, **kwargs)
        return wrapped

    def _attention_work(self, args, backward):
        b, length, c3 = args[0].shape
        return counts.attention_call(b, length, c3 // 3, backward)

    def _decoder_work(self, args, backward):
        x, skip1 = args[0], args[1]
        return counts.decoder_call(self.head_cfg, x.shape[0], skip1.shape[0],
                                   x.shape[2], x.shape[3], backward)

    @contextlib.contextmanager
    def installed(self, model, optimizer=None, step_names=()):
        """Wrap the two entries and hook the model (and the optimizer)
        while the traced window runs."""
        from semivl_tpu_torch.ops import attention, fused_decoder
        orig_attn = attention.qkv_attention
        orig_dec = fused_decoder.fused_vlg_decoder
        attention.qkv_attention = self._wrap(
            orig_attn, 'attention', self._attention_work,
            lambda a: a[0].requires_grad)
        fused_decoder.fused_vlg_decoder = self._wrap(
            orig_dec, 'decoder', self._decoder_work,
            lambda a: any(t.requires_grad for t in a[:3]))
        handles, open_rf = [], []

        def enter(name):
            rf = record_function(name)
            rf.__enter__()
            open_rf.append(rf)

        def leave(*_):
            open_rf.pop().__exit__(None, None, None)

        if step_names:
            def pre(*_):
                enter(step_names[self.model_calls % len(step_names)])
                self.model_calls += 1
            handles += [model.register_forward_pre_hook(pre),
                        model.register_forward_hook(leave)]
        if getattr(model, 'clip_encoder', None) is not None:
            handles += [model.clip_encoder.register_forward_pre_hook(
                lambda *_: enter('pb.step.guidance')),
                model.clip_encoder.register_forward_hook(leave)]
        if optimizer is not None:
            handles += [optimizer.register_step_pre_hook(
                lambda *_: enter('pb.step.optimizer')),
                optimizer.register_step_post_hook(leave)]
        try:
            yield self
        finally:
            attention.qkv_attention = orig_attn
            fused_decoder.fused_vlg_decoder = orig_dec
            for h in handles:
                h.remove()


class Reading:
    """What one traced window shows: device operations with their spans,
    the window's length and busy time, and the boundaries' counted work."""

    def __init__(self, kind, units, window_s, ops, launches, bound_s, flops):
        self.kind = kind            # 'train' or 'eval'
        self.units = units          # steps or images in the window
        self.window_s = window_s
        self.ops = ops              # [(name, start_us, dur_us, span)]
        self.launches = launches    # kernels (not copies or sets)
        self.bound_s = bound_s      # {'attention': s, 'decoder': s}
        self.flops = flops          # the model's operations in the window
        self.busy_s = _union_us([(s, d) for _, s, d, _ in ops]) / 1e6

    def kernel_s(self, *prefixes):
        """Device seconds of the operations whose span starts with one of
        ``prefixes``."""
        return sum(d for _, _, d, sp in self.ops
                   if sp.startswith(prefixes)) / 1e6

    def breakdown(self, top=10):
        by_name = collections.Counter()
        for name, _, d, _ in self.ops:
            by_name[name[:64]] += d / 1e6
        gaps = collections.Counter()
        ordered = sorted(self.ops, key=lambda o: o[1])
        end = None
        for name, s, d, sp in ordered:
            if end is not None and s > end:
                gaps[sp] += (s - end) / 1e6
            end = s + d if end is None else max(end, s + d)
        return {'device_ops': [[k, v] for k, v in by_name.most_common(top)],
                'idle_gaps': [[k, v] for k, v in gaps.most_common(top)]}


def _union_us(intervals):
    total, end = 0.0, None
    for s, d in sorted(intervals):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def _parse(path, main_tid, other_thread):
    """(device ops with spans, kernel count, whether every kernel launch
    has its device record) of a Chrome trace the profiler wrote. A kernel
    launched outside every span belongs to ``other_thread`` where another
    thread than ``main_tid`` launched it, else to the host."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    ranges = collections.defaultdict(list)    # tid -> [(ts, end, name)]
    launches = {}                              # correlation -> (tid, ts)
    device = []
    for e in events:
        cat = e.get('cat', '')
        if e.get('ph') != 'X':
            continue
        if cat == 'user_annotation' and e['name'].startswith('pb.'):
            ranges[e['tid']].append((e['ts'], e['ts'] + e['dur'], e['name']))
        elif cat in ('cuda_runtime', 'cuda_driver'):
            corr = e.get('args', {}).get('correlation')
            if corr is not None:
                launches[corr] = (e['tid'], e['ts'], e['name'])
        elif cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            device.append(e)
    for rs in ranges.values():
        rs.sort()
    ops, kernels, seen = [], 0, set()
    for e in device:
        corr = e.get('args', {}).get('correlation')
        seen.add(corr)
        tid, ts, _ = launches.get(corr, (None, None, None))
        span = MAIN
        if tid is not None:
            inner = [r for r in ranges.get(tid, ()) if r[0] <= ts <= r[1]]
            if inner:
                span = max(inner)[2]          # the latest to open
            elif tid != main_tid:
                span = other_thread
        ops.append((e['name'], float(e['ts']), float(e['dur']), span))
        kernels += e.get('cat') == 'kernel'
    missing = sum(1 for c, (_, _, name) in launches.items()
                  if 'LaunchKernel' in name and c not in seen)
    return ops, kernels, missing == 0


def profiled(run, units, kind, spans, flops_per_unit, other_thread,
             tries=3):
    """Run ``run()`` (``units`` steps or images, ending in a synchronise)
    under the profiler until a window keeps every kernel launch's record,
    at most ``tries`` times; a ``Reading`` of the first whole one. Raises
    where none is whole: a partial window is never read."""
    for attempt in range(tries):
        spans.bound_s.clear()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
            prof.export_chrome_trace(path)
            ops, kernels, whole = _parse(path, threading.get_native_id(),
                                         other_thread)
        finally:
            os.remove(path)
        if whole and kernels:
            print(f'trace: window {attempt + 1} whole, {kernels} kernels',
                  file=sys.stderr, flush=True)
            return Reading(kind, units, window_s, ops, kernels,
                           dict(spans.bound_s), flops_per_unit * units)
        print(f'trace: window {attempt + 1} dropped kernel records; '
              'profiling again', file=sys.stderr, flush=True)
    raise RuntimeError(f'no whole profiler window in {tries} tries: the '
                       'profiler dropped kernel records')
