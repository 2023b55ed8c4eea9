"""The two kinds of cell: the SemiVL training step and the sliding-window
evaluation, each as the port runs them, and the reference's readings of
the same inputs.

A run builds the port's model once (``TrainCell`` / ``EvalCell``), loads
the benchmark's seeded weights into it (``load``), drives the timed path,
then frees the program's state and lets the reference work the same
inputs out again (``reference``). ``compare_train`` and the evaluation's
``reference`` turn both readings into the numbers that decide ``correct``.
"""

import gc
import time

import numpy as np
import torch

from portbench import counts
from portbench.harness import report, spec, trace, traffic, weights
from portbench.reference import evaluate as ref_eval
from portbench.reference import model as ref_model
from portbench.reference.step import ReferenceTrainer

FIRST_STEPS = 3        # the steps the reference follows
BETA1 = 0.9            # AdamW's first moment: exp_avg = (1 - beta1) g at step 1
VANISHING = 1e-3       # a leaf whose reference gradient is below this share
                       # of the median leaf's moves by round-off alone
UNLABELED_TERMS = {'loss_s1': 0.25, 'loss_s2': 0.25, 'loss_fp': 0.5}
TRAIN_STEP_SPANS = ('pb.step.teacher', 'pb.step.student1',
                    'pb.step.student2')


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def _reset_peak(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


class _Clock:
    """When the device reached a point of its stream, on the host's clock:
    a CUDA event read against an anchor taken after a synchronise (the
    host's clock itself off the card, which runs synchronously)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        if self.cuda:
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
            self.anchor.synchronize()
        self.t_anchor = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def when(self, mark):
        if not self.cuda:
            return mark
        return self.t_anchor + self.anchor.elapsed_time(mark) / 1e3


PACKED = ('in_proj_weight', 'in_proj_bias')   # q, k and v stacked on dim 0


def _parts(tensors):
    """Each leaf, with a packed attention projection taken as its three
    parts (``name[q]``, ``name[k]``, ``name[v]``): under softmax the key
    part of the bias has a gradient nought to rounding, which the
    ``VANISHING`` rule can leave out only apart from the rest."""
    out = {}
    for n, t in tensors.items():
        if n.endswith(PACKED):
            for tag, piece in zip('qkv', t.chunk(3, dim=0)):
                out[f'{n}[{tag}]'] = piece
        else:
            out[n] = t
    return out


def _norms(tensors):
    """{name: float norm} of each leaf or part in one batched reduction."""
    tensors = _parts(tensors)
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                        for n in names]).tolist()
    return dict(zip(names, vals))


def _concepts(conf):
    per = conf.get('mcc_concepts_per_class')
    return ref_model.concept_index(per) if per else None


class _Base:
    def __init__(self, conf, mix, kind, device):
        from semivl_tpu_torch.models.builder import build_model
        self.conf, self.mix, self.device = conf, mix, torch.device(device)
        self.arch = conf['architecture']
        self.cfg = spec.port_run_config(conf, kind)
        self.bundle = build_model(self.cfg, dtype=torch.bfloat16,
                                  device=self.device)
        self.model = self.bundle.model
        if not np.array_equal(self.bundle.text_feats, spec.text(conf['text'])):
            raise ValueError('the program reads another text than the '
                             'configuration names')
        shapes = ref_model.param_shapes(self.arch)
        self.shapes = {n: s for n, s in shapes.items()
                       if kind == 'train' or not n.startswith('clip_')}

    def weights(self, seed):
        return weights.make(self.shapes, seed, self.conf['weight_scales'],
                            self.device)

    def load(self, seed):
        """The seed's weights in the program's model, its BatchNorm
        statistics at their start."""
        weights.load_into(self.model, self.weights(seed))
        with torch.no_grad():
            for n, b in self.model.named_buffers():
                b.fill_(0.0 if n.endswith('running_mean') else 1.0)


class TrainCell(_Base):
    """``make_semivl_train_step`` on the mix's ring of batches."""

    def __init__(self, conf, mix, device='cuda'):
        super().__init__(conf, mix, 'train', device)
        if not np.array_equal(self.bundle.mcc_text_feats,
                              spec.text(conf['mcc_text'])):
            raise ValueError('the guidance text is not the configuration\'s')
        self.images_per_step = mix['labeled'] + mix['unlabeled']

    def flops_per_step(self):
        n = spec.text(self.conf['text']).shape[0]
        nm = spec.text(self.conf['mcc_text']).shape[0]
        return counts.train_step(self.arch, n, nm, self.mix['labeled'],
                                 self.mix['crop'])

    def inputs(self, seed):
        return traffic.train_batches(self.mix, self.conf['nclass'], seed,
                                     self.device)

    def generator(self, seed):
        return torch.Generator(device=self.device).manual_seed(
            weights.sub_seed(seed, 'dropout'))

    def start(self, seed, ring, fault=None):
        """Load the seed's weights, build the step with its optimizer and
        drive it through the first steps on the ring. Returns (step,
        generator, readings): the loss terms of each step, the norm of each
        leaf's first gradient as AdamW took it (from its first moment) and
        of each leaf's change after the first steps."""
        from semivl_tpu_torch.train.optim import build_optimizer
        from semivl_tpu_torch.train.step import make_semivl_train_step
        self.load(seed)
        total = self.conf['train']['total_iters']
        opt, _ = build_optimizer(self.cfg, self.model, total)
        step = make_semivl_train_step(self.bundle, self.cfg, opt, total,
                                      device=self.device)
        step = _faulty(step, fault)
        gen = self.generator(seed)
        names = {p: n for n, p in self.model.named_parameters()}
        start = {n: p.detach().clone() for n, p in
                 self.model.named_parameters() if p.requires_grad}
        losses, grad1 = [], None
        for i in range(FIRST_STEPS):
            m = step(ring[i % len(ring)], gen)
            losses.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grad1 = _norms({names[p]: s['exp_avg'] / (1 - BETA1)
                                for p, s in opt.state.items()})
        params = dict(self.model.named_parameters())
        change = _norms({n: params[n].detach() - w for n, w in start.items()})
        del start
        return step, gen, dict(losses=losses, grad1=grad1, change=change)

    def window(self, step, ring, gen, seconds):
        """Steps back to back for ``seconds``: no host-made batch, no copy
        and no synchronisation until the window closes."""
        _sync(self.device)
        _reset_peak(self.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            step(ring[(FIRST_STEPS + n) % len(ring)], gen)
            n += 1
        _sync(self.device)
        dt = time.perf_counter() - t0
        return dict(t0=t0, steps=n, seconds=dt,
                    train_imgs_per_s=n * self.images_per_step / dt,
                    peak=report.peak(self.device))

    def traced(self, step, ring, gen, steps=3):
        spans = trace.Spans(self.arch['decode_head'])
        k = [FIRST_STEPS]

        def run():
            for _ in range(steps):
                spans.model_calls = 0
                with torch.profiler.record_function('pb.step'):
                    step(ring[k[0] % len(ring)], gen)
                k[0] += 1

        with spans.installed(self.model, step.optimizer, TRAIN_STEP_SPANS):
            return trace.profiled(run, steps, 'train', spans,
                                  self.flops_per_step(), 'pb.step.backward')

    def reference(self, seed, ring, precision='fp32'):
        """The reference's readings of the same first steps from the same
        weights, inputs and dropout draws."""
        w0 = self.weights(seed)
        ref = ReferenceTrainer(self.arch, self.conf['train'], w0,
                               spec.text(self.conf['text']),
                               spec.text(self.conf['mcc_text']), self.device,
                               precision, _concepts(self.conf))
        gen = self.generator(seed)
        losses, grad1 = [], None
        for i in range(FIRST_STEPS):
            m, grads = ref.step(ring[i % len(ring)], gen)
            losses.append(m)
            if i == 0:
                grad1 = _norms(grads)
        change = _norms({n: p.detach() - w0[n]
                         for n, p in ref.trainable().items()})
        return dict(losses=losses, grad1=grad1, change=change)


def _faulty(step, fault):
    """The step with a planted fault (tests and the limits' readings)."""
    if fault is None:
        return step
    if fault == 'unchanged':
        step.optimizer.step = lambda *a, **k: None
        return step
    if fault == 'half_batch':
        call = step.__call__

        class Half:
            def __init__(self):
                self.optimizer = step.optimizer

            def __call__(self, batch, gen=None):
                b = batch['mask_x'].shape[0] // 2
                return call({k: v[:b] for k, v in batch.items()}, gen)
        return Half()
    raise ValueError(f'unknown fault {fault!r}')


def _leaf_gaps(prog, ref, keep):
    """Each kept leaf's |program norm - reference norm| against the larger
    of the reference's norm of that leaf and of the median leaf, worst
    first: [(gap, leaf)]."""
    med = float(np.median([ref[n] for n in keep]))
    return sorted(((abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30),
                    n) for n in keep), reverse=True)


def _named(gaps, k=3):
    return ', '.join(f'{n} {g:.4g}' for g, n in gaps[:k])


def compare_train(prog, ref):
    """{number: (value, detail)} of the first steps, program against
    reference; the cell's limits file names the ones it compares, the rest
    are recorded beside them:

    - ``loss1_gap``: the first step's loss gap against the reference's
      loss (both from the same weights and inputs);
    - ``loss_gap_all``: the worst step's loss gap;
    - ``grad_gap``, ``grad_gap_worst``: the median and the worst leaf's
      first-gradient gap;
    - ``grad_ratio``: how far the median over the leaves of (program's
      first-gradient norm / reference's) lies from 1;
    - ``change_gap``, ``change_gap_median``: the worst and the median
      leaf's change gap after the first steps;
    - ``loss1_gap_unlabeled``: the first step's gap of the unlabeled
      student's pseudo-label terms (``0.25 loss_s1 + 0.25 loss_s2 + 0.5
      loss_fp``), 0 where both sides read 0;
    - ``vanishing_left_out``, ``vanishing_grad_max``,
      ``vanishing_change_gap``: how many leaves and parts the rule leaves
      out, the largest of their reference gradients against the median
      leaf's, and the worst of their change gaps (recorded only).

    A leaf's gap is |program norm - reference norm| against the larger of
    the reference's norm of that leaf and of the median leaf; a packed
    attention projection counts as its q, k and v parts. Leaves and parts
    whose reference gradient is below ``VANISHING`` of the median's (the
    key part of an attention bias under softmax: nought to rounding) are
    left out of the leaf numbers."""
    gaps = [_rel(p['loss_all'], r['loss_all'])
            for p, r in zip(prog['losses'], ref['losses'])]
    if any(not np.isfinite(p['loss_all']) for p in prog['losses']):
        gaps = [float('inf')] * len(gaps)
    unl = [sum(w * m.get(k, 0.0) for k, w in UNLABELED_TERMS.items())
           for m in (prog['losses'][0], ref['losses'][0])]
    med = float(np.median(list(ref['grad1'].values())))
    moving = [n for n, v in ref['grad1'].items() if v >= VANISHING * med]
    left_out = sorted(set(ref['grad1']) - set(moving))
    grad = _leaf_gaps(prog['grad1'], ref['grad1'], moving)
    change = _leaf_gaps(prog['change'], ref['change'], moving)
    change_med = float(np.median([ref['change'][n] for n in moving]))
    gone = sorted(((abs(prog['change'].get(n, 0.0) - ref['change'][n])
                    / max(ref['change'][n], change_med, 1e-30), n)
                   for n in left_out), reverse=True)
    return {'loss1_gap': (gaps[0], None),
            'loss_gap_all': (max(gaps), None),
            'grad_gap': (float(np.median([g for g, _ in grad])), None),
            'grad_gap_worst': (grad[0][0], _named(grad)),
            'grad_ratio': (abs(float(np.median(
                [prog['grad1'].get(n, 0.0) / ref['grad1'][n]
                 for n in moving])) - 1.0), None),
            'change_gap': (change[0][0], _named(change)),
            'change_gap_median': (float(np.median([g for g, _ in change])),
                                  None),
            'loss1_gap_unlabeled': (0.0 if unl == [0.0, 0.0]
                                    else _rel(*unl), None),
            'vanishing_left_out': (float(len(left_out)),
                                   ', '.join(left_out[:4]) or None),
            'vanishing_grad_max': (max([ref['grad1'][n] / med
                                        for n in left_out], default=0.0),
                                   'of the median leaf\'s'),
            'vanishing_change_gap': (gone[0][0] if gone else 0.0,
                                     _named(gone) if gone else None)}


def _rel(a, b):
    """|a - b| against |b|; inf where a is not finite."""
    if not np.isfinite(a):
        return float('inf')
    return abs(a - b) / max(abs(b), 1e-30)


class EvalCell(_Base):
    """``evaluate_histograms`` in ``zegclip_sliding_window`` over the mix's
    images, with the evaluator's defaults (prefetch, device histograms,
    a flush every 256 images)."""

    def __init__(self, conf, mix, device='cuda'):
        super().__init__(conf, mix, 'eval', device)
        # one call of evaluate_histograms per flush of the histograms, at
        # the evaluator's default
        self.chunk = int(self.cfg.get('eval_hist_flush_every', 256))
        from semivl_tpu_torch.evaluation.predict import Evaluator
        self.evaluator = Evaluator(self.model, self.bundle.text_feats,
                                   self.cfg, device=self.device)
        self.mode = self.cfg['eval_mode']

    def flops(self, items):
        n = spec.text(self.conf['text']).shape[0]
        return [counts.eval_image(self.arch, n, *it['img'].shape[:2],
                                  self.conf['crop_size'], self.conf['stride'])
                for it in items]

    def images(self, seed):
        return traffic.eval_images(self.mix, self.conf['nclass'], seed)

    def samples(self, seed, items):
        """Positions compared: the first image with the most windows and
        ``sample - 1`` more drawn from the seed, all in the first flush."""
        wins = [counts.eval_windows(*it['img'].shape[:2],
                                    self.conf['crop_size'],
                                    self.conf['stride']) for it in items]
        first = int(np.argmax(wins))
        rs = np.random.RandomState(weights.sub_seed(seed, 'sample') % 2 ** 32)
        rest = rs.choice([i for i in range(self.chunk) if i != first],
                         self.mix['sample'] - 1, replace=False)
        return sorted({first, *map(int, rest)})

    def _run(self, dataset, indices, progress=None):
        from semivl_tpu_torch.evaluation.predict import evaluate_histograms
        return evaluate_histograms(self.evaluator, dataset, self.mode,
                                   self.cfg, indices=indices,
                                   progress=progress)

    def warm(self, items):
        """Every crop batch size this mix's images use, once."""
        wins = [counts.eval_windows(*it['img'].shape[:2],
                                    self.conf['crop_size'],
                                    self.conf['stride']) for it in items]
        first = sorted({w: i for i, w in reversed(list(enumerate(wins)))}
                       .values())
        self._run(traffic.CycledImages(items, len(items), time.perf_counter),
                  first)
        _sync(self.device)

    def window(self, items, seconds, sample, fault=None):
        """Whole flushes of images for at least ``seconds``; each image
        timed from the dataset's ask to the event recorded after its
        histogram update."""
        dataset = traffic.CycledImages(items, 1 << 40, time.perf_counter)
        stash, events = {}, {}
        hist = self.evaluator._hist
        seen = [0]
        want = set(sample)

        def stashing(pred, mask):
            h = hist(pred, mask)
            if seen[0] in want:
                stash[seen[0]] = (pred.clone(), h.clone())
            seen[0] += 1
            return h

        def progress(i):
            events[i] = clock.mark()

        self.evaluator._hist = stashing
        restore = _eval_fault(self.evaluator, fault, self.conf['nclass'])
        try:
            _sync(self.device)
            _reset_peak(self.device)
            clock = _Clock(self.device)
            t0 = clock.t_anchor
            k = 0
            while k == 0 or time.perf_counter() - t0 < seconds:
                self._run(dataset, range(k, k + self.chunk), progress)
                k += self.chunk
            _sync(self.device)
            dt = time.perf_counter() - t0
        finally:
            del self.evaluator._hist
            restore()
        lat = [clock.when(events[i]) - dataset.asked[i] for i in range(k)]
        return dict(t0=t0, images=k, seconds=dt,
                    eval_imgs_per_s=k / dt,
                    eval_image_ms_p95=1e3 * float(np.quantile(lat, 0.95)),
                    peak=report.peak(self.device),
                    stash={i: (p.cpu().numpy(), h.cpu().numpy())
                           for i, (p, h) in stash.items()})

    def traced(self, items, images=32):
        dataset = traffic.CycledImages(items, 1 << 40, time.perf_counter)
        spans = trace.Spans(self.arch['decode_head'])
        flops = self.flops([items[i % len(items)] for i in range(images)])

        def run():
            with torch.profiler.record_function('pb.eval'):
                self._run(dataset, range(images))

        with spans.installed(self.model, None, ('pb.eval.forward',)):
            return trace.profiled(run, images, 'eval', spans,
                                  sum(flops) / images, 'pb.eval.prefetch')

    def reference(self, seed, items, stash, precision='fp32'):
        """The reference's score map of each compared image against the
        program's answer: the share of pixels whose predicted class is not
        the reference's best (``flip_share``), the gap by which a predicted
        class lies below the reference's best over the map's spread (the
        widest, ``pixel_gap``, and the 99.9th percentile, ``pixel_gap_q``,
        of the image that reads most), and the program's histogram update
        against the one its prediction gives (``hist_wrong``, entries)."""
        P = self.weights(seed)
        q = ref_model.Precision(precision)
        text = spec.text(self.conf['text'])
        gap = gap_q = flips = 0.0
        wrong = 0
        for i, (pred, hist) in sorted(stash.items()):
            it = items[i % len(items)]
            score = ref_eval.score_map(P, self.arch, text, it['img'],
                                       self.conf['crop_size'],
                                       self.conf['stride'], q, self.device)
            p = torch.as_tensor(pred, device=self.device).long()
            top = score.max(0).values
            mine = torch.gather(score, 0, p[None])[0]
            g = ((top - mine) / score.std(dim=0).mean()).flatten()
            gap = max(gap, float(g.max()))
            gap_q = max(gap_q, float(torch.quantile(g[::7], 0.999)))
            flips = max(flips, float((g > 0).float().mean()))
            if hist is not None:
                want = ref_eval.histograms(pred, it['mask'],
                                           self.conf['nclass'])
                wrong += int((np.asarray(hist) != want).sum())
        return {'flip_share': (flips, None), 'pixel_gap': (gap, None),
                'pixel_gap_q': (gap_q, None),
                'hist_wrong': (float(wrong), None)}


def control_stash(cell, seed, items, sample, precision='fp8'):
    """The control's answers in the program's place: the reference's own
    prediction of each compared image, computed in ``precision``."""
    P = cell.weights(seed)
    q = ref_model.Precision(precision)
    text = spec.text(cell.conf['text'])
    return {i: (ref_eval.score_map(P, cell.arch, text,
                                   items[i % len(items)]['img'],
                                   cell.conf['crop_size'], cell.conf['stride'],
                                   q, cell.device).argmax(0).cpu().numpy(),
                None) for i in sample}


def _eval_fault(evaluator, fault, nclass):
    """An answer altered where it is produced (tests and limits)."""
    if fault is None:
        return lambda: None
    if fault != 'altered':
        raise ValueError(f'unknown fault {fault!r}')
    orig = evaluator.predict_device

    def altered(*a, **k):
        return (orig(*a, **k) + 1) % nclass

    evaluator.predict_device = altered

    def restore():
        del evaluator.predict_device
    return restore
