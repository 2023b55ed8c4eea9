"""The SemiVL and supervised train steps (counterparts of
``semivl_tpu/train/step.py::make_semivl_train_step`` and
``::make_supervised_train_step``) on one card or on each rank of a process
group.

One iteration (reference semivl.py:203-328): CutMix of the strong views,
teacher pseudo-labels for the mixed-in images, MaskCLIP guidance labels from
the frozen encoder, student pass 1 on ``[img_x | img_w]`` with feature
perturbation of the w half, student pass 2 on ``[s1 | s2]``, the weighted
loss mix, one backward and one update of the trainable parameters.
``method='unimatch'`` is the same step with
``maskclip_consistency_lambda`` 0 and no guidance encoder (JAX
step.py:170-171). The supervised baseline (reference supervised.py:273-289)
takes one train-mode pass over the labeled batch and its labeled loss.
The criteria are CELoss, OHEM for the labeled term (the Cityscapes
class weights with ``use_weight``; JAX step.py:119-130) or, with exp 41's
ATM head, 'mmseg' (SegLossPlus:
the labeled term on the final layer's masks; the unlabeled terms on the
pseudo-labels times this rank's kept fraction; JAX step.py:100-143,
:201-217).
With ``strong_aug_on_device`` the step takes one uint8 crop of each
unlabeled image (``img_raw``, ``img_raw_other``) and of each labeled one,
and makes the views on the card (``ops.augment``, JAX step.py:219-266,
:407-413): the weak views normalised, two strong views of each raw crop,
the labeled crops through ``photometric_distortion`` when
``labeled_photometric_distortion`` is set; the draws come from the step's
generator, before the feature perturbation's.
A model with BatchNorm (the Cityscapes conv encoder, exp 41's DeepLabV3+
head, the UniMatch DeepLabV3+) runs it in eval mode in the teacher pass
(``pleval``: the running
statistics) and in train mode in both student passes, whose
running-statistic updates chain (pass 2 starts from pass 1's), as the JAX
step threads ``batch_stats`` (step.py:293-323): the head's statistics
come from ``[x | w | perturbed w]`` in pass 1 and ``[s1 | s2]`` in pass 2.

Inside a process group (``parallel.dist``) each rank takes its own rows of
the global batch, as the JAX step does under ``shard_map`` over ``data``:
each rank normalises its loss by its own valid-pixel counts, then, after
the one backward, the trainable gradients alone are averaged over the
ranks in one ``all_reduce`` (``_pmean_trainable``, step.py:146; frozen
leaves carry no gradient), the metrics are averaged and the ranks'
preemption flags summed in one more (step.py:238, :369), ``grad_norm`` is
taken after the mean (:373), and every rank applies the same update
(AdamW, or the ``original`` SGD). Without a process group no collective
is issued.

With ``ema_decay`` set, each step keeps an exponential moving average of
every parameter, trainable and frozen (JAX's whole ``params`` collection,
not the BatchNorm statistics; step.py:25-39, :380-385, :446-452): after
the update, ``decay * e + (1 - decay) * p`` in float32, two products and
one sum as JAX rounds them. It starts from the parameters the step is
made with (JAX loop.py:138-143); every rank holds the same one.
"""

import torch

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.losses.ce import (
    CITYSCAPES_OHEM_WEIGHT,
    cross_entropy,
    ohem_cross_entropy,
)
from semivl_tpu_torch.losses.conf_weight import confidence_weighted_loss
from semivl_tpu_torch.losses.seg_loss_plus import seg_loss_plus
from semivl_tpu_torch.ops.augment import (
    normalize_imagenet,
    photometric_distortion,
    strong_augment,
    to_unit,
)
from semivl_tpu_torch.parallel import dist
from semivl_tpu_torch.train.optim import lr_schedule

LOSS_KEYS = ('loss_x', 'loss_s1', 'loss_s2', 'loss_fp', 'loss_mc_s1',
             'loss_mc_s2', 'loss_mc_fp', 'loss_all')


def cutmix_image(img, img_other, box):
    """Paste ``img_other`` under the box (reference train_utils.py:19-21)."""
    return torch.where(box[..., None] == 1, img_other, img)


def cutmix_mask(mask, mask_other, box):
    """(reference train_utils.py:24-27)"""
    return torch.where(box == 1, mask_other, mask)


def cutmix_box_from_coords(coords, hw):
    """(B, 4) integer (y, x, h, w) boxes -> (B, hw, hw) {0, 1} float masks."""
    y, x, h, w = (coords[:, i, None, None] for i in range(4))
    yy = torch.arange(hw, device=coords.device)[None, :, None]
    xx = torch.arange(hw, device=coords.device)[None, None, :]
    return ((yy >= y) & (yy < y + h) & (xx >= x) & (xx < x + w)).float()


def _unpack_compact(batch, device):
    """Batch arrays -> tensors on ``device``: label maps as int64, coordinate
    boxes rasterised."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    hw = out['mask_x'].shape[1]
    for k in ('mask_x', 'ignore_mask', 'ignore_mask_other'):
        out[k] = out[k].long()
    for k in ('cutmix_box1', 'cutmix_box2'):
        if out[k].ndim == 2:
            out[k] = cutmix_box_from_coords(out[k], hw)
    return out


def _softmax_conf_label(logits):
    conf, label = torch.softmax(logits.float(), dim=1).max(dim=1)
    return conf, label


def _mc_loss(logits, mc_label, ignore_mask, reduce_mode):
    """MaskCLIP-consistency loss (reference semivl.py:52-58)."""
    if reduce_mode == 'mean':
        return cross_entropy(logits, mc_label)
    ce = cross_entropy(logits, mc_label, reduction='none')
    if reduce_mode == 'mean_valid':
        return ce.sum() / (ignore_mask != 255).sum().clamp(min=1)
    if reduce_mode == 'mean_all':
        return ce.sum() / ignore_mask.numel()
    raise ValueError(reduce_mode)


def _criterion_name(cfg):
    crit = cfg['criterion']
    return crit['name'] if isinstance(crit, dict) else crit


CRITERIA = ('CELoss', 'OHEM', 'mmseg')   # of the labeled term
CRITERIA_U = ('CELoss', 'mmseg')


def check_criteria(cfg, bundle, unlabeled=True):
    """The criteria the port runs (``unlabeled``: the step's unlabeled
    criterion too, which JAX's step takes as CELoss or 'mmseg') and JAX's
    pairing rule (``check_criterion_pairing``, step.py:100-117, over the
    criterion and, where the config has one, ``criterion_u``): 'mmseg'
    means the model's own loss_decode, SegLossPlus, which only the ATM head
    configures."""
    names = [_criterion_name(cfg)]
    if names[0] not in CRITERIA:
        raise NotImplementedError(f'criterion {names[0]!r} is not ported to '
                                  f'the PyTorch step ({CRITERIA})')
    if unlabeled and cfg['criterion_u'] not in CRITERIA_U:
        raise NotImplementedError(
            f'criterion_u {cfg["criterion_u"]!r} is not a criterion of the '
            f'unlabeled terms ({CRITERIA_U})')
    if 'criterion_u' in cfg:
        names.append(cfg['criterion_u'])
    if 'mmseg' in names:
        head = getattr(bundle.model, 'decode_head_cfg', None) or {}
        if head.get('type') != 'ATMSingleHeadSeg':
            raise ValueError(
                "criterion 'mmseg' resolves to SegLossPlus, which only the "
                f"ATM head configures; got head {head.get('type')!r} — use "
                "'CELoss'/'OHEM' for this model")


def labeled_loss(cfg, logits, mask):
    """The labeled term of the run config's criterion (JAX
    ``_labeled_loss``). OHEM takes ``thresh``, ``min_kept`` and
    ``use_weight`` from the criterion's kwargs (0.7, 200000, False), which
    the generator never sets (a reference quirk, configs/experiments.py)."""
    name = _criterion_name(cfg)
    if name == 'OHEM':
        crit = cfg['criterion']
        kwargs = crit.get('kwargs', {}) if isinstance(crit, dict) else {}
        weight = (CITYSCAPES_OHEM_WEIGHT if kwargs.get('use_weight', False)
                  else None)
        return ohem_cross_entropy(
            logits, mask, thresh=kwargs.get('thresh', 0.7),
            min_kept=kwargs.get('min_kept', 200000), weight=weight)
    if name == 'mmseg':
        # the final layer only, as the reference's train loop passes no
        # aux outputs (semivl.py:269; JAX step.py:133-142)
        return seg_loss_plus(logits, mask, cfg['nclass'])
    return cross_entropy(logits, mask)


def labeled_view(cfg, img, generator):
    """The labeled crops as the model takes them: a uint8 crop through the
    photometric distortion (with ``labeled_photometric_distortion``) and
    the ImageNet normalisation on the device; a float one as it is."""
    if img.dtype != torch.uint8:
        return img
    x = to_unit(img)
    if cfg.get('labeled_photometric_distortion', False):
        x = photometric_distortion(x, generator)
    return normalize_imagenet(x)


def init_ema(model):
    """The EMA's start: a float32 copy of every parameter of ``model``,
    by name (JAX ``jax.tree.map(jnp.array, variables['params'])``)."""
    return {n: p.detach().float().clone()
            for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update_(ema, model, decay):
    """``ema <- decay * ema + (1 - decay) * params`` (JAX
    ``_ema_update``): the two products rounded to float32 before the sum,
    so a leaf that did not move drifts as JAX's does (``lerp`` rounds
    ``e + w (p - e)`` instead)."""
    params = dict(model.named_parameters())
    old = list(ema.values())
    new = torch._foreach_mul([params[n].detach().float() for n in ema],
                             1.0 - decay)
    torch._foreach_mul_(old, decay)
    torch._foreach_add_(old, new)


class _Step:
    """What both steps share: the schedule, the text and the update;
    ``step(batch, generator) -> metrics``, ``iteration`` counts the updates
    made (the JAX ``TrainState.step``), ``ema`` is the parameter EMA
    (name -> float32 tensor; None without ``ema_decay``)."""

    def __init__(self, bundle, cfg, optimizer, total_iters, device):
        self.device = resolve_device(device)
        self.model = bundle.model
        self.cfg = cfg
        self.optimizer = optimizer
        self.total_iters = total_iters
        self.sched = lr_schedule(cfg, total_iters)
        self.text = torch.as_tensor(bundle.text_feats).to(self.device)
        self.iteration = 0
        self.ema = init_ema(self.model) if cfg.get('ema_decay') else None

    def __call__(self, batch, generator=None, preempt=False):
        """One iteration: ``backward`` then ``update``; the metrics (with
        ``preempt_count``, the ranks' ``preempt`` flags summed, inside a
        process group)."""
        return self.update(self.backward(batch, generator), preempt)

    def update(self, metrics, preempt=False):
        """Average the gradients and metrics over the ranks (inside a
        process group), then one optimizer step at this iteration's rate.
        A trainable leaf that the loss does not reach (the ATM head's last
        layer after its attention logits) has no gradient on any rank and
        is not reduced; it takes a zero gradient, so that AdamW decays it
        as JAX's optimizer does with its zero gradient."""
        params = [p for g in self.optimizer.param_groups for p in g['params']]
        grads = [p.grad for p in params if p.grad is not None]
        m = dict(metrics)
        if dist.active():
            dist.mean_over_ranks_(grads)
            keys = sorted(m)
            means, count = dist.reduce_metrics(
                torch.stack([m[k] for k in keys]),
                torch.tensor(float(preempt)))
            m = dict(zip(keys, means.unbind()))
            m['preempt_count'] = count
        if self.cfg.get('log_grad_norm'):
            m['grad_norm'] = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float())
                             for g in grads]))
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.sched(self.iteration)
        for group in self.optimizer.param_groups:
            group['lr'] = lr * group['lr_mult']
        self.optimizer.step()
        if self.ema is not None:
            ema_update_(self.ema, self.model, self.cfg.get('ema_decay', 0.999))
        self.iteration += 1
        return m


class SemiVLStep(_Step):
    """The SemiVL (and UniMatch) step."""

    def __init__(self, bundle, cfg, optimizer, total_iters, device=None):
        check_criteria(cfg, bundle)
        if not cfg.get('use_fp', True):
            raise ValueError('the reference asserts use_fp (semivl.py:114)')
        super().__init__(bundle, cfg, optimizer, total_iters, device)
        self.mcc_lambda = cfg.get('maskclip_consistency_lambda', 0)
        self.use_mcc = self.mcc_lambda != 0
        if self.use_mcc and bundle.mcc_text_feats is None:
            raise ValueError('maskclip_consistency_lambda is set but the '
                             'bundle has no guidance encoder text')
        self.mcc_text = (torch.as_tensor(bundle.mcc_text_feats).to(
            self.device) if self.use_mcc else None)

    def _lambda(self):
        if isinstance(self.mcc_lambda, (list, tuple)):
            a, b = self.mcc_lambda
            prog = self.iteration / self.total_iters
            return a * (1 - prog) + b * prog
        return float(self.mcc_lambda)

    def _unlabeled_loss(self, logits, pl, conf, ignore):
        if self.cfg['criterion_u'] == 'mmseg':
            # SegLossPlus on the pseudo-labels times this rank's fraction of
            # confident valid pixels, not reduced over the ranks
            # (reference semivl.py:278-282)
            valid = ignore != 255
            kept = (conf >= self.cfg['conf_thresh']) & valid
            ratio = kept.sum() / valid.sum().clamp(min=1)
            return seg_loss_plus(logits, pl, self.cfg['nclass']) \
                * ratio.float()
        ce = cross_entropy(logits, pl, reduction='none')
        return confidence_weighted_loss(ce, conf, ignore,
                                        self.cfg['conf_mode'],
                                        self.cfg['conf_thresh'])

    def _views(self, batch, generator):
        """The on-device views of ``strong_aug_on_device`` (module
        docstring): the labeled crops', then one draw for the four strong
        views ``[s1 | s2 | s1_other | s2_other]``."""
        batch = dict(batch)
        raw, raw_o = to_unit(batch['img_raw']), to_unit(batch['img_raw_other'])
        batch['img_x'] = labeled_view(self.cfg, batch['img_x'], generator)
        batch['img_w'] = normalize_imagenet(raw)
        batch['img_w_other'] = normalize_imagenet(raw_o)
        views = strong_augment(torch.cat([raw, raw, raw_o, raw_o]),
                               generator).chunk(4)
        batch.update(zip(('img_s1', 'img_s2', 'img_s1_other',
                          'img_s2_other'), views))
        return batch

    def backward(self, batch, generator=None):
        """This rank's losses of ``batch`` and their gradients in the
        trainable parameters' ``grad``; returns the detached metrics."""
        cfg, model, text = self.cfg, self.model, self.text
        batch = _unpack_compact(batch, self.device)
        if cfg.get('strong_aug_on_device', False):
            batch = self._views(batch, generator)
        b = batch['mask_x'].shape[0]
        box1, box2 = batch['cutmix_box1'], batch['cutmix_box2']
        img_s1 = cutmix_image(batch['img_s1'], batch['img_s1_other'], box1)
        img_s2 = cutmix_image(batch['img_s2'], batch['img_s2_other'], box2)
        ign, ign_o = batch['ignore_mask'], batch['ignore_mask_other']

        with torch.no_grad():
            # teacher pseudo-labels for the mixed-in halves (228-232)
            conf_w_other, mask_w_other = _softmax_conf_label(
                model(batch['img_w_other'], text))
            if self.use_mcc:   # MaskCLIP guidance labels (234-240)
                mclip_all = model.forward_maskclip(
                    torch.cat([batch['img_w'], batch['img_w_other']]),
                    self.mcc_text, cfg.get('mcc_conf_thresh', 0.75))
                mclip = torch.where(ign == 255, 255, mclip_all[:b])
                mclip_other = torch.where(ign_o == 255, 255, mclip_all[b:])

        preds, pred_w_fp = model(torch.cat([batch['img_x'], batch['img_w']]),
                                 text, need_fp=True, generator=generator,
                                 train=True)
        pred_x, pred_w = preds[:b], preds[b:]
        pred_s = model(torch.cat([img_s1, img_s2]), text, train=True)
        pred_s1, pred_s2 = pred_s[:b], pred_s[b:]

        conf_w, mask_w = _softmax_conf_label(pred_w.detach())
        ign_m1 = cutmix_mask(ign, ign_o, box1)
        ign_m2 = cutmix_mask(ign, ign_o, box2)
        m = dict(
            loss_x=labeled_loss(cfg, pred_x, batch['mask_x']),
            loss_s1=self._unlabeled_loss(
                pred_s1, cutmix_mask(mask_w, mask_w_other, box1),
                cutmix_mask(conf_w, conf_w_other, box1), ign_m1),
            loss_s2=self._unlabeled_loss(
                pred_s2, cutmix_mask(mask_w, mask_w_other, box2),
                cutmix_mask(conf_w, conf_w_other, box2), ign_m2),
            loss_fp=self._unlabeled_loss(pred_w_fp, mask_w, conf_w, ign))
        loss = (m['loss_x'] + m['loss_s1'] * 0.25 + m['loss_s2'] * 0.25
                + m['loss_fp'] * 0.5) / 2.0
        if self.use_mcc:
            red = cfg.get('mcc_loss_reduce', 'mean')
            m['loss_mc_s1'] = _mc_loss(
                pred_s1, cutmix_mask(mclip, mclip_other, box1), ign_m1, red)
            m['loss_mc_s2'] = _mc_loss(
                pred_s2, cutmix_mask(mclip, mclip_other, box2), ign_m2, red)
            m['loss_mc_fp'] = _mc_loss(pred_w_fp, mclip, ign, red)
            loss = loss + self._lambda() * (
                m['loss_mc_s1'] * 0.25 + m['loss_mc_s2'] * 0.25
                + m['loss_mc_fp'] * 0.5)
        m['loss_all'] = loss

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return {k: v.detach() for k, v in m.items()}

class SupervisedStep(_Step):
    """The supervised baseline (JAX ``make_supervised_train_step``,
    step.py:397-455): ``batch`` holds ``img`` (normalised float) or
    ``img_u8`` (uint8, normalised on the device after the photometric
    distortion of ``labeled_photometric_distortion``, drawn from the
    step's generator) and ``mask``; the metrics are ``loss_all`` and
    ``loss_x``, the same labeled loss."""

    def __init__(self, bundle, cfg, optimizer, total_iters, device=None):
        check_criteria(cfg, bundle, unlabeled=False)
        super().__init__(bundle, cfg, optimizer, total_iters, device)

    def backward(self, batch, generator=None):
        """This rank's labeled loss and its gradients."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        img = labeled_view(self.cfg, batch.get('img', batch.get('img_u8')),
                           generator)
        pred = self.model(img, self.text, train=True)
        loss = labeled_loss(self.cfg, pred, batch['mask'].long())
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        return {'loss_all': loss, 'loss_x': loss}


def make_supervised_train_step(bundle, cfg, optimizer, total_iters,
                               device=None):
    """The supervised baseline's step (``SupervisedStep``), on the card
    unless ``device='cpu'`` is given; inside a process group, ``batch`` is
    this rank's rows and the update is the ranks'."""
    return SupervisedStep(bundle, cfg, optimizer, total_iters, device)


def make_semivl_train_step(bundle, cfg, optimizer, total_iters, device=None):
    """The SemiVL train step for ``bundle`` (a ``ModelBundle`` with the
    guidance encoder) and an optimizer from ``train.optim.build_optimizer``:
    ``step(batch, generator) -> metrics`` with the JAX step's metric names.

    ``batch`` holds (B, H, W, 3) float images ``img_x``, ``img_w``,
    ``img_s1``, ``img_s2``, ``img_w_other``, ``img_s1_other``,
    ``img_s2_other``, label maps ``mask_x``, ``ignore_mask``,
    ``ignore_mask_other`` (255 = ignore) and CutMix boxes ``cutmix_box1``,
    ``cutmix_box2`` as (B, 4) (y, x, h, w) coordinates or (B, H, W) masks;
    with ``strong_aug_on_device``, uint8 ``img_x``, ``img_raw`` and
    ``img_raw_other`` in place of the seven float images.
    ``generator`` drives the feature-perturbation dropout. Runs on the card
    unless ``device='cpu'`` is given; inside a process group, ``batch`` is
    this rank's rows and the update is the ranks' (module docstring)."""
    return SemiVLStep(bundle, cfg, optimizer, total_iters, device)
