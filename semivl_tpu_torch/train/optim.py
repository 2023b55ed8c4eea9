"""Optimizer and LR schedule (counterpart of ``semivl_tpu/train/optim.py``):
the mmseg AdamW path and the UniMatch ``original`` SGD.

- The freeze mask: ``clip_encoder.*`` always frozen; with
  ``freeze_backbone``, ``backbone.*`` frozen unless an ``exclude_keys``
  string occurs in the parameter name (reference model/vlm.py:80-93).
- AdamW with the mmseg ``paramwise_cfg.custom_keys`` multipliers: the
  longest key that occurs in the name gives (lr_mult, decay_mult), as
  mmseg's DefaultOptimizerConstructor resolves them.
- The ``original`` SGD (``opt='original'``: no ``optimizer`` entry, the
  base rate ``cfg['lr']``; reference semivl.py:119-121, JAX
  optim.py:151-163): momentum 0.9, weight decay 1e-4 added to the
  gradient before the momentum, names starting with ``backbone`` at the
  base rate and the rest at ``lr_multi`` times it.
- The poly schedule with linear warm-up (reference semivl.py:330-346).
"""

import torch

from semivl_tpu_torch.models.builder import is_trainable


def trainable_mask(names, freeze_backbone, exclude_keys):
    """{name: True if trainable} for parameter names."""
    return {n: is_trainable(n, freeze_backbone, exclude_keys) for n in names}


def make_poly_schedule(base_lr, max_iters, warmup_iters=0, warmup_ratio=1e-6,
                       power=0.9):
    """step -> lr: poly decay with linear warm-up (reference
    semivl.py:330-346)."""
    def sched(step):
        step = float(step)
        if step < warmup_iters:
            frac = step / warmup_iters
            return base_lr * (frac * (1.0 - warmup_ratio) + warmup_ratio)
        return base_lr * max(1.0 - step / max_iters, 0.0) ** power
    return sched


def custom_key_mults(custom_keys, name):
    """(lr_mult, decay_mult) of the longest ``custom_keys`` key that occurs
    in ``name`` (sorted by length, stable), else (1, 1)."""
    for key in sorted(custom_keys, key=len, reverse=True):
        if key in name:
            spec = custom_keys[key]
            return spec.get('lr_mult', 1.0), spec.get('decay_mult', 1.0)
    return 1.0, 1.0


def lr_schedule(cfg, total_iters):
    """The run config's schedule over ``total_iters`` (or
    ``scheduler_max_iters``) from the AdamW rate, or from ``cfg['lr']``
    without an ``optimizer`` entry (the ``original`` SGD), as JAX
    branches."""
    max_iters = cfg.get('scheduler_max_iters') or total_iters
    base = cfg['optimizer']['lr'] if 'optimizer' in cfg else cfg['lr']
    return make_poly_schedule(base, max_iters,
                              cfg.get('warmup_iters', 0),
                              cfg.get('warmup_ratio', 1e-6))


def build_optimizer(cfg, model, total_iters):
    """Run config + model -> (``torch.optim.AdamW``, schedule).

    One parameter group per (lr_mult, decay_mult) over the trainable
    parameters (``requires_grad``); each group keeps its ``lr_mult`` and
    sets ``weight_decay`` to wd * decay_mult, and the step sets
    ``lr = schedule(step) * lr_mult``. torch's decoupled decay then updates
    p <- p (1 - lr lr_mult wd decay_mult) - lr lr_mult adam(g), which is the
    JAX optax chain scale_by_adam -> + wd decay_mult p -> x -lr(step) ->
    x lr_mult (``semivl_tpu/train/optim.py:143-150``), with the same
    betas, eps and bias correction.

    Without an ``optimizer`` entry: the ``original`` SGD
    (``build_sgd``)."""
    if 'optimizer' not in cfg:
        return build_sgd(cfg, model, total_iters)
    opt_cfg = cfg['optimizer']
    if opt_cfg['type'] != 'AdamW':
        raise NotImplementedError(opt_cfg['type'])
    wd = opt_cfg.get('weight_decay', 0.01)
    custom_keys = opt_cfg.get('paramwise_cfg', {}).get('custom_keys', {})
    groups = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups.setdefault(custom_key_mults(custom_keys, name), []).append(p)
    sched = lr_schedule(cfg, total_iters)
    param_groups = [dict(params=ps, lr=sched(0) * lr_mult, lr_mult=lr_mult,
                         weight_decay=wd * decay_mult)
                    for (lr_mult, decay_mult), ps in groups.items()]
    opt = torch.optim.AdamW(param_groups, lr=opt_cfg['lr'],
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    return opt, sched


SGD_MOMENTUM = 0.9
SGD_WEIGHT_DECAY = 1e-4


def build_sgd(cfg, model, total_iters):
    """The ``original`` SGD: (``torch.optim.SGD``, schedule). Two groups of
    trainable parameters, those whose name starts with ``backbone`` at
    ``lr_mult`` 1 and the rest at ``cfg['lr_multi']``; the step sets
    ``lr = schedule(step) * lr_mult``. torch's SGD adds wd p to the
    gradient, then buf <- 0.9 buf + g (buf = g at the first step), p <- p
    - lr lr_mult buf: JAX's add_decayed_weights(1e-4) -> trace(0.9) ->
    x -lr(step) -> x lr_mult (optim.py:151-163). A model without
    ``backbone`` names (the UniMatch DeepLabV3+, whose encoder is
    ``encoder``) has every leaf at ``lr_multi``, as under JAX's rule."""
    lr_multi = cfg.get('lr_multi', 1.0)
    groups = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            mult = 1.0 if name.startswith('backbone') else lr_multi
            groups.setdefault(mult, []).append(p)
    sched = lr_schedule(cfg, total_iters)
    param_groups = [dict(params=ps, lr=sched(0) * mult, lr_mult=mult)
                    for mult, ps in groups.items()]
    opt = torch.optim.SGD(param_groups, lr=cfg['lr'], momentum=SGD_MOMENTUM,
                          dampening=0, nesterov=False,
                          weight_decay=SGD_WEIGHT_DECAY)
    return opt, sched
