"""The plain reference of one SemiVL training iteration and its AdamW
update (the reference repository's ``semivl.py:203-328`` and mmseg's
AdamW with ``paramwise_cfg``), on the functional model of ``model.py``.

``ReferenceTrainer(arch, train, weights, ...)`` holds float32 copies of the
parameters, the BatchNorm running statistics and AdamW's state;
``step(batch, generator)`` runs one iteration and returns its loss terms.
"""

import torch

from portbench.reference import model as M

def cross_entropy_map(logits, labels):
    """Per-pixel cross-entropy (0 where the label is 255) and the valid
    mask."""
    valid = labels != 255
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = torch.logsumexp(logits, 1) - torch.gather(logits, 1,
                                                   safe[:, None])[:, 0]
    return torch.where(valid, ce, torch.zeros_like(ce)), valid


def cross_entropy(logits, labels):
    ce, valid = cross_entropy_map(logits, labels)
    return ce.sum() / valid.sum().clamp(min=1)


def confidence_weighted(ce, conf, ignore, mode, thresh):
    """The reference's ``train_utils.py:30-49``."""
    valid = ignore != 255
    total = valid.float().sum().clamp(min=1.0)
    if mode == 'pixelwise':
        return (ce * ((conf >= thresh) & valid)).sum() / total
    if mode == 'pixelavg':
        vf = valid.float()
        avg = (conf * vf).sum(dim=(1, 2)) / vf.sum(dim=(1, 2)).clamp(min=1.0)
        return ce.sum() * avg.sum() / total
    raise ValueError(mode)


def mc_loss(logits, label, ignore, reduce_mode):
    ce, valid = cross_entropy_map(logits, label)
    if reduce_mode == 'mean_all':
        return ce.sum() / ignore.numel()
    if reduce_mode == 'mean':
        return ce.sum() / valid.sum().clamp(min=1)
    raise ValueError(reduce_mode)


def box_masks(coords, hw):
    """(B, 4) (y, x, h, w) CutMix boxes -> (B, hw, hw) {0, 1} masks."""
    y, x, h, w = (coords[:, i, None, None].long() for i in range(4))
    yy = torch.arange(hw, device=coords.device)[None, :, None]
    xx = torch.arange(hw, device=coords.device)[None, None, :]
    return (yy >= y) & (yy < y + h) & (xx >= x) & (xx < x + w)


def custom_key_mults(custom_keys, name):
    """mmseg: the longest key that occurs in the name gives (lr_mult,
    decay_mult)."""
    for key in sorted(custom_keys, key=len, reverse=True):
        if key in name:
            spec = custom_keys[key]
            return spec.get('lr_mult', 1.0), spec.get('decay_mult', 1.0)
    return 1.0, 1.0


def poly_lr(base, it, max_iters, power=0.9):
    return base * max(1.0 - it / max_iters, 0.0) ** power


class ReferenceTrainer:
    """Float32 parameters, running statistics and AdamW state of the
    reference, started from ``weights`` ({name: tensor})."""

    def __init__(self, arch, train, weights, text, mcc_text, device,
                 precision='fp32', mcc_concepts=None):
        self.arch, self.train = arch, train
        self.q = M.Precision(precision)
        self.P = {n: w.detach().float().clone().requires_grad_(
            M.is_trainable(n, arch)) for n, w in weights.items()}
        self.B = M.init_buffers(arch, device)
        self.text = torch.as_tensor(text, device=device).float()
        self.mcc_text = torch.as_tensor(mcc_text, device=device).float()
        self.mcc_concepts = mcc_concepts
        opt = train['optimizer']
        groups = {}
        for n, p in self.P.items():
            if p.requires_grad:
                groups.setdefault(custom_key_mults(opt['custom_keys'], n),
                                  []).append(p)
        self.opt = torch.optim.AdamW(
            [dict(params=ps, lr_mult=lm, weight_decay=opt['weight_decay'] * dm)
             for (lm, dm), ps in groups.items()],
            lr=opt['lr'], betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.iteration = 0

    def trainable(self):
        return {n: p for n, p in self.P.items() if p.requires_grad}

    def _lambda(self):
        a, b = self.train['maskclip_consistency_lambda']
        prog = self.iteration / self.train['total_iters']
        return a * (1 - prog) + b * prog

    def forward(self, img, **kw):
        return M.vlm_forward(self.P, self.B, self.arch, img, self.text,
                             self.q, ckpt=True, **kw)

    def losses(self, batch, generator):
        """The loss terms of one iteration (the graph kept for backward)."""
        t = self.train
        b, hw = batch['mask_x'].shape[:2]
        box1 = box_masks(batch['cutmix_box1'], hw)
        box2 = box_masks(batch['cutmix_box2'], hw)
        img_s1 = torch.where(box1[..., None], batch['img_s1_other'],
                             batch['img_s1'])
        img_s2 = torch.where(box2[..., None], batch['img_s2_other'],
                             batch['img_s2'])
        ign, ign_o = batch['ignore_mask'], batch['ignore_mask_other']
        with torch.no_grad():
            conf_wo, mask_wo = torch.softmax(
                self.forward(batch['img_w_other']), 1).max(1)
            mc = M.maskclip_labels(
                self.P, self.arch, torch.cat([batch['img_w'],
                                              batch['img_w_other']]),
                self.mcc_text, t['mcc_conf_thresh'], self.q,
                self.mcc_concepts)
            mclip = torch.where(ign == 255, 255, mc[:b])
            mclip_o = torch.where(ign_o == 255, 255, mc[b:])
        preds, pred_fp = self.forward(torch.cat([batch['img_x'],
                                                 batch['img_w']]),
                                      need_fp=True, generator=generator,
                                      train=True)
        pred_x, pred_w = preds[:b], preds[b:]
        pred_s = self.forward(torch.cat([img_s1, img_s2]), train=True)
        pred_s1, pred_s2 = pred_s[:b], pred_s[b:]
        conf_w, mask_w = torch.softmax(pred_w.detach(), 1).max(1)

        def mix(a, o, box):
            return torch.where(box, o, a)

        def unl(logits, box):
            ce, _ = cross_entropy_map(logits, mix(mask_w, mask_wo, box))
            return confidence_weighted(ce, mix(conf_w, conf_wo, box),
                                       mix(ign, ign_o, box), t['conf_mode'],
                                       t['conf_thresh'])

        ce_fp, _ = cross_entropy_map(pred_fp, mask_w)
        m = dict(loss_x=cross_entropy(pred_x, batch['mask_x']),
                 loss_s1=unl(pred_s1, box1), loss_s2=unl(pred_s2, box2),
                 loss_fp=confidence_weighted(ce_fp, conf_w, ign,
                                             t['conf_mode'], t['conf_thresh']))
        loss = (m['loss_x'] + 0.25 * m['loss_s1'] + 0.25 * m['loss_s2']
                + 0.5 * m['loss_fp']) / 2.0
        red = t['mcc_loss_reduce']
        m['loss_mc_s1'] = mc_loss(pred_s1, mix(mclip, mclip_o, box1),
                                  mix(ign, ign_o, box1), red)
        m['loss_mc_s2'] = mc_loss(pred_s2, mix(mclip, mclip_o, box2),
                                  mix(ign, ign_o, box2), red)
        m['loss_mc_fp'] = mc_loss(pred_fp, mclip, ign, red)
        m['loss_all'] = loss + self._lambda() * (
            0.25 * m['loss_mc_s1'] + 0.25 * m['loss_mc_s2']
            + 0.5 * m['loss_mc_fp'])
        return m

    def step(self, batch, generator):
        """One iteration: losses, backward, the AdamW update at this
        iteration's rate. Returns the loss terms as floats and the
        gradients the optimizer took ({name: tensor})."""
        self.opt.zero_grad(set_to_none=True)
        m = self.losses(batch, generator)
        m['loss_all'].backward()
        grads = {}
        for n, p in self.trainable().items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads[n] = p.grad
        lr = poly_lr(self.train['optimizer']['lr'], self.iteration,
                     self.train['total_iters'])
        for g in self.opt.param_groups:
            g['lr'] = lr * g['lr_mult']
        self.opt.step()
        self.iteration += 1
        return {k: float(v.detach()) for k, v in m.items()}, grads
