"""The plain reference against the port's CPU path at tiny widths, both in
float32 from the same weights and inputs: the forward, three SemiVL steps
with AdamW, and the evaluation's score map."""

import numpy as np
import torch

from portbench.harness import cells, spec, traffic, weights
from portbench.reference import evaluate as ref_eval
from portbench.reference import model as M
from portbench.reference.step import ReferenceTrainer
from portbench.tests import tiny


def _port(conf, kind='train'):
    from semivl_tpu_torch.models.builder import build_model
    cfg = spec.port_run_config(conf, kind)
    bundle = build_model(cfg, dtype=torch.float32, device='cpu')
    return cfg, bundle


def test_forward_and_three_steps_match_the_port():
    tiny.few_threads()
    from semivl_tpu_torch.train.optim import build_optimizer
    from semivl_tpu_torch.train.step import make_semivl_train_step
    conf = tiny.load('tiny-vlm')
    cfg, bundle = _port(conf)
    w = weights.make(M.param_shapes(conf['architecture']), 11,
                     conf['weight_scales'], 'cpu')
    weights.load_into(bundle.model, w)
    ring = traffic.train_batches(tiny.load('tiny-train'), 21, 11, 'cpu')
    text = spec.text(conf['text'])
    with torch.no_grad():
        x = ring[0]['img_x']
        got = bundle.model(x, torch.as_tensor(text))
        want = M.vlm_forward(w, {}, conf['architecture'], x,
                             torch.as_tensor(text), M.Precision())
    assert float((got - want).norm() / want.norm()) < 1e-5
    opt, _ = build_optimizer(cfg, bundle.model, 1000)
    step = make_semivl_train_step(bundle, cfg, opt, 1000, device='cpu')
    ref = ReferenceTrainer(conf['architecture'], conf['train'], w, text,
                           spec.text(conf['mcc_text']), 'cpu', 'fp32',
                           cells._concepts(conf))
    g_port = torch.Generator().manual_seed(5)
    g_ref = torch.Generator().manual_seed(5)
    # step 1 from equal weights; steps 2 and 3 after AdamW's first
    # updates, which move a leaf whose gradient is round-off (a bias under
    # softmax) by a whole step of either sign
    for i, tol in enumerate((1e-5, 2e-3, 2e-3)):
        m = step(ring[i], g_port)
        r, _ = ref.step(ring[i], g_ref)
        for k, v in r.items():
            assert abs(float(m[k]) - v) <= tol * max(abs(v), 1e-3), (i, k)


def test_gradients_match_the_port():
    """Every leaf's gradient of one objective through the whole model: the
    port's float32 CPU path against the reference in float64. (At these
    widths the head's gradient is ill-conditioned in the ViT's features:
    the reference's own float32 lies ~1 % from its float64 on the worst
    leaf, so the comparison is made against float64.)"""
    tiny.few_threads()
    conf = tiny.load('tiny-vlm')
    arch = conf['architecture']
    _, bundle = _port(conf)
    w = weights.make(M.param_shapes(arch), 11, conf['weight_scales'], 'cpu')
    weights.load_into(bundle.model, w)
    for p in bundle.model.parameters():
        p.requires_grad_(True)
    x = traffic.train_batches(tiny.load('tiny-train'), 21, 11,
                              'cpu')[0]['img_x']
    text = torch.as_tensor(spec.text(conf['text']))
    r = torch.randn(2, 21, 64, 64, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    (bundle.model(x, text, train=True) * r.float()).sum().backward()
    P = {n: t.double().requires_grad_(True) for n, t in w.items()}
    (M.vlm_forward(P, {}, arch, x.double(), text.double(), M.Precision(),
                   train=True) * r).sum().backward()
    for n, p in bundle.model.named_parameters():
        if P[n].grad is None:
            assert p.grad is None or not p.grad.any(), n
            continue
        err = (p.grad.double() - P[n].grad).norm() / P[n].grad.norm()
        assert float(err) < 1e-4, n


def test_score_map_matches_the_ports_evaluator():
    tiny.few_threads()
    from semivl_tpu_torch.evaluation.predict import Evaluator
    conf = tiny.load('tiny-vlm')
    cfg, bundle = _port(conf, 'eval')
    shapes = {n: s for n, s in M.param_shapes(conf['architecture']).items()
              if not n.startswith('clip_')}
    w = weights.make(shapes, 4, conf['weight_scales'], 'cpu')
    weights.load_into(bundle.model, w)
    ev = Evaluator(bundle.model, bundle.text_feats, cfg, device='cpu')
    for it in traffic.eval_images(tiny.load('tiny-eval'), 21, 4):
        pred = ev.predict(it['img'][None], it['mask'].shape,
                          cfg['eval_mode'])[0]
        score = ref_eval.score_map(w, conf['architecture'],
                                   spec.text(conf['text']), it['img'], 64,
                                   cfg['stride'], M.Precision(), 'cpu')
        top2 = score.topk(2, 0).values
        clear = (top2[0] - top2[1]) > 1e-4 * score.std()
        assert np.array_equal(pred[clear.numpy()],
                              score.argmax(0).numpy()[clear.numpy()])
        h = ref_eval.histograms(pred, it['mask'], 21)
        assert h[2].sum() == (it['mask'] != 255).sum()


def test_float8_control_rounds_every_product():
    q = M.Precision('fp8')
    x = torch.randn(1000)
    y = q(x)
    assert not torch.equal(x, y)
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 16
    x.requires_grad_(True)
    q(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(1000))
