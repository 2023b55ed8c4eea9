"""Port evaluation vs the JAX package on the CPU (``zegclip_sliding_window``).

Predictions must be identical except at pixels whose top two JAX logits lie
within 1e-4 (float32 sums in another order may swap a near tie there), and
the IoU histograms must follow."""

import numpy as np
import pytest
import torch

from semivl_tpu.evaluation import metrics as jax_metrics
from semivl_tpu.evaluation.predict import Evaluator as JaxEvaluator
from semivl_tpu.evaluation.predict import _chunk_sizes as jax_chunk_sizes
from semivl_tpu.evaluation.predict import evaluate as jax_evaluate
from semivl_tpu_torch.evaluation import metrics
from semivl_tpu_torch.evaluation.predict import (
    Evaluator, _chunk_sizes, evaluate)

from torch_parity import text_embedding, tiny_vlm

CFG = dict(nclass=21, crop_size=64, stride=48,
           eval_mode='zegclip_sliding_window')


@pytest.fixture(scope='module')
def evaluators():
    jm, params, pm = tiny_vlm(seed=11)
    text = text_embedding()
    return (JaxEvaluator(jm, {'params': params}, text, CFG),
            Evaluator(pm, text, CFG, device='cpu'))


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(1, h, w, 3) * 255).astype(
        np.uint8)


def _check_pred(got, jev, img, mask_shape):
    """got vs the JAX device-path prediction, excusing near-ties of the
    JAX logits (host path, the same math)."""
    want = jev.predict(img, mask_shape, 'zegclip_sliding_window')
    _, logits = jev.predict(img, mask_shape, 'zegclip_sliding_window',
                            return_logits=True)
    top2 = np.sort(logits[0], axis=0)[-2:]
    tie = (top2[1] - top2[0]) < 1e-4
    assert got.shape == want.shape == (1,) + tuple(mask_shape)
    assert got.dtype == want.dtype == np.int64
    assert ((got == want) | tie[None]).all()
    return want


@pytest.mark.parametrize('hw,seed', [((80, 112), 0), ((48, 100), 1)])
def test_zegclip_prediction_matches_jax(evaluators, hw, seed):
    """(80, 112): 4 windows on the device route; (48, 100): shorter than
    the crop, so the host route with clipped windows."""
    jev, ev = evaluators
    img = _image(*hw, seed)
    assert ev.use_device(img, 'zegclip_sliding_window') == (min(hw) >= 64)
    got = ev.predict(img, hw, 'zegclip_sliding_window')
    want = _check_pred(got, jev, img, hw)
    mask = np.random.RandomState(seed + 10).randint(0, 21, hw)
    mask[:4] = 255
    for a, b in zip(metrics.intersection_and_union(got[0], mask, 21),
                    jax_metrics.intersection_and_union(want[0], mask, 21)):
        np.testing.assert_array_equal(a, b)


def test_evaluate_matches_jax(evaluators):
    jev, ev = evaluators

    class DS:
        def __init__(self):
            self.items = [(_image(80, 112, 3)[0], (80, 112)),
                          (_image(64, 64, 4)[0], (64, 64))]

        def __len__(self):
            return len(self.items)

        def get(self, i):
            img, hw = self.items[i]
            return {'img': img, 'mask': np.random.RandomState(i).randint(
                0, 21, hw)}

    miou, iou = evaluate(ev, DS(), 'zegclip_sliding_window', CFG)
    jmiou, jiou = jax_evaluate(jev, DS(), 'zegclip_sliding_window', CFG)
    assert miou == pytest.approx(jmiou, abs=1e-9)
    np.testing.assert_allclose(iou, jiou, atol=1e-9)
    assert iou.shape == jiou.shape == (21,)


def test_metrics_and_chunks_match_jax():
    rs = np.random.RandomState(0)
    out = rs.randint(0, 5, (2, 16, 16))
    tgt = rs.randint(0, 5, (2, 16, 16))
    tgt[0, :2] = 255
    for a, b in zip(metrics.intersection_and_union(out, tgt, 5),
                    jax_metrics.intersection_and_union(out, tgt, 5)):
        np.testing.assert_array_equal(a, b)
    inter = rs.rand(5)
    union = inter + rs.rand(5)
    assert metrics.miou_from_histograms(inter, union)[0] == \
        jax_metrics.miou_from_histograms(inter, union)[0]
    for n in range(1, 70):
        assert _chunk_sizes(n) == jax_chunk_sizes(n)


def test_float_input_passes_through(evaluators):
    """Normalised float images are not normalised again."""
    _, ev = evaluators
    x = torch.randn(1, 8, 8, 3)
    assert ev._to_model_input(x) is x
    u = torch.full((1, 2, 2, 3), 255, dtype=torch.uint8)
    want = (1.0 - np.array([0.485, 0.456, 0.406])) / np.array(
        [0.229, 0.224, 0.225])
    np.testing.assert_allclose(ev._to_model_input(u)[0, 0, 0].numpy(), want,
                               rtol=1e-6)
