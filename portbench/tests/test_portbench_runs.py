"""Whole runs of the benchmark: the tiny cell driven on the CPU with the
look for a card skipped (sound, with each fault a cell can have, and the
float8 control in the program's place), the exit without a card, the
modules a run loads, and on the card a short run of each cell."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.harness import cells, spec
from portbench.tests import tiny

ROOT = spec.ROOT


def _result(capsys, **kw):
    tiny.few_threads()
    rc = run.main(check_card=False, device='cpu', **kw)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


TRAIN = ['--workload', 'tiny', '--seed', '3', '--seconds', '1', '--trace',
         '0']
EVAL = ['--workload', 'tiny', '--seed', '1', '--seconds', '1', '--trace',
        '0']


def test_tiny_train_run_is_correct(capsys):
    r = _result(capsys, argv=TRAIN,
                resolve=tiny.resolver('tiny-train', tiny.TRAIN_LIMITS))
    assert r['correct'], r['compared']
    assert set(r) >= {'correct', 'attempted', 'failed', 'metrics', 'device'}
    assert list(r)[-1] == 'compared'
    assert set(r['metrics']) == {'train_imgs_per_s', 'peak_mem_gib',
                                 'setup_s'}


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch'])
def test_tiny_train_run_with_a_fault_is_not_correct(capsys, fault):
    r = _result(capsys, argv=TRAIN, fault=fault,
                resolve=tiny.resolver('tiny-train', tiny.TRAIN_LIMITS))
    assert not r['correct'], r['compared']


def test_tiny_eval_run_is_correct(capsys):
    r = _result(capsys, argv=EVAL,
                resolve=tiny.resolver('tiny-eval', tiny.EVAL_LIMITS))
    assert r['correct'], r['compared']
    assert r['attempted'] >= 256 and r['failed'] == 0
    assert set(r['metrics']) == {'eval_imgs_per_s', 'eval_image_ms_p95',
                                 'peak_mem_gib', 'setup_s'}


def test_tiny_eval_run_with_answers_altered_is_not_correct(capsys):
    r = _result(capsys, argv=EVAL, fault='altered',
                resolve=tiny.resolver('tiny-eval', tiny.EVAL_LIMITS))
    assert not r['correct'], r['compared']


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_tiny_train_control_is_not_correct(seed):
    """The reference in float8 in the program's place fails the limits."""
    tiny.few_threads()
    cell = cells.TrainCell(tiny.load('tiny-vlm'), tiny.load('tiny-train'),
                           'cpu')
    ring = cell.inputs(seed)
    numbers = cells.compare_train(cell.reference(seed, ring, 'fp8'),
                                  cell.reference(seed, ring))
    assert any(numbers[k][0] > lim for k, lim in tiny.TRAIN_LIMITS.items()), \
        numbers


def test_tiny_eval_control_is_not_correct():
    tiny.few_threads()
    cell = cells.EvalCell(tiny.load('tiny-vlm'), tiny.load('tiny-eval'),
                          'cpu')
    cell.load(2)
    items = cell.images(2)
    sample = cell.samples(2, items)
    numbers = cell.reference(2, items, cells.control_stash(cell, 2, items,
                                                           sample))
    assert numbers['pixel_gap'][0] > tiny.EVAL_LIMITS['pixel_gap'], numbers


def _python(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300, **kw)


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    p = _python(['-m', 'portbench.run', '--workload', 'cs-train', '--seed',
                 '1', '--seconds', '1', '--trace', '0'])
    assert p.returncode != 0
    assert p.stdout.strip() == ''
    assert 'CUDA card' in p.stderr


def test_a_run_loads_no_jax():
    """Every module a run imports, and none of JAX or the JAX package
    (top-level names compared whole: ``semivl_tpu_torch`` is not
    ``semivl_tpu``)."""
    code = ('import sys, portbench.run as r, portbench.calibrate, '
            'portbench.harness.cells, portbench.harness.trace, '
            'portbench.harness.report, semivl_tpu_torch.train.step, '
            'semivl_tpu_torch.evaluation.predict, '
            'semivl_tpu_torch.models.builder; '
            'print(r.forbidden_modules())')
    p = _python(['-c', code], input='')
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[]'


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'semivl_tpu_torch_x', sys)
    assert 'semivl_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert 'jax' in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    code = ('import sys, portbench.reference.model, '
            'portbench.reference.step, portbench.reference.evaluate; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("semivl_tpu", "semivl_tpu_torch", "jax")))')
    p = _python(['-c', code], input='')
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[]'


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['cs-train', 'ade-eval'])
def test_cell_runs_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = _python(['-m', 'portbench.run', '--workload', workload, '--seed',
                 '12345', '--seconds', '2', '--trace', '0'])
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])['correct']


def test_key_part_of_a_packed_bias_is_left_out_by_its_gradient():
    """A packed q, k, v bias counts as three parts; the key part, whose
    reference gradient is nought to rounding, is left out by the rule on
    that gradient, and the rest of the leaf is still compared."""
    def leaf(q, k, v):
        return torch.cat([torch.full((4,), q), torch.full((4,), k),
                          torch.full((4,), v)])
    ref_g = cells._norms({'a.in_proj_bias': leaf(1.0, 1e-9, 1.0),
                          'b.weight': torch.ones(4),
                          'c.weight': torch.ones(4)})
    assert set(ref_g) == {'a.in_proj_bias[q]', 'a.in_proj_bias[k]',
                          'a.in_proj_bias[v]', 'b.weight', 'c.weight'}
    ref_c = dict.fromkeys(ref_g, 1.0)
    prog_c = dict(ref_c, **{'a.in_proj_bias[k]': 5.0})
    losses = [{'loss_all': 1.0}]

    def numbers():
        return cells.compare_train(
            dict(losses=losses, grad1=ref_g, change=prog_c),
            dict(losses=losses, grad1=ref_g, change=ref_c))
    assert numbers()['change_gap'][0] == 0.0
    assert numbers()['vanishing_left_out'] == (1.0, 'a.in_proj_bias[k]')
    prog_c['a.in_proj_bias[v]'] = 2.0
    assert numbers()['change_gap'][0] == 1.0
    assert numbers()['vanishing_change_gap'][0] == 4.0
