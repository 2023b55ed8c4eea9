"""Every configuration, traffic mix, limit file, per-layer metric and cell
that ``BENCHMARK.json`` names resolves by name, and holds to the
benchmark's rules on names and units."""

import json
import os
import re

import pytest

from portbench.harness import spec
from portbench.reference import model as ref_model

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_keys_and_names():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [x['name'] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    assert os.path.getsize(os.path.join(spec.ROOT, 'BENCHMARK.json')) \
        < 64 * 1024


@pytest.mark.parametrize('workload', CELLS)
def test_cell_resolves(workload):
    w, conf, mix, e2e, per_layer = spec.cell(workload)
    assert conf['name'] == w['config']
    assert mix['kind'] in ('semi_train', 'eval_images')
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2
    assert per_layer
    lim = spec.limits(workload)
    assert lim and all(isinstance(v, (int, float)) for v in lim.values())
    for m in per_layer:
        assert callable(spec.reader(m['name']))
        assert m['moves'] in names


@pytest.mark.parametrize('c', BENCH['configs'], ids=lambda c: c['name'])
def test_configuration_file(c):
    with open(os.path.join(spec.ROOT, c['file'])) as f:
        conf = json.load(f)
    assert conf['name'] == c['name'] and conf['source'] == c['source']
    assert conf['reduced'] == c['reduced']
    assert any(w['config'] == c['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('c', BENCH['configs'], ids=lambda c: c['name'])
def test_configuration_is_the_ports_as_run(c):
    """The file's values are what the port's run config holds, and the
    reference's parameters are the port's model's, name for name and shape
    for shape."""
    from semivl_tpu_torch.models.builder import build_model
    conf = spec.config(c['name'])
    cfg = spec.port_run_config(conf, 'train')
    spec.port_run_config(conf, 'eval')
    model = build_model(cfg, device='cpu').model
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(s) for n, s in
            ref_model.param_shapes(conf['architecture']).items()}
    assert got == want
    assert {n for n, _ in model.named_buffers()} == set(
        ref_model.buffer_shapes(conf['architecture']))
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == {n for n in want if ref_model.is_trainable(
        n, conf['architecture'])}
