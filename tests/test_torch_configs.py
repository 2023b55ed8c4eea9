"""The port's run-config generator (``semivl_tpu_torch.configs.experiments``)
against the JAX package's and the golden snapshot of the reference's output,
key for key, its YAML files and its CLI; and the exp-40 config as the port's
``build_model`` and step read it."""

import json
import os
import subprocess
import sys

import pytest
import yaml

from semivl_tpu.configs import experiments as jax_experiments
from semivl_tpu_torch.configs import experiments

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__),
                                     'golden_experiment_cfgs.json')))


@pytest.mark.parametrize('exp_id', [40, 41, 42, 43, 44])
def test_generate_matches_golden_and_jax(exp_id):
    """Every config of the grid equals JAX's (the whole dict, run name,
    version and git revision included) and holds the golden file's keys
    with its values."""
    cfgs = experiments.generate_experiment_cfgs(exp_id)
    assert cfgs == jax_experiments.generate_experiment_cfgs(exp_id)
    golden = GOLDEN[str(exp_id)]
    assert len(cfgs) == len(golden)
    for mine, ref in zip(cfgs, golden):
        assert mine['name'] == ref['name']
        for k, v in ref.items():
            got = mine[k]
            if isinstance(v, list) and isinstance(got, tuple):
                got = list(got)
            assert got == v, (exp_id, ref['name'], k, got, v)


def test_config_from_vars_matches_jax():
    kw = dict(exp_id=7, dataset='cityscapes', split='1_8', crop_size=801,
              iters=100, epochs=None, warmup_iters=1500, opt='original',
              eval_mode='sliding_window', mcc_fix_resize_pos=True,
              maskclip_consistency_lambda=0.1, maskclip_class_filter=1)
    assert experiments.config_from_vars(**kw) == \
        jax_experiments.config_from_vars(**kw)
    d = {'a': {'b': 1}}
    experiments.nested_set(d, 'a.c.d', 2)
    assert d == {'a': {'b': 1, 'c': {'d': 2}}}
    assert experiments.nested_get(d, 'a.c.d') == 2
    assert experiments.nested_get(d, 'a.x.y', 5) == 5


@pytest.mark.parametrize('exp_id', [40, 44])
def test_save_experiment_cfgs_writes_yaml_that_loads_equal(tmp_path, exp_id):
    """``save_experiment_cfgs`` writes one YAML per config, named by its
    run name, that loads back equal to the config and byte-equal to JAX's
    file."""
    cfgs, files = experiments.save_experiment_cfgs(exp_id, str(tmp_path))
    _, jfiles = jax_experiments.save_experiment_cfgs(
        exp_id, str(tmp_path / 'jax'))
    assert len(files) == len(cfgs) == len(jfiles)
    for cfg, path, jpath in zip(cfgs, files, jfiles):
        assert os.path.basename(path) == cfg['name'] + '.yaml'
        with open(path) as f:
            loaded = yaml.load(f, Loader=yaml.Loader)
        assert loaded == cfg
        with open(path, 'rb') as f, open(jpath, 'rb') as g:
            assert f.read() == g.read()


def test_experiments_cli_lists(tmp_path):
    """``python -m semivl_tpu_torch.tools.experiments --exp 40 --list``
    writes exp 40's five configs under ``configs/generated/exp-40``."""
    out = subprocess.run(
        [sys.executable, '-m', 'semivl_tpu_torch.tools.experiments',
         '--exp', '40', '--list'], cwd=tmp_path, check=True,
        capture_output=True, text=True,
        env={**os.environ, 'PYTHONPATH': ROOT}).stdout
    assert len(out.splitlines()) == 5
    assert len(os.listdir(tmp_path / 'configs' / 'generated' / 'exp-40')) == 5


def test_exp40_config_is_what_the_port_reads():
    """Exp 40's generated split-92 config carries every key the port's
    ``build_model``, step and loop read, with the values of the port's
    hand-written flagship training config."""
    from semivl_tpu_torch.configs import flagship_train_cfg
    cfg = experiments.generate_experiment_cfgs(40)[0]
    ref = flagship_train_cfg()
    for k, v in ref.items():
        if k == 'maskclip_consistency_lambda':
            assert list(cfg[k]) == list(v)
        else:
            assert cfg[k] == v, k
    assert cfg['split'] == '92' and cfg['batch_size'] == 2
