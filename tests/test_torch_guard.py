"""Guards of the PyTorch port: it stands alone (no JAX, nothing of the JAX
package), runs on the card unless told otherwise, and builds its kernels
from the sources in the repository."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import semivl_tpu_torch
from semivl_tpu_torch.configs import flagship_cfg
from semivl_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(semivl_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix='semivl_tpu_torch.'))


def _forbidden(name):
    return (name == 'jax' or name.startswith(('jax.', 'jaxlib', 'flax'))
            or name == 'semivl_tpu' or name.startswith('semivl_tpu.'))


def test_import_loads_no_jax():
    """Importing every module of the port, in a fresh interpreter, loads
    neither jax nor semivl_tpu."""
    code = ('import importlib, sys\n'
            f'for m in {_modules()!r}:\n'
            '    importlib.import_module(m)\n'
            'print("\\n".join(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, 'PYTHONPATH': ROOT}).stdout
    loaded = out.split()
    assert 'semivl_tpu_torch.evaluation.predict' in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_sources_import_no_jax():
    """No ``import`` in the package or in chip_smoke.py names jax or the JAX
    package."""
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_need_a_device_on_a_host_without_card():
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the default device exists')
    from semivl_tpu_torch.evaluation.predict import Evaluator
    from semivl_tpu_torch.models.builder import build_model
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(flagship_cfg())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evaluator(torch.nn.Identity(), np.zeros((21, 512)), flagship_cfg())


def test_flagship_config_and_text_asset():
    cfg = flagship_cfg()
    assert (cfg['crop_size'], cfg['stride'], cfg['nclass']) == (512, 426, 21)
    from semivl_tpu_torch.text.embeddings import (
        load_text_embedding, text_embedding_path)
    path = text_embedding_path(cfg['dataset'], cfg['text_embedding_variant'])
    assert path.startswith(PKG)
    text = load_text_embedding(path)
    assert text.shape == (21, 512) and text.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(text, axis=-1), 1.0, atol=2e-3)


def test_kernel_sources_and_build_keys():
    """Each kernel source has its own library, keyed by its content."""
    assert _build.sources() == ['flash_attention', 'fused_decoder']
    paths = {n: _build.library_path(n) for n in _build.sources()}
    assert len(set(paths.values())) == 2
    for n, p in paths.items():
        assert os.path.dirname(p) == _build.BUILD_DIR
        assert os.path.basename(p).startswith(n + '-') and p.endswith('.so')
        assert _build.library_path(n) == p
    with open(os.path.join(ROOT, '.gitignore')) as f:
        assert 'semivl_tpu_torch/_build/' in f.read().split()
