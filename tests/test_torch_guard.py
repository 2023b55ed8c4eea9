"""Guards of the PyTorch port: it stands alone (no JAX, nothing of the JAX
package), runs on the card unless told otherwise, and builds its kernels
from the sources in the repository."""

import ast
import functools
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import semivl_tpu_torch
from semivl_tpu_torch.configs import (ade_train_cfg, cityscapes_cfg,
                                      cityscapes_train_cfg, coco_train_cfg,
                                      flagship_cfg, flagship_train_cfg,
                                      tiny_cfg, tiny_train_cfg)
from semivl_tpu_torch.ops import _build
from semivl_tpu_torch.text.embeddings import (
    load_text_embedding,
    text_embedding_path,
)

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
    for m in ('semivl_tpu_torch.evaluation.predict',
              'semivl_tpu_torch.losses.seg_loss_plus',
              'semivl_tpu_torch.models.atm_head',
              'semivl_tpu_torch.models.deeplabv3plus',
              'semivl_tpu_torch.models.dlv3p_head',
              'semivl_tpu_torch.models.resnet',
              'semivl_tpu_torch.models.timm_vit',
              'semivl_tpu_torch.models.xception',
              'semivl_tpu_torch.models.zegclip_vit',
              'semivl_tpu_torch.ops.attention',
              'semivl_tpu_torch.ops.augment',
              'semivl_tpu_torch.ops.fused_decoder_banded',
              'semivl_tpu_torch.ops.fused_up',
              'semivl_tpu_torch.tools.fused_up_bench') + NEW_MODULES:
        assert m in loaded, m
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
    from semivl_tpu_torch.models.builder import ModelBundle, build_model
    from semivl_tpu_torch.train.step import make_semivl_train_step
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(flagship_cfg())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(flagship_train_cfg())
    for cfg in (tiny_cfg(), tiny_train_cfg()):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_model(cfg)
    for cfg in (cityscapes_cfg(), cityscapes_train_cfg()):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_model(cfg)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            Evaluator(torch.nn.Identity(), np.zeros((19, 512)), cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evaluator(torch.nn.Identity(), np.zeros((21, 512)), flagship_cfg())
    bundle = ModelBundle(model=torch.nn.Identity(),
                         text_feats=np.zeros((21, 512)),
                         mcc_text_feats=np.zeros((98, 512)))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_semivl_train_step(bundle, flagship_train_cfg(), None, 10)


def test_attention_bench_needs_a_card():
    """The attention bench times CUDA kernels only: without a card it
    raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the default device exists')
    from semivl_tpu_torch.tools import attention_bench
    with pytest.raises(RuntimeError, match='no CUDA device'):
        attention_bench.run('semivl_tpu_torch/csrc')


@pytest.mark.parametrize('tool', ['decoder_bench', 'conv_probe'])
def test_decoder_tools_need_a_card(tool):
    """The decoder bench (both backward routes and the fused Up stage
    against another checkout) and the conv probe time CUDA kernels only:
    without a card each raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the default device exists')
    import importlib
    mod = importlib.import_module(f'semivl_tpu_torch.tools.{tool}')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.run(*(['.scratch/parent'] if tool == 'decoder_bench' else []))


def test_flagship_config_and_text_asset():
    train = flagship_train_cfg()
    assert (train['clip_encoder'], train['mcc_text']) == ('mcvit16',
                                                          'concept4_single')
    from semivl_tpu_torch.text.embeddings import get_class_to_concept_idxs
    concept = load_text_embedding(text_embedding_path('pascal',
                                                      train['mcc_text']))
    assert concept.shape == (98, 512)
    idxs = get_class_to_concept_idxs('voc12_wbg_concept4_single')
    assert sorted(i for v in idxs.values() for i in v) == list(range(98))
    cfg = flagship_cfg()
    assert (cfg['crop_size'], cfg['stride'], cfg['nclass']) == (512, 426, 21)
    path = text_embedding_path(cfg['dataset'], cfg['text_embedding_variant'])
    assert path.startswith(PKG)
    text = load_text_embedding(path)
    assert text.shape == (21, 512) and text.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(text, axis=-1), 1.0, atol=2e-3)


def test_cityscapes_config_and_text_assets():
    """exp 44: 801 crops, 19 classes, the banded decoder backward, and the
    two Cityscapes text assets carried in the package (the 54 concepts of
    ``concept3`` cover the 19 classes)."""
    from semivl_tpu_torch.configs import get_model_config
    from semivl_tpu_torch.text.embeddings import get_class_to_concept_idxs
    cfg = cityscapes_train_cfg()
    assert (cfg['crop_size'], cfg['nclass'], cfg['eval_mode'],
            cfg['decoder_bwd'], cfg['conf_mode'], cfg['batch_size']) == (
                801, 19, 'sliding_window', 'banded', 'pixelavg', 1)
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    assert keys['conv_encoder'] == keys['backbone'] == {'lr_mult': 0.1}
    assert cfg['model_args'] == {'renorm_clip_img': True}
    model = get_model_config(cfg['model'], img_size=801)['model']
    assert model['conv_encoder']['depth'] == 101
    assert model['decode_head']['skip_in_channels'] == (768, 256)
    assert model['decode_head']['decoder_bwd'] == 'whole'  # until built
    for variant, n in ((cfg['text_embedding_variant'], 19),
                       (cfg['mcc_text'], 54)):
        path = text_embedding_path('cityscapes', variant)
        assert path.startswith(PKG)
        assert load_text_embedding(path).shape == (n, 512)
    idxs = get_class_to_concept_idxs('cityscapes_concept3_single')
    assert len(idxs) == 19
    assert sorted(i for v in idxs.values() for i in v) == list(range(54))


@pytest.mark.parametrize('make,dataset,n', [(coco_train_cfg, 'coco', 81),
                                            (ade_train_cfg, 'ade', 150)])
def test_coco_ade_configs_and_text_assets(make, dataset, n):
    """exps 42 and 43: the flagship model at 512 crops with 1 + 1 crops a
    step, lr 4e-4 with the backbone at x0.001, the whole-plane decoder
    backward, and the dataset's ``single`` text (one row per class, for the
    decoder and the guidance labels) carried in the package."""
    cfg = make()
    assert (cfg['crop_size'], cfg['nclass'], cfg['eval_mode'],
            cfg['decoder_bwd'], cfg['batch_size'], cfg['dataset']) == (
                512, n, 'zegclip_sliding_window', 'whole', 1, dataset)
    assert cfg['optimizer']['lr'] == 4e-4
    keys = cfg['optimizer']['paramwise_cfg']['custom_keys']
    assert keys['backbone'] == {'lr_mult': 0.001}
    for variant in {cfg['text_embedding_variant'], cfg['mcc_text']}:
        path = text_embedding_path(dataset, variant)
        assert path.startswith(PKG)
        assert load_text_embedding(path).shape == (n, 512)


def test_text_assets_equal_jax_bytes():
    """Every text embedding the JAX package ships is in the port, byte for
    byte (the port reads its own copies, never the JAX package's)."""
    jax_dir = os.path.join(ROOT, 'semivl_tpu', 'assets', 'text_embedding')
    port_dir = os.path.join(PKG, 'assets', 'text_embedding')
    names = sorted(n for n in os.listdir(jax_dir) if n.endswith('.npy'))
    assert len(names) == 8
    assert sorted(n for n in os.listdir(port_dir)
                  if n.endswith('.npy')) == names
    for name in names:
        with open(os.path.join(jax_dir, name), 'rb') as a, \
                open(os.path.join(port_dir, name), 'rb') as b:
            assert a.read() == b.read(), name


def test_kernel_sources_and_build_keys():
    """Each kernel source has its own library, keyed by its content."""
    assert _build.sources() == ['flash_attention', 'flash_attention_heads',
                                'fused_decoder', 'fused_decoder_banded',
                                'fused_decoder_bwd']
    paths = {n: _build.library_path(n) for n in _build.sources()}
    assert len(set(paths.values())) == 5
    for n, p in paths.items():
        assert os.path.dirname(p) == _build.BUILD_DIR
        assert os.path.basename(p).startswith(n + '-') and p.endswith('.so')
        assert _build.library_path(n) == p
    with open(os.path.join(ROOT, '.gitignore')) as f:
        assert 'semivl_tpu_torch/_build/' in f.read().split()


# the LoRA attention (models.layers), the MaskCLIP heads, the CLIP text
# encoder, the evaluation CLI, the checkpoint converters and the demos
NEW_MODULES = (
    'semivl_tpu_torch.models.maskclip_heads',
    'semivl_tpu_torch.text.text_encoder',
    'semivl_tpu_torch.tools.convert_clip_weights',
    'semivl_tpu_torch.tools.convert_timm_weights',
    'semivl_tpu_torch.tools.convert_reference_ckpt',
    'semivl_tpu_torch.tools.convert_to_torch',
    'semivl_tpu_torch.tools.eval', 'semivl_tpu_torch.tools.parity_check',
    'semivl_tpu_torch.tools.semi_effect_demo',
    'semivl_tpu_torch.tools.pseudo_label_quality')

# the trainer entry point's modules (data pipeline, configs, loop, CLI,
# the process group and the multi-rank dry run), the exp-41 models it
# builds (DeepLabV3+, ZegCLIP with its SegLossPlus) and the baselines'
# (the UniMatch DeepLabV3+ and its Xception-65, the on-device augmentation)
TRAINER_MODULES = (
    'semivl_tpu_torch.configs.experiments', 'semivl_tpu_torch.data.dataset',
    'semivl_tpu_torch.models.dlv3p_head', 'semivl_tpu_torch.models.timm_vit',
    'semivl_tpu_torch.models.zegclip_vit', 'semivl_tpu_torch.models.atm_head',
    'semivl_tpu_torch.losses.seg_loss_plus',
    'semivl_tpu_torch.models.deeplabv3plus',
    'semivl_tpu_torch.models.xception', 'semivl_tpu_torch.ops.augment',
    'semivl_tpu_torch.data.loader', 'semivl_tpu_torch.data.transforms',
    'semivl_tpu_torch.datasets.classes', 'semivl_tpu_torch.datasets.palettes',
    'semivl_tpu_torch.native.build', 'semivl_tpu_torch.native.loader',
    'semivl_tpu_torch.parallel.dist',
    'semivl_tpu_torch.tools.dryrun_multichip',
    'semivl_tpu_torch.tools.experiments', 'semivl_tpu_torch.tools.train',
    'semivl_tpu_torch.train.checkpoint', 'semivl_tpu_torch.train.loop',
    'semivl_tpu_torch.utils.code_archive',
    'semivl_tpu_torch.utils.logging_utils', 'semivl_tpu_torch.utils.plotting'
) + NEW_MODULES


@pytest.mark.parametrize('module', TRAINER_MODULES)
def test_trainer_modules_import_no_jax(module):
    """Each module of the trainer entry point, imported alone in a fresh
    interpreter, loads neither jax nor semivl_tpu."""
    code = (f'import importlib, sys\nimportlib.import_module({module!r})\n'
            'print("\\n".join(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, 'PYTHONPATH': ROOT}).stdout
    assert module in out.split()
    assert [m for m in out.split() if _forbidden(m)] == []


def test_trainer_entry_points_need_a_device(tmp_path, monkeypatch):
    """Without a card the trainer (``train.loop.train``), its CLI
    (``tools.train``, no ``--device``) and ``evaluate``'s evaluator raise
    before they write anything; ``--device cpu`` is the way to the plain
    path."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the default device exists')
    from semivl_tpu_torch.configs.experiments import generate_experiment_cfgs
    from semivl_tpu_torch.evaluation.predict import Evaluator
    from semivl_tpu_torch.tools import train as cli
    from semivl_tpu_torch.train.loop import train
    import yaml
    monkeypatch.chdir(tmp_path)
    cfg = generate_experiment_cfgs(40)[0]
    with open('cfg.yaml', 'w') as f:
        yaml.dump(cfg, f)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['--config', 'cfg.yaml'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evaluator(torch.nn.Identity(), np.zeros((21, 512)), cfg)
    out = subprocess.run([sys.executable, '-m', 'semivl_tpu_torch.tools.train',
                          '--config', 'cfg.yaml'], capture_output=True,
                         text=True, env={**os.environ, 'PYTHONPATH': ROOT})
    assert out.returncode != 0 and 'no CUDA device' in out.stderr
    assert not os.path.exists('exp')


@pytest.mark.parametrize('entry', [
    'eval', 'parity_check', 'semi_effect_demo', 'pseudo_label_quality',
    'pretrain_guidance', 'generate_text_embeddings'])
def test_new_entry_points_need_a_device(entry, tmp_path, monkeypatch):
    """Without a card the evaluation CLI, ``parity_check``, both demos,
    the guidance pretraining and the text-embedding generation raise
    before they read or write anything; ``--device cpu`` (``device='cpu'``)
    is the way to the plain path."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the default device exists')
    import importlib
    monkeypatch.chdir(tmp_path)
    if entry == 'pretrain_guidance':
        from semivl_tpu_torch.tools.semi_effect_demo import pretrain_guidance
        call = functools.partial(pretrain_guidance, str(tmp_path), (72, 88))
    elif entry == 'generate_text_embeddings':
        from semivl_tpu_torch.text.text_encoder import (
            generate_text_embeddings)
        call = functools.partial(generate_text_embeddings, ['cat'], {})
    else:
        main = importlib.import_module(f'semivl_tpu_torch.tools.{entry}').main
        args = {'eval': ['--config', 'missing.yaml', '--save-path', 'none'],
                'parity_check': ['--config', 'missing.yaml', '--ckpt',
                                 'missing.pth']}.get(
                                     entry, ['--out-root', 'out'])
        call = functools.partial(main, args)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        call()
    assert os.listdir(tmp_path) == []
