"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
root of the checkout names the cells; each cell's configuration, traffic
mix, limits and per-layer metrics sit in files of their own under
``portbench/``."""

import importlib.util
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, 'portbench')
TEXT_DIR = os.path.join(ROOT, 'semivl_tpu_torch', 'assets', 'text_embedding')


def _json(*parts):
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


def benchmark():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def config(name):
    return _json('configs', f'{name}.json')


def traffic(name):
    return _json('traffic', f'{name}.json')


def limits(workload):
    return _json('limits', f'{workload}.json')


def reader(metric):
    """The ``read(reading)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(PKG, 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location(f'pb_metric_{metric}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(workload):
    """(the cell's entry, its configuration, its mix, its end-to-end and
    per-layer metric entries) of ``workload`` in ``BENCHMARK.json``."""
    bench = benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}: one of '
                         f'{sorted(cells)}')
    w = cells[workload]

    def mine(m):
        return workload in m.get('workloads', [workload])

    return (w, config(w['config']), traffic(w['traffic']),
            [m for m in bench['end_to_end'] if mine(m)],
            [m for m in bench['per_layer'] if mine(m)])


def text(name):
    """A text-embedding asset (a raw ``.npy`` file that the program reads
    too) as float32."""
    return np.load(os.path.join(TEXT_DIR, f'{name}.npy')).astype(np.float32)


def port_run_config(conf, kind):
    """The port's run config that the configuration file describes, built
    by the port's own function, with every value the file states checked
    against it: the file holds the configuration as it is run."""
    from semivl_tpu_torch import configs
    from semivl_tpu_torch.configs.models import get_model_config
    cfg = getattr(configs, conf[f'port_{kind}_config'])()
    for key in ('model', 'nclass', 'crop_size', 'eval_mode'):
        if cfg[key] != conf[key]:
            raise ValueError(f'{conf["name"]}: {key} {conf[key]!r} is not '
                             f'the port\'s {cfg[key]!r}')
    arch = dict(conf['architecture'])
    m = get_model_config(cfg['model'], img_size=cfg['crop_size'])['model']
    m['decode_head']['num_classes'] = cfg['nclass']
    m['decode_head']['decoder_bwd'] = cfg.get(
        'decoder_bwd', conf['architecture']['decode_head']['decoder_bwd'])
    want = {k: m.get(k) for k in ('backbone', 'decode_head', 'conv_encoder',
                                  'freeze_backbone', 'exclude_keys')}
    got = {k: arch.get(k) for k in want}
    if json.loads(json.dumps(want)) != got:
        raise ValueError(f'{conf["name"]}: the architecture is not the '
                         f'port\'s {cfg["model"]}')
    if kind == 'train':
        clip = get_model_config(cfg['clip_encoder'], img_size=(
            cfg['crop_size'] if cfg.get('mcc_fix_resize_pos') else 512))
        if json.loads(json.dumps(clip['backbone'])) != arch['clip_encoder']:
            raise ValueError(f'{conf["name"]}: the guidance encoder is not '
                             f'the port\'s {cfg["clip_encoder"]}')
        t, o = conf['train'], cfg['optimizer']
        pairs = [(t['conf_mode'], cfg['conf_mode']),
                 (t['conf_thresh'], cfg['conf_thresh']),
                 (t['maskclip_consistency_lambda'],
                  cfg['maskclip_consistency_lambda']),
                 (t['mcc_conf_thresh'], cfg['mcc_conf_thresh']),
                 (t['mcc_loss_reduce'], cfg['mcc_loss_reduce']),
                 (t['optimizer']['lr'], o['lr']),
                 (t['optimizer']['weight_decay'], o['weight_decay']),
                 (t['optimizer']['custom_keys'],
                  o['paramwise_cfg']['custom_keys']),
                 (arch['fp_rate'], cfg['fp_rate']),
                 (arch['renorm_clip_img'], bool((cfg.get('model_args') or {})
                                                .get('renorm_clip_img')))]
        for a, b in pairs:
            if json.loads(json.dumps(a)) != json.loads(json.dumps(b)):
                raise ValueError(f'{conf["name"]}: training value {a!r} is '
                                 f'not the port\'s {b!r}')
        if t['warmup_iters'] != cfg.get('warmup_iters', 0):
            raise ValueError(f'{conf["name"]}: warm-up differs')
    return cfg
