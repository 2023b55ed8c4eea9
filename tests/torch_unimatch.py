"""Shared pieces of the UniMatch baselines' parity tests
(tests/test_torch_baselines.py, test_torch_unimatch_encoders.py,
test_torch_unimatch_dlv3p.py): random weights and BatchNorm statistics of
the JAX networks carried into the port through ``convert``, the
train-mode BatchNorm bound, the UniMatch DeepLabV3+ set-ups and their
step's inputs.

The train-mode BatchNorm bound (``bn_tol``): the larger of 1e-5 and twice
JAX's own float32 distance from the float64 forward. JAX's BatchNorm is
pinned to float32, so the float64 forward is the port's at float64; on a
random ResNet-50 at 65^2 JAX's own float32 lies ~2.5e-4 from it at c4
(BatchNorm over 2 x 5 x 5 positions amplifies the roundings of the layers
before)."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semivl_tpu.models.deeplabv3plus import DeepLabV3Plus as JaxDLV3P
from semivl_tpu_torch import convert
from semivl_tpu_torch.configs.experiments import config_from_vars
from semivl_tpu_torch.models.deeplabv3plus import DeepLabV3Plus

from torch_parity import (MARGIN, InjectedDropout, gap_threshold,
                          random_tree, semivl_batch)

# the test sizes of the DeepLabV3+ encoders: c4 at 5^2 and 3^2
DLV3P_IMG = {'resnet50': 65, 'xception': 33}
NCLS = 5


def as_tensor(a):
    return torch.from_numpy(np.require(a, requirements=('C', 'W')))


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def random_stats(shapes, seed):
    """BatchNorm running statistics: means N(0, 0.1), variances in
    [0.5, 1.5]."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if jax.tree_util.keystr(path).endswith("'var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def bn_tol(jax32, ref64):
    """The train-mode bound (module docstring): the larger of 1e-5 and
    twice JAX's own float32 distance from the float64 forward."""
    return max(1e-5, 2 * rel_l2(jax32, ref64))


def stats_vectors(sd):
    """All running means and all running variances of a state dict, each
    concatenated in key order."""
    keys = sorted(k for k in sd if k.endswith('running_mean'))
    return [np.concatenate([np.ravel(np.asarray(sd[k[:-4] + what]))
                            for k in keys]) for what in ('mean', 'var')]


def jax_tree(module, seed, size, batch=2, **init_kw):
    """Random numpy params and BatchNorm statistics of a flax module."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'fp': jax.random.PRNGKey(1)},
        jnp.zeros((batch, size, size, 3)), **init_kw))
    return (random_tree(shapes['params'], seed),
            random_stats(shapes['batch_stats'], seed + 1))


def port_encoder(cls, export, params, stats, dtype=torch.float32, **kw):
    sd = {}
    export(sd, params, stats, prefix='')
    m = cls(dtype=dtype, **kw)
    m.load_state_dict({k: as_tensor(v) for k, v in sd.items()})
    return m.double() if dtype == torch.float64 else m


def encoder_readings(jm, params, stats, make_port, x):
    """Both frameworks' eval-mode and train-mode outputs and the running
    statistics after the train-mode call, and the port's at float64."""
    v = {'params': params, 'batch_stats': stats}
    out = dict(jax_eval=[np.asarray(o) for o in jm.apply(v, x)])
    jtrain, upd = jm.apply(v, x, train=True, mutable=['batch_stats'])
    out['jax_train'] = [np.asarray(o) for o in jtrain]
    for name, dtype in (('port', torch.float32), ('port64', torch.float64)):
        m = make_port(dtype)
        xt = as_tensor(x).to(dtype)
        with torch.no_grad():
            out[name + '_eval'] = [o.numpy() for o in m(xt)]
            out[name + '_train'] = [o.numpy() for o in m(xt, train=True)]
        out[name + '_stats'] = stats_vectors(
            {k: t.numpy() for k, t in m.state_dict().items()})
    return out, upd['batch_stats']


@functools.lru_cache(maxsize=None)
def dlv3p_setup(bb):
    """The UniMatch DeepLabV3+ over NCLS classes on encoder ``bb``: the JAX
    module (``axis_name='data'``, for the steps) and its mesh-free twin,
    params and statistics, and a maker of the port's model at a dtype."""
    jm = JaxDLV3P(num_classes=NCLS, backbone=bb)
    params, stats = jax_tree(jm, 51, DLV3P_IMG[bb], batch=1)

    def make(dtype=torch.float32):
        m = convert.load_jax_params(
            DeepLabV3Plus(NCLS, backbone=bb, dtype=dtype), params, stats)
        return m.double() if dtype == torch.float64 else m

    local = jm.clone(axis_name=None)
    return dict(backbone=bb, jm=jm, local=local,
                apply=jax.jit(local.apply),
                params=params, stats=stats, make=make, img=DLV3P_IMG[bb])


def dlv3p_keeps(d, rows, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(rows, 1, 1, c) < 0.5 for c in (256, 2048)]


def dlv3p_threshold(pm, batch, keeps):
    """A confidence threshold in a gap of the pseudo-labels' confidences
    (the teacher's in eval mode, the student's w half in train mode),
    after checking the argmax margin of every pixel that counts; the
    model's state is left as it was."""
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    fake = InjectedDropout(keeps)
    b = batch['img_x'].shape[0]
    with torch.no_grad(), mock.patch(
            'semivl_tpu_torch.models.deeplabv3plus.dropout2d', fake.torch):
        teacher = pm(as_tensor(batch['img_w_other']))
        student = pm(as_tensor(np.concatenate([batch['img_x'],
                                               batch['img_w']])),
                     need_fp=True, train=True)[0][b:]
    pm.load_state_dict(state)
    probs = [torch.softmax(t, 1).numpy() for t in (teacher, student)]
    thresh, margin = gap_threshold(np.concatenate(
        [p.max(axis=1).ravel() for p in probs]))
    assert margin > MARGIN
    n_kept = 0
    for p in probs:
        top2 = np.sort(p, axis=1)[:, -2:]
        kept = top2[:, 1] >= thresh
        n_kept += kept.sum()
        assert (top2[:, 1] - top2[:, 0])[kept].min(initial=1.0) > MARGIN
    assert 0 < n_kept
    return thresh


def dlv3p_step_inputs(d):
    """A UniMatch batch of 2 + 2 crops at the encoder's test size, its
    perturbation masks and the ``dlv3p`` config's ``original`` SGD (lr
    1e-3, ``lr_multi`` 10) and CELoss."""
    size = d['img']
    batch = semivl_batch(55, 2, size, nclass=NCLS)
    batch['cutmix_box1'] = np.array([[3, 2, size // 2, size // 2],
                                     [0, 0, size, size // 3]], np.int32)
    batch['cutmix_box2'] = np.array([[size // 3, size // 4, size // 2,
                                      size // 2], [1, 5, size // 2, size]],
                                    np.int32)
    keeps = dlv3p_keeps(d, 2, 56)
    pm = d['make']()
    cfg = config_from_vars(exp_id=99, model='dlv3p-r101', method='unimatch',
                           opt='original', lr=1e-3, criterion='CELoss',
                           criterion_u='CELoss', crop_size=size,
                           img_scale=None)
    cfg.update(backbone=d['backbone'], nclass=NCLS,
               conf_thresh=dlv3p_threshold(pm, batch, keeps))
    return batch, keeps, pm, cfg
