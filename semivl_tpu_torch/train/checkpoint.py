"""Checkpointing with true resume (the counterpart of
``semivl_tpu/train/checkpoint.py::CheckpointManager``).

The reference only saves ``best.pth`` (model + optimizer + epoch,
semivl.py:423-433) and has no resume path. Here each slot (``best``,
``latest``) under ``<run dir>/ckpt/`` is one ``torch.save`` file of every
parameter and buffer of the model (the BatchNorm running statistics
included), the optimizer's state, the iteration and, in a run with
``ema_decay``, the parameter EMA (``ema``, beside ``model`` as JAX's slot
holds ``ema_params`` beside ``params``), with a sidecar
``<slot>.extra.json`` of scalar metadata (epoch, epoch step,
previous best), as the JAX manager writes it beside its orbax slot. A slot
is written to a temporary file and renamed, so a run killed mid-save keeps
its previous checkpoint.
"""

import json
import os
from typing import Optional

import torch


class CheckpointManager:
    def __init__(self, save_path):
        self.root = os.path.abspath(os.path.join(save_path, 'ckpt'))
        os.makedirs(self.root, exist_ok=True)

    def _slot(self, name):
        return os.path.join(self.root, name)

    def save(self, name, model, optimizer, iteration,
             extra: Optional[dict] = None, ema=None):
        """``model``'s state dict, ``optimizer``'s, the iteration and the
        parameter EMA ``ema`` (name -> tensor; None: none) into slot
        ``name``; ``extra``: small JSON-able scalars."""
        path = self._slot(name)
        tmp = f'{path}.{os.getpid()}.tmp'
        payload = {'model': model.state_dict(),
                   'optimizer': optimizer.state_dict(),
                   'iteration': int(iteration)}
        if ema is not None:
            payload['ema'] = ema
        torch.save(payload, tmp)
        os.replace(tmp, path)
        with open(path + '.extra.json', 'w') as f:
            json.dump({k: float(v) for k, v in (extra or {}).items()}, f)

    def restore(self, name, model, optimizer, ema=None):
        """Load slot ``name`` into ``model`` (strict), ``optimizer`` and,
        where the slot has one, its EMA into ``ema`` (a slot without one
        leaves ``ema`` as it is, as JAX's restore keeps the state's);
        returns (iteration, extra)."""
        path = self._slot(name)
        payload = torch.load(path, map_location='cpu', weights_only=True)
        model.load_state_dict(payload['model'], strict=True)
        optimizer.load_state_dict(payload['optimizer'])
        if ema is not None and 'ema' in payload:
            if set(payload['ema']) != set(ema):
                raise ValueError(f'{path}: the EMA names differ from the '
                                 'model\'s parameters')
            with torch.no_grad():
                for k, v in payload['ema'].items():
                    ema[k].copy_(v)
        extra = {}
        if os.path.isfile(path + '.extra.json'):
            with open(path + '.extra.json') as f:
                extra = json.load(f)
        return int(payload['iteration']), extra

    def exists(self, name):
        return os.path.isfile(self._slot(name))
