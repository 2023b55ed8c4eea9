"""Checkpointing with true resume (the counterpart of
``semivl_tpu/train/checkpoint.py::CheckpointManager``).

The reference only saves ``best.pth`` (model + optimizer + epoch,
semivl.py:423-433) and has no resume path. Here each slot (``best``,
``latest``) under ``<run dir>/ckpt/`` is one ``torch.save`` file of every
parameter and buffer of the model (the BatchNorm running statistics
included), the optimizer's state and the iteration, with a sidecar
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
             extra: Optional[dict] = None):
        """``model``'s state dict, ``optimizer``'s and the iteration into
        slot ``name``; ``extra``: small JSON-able scalars."""
        path = self._slot(name)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save({'model': model.state_dict(),
                    'optimizer': optimizer.state_dict(),
                    'iteration': int(iteration)}, tmp)
        os.replace(tmp, path)
        with open(path + '.extra.json', 'w') as f:
            json.dump({k: float(v) for k, v in (extra or {}).items()}, f)

    def restore(self, name, model, optimizer):
        """Load slot ``name`` into ``model`` (strict) and ``optimizer``;
        returns (iteration, extra)."""
        path = self._slot(name)
        payload = torch.load(path, map_location='cpu', weights_only=True)
        model.load_state_dict(payload['model'], strict=True)
        optimizer.load_state_dict(payload['optimizer'])
        extra = {}
        if os.path.isfile(path + '.extra.json'):
            with open(path + '.extra.json') as f:
                extra = json.load(f)
        return int(payload['iteration']), extra

    def exists(self, name):
        return os.path.isfile(self._slot(name))
