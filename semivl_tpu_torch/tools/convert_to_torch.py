"""A port training run's checkpoint -> the reference's ``best.pth`` layout
(counterpart of ``semivl_tpu/tools/convert_to_torch.py``, the inverse of
``convert_reference_ckpt``).

Writes ``{'model': state_dict, 'epoch': N}`` (reference semivl.py:423-433)
with the keys JAX's ``export_vlm_checkpoint`` names: the MaskCLIP ViT
backbone, the VLG decode head and, in the Cityscapes models, the
ResNetV1c conv encoder with its BatchNorm running statistics and a zero
``num_batches_tracked`` (so the reference's ``load_state_dict(strict=True)``
takes it). The frozen guidance encoder is left out, as the reference's
loader expects (its eval.py:130-139 ignores a missing ``clip_encoder.*``).
The port's parameter names are the reference's already, so this is a
selection of the slot's state dict; with ``--ema`` the slot's parameter
EMA stands in for the parameters (the running statistics stay the
model's). The epoch comes from ``<slot>.extra.json``.

    python -m semivl_tpu_torch.tools.convert_to_torch \\
        --run-dir exp/exp-40/<run> [--slot best|latest] --out best.pth [--ema]
"""

import argparse
import json
import os

import numpy as np
import torch

EXPORTED = ('backbone.', 'decode_head.', 'conv_encoder.')


def export_vlm_checkpoint(state_dict):
    """The port VLM's state dict -> the reference-named flat dict of JAX's
    ``export_vlm_checkpoint`` (float32 numpy, ``num_batches_tracked``
    int64 zeros). The VLG head and the MaskCLIP ViT only, as JAX's: another
    head or backbone is refused by name."""
    if 'decode_head.conv1.weight' not in state_dict:
        raise NotImplementedError('export_vlm_checkpoint: only the VLG '
                                  'decode head is exported')
    if 'backbone.patch_embed.projection.weight' not in state_dict:
        raise NotImplementedError('export_vlm_checkpoint: only the MaskCLIP '
                                  'ViT backbone is exported')
    out = {}
    for k, v in state_dict.items():
        if not k.startswith(EXPORTED):
            continue
        out[k] = v.detach().float().cpu().numpy()
        if k.startswith('conv_encoder.') and k.endswith('.running_var'):
            out[k[:-len('running_var')] + 'num_batches_tracked'] = np.zeros(
                (), np.int64)
    return out


def load_run_checkpoint(run_dir, slot='best', ema=False):
    """A run's slot -> (model state dict, epoch); with ``ema``, the slot's
    parameter EMA in place of its parameters."""
    path = os.path.join(run_dir, 'ckpt', slot)
    payload = torch.load(path, map_location='cpu', weights_only=True)
    sd = dict(payload['model'])
    if ema:
        if 'ema' not in payload:
            raise SystemExit(f'{path} has no parameter EMA (ema_decay)')
        sd.update(payload['ema'])
    epoch = 0
    if os.path.isfile(path + '.extra.json'):
        with open(path + '.extra.json') as f:
            epoch = int(json.load(f).get('epoch', 0))
    return sd, epoch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--run-dir', required=True,
                        help='training run dir (contains ckpt/)')
    parser.add_argument('--slot', default='best', choices=['best', 'latest'])
    parser.add_argument('--out', required=True, help='output .pth')
    parser.add_argument('--ema', action='store_true',
                        help='export the parameter EMA as the model')
    args = parser.parse_args(argv)
    sd, epoch = load_run_checkpoint(args.run_dir, args.slot, args.ema)
    flat = export_vlm_checkpoint(sd)
    torch.save({'model': {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in flat.items()},
                'epoch': epoch}, args.out)
    print(f'wrote {args.out} ({len(flat)} tensors, epoch {epoch})')
    return flat, epoch


if __name__ == '__main__':
    main()
