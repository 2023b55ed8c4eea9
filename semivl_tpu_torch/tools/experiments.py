#!/usr/bin/env python
"""Experiment launcher CLI (reference experiments.py:481-497 equivalent;
the counterpart of ``semivl_tpu/tools/experiments.py``).

    python -m semivl_tpu_torch.tools.experiments --exp 40        # generate+run 0
    python -m semivl_tpu_torch.tools.experiments --exp 40 --run 2
    python -m semivl_tpu_torch.tools.experiments --exp 40 --list # generate only

Generates the YAML grid into configs/generated/exp-N/ and launches the
port's trainer (``python -m semivl_tpu_torch.tools.train``) for the selected
run, on one card (``--device cpu`` for the plain path).
"""

import argparse
import subprocess
import sys

from semivl_tpu_torch.configs.experiments import save_experiment_cfgs


def main():
    parser = argparse.ArgumentParser(description='Generate experiment configs')
    parser.add_argument('--exp', type=int, required=True, help='Experiment id')
    parser.add_argument('--run', type=int, default=0, help='Run id')
    parser.add_argument('--list', action='store_true',
                        help='only generate + list configs')
    parser.add_argument('--pretrained', type=str, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help="the trainer's device (default: the card)")
    args = parser.parse_args()

    cfgs, cfg_files = save_experiment_cfgs(args.exp)
    if args.list:
        for i, f in enumerate(cfg_files):
            print(f'[{i}] {f}')
        return

    cmd = [sys.executable, '-m', 'semivl_tpu_torch.tools.train', '--config',
           cfg_files[args.run]]
    if args.pretrained:
        cmd += ['--pretrained', args.pretrained]
    if args.device:
        cmd += ['--device', args.device]
    print(' '.join(cmd))
    raise SystemExit(subprocess.call(cmd))


if __name__ == '__main__':
    main()
