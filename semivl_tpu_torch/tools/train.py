"""The port's trainer CLI (the counterpart of ``semivl_train.py``): one
process trains on one card.

    python -m semivl_tpu_torch.tools.train --config \\
        configs/generated/exp-40/<name>.yaml [--pretrained clip.npz] \\
        [--seed 0] [--max-iters N] [--resume-from exp/exp-40/<run>] \\
        [--device cpu]

``--config`` is a run config as ``configs.experiments`` generates it
(``python -m semivl_tpu_torch.tools.experiments --exp 40 --list``);
``--pretrained`` a converted CLIP backbone tree (the npz of
``semivl_tpu/tools/convert_clip_weights.py``); ``--device`` the torch device
(default: the CUDA card, and without one the CLI fails; ``cpu`` runs the
plain path). The run's artifacts go under ``exp/exp-<id>/<run name>/``.
"""

import argparse

import yaml


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--pretrained', type=str, default=None,
                        help='converted CLIP checkpoint (npz)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max-iters', type=int, default=None,
                        help='cap total iterations (smoke runs)')
    parser.add_argument('--resume-from', default=None,
                        help='existing run dir: restore its latest '
                             'checkpoint and continue')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             'for the plain path)')
    args = parser.parse_args(argv)

    from semivl_tpu_torch.train.loop import train

    with open(args.config) as f:
        cfg = yaml.load(f, Loader=yaml.Loader)
    best, save_path = train(cfg, args_dict=vars(args),
                            max_iters_override=args.max_iters,
                            pretrained=args.pretrained, seed=args.seed,
                            resume_from=args.resume_from, device=args.device)
    print(f'best mIoU: {best:.2f} (artifacts in {save_path})')
    return best, save_path


if __name__ == '__main__':
    main()
