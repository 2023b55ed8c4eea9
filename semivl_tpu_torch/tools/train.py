"""The port's trainer CLI (the counterpart of ``semivl_train.py``): one
process trains on one card, or N processes data-parallel on N cards.

    python -m semivl_tpu_torch.tools.train --config \\
        configs/generated/exp-40/<name>.yaml [--pretrained clip.npz] \\
        [--seed 0] [--max-iters N] [--resume-from exp/exp-40/<run>] \\
        [--device cpu]

    python -m torch.distributed.run --nproc-per-node N \\
        -m semivl_tpu_torch.tools.train --config ...

Under torchrun every process is one rank (``parallel.dist``): NCCL on the
card ``cuda:LOCAL_RANK``; with ``--device cpu``, gloo ranks on the CPU.

``--config`` is a run config as ``configs.experiments`` generates it
(``python -m semivl_tpu_torch.tools.experiments --exp 40 --list``);
``--pretrained`` a converted CLIP backbone tree (the npz of
``semivl_tpu/tools/convert_clip_weights.py``); ``--device`` the torch device
(default: the CUDA card, and without one the CLI fails; ``cpu`` runs the
plain path). The run's artifacts go under ``exp/exp-<id>/<run name>/``,
written by rank 0.
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
                        help="torch device (default: the CUDA card, "
                             "cuda:LOCAL_RANK under torchrun; 'cpu' for the "
                             'plain path)')
    args = parser.parse_args(argv)

    from semivl_tpu_torch.parallel import dist
    from semivl_tpu_torch.train.loop import train

    with open(args.config) as f:
        cfg = yaml.load(f, Loader=yaml.Loader)
    best, save_path = train(cfg, args_dict=vars(args),
                            max_iters_override=args.max_iters,
                            pretrained=args.pretrained, seed=args.seed,
                            resume_from=args.resume_from, device=args.device)
    if dist.active():   # the rank's group ends with its run
        dist.shutdown()
    print(f'best mIoU: {best:.2f} (artifacts in {save_path})')
    return best, save_path


if __name__ == '__main__':
    main()
