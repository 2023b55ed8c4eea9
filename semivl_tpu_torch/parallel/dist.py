"""The process group and the collectives of data-parallel training (the
counterpart of ``semivl_tpu/parallel/mesh.py`` and of JAX
``train/loop.py::make_mesh``, ``_maybe_multihost``, ``_broadcast_run_name``).

One process drives one card, as ``torchrun`` launches them: JAX's ``data``
mesh axis is the process group, its ``pmean``/``psum`` are ``all_reduce``s
here. NCCL carries them on the card, gloo on the CPU; a caller may ask for
gloo on the card (two ranks sharing one card, which NCCL refuses). Gloo
takes CUDA tensors in ``all_reduce`` and ``broadcast`` and stages them
through the host itself.

Without a process group (no torchrun environment) nothing here is called
and a run is the one-process run, bit for bit.
"""

import os
import socket
import subprocess
import time

import torch
import torch.distributed as dist

from semivl_tpu_torch.device import resolve_device

ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def setup_distributed(cfg=None, device=None, backend=None):
    """Join the process group torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or
    none without that environment; returns (rank, world, device).

    A group is made whenever ``WORLD_SIZE`` is set, at 1 too, so that
    ``torchrun --nproc-per-node 1`` takes the distributed route. The device
    is ``cuda:LOCAL_RANK`` unless ``device`` is given (``'cpu'``, or one
    card shared by several ranks); the backend NCCL on a card and gloo on
    the CPU unless ``backend`` is given. Refused by name: a world larger
    than ``cfg``'s ``respect_n_gpus`` allows, a missing environment key,
    NCCL on the CPU. A group that cannot be made raises: the run never
    carries on as one process. An existing group is joined as it is."""
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1, resolve_device(device)
    missing = [k for k in ENV_KEYS
               if k not in os.environ and k != 'LOCAL_RANK']
    if missing:
        raise RuntimeError(f'WORLD_SIZE is set but {", ".join(missing)} '
                           'is not: launch the ranks with torchrun')
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    # JAX takes min(devices, n_gpus * n_nodes) devices (loop.py:47-51);
    # with one process a card, a larger world is refused instead
    if cfg and cfg.get('respect_n_gpus'):
        limit = cfg.get('n_gpus', 1) * cfg.get('n_nodes', 1)
        if world > limit:
            raise ValueError(f'WORLD_SIZE {world} is larger than '
                             'respect_n_gpus allows (n_gpus * n_nodes = '
                             f'{limit})')
    if device is None:
        device = f'cuda:{int(os.environ.get("LOCAL_RANK", 0))}'
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               'device="cpu" to run the ranks on the CPU')
    device = torch.device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'the NCCL backend needs a CUDA device, not {device}')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        extra = {'device_id': device} if backend == 'nccl' else {}
        dist.init_process_group(backend, init_method='env://', rank=rank,
                                world_size=world, **extra)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(f'the process group is rank {dist.get_rank()} of '
                           f'{dist.get_world_size()}, the environment says '
                           f'{rank} of {world}')
    return rank, world, device


def free_port():
    """A TCP port on this host that no socket holds now (for
    ``MASTER_PORT``)."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def torchrun_env(rank, world, port, env=None):
    """``env`` (default: this process's environment) with the variables
    torchrun gives rank ``rank`` of ``world`` on this host, the group's
    store at ``localhost:port``."""
    return dict(os.environ if env is None else env, RANK=str(rank),
                LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                MASTER_ADDR='localhost', MASTER_PORT=str(port))


class RankProcesses:
    """``world`` processes of ``argv`` on this host, started as torchrun
    starts them (``torchrun_env`` over ``env``, one free port); each rank
    reads its rank from ``RANK``. ``stdout``: a file every rank's output
    and errors go to (default: this process's streams)."""

    def __init__(self, argv, world, env=None, cwd=None, stdout=None):
        port = free_port()
        err = None if stdout is None else subprocess.STDOUT
        self.procs = []
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    argv, cwd=cwd, env=torchrun_env(r, world, port, env),
                    stdout=stdout, stderr=err))
        except BaseException:
            self.kill()
            raise

    def wait(self, timeout):
        """Every rank's exit code; a rank still running after ``timeout``
        seconds raises ``subprocess.TimeoutExpired``. Every rank is killed
        on the way out."""
        deadline = time.monotonic() + timeout
        try:
            return [p.wait(timeout=max(0.0, deadline - time.monotonic()))
                    for p in self.procs]
        finally:
            self.kill()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch_ranks(argv, world, timeout, env=None, cwd=None, stdout=None):
    """Run ``world`` ranks of ``argv`` to their end (``RankProcesses``);
    returns their exit codes."""
    return RankProcesses(argv, world, env, cwd, stdout).wait(timeout)


def active():
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if active() else 1


def barrier():
    dist.barrier()


def shutdown():
    dist.destroy_process_group()


def broadcast_run_name(name):
    """Rank 0's run name on every rank (each rank's own name has another
    time stamp and uid)."""
    box = [name]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def mean_over_ranks_(tensors):
    """Each tensor becomes, in place, its mean over the ranks: the tensors
    of one dtype are flattened into one buffer, summed by one
    ``all_reduce`` and divided by the world (JAX's ``pmean``; one buffer
    for the float32 gradients of the port's models)."""
    world = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_metrics(values, flag):
    """The mean over ranks of the metric vector ``values`` and the sum over
    ranks of the scalar ``flag`` (the preemption flag), in one
    ``all_reduce``: (means, count)."""
    buf = torch.cat([values.float().reshape(-1),
                     flag.float().reshape(1).to(values.device)])
    dist.all_reduce(buf)
    return buf[:-1] / dist.get_world_size(), buf[-1]


def all_reduce_sum_(tensor):
    """``tensor`` summed over the ranks, in place (integer histograms)."""
    dist.all_reduce(tensor)
    return tensor


class _MeanOverRanks(torch.autograd.Function):
    """The mean over ranks with its transpose: the cotangents of the mean
    are themselves averaged over the ranks, as JAX transposes ``pmean``.
    Each rank's loss is its own; with the parameter gradients averaged
    afterwards, every rank then holds the gradient of the mean of the
    ranks' losses."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y.div_(dist.get_world_size())

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g.div_(dist.get_world_size())


def mean_over_ranks(x):
    """Differentiable mean of ``x`` over the ranks (BatchNorm's cross-rank
    statistics, the counterpart of flax ``BatchNorm(axis_name='data')``)."""
    return _MeanOverRanks.apply(x)
