"""Sharded, prefetching data loader.

One host process feeds the whole data mesh: each step yields a *global*
batch of ``n_shards * batch_size`` samples whose leading axis, when sharded
over the mesh's data axis, reproduces the reference's per-rank
``DistributedSampler`` batches (epoch-seeded permutation, wrap-padding to a
multiple of the world size; reference semivl.py:170-177).

Samples are produced by a thread pool (PIL releases the GIL for
decode/resize) with a bounded prefetch queue so host augmentation overlaps
device compute. A copy of ``semivl_tpu/data/loader.py``: the same
permutation, prefetch depth and ``start_step`` skip; the port's loop runs
it as one process (``process_count=1``).
"""

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def epoch_permutation(n, epoch, world, seed=0, shuffle=True):
    """Per-rank index lists, DistributedSampler-equivalent."""
    if shuffle:
        g = np.random.RandomState((seed + epoch) % (2**32))
        order = g.permutation(n)
    else:
        order = np.arange(n)
    total = int(math.ceil(n / world)) * world
    if total > n:
        order = np.concatenate([order, order[:total - n]])
    # rank r takes order[r::world]
    return np.stack([order[r::world] for r in range(world)])  # (world, per)


class ShardedLoader:
    def __init__(self, dataset, batch_size, world, shuffle=True, seed=0,
                 pair=False, num_threads=4, process_index=0,
                 process_count=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.world = world  # TOTAL ranks across all hosts
        self.shuffle = shuffle
        self.seed = seed
        self.pair = pair  # unlabeled: fetch two augmented views per sample
        self.num_threads = num_threads
        # multi-host: this host materialises only its local ranks' samples
        assert world % process_count == 0, (world, process_count)
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        per_rank = int(math.ceil(len(self.dataset) / self.world))
        return per_rank // self.batch_size  # drop_last=True

    def _fetch(self, item, epoch):
        if self.pair:
            a, b = self.dataset.get_pair(item, epoch)
            return a, b
        return self.dataset.get(item, epoch)

    def epoch(self, epoch, start_step=0):
        """Yield global batches for one epoch.

        ``start_step``: skip the first N batches without producing them —
        exact mid-epoch resume (the permutation depends only on
        ``(seed, epoch)``, so the resumed stream is identical to the
        uninterrupted one)."""
        per_rank_idx = epoch_permutation(
            len(self.dataset), epoch, self.world, self.seed, self.shuffle)
        steps = len(self)
        local = self.world // self.process_count
        rank_lo = self.process_index * local
        # host batch s = concat over THIS host's ranks of their s-th batch
        batches = [
            [per_rank_idx[r, s * self.batch_size + j]
             for r in range(rank_lo, rank_lo + local)
             for j in range(self.batch_size)]
            for s in range(steps)
        ][start_step:]
        steps = len(batches)

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending = deque()
            submitted = 0

            def submit_next():
                nonlocal submitted
                if submitted < steps:
                    items = batches[submitted]
                    pending.append(
                        [pool.submit(self._fetch, int(i), epoch)
                         for i in items])
                    submitted += 1

            for _ in range(2):  # prefetch depth
                submit_next()
            while pending:
                futures = pending.popleft()
                submit_next()
                samples = [f.result() for f in futures]
                yield self._collate(samples)

    def _collate(self, samples):
        if self.pair:
            first = self._stack([s[0] for s in samples])
            other = self._stack([s[1] for s in samples])
            return {**first, **{k + '_other': v for k, v in other.items()}}
        return self._stack(samples)

    @staticmethod
    def _stack(samples):
        out = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals)
            else:
                out[k] = vals  # e.g. string ids
        return out
