"""Logging / metric utilities (a copy of ``semivl_tpu/utils/logging_utils.py``).

Equivalent of the reference's observability layer (init_log
third_party/unimatch/util/utils.py:109-126, DictAverageMeter
utils/train_utils.py:52-76, TensorBoard scalars semivl.py:364-369): console +
file logging, running means, and a JSONL metric stream (TensorBoard optional
— scalars are also written to ``metrics.jsonl`` so runs are inspectable
without TB).
"""

import json
import logging
import os
import time

_logs = set()


def init_log(name='global', level=logging.INFO):
    logger = logging.getLogger(name)
    if (name, level) in _logs:
        return logger
    _logs.add((name, level))
    logger.setLevel(level)
    ch = logging.StreamHandler()
    ch.setLevel(level)
    ch.setFormatter(logging.Formatter(
        '[%(asctime)s][%(levelname)8s] %(message)s'))
    logger.addHandler(ch)
    logger.propagate = False
    return logger


def add_file_handler(logger, path):
    """Attach the run's debug.log handler, replacing any previous run's
    (multiple train() calls in one process — tests, semi_effect_demo —
    would otherwise write every later run's lines into all earlier run
    dirs)."""
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(
        '[%(asctime)s] [%(levelname)-8s] %(message)s'))
    logger.addHandler(fh)


class DictAverageMeter:
    """Running means of a dict of scalars (reference train_utils.py:52-76)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sums = {}
        self.counts = {}

    def update(self, vals):
        for k, v in vals.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    @property
    def avgs(self):
        return {k: self.sums[k] / self.counts[k] for k in self.sums}

    def __str__(self):
        return ', '.join(f'{k}: {v:.3f}' for k, v in self.avgs.items())


class MetricWriter:
    """JSONL scalar stream + optional TensorBoard."""

    def __init__(self, save_path, use_tensorboard=True):
        self.path = os.path.join(save_path, 'metrics.jsonl')
        self._f = open(self.path, 'a')
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(save_path)
            except Exception:
                self.tb = None

    def add_scalar(self, key, value, step):
        rec = {'t': time.time(), 'step': int(step), key: float(value)}
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()
        if self.tb is not None:
            self.tb.add_scalar(key, float(value), int(step))

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()
