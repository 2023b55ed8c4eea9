"""The tiny cell the CPU tests drive: the port's tiny test VLM (not a
reference model) through the benchmark's own path, on the CPU."""

import json
import os

import torch

DATA = os.path.join(os.path.dirname(__file__), 'data')
# Limits for the tiny cell, from its readings on a CPU over seeds 1, 2,
# 3 and 2**31 + 7: the program's first-step loss gap 1e-5 to 8e-5, median
# leaf gradient gap 0.018 to 0.024, worst-leaf change gap 0.11 to 0.26; the
# float8 control's gradient gap 0.045 to 0.059; half of each batch left
# out: gradient gap 0.20 to 0.36; a state left unchanged: 1.0. The tiny
# evaluation over seeds 1 and 2: the program's pixel gap 0.20, the
# control's 2.67 to 2.69, an answer shifted by one class 9.5 to 11.7.
TRAIN_LIMITS = {'loss1_gap': 2e-4, 'grad_gap': 0.035, 'change_gap': 0.5}
EVAL_LIMITS = {'pixel_gap': 1.0, 'hist_wrong': 0}


def load(name):
    with open(os.path.join(DATA, f'{name}.json')) as f:
        return json.load(f)


def resolver(mix, limits):
    """A ``run.main`` resolver of the tiny cell under ``mix``."""
    def resolve(workload):
        return ({'name': workload, 'chips': 1}, load('tiny-vlm'), load(mix),
                [], dict(limits))
    return resolve


def few_threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))
