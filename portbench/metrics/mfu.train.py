"""mfu.train: the model's operations of the traced steps (counted from
shapes, ``counts.train_step``) over the traced window, against the bf16
peak."""

from portbench import counts


def read(t):
    if t.kind != 'train':
        return None
    return counts.mfu_percent(t.flops, t.window_s)
