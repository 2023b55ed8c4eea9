"""mfu.eval: the model's operations of the traced images' windows (counted
from shapes, ``counts.eval_image``) over the traced window, against the
bf16 peak."""

from portbench import counts


def read(t):
    if t.kind != 'eval':
        return None
    return counts.mfu_percent(t.flops, t.window_s)
