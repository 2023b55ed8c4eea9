"""decoder_roofline.train: the least time of every decoder call
(``fused_vlg_decoder``: both Up stages and the head) of the traced steps (operations at the bf16 peak or bytes at HBM's, counted from
each call's shapes, forward and backward) over the device time of every
operation launched inside those calls."""

from portbench import counts


def read(t):
    if t.kind != 'train':
        return None
    return counts.roofline_percent(t.bound_s.get('decoder', 0.0),
                                   t.kernel_s('pb.decoder.'))
