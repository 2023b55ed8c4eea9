"""optimizer_ms.train: device time of the operations launched between the
optimizer's step pre- and post-hooks, per step."""


def read(t):
    if t.kind != 'train':
        return None
    s = t.kernel_s('pb.step.optimizer')
    return 1e3 * s / t.units if s else None
