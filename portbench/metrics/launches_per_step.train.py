"""launches_per_step.train: device kernels per step in the profile."""


def read(t):
    if t.kind != 'train' or not t.launches:
        return None
    return t.launches / t.units
