"""Channel dropout, the feature perturbation (counterpart of
``semivl_tpu/ops/dropout.py``).

``F.dropout2d`` of the reference's NCHW feature-perturbation path
(reference model/builder.py:66-91) on NHWC: whole channels of each sample
are zeroed with probability ``rate`` and survivors scaled by 1/(1-rate).
The random stream is an explicit ``torch.Generator`` on the tensor's device.
"""

import torch


def dropout2d(x, rate, generator=None):
    """Drop whole channels of NHWC ``x`` with probability ``rate``."""
    if rate == 0.0:
        return x
    b, c = x.shape[0], x.shape[-1]
    u = torch.rand((b, 1, 1, c), generator=generator, device=x.device)
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
