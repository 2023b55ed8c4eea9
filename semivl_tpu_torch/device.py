"""Device selection for the package's entry points."""

import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the first CUDA card.

    Without a card, ``None`` raises instead of running on the CPU: a run on
    the CPU is asked for by name (``device='cpu'``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return torch.device('cuda')
