from semivl_tpu_torch.datasets.classes import CLASSES, NUM_CLASSES
from semivl_tpu_torch.datasets.palettes import get_palette

__all__ = ["CLASSES", "NUM_CLASSES", "get_palette"]
