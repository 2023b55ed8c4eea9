from semivl_tpu_torch.data.dataset import SemiDataset
from semivl_tpu_torch.data.loader import ShardedLoader

__all__ = ["SemiDataset", "ShardedLoader"]
