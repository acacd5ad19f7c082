from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.data.pipeline import PrefetchPipeline

__all__ = ["SyntheticLMDataset", "PrefetchPipeline"]
