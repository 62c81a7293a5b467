from repro_torch.data.pipeline import SyntheticPipeline

__all__ = ["SyntheticPipeline"]
