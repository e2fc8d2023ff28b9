"""Data substrate: deterministic, resumable synthetic pipelines."""
from repro_torch.data.synthetic import DataConfig, SyntheticDataset

__all__ = ["DataConfig", "SyntheticDataset"]
