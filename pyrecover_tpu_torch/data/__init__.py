"""Synthetic data, the stateful sampler and causal-LM collation."""

from pyrecover_tpu_torch.data.collate import collate_clm
from pyrecover_tpu_torch.data.sampler import StatefulSampler
from pyrecover_tpu_torch.data.synthetic import SyntheticTextDataset

__all__ = ["SyntheticTextDataset", "StatefulSampler", "collate_clm"]
