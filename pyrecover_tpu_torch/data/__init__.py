"""The data path: synthetic, parquet and packed datasets, the stateful
sampler, causal-LM collation and the prefetching loader."""

from pyrecover_tpu_torch.data.collate import PAD_SEGMENT, collate_clm
from pyrecover_tpu_torch.data.loader import DataLoader, LoaderStallError
from pyrecover_tpu_torch.data.sampler import StatefulSampler
from pyrecover_tpu_torch.data.synthetic import SyntheticTextDataset

__all__ = ["PAD_SEGMENT", "DataLoader", "LoaderStallError", "SyntheticTextDataset",
           "StatefulSampler", "collate_clm"]
