"""Parquet-backed text dataset with on-the-fly tokenization (the JAX
package's ``data/parquet.py``, copied).

Parity with reference ``ParquetDataset`` (dataset.py:10-35): memory-mapped
parquet of a ``text`` column, virtual length with index wraparound, per-item
tokenization to seq_len+1 with right-padding and truncation. The hot-loop
tokenization cost the reference pays per step is hidden by the
DataLoader's background prefetch pool, not by this class. ``pyarrow`` and
``transformers`` are imported inside the functions that need them, so the
package imports where neither is installed.

Beyond parity: the path may be a single file, a glob (``shards-*.parquet``),
or a directory of ``*.parquet`` shards — real corpora ship sharded; shards
are concatenated in sorted order so data order is deterministic.
"""

import glob as _glob
from pathlib import Path

import numpy as np


def _resolve_parquet_files(path):
    """One file, a glob pattern, or a directory of *.parquet → sorted list."""
    p = Path(path)
    if p.is_dir():
        files = sorted(str(f) for f in p.glob("*.parquet"))
    elif any(ch in str(path) for ch in "*?["):
        files = sorted(_glob.glob(str(path)))
        if not files and p.exists():
            # a real file whose NAME contains glob metacharacters
            files = [str(path)]
    else:
        files = [str(path)]
    if not files:
        raise FileNotFoundError(f"no parquet files match {path!r}")
    return files


class ParquetTextDataset:
    def __init__(self, parquet_file, tokenizer, seq_len, training_samples=0,
                 text_column="text"):
        import pyarrow as pa
        import pyarrow.parquet as pq

        tables = [
            pq.read_table(f, memory_map=True, columns=[text_column])
            for f in _resolve_parquet_files(parquet_file)
        ]
        table = tables[0] if len(tables) == 1 else pa.concat_tables(tables)
        self.texts = table.column(text_column)
        self.real_length = len(self.texts)
        self.num_samples = int(training_samples) if training_samples else self.real_length
        self.tokenizer = tokenizer
        self.seq_len = int(seq_len)
        self.pad_token_id = tokenizer.pad_token_id
        if self.pad_token_id is None:
            # common for base LMs: fall back to eos (same move HF trainers make)
            self.pad_token_id = tokenizer.eos_token_id

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        text = str(self.texts[int(idx) % self.real_length])
        enc = self.tokenizer(
            text,
            max_length=self.seq_len + 1,
            padding="max_length",
            truncation=True,
            return_attention_mask=False,
        )
        return np.asarray(enc["input_ids"], dtype=np.int32)


def load_tokenizer(name_or_path):
    """HF AutoTokenizer (reference train.py:54); deferred import so the
    synthetic path needs no `transformers`."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path)
