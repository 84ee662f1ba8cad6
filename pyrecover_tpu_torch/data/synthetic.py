"""Deterministic synthetic token dataset.

The reference has no synthetic path — every run needs the CSCS parquet and a
HF tokenizer download (`utils.py:107-118`). For tests, benchmarks, and
air-gapped TPU pods this dataset produces tokenized "documents" directly:
per-index tokens are a pure function of (seed, index), so every host and
every resume sees identical data with no tokenizer in the loop.
"""

import numpy as np


class SyntheticTextDataset:
    """Items are int32 arrays of length seq_len + 1 (like a tokenized doc),
    with a deterministic pad tail to exercise the CLM mask path
    (reference dataset.py:29-35 right-pads to seq_len+1)."""

    def __init__(self, num_samples, seq_len, vocab_size, pad_token_id=0, seed=0):
        self.num_samples = int(num_samples)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self.pad_token_id = int(pad_token_id)
        self.seed = int(seed)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        idx = int(idx) % self.num_samples  # wraparound (reference dataset.py:25-28)
        rng = np.random.Generator(np.random.Philox(key=[self.seed, idx]))
        n = self.seq_len + 1
        # Learnable structure: an affine bigram recurrence over the non-pad
        # vocab — next-token is a deterministic function of the current
        # token, so models can actually drive the loss down (random tokens
        # would make convergence tests meaningless). The start token is the
        # only randomness per item.
        m = self.vocab_size - 1
        start = int(rng.integers(0, m))
        a, c = 5, 7
        tokens = np.empty(n, dtype=np.int64)
        t = start
        for i in range(n):
            tokens[i] = t
            t = (a * t + c) % m
        tokens = (tokens + 1).astype(np.int32)  # keep 0 free for pad
        # deterministic variable-length "document": 0-25% pad tail
        doc_len = n - int(rng.integers(0, max(n // 4, 1)))
        tokens[doc_len:] = self.pad_token_id
        return tokens
