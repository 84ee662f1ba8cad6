"""Sequence packing: multiple documents per row, separated by segment ids
(the JAX package's ``data/packed.py``, copied; its caches beside the corpus
have the same names, layout and key, so either package reuses the other's).

The reference right-pads every document to the sequence length
(reference dataset.py:29-35) and merely REPORTS the resulting waste as its
"training tokens %" metric (reference train.py:253-254). Packing converts
that percentage into throughput: documents are tokenized to their natural
length, laid end-to-end in one virtual token stream (EOS-separated), and
each dataset row is one contiguous ``seq_len + 1`` chunk of that stream —
so every position holds a real token and training-tokens % is ~100 by
construction.

Per-row segment ids mark the document boundaries; the attention mask
(ops/attention.py, ops/flash_attention.py ``segment_ids``) blocks
cross-document attention, and the collator (data/collate.py) masks the
labels that would predict across a boundary. Documents longer than a row —
or straddling a row boundary — simply continue in the next row as their own
segment (standard stream-packing semantics).

Random access is exact and deterministic: a one-time tokenization pass
records per-document token counts AND persists the concatenated token
stream (memmapped next to the corpus), so each row is a pure slice plus a
binary search over the cumulative lengths — no tokenizer in the hot path,
and the StatefulSampler's bit-exact-resume contract holds under packing.
"""

import os
from pathlib import Path

import numpy as np

from pyrecover_tpu_torch.data.collate import PAD_SEGMENT
from pyrecover_tpu_torch.data.parquet import _resolve_parquet_files



class PackedParquetTextDataset:
    """Parquet corpus packed into dense ``seq_len + 1`` rows.

    ``__getitem__`` returns ``(tokens, segment_ids)`` — both (seq_len+1,)
    int32; segment ids are numbered locally within the row (0, 1, 2, ...).
    ``training_samples`` keeps the reference's wraparound semantics over
    the PACKED row count (reference dataset.py:25).
    """

    # self-validating token-cache pair, rebuilt from the corpus when the
    # dtype/shape gate rejects a torn stream  # faultcheck: tear-ok
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
        self.real_docs = len(self.texts)
        self.tokenizer = tokenizer
        self.seq_len = int(seq_len)
        self.eos_token_id = tokenizer.eos_token_id
        self.pad_token_id = tokenizer.pad_token_id
        if self.pad_token_id is None:
            self.pad_token_id = tokenizer.eos_token_id

        # The index pass tokenizes the WHOLE corpus once — so it persists
        # both its products next to the corpus (keyed on file identity +
        # tokenizer + eos): the per-document token counts (the row→doc
        # binary-search index) AND the concatenated token stream itself, as
        # a memmapped int32 .npy. With a warm pair, construction does ZERO
        # tokenizer calls and __getitem__ is a pure slice: no tokenizing
        # in the loader's workers, whose host time would starve the
        # device. The stream is written before the
        # key-carrying index, so a torn pair fails the size check below
        # and falls back to on-demand tokenization. An unwritable data
        # directory just repeats the pass (stream kept in memory this run).
        files = _resolve_parquet_files(parquet_file)
        key = repr([
            [(f, os.path.getsize(f), os.path.getmtime(f)) for f in files],
            getattr(tokenizer, "name_or_path", type(tokenizer).__name__),
            self.eos_token_id,
        ])
        sidecar = Path(files[0]).with_suffix(".pyrecover_lenidx.npz")
        stream_path = Path(files[0]).with_suffix(".pyrecover_tokens.npy")
        lengths = None
        self._stream = None
        if sidecar.exists():
            try:
                cached = np.load(sidecar, allow_pickle=False)
                if str(cached["key"]) == key:
                    lengths = cached["lengths"]
            except Exception:
                lengths = None  # unreadable/stale cache: rebuild
        if lengths is not None and stream_path.exists():
            try:
                stream = np.load(stream_path, mmap_mode="r")
                if stream.dtype == np.int32 and stream.shape == (
                    int(lengths.sum()),
                ):
                    self._stream = stream
            except Exception:
                self._stream = None  # stale/torn: rebuilt below
        # rebuild when EITHER product is missing: a warm pre-stream length
        # index (or a torn stream file) must not silently pin every future
        # restart to the re-tokenize fallback — one repair pass writes the
        # pair and restores the pure-slice path
        if lengths is None or self._stream is None:
            doc_tokens = [self._tokenize(d) for d in range(self.real_docs)]
            lengths = np.asarray([len(t) for t in doc_tokens], dtype=np.int64)
            stream = (
                np.concatenate(doc_tokens)
                if doc_tokens
                else np.zeros(0, np.int32)
            )
            del doc_tokens
            self._stream = stream
            try:
                tmp_s = stream_path.with_suffix(".tmp.npy")
                np.save(tmp_s, stream)
                # jaxlint: disable-next=torn-write -- cache pair is
                # self-validating (dtype/shape gate above rejects a torn
                # stream and triggers a rebuild); fsyncing a multi-GB
                # token stream would stall every cold start for a file
                # that is derivable from the corpus
                os.replace(tmp_s, stream_path)
                tmp = sidecar.with_suffix(".tmp.npz")
                np.savez(tmp, key=np.str_(key), lengths=lengths)
                # jaxlint: disable-next=torn-write -- same self-validating
                # cache protocol as the stream publish above
                os.replace(tmp, sidecar)
                # persisted: swap the resident concatenation for the memmap
                # (a multi-GB corpus must not stay in host RAM for the
                # process lifetime, duplicated per forked loader worker)
                self._stream = np.load(stream_path, mmap_mode="r")
            except OSError:
                pass  # read-only corpus dir: in-memory stream this run
        self.cum = np.concatenate([[0], np.cumsum(lengths)])
        total = int(self.cum[-1])
        self.rows_available = max(total // (self.seq_len + 1), 1)
        self.num_samples = (
            int(training_samples) if training_samples else self.rows_available
        )
        self._cache = {}  # doc-token cache for the no-stream fallback only

    def _tokenize(self, doc_idx):
        ids = self.tokenizer(
            str(self.texts[int(doc_idx)]),
            return_attention_mask=False,
            truncation=False,
        )["input_ids"]
        if self.eos_token_id is not None and (
            not ids or ids[-1] != self.eos_token_id
        ):
            ids = list(ids) + [self.eos_token_id]
        return np.asarray(ids, dtype=np.int32)

    def _doc_tokens(self, doc_idx):
        got = self._cache.get(doc_idx)
        if got is None:
            got = self._tokenize(doc_idx)
            if len(self._cache) > 64:
                self._cache.clear()
            self._cache[doc_idx] = got
        return got

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        row = int(idx) % self.rows_available
        width = self.seq_len + 1
        start = row * width
        end = start + width
        # documents overlapping [start, end): cum[d] <= pos < cum[d+1]
        d0 = int(np.searchsorted(self.cum, start, side="right") - 1)
        tokens = np.empty(width, dtype=np.int32)
        segs = np.empty(width, dtype=np.int32)
        if self._stream is not None:
            # pure slice of the persisted stream; segment ids from the
            # cumulative lengths alone — no tokenizer anywhere on this path
            total = int(self.cum[-1])
            take = min(end, total) - start
            tokens[:take] = self._stream[start : start + take]
            pos = np.arange(start, start + take)
            segs[:take] = np.searchsorted(self.cum, pos, side="right") - 1 - d0
            if take < width:
                # total stream not divisible by width: the final row's
                # tail is padding (masked via PAD_SEGMENT)
                tokens[take:] = self.pad_token_id
                segs[take:] = PAD_SEGMENT
            return tokens, segs
        # fallback (read-only corpus dir with a warm length index from a
        # pre-stream version): re-tokenize the row's documents on demand
        filled = 0
        d = d0
        while filled < width:
            if d >= self.real_docs:
                tokens[filled:] = self.pad_token_id
                segs[filled:] = PAD_SEGMENT
                break
            doc = self._doc_tokens(d)
            lo = max(start + filled - int(self.cum[d]), 0)
            take = min(len(doc) - lo, width - filled)
            tokens[filled : filled + take] = doc[lo : lo + take]
            segs[filled : filled + take] = d - d0
            filled += take
            d += 1
        return tokens, segs
