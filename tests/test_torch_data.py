"""The port's data path held to the JAX package's: the prefetching loader
(pyrecover_tpu_torch/data/loader.py), the parquet and packed datasets and
the trainer's dataset flags.

Batches are integer token and segment ids, so every comparison is exact:
the same sampler over the same rows must give the same batches, in the same
order, in both packages. The parquet corpora are tokenized with a small
WordLevel tokenizer built offline (as tests/test_parquet_data.py and
tests/test_packing.py build theirs).
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from tokenizers import Tokenizer, models, pre_tokenizers
from transformers import PreTrainedTokenizerFast

from pyrecover_tpu.data import DataLoader as JaxDataLoader
from pyrecover_tpu.data import StatefulSampler as JaxSampler
from pyrecover_tpu.data import SyntheticTextDataset as JaxSynthetic
from pyrecover_tpu.data.packed import PackedParquetTextDataset as JaxPacked
from pyrecover_tpu.data.parquet import ParquetTextDataset as JaxParquet
from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.config import get_args
from pyrecover_tpu_torch.data import (
    PAD_SEGMENT,
    DataLoader,
    LoaderStallError,
    StatefulSampler,
    SyntheticTextDataset,
)
from pyrecover_tpu_torch.data.packed import PackedParquetTextDataset
from pyrecover_tpu_torch.data.parquet import ParquetTextDataset

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
# 24 documents of 3-26 words: several to a packed row, some split across rows
TEXTS = [" ".join(WORDS[(i + j) % len(WORDS)] for j in range(3 + (7 * i) % 24))
         for i in range(24)]
SEQ, BATCH = 16, 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tokenizer():
    vocab = {"[PAD]": 0, "[UNK]": 1, "[EOS]": 2}
    for t in WORDS:
        vocab.setdefault(t, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                                   unk_token="[UNK]", eos_token="[EOS]")


def write_corpus(path, texts=TEXTS):
    path.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(pa.table({"text": texts}), path)
    return path


def datasets(kind, tmp_path):
    """``(port dataset, JAX dataset, pad id)`` over the same rows."""
    if kind == "synthetic":
        mk = dict(num_samples=40, seq_len=SEQ, vocab_size=97, seed=5)
        return SyntheticTextDataset(**mk), JaxSynthetic(**mk), 0
    tok = make_tokenizer()
    if kind == "parquet":
        path = write_corpus(tmp_path / "corpus" / "texts.parquet")
        return ParquetTextDataset(path, tok, SEQ), JaxParquet(path, tok, SEQ), tok.pad_token_id
    # packed: each package builds its own cache in a directory of its own
    port = PackedParquetTextDataset(write_corpus(tmp_path / "p" / "texts.parquet"), tok, SEQ)
    jax_ds = JaxPacked(write_corpus(tmp_path / "j" / "texts.parquet"), tok, SEQ)
    return port, jax_ds, tok.pad_token_id


@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "prefetch"])
@pytest.mark.parametrize("kind", ["synthetic", "parquet", "packed"])
def test_loader_batches_bit_identical_to_jax(tmp_path, kind, prefetch):
    port_ds, jax_ds, pad = datasets(kind, tmp_path)
    port = DataLoader(port_ds, StatefulSampler(len(port_ds), BATCH, seed=3), pad,
                      device="cpu", prefetch=prefetch, num_workers=3)
    ref = JaxDataLoader(jax_ds, JaxSampler(len(jax_ds), BATCH, seed=3), pad,
                        prefetch=prefetch, num_workers=3)
    try:
        for _ in range(3 * len(port_ds) // BATCH + 1):  # crosses epoch boundaries
            (pe, pb), (je, jb) = next(port), next(ref)
            assert pe == je and pb.keys() == jb.keys()
            assert pb["inputs"].dtype == torch.int64 and pb["labels"].dtype == torch.int64
            for key in pb:
                np.testing.assert_array_equal(pb[key].numpy(), np.asarray(jb[key]), err_msg=key)
            if kind == "packed":
                assert pb["segments"].dtype == torch.int32
    finally:
        port.stop()
        ref.stop()
    if kind == "packed":  # some row carries several documents
        assert int(pb["segments"].max()) >= 1


def test_packed_short_corpus_pads_its_one_row(tmp_path):
    """A corpus shorter than one row: the row's tail is pad tokens in
    segment PAD_SEGMENT, as in JAX, and their labels collate to -100."""
    from pyrecover_tpu_torch.data import collate_clm

    tok = make_tokenizer()
    texts = TEXTS[:2]
    port = PackedParquetTextDataset(write_corpus(tmp_path / "p" / "t.parquet", texts), tok, 64)
    ref = JaxPacked(write_corpus(tmp_path / "j" / "t.parquet", texts), tok, 64)
    (tokens, segs), (jt, js) = port[0], ref[0]
    np.testing.assert_array_equal(tokens, jt)
    np.testing.assert_array_equal(segs, js)
    n_real = int(port.cum[-1])
    assert n_real < 65 and (segs[n_real:] == PAD_SEGMENT).all() and (segs[:n_real] >= 0).all()
    labels = collate_clm([(tokens, segs)], tok.pad_token_id)["labels"][0]
    assert (labels[n_real - 1:] == -100).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_packed_caches_are_shared_both_ways(tmp_path, writer, monkeypatch):
    """One package writes the token-stream and length-index caches beside the
    corpus; the other reads them (same names, same key) with no tokenizer
    call, and yields the same rows."""
    path = write_corpus(tmp_path / "texts.parquet")
    tok = make_tokenizer()
    first, second = (PackedParquetTextDataset, JaxPacked)[::1 if writer == "port" else -1]
    built = first(path, tok, SEQ)
    assert path.with_suffix(".pyrecover_tokens.npy").exists()
    assert path.with_suffix(".pyrecover_lenidx.npz").exists()
    monkeypatch.setattr(second, "_tokenize", lambda self, d: pytest.fail("re-tokenized"))
    reused = second(path, tok, SEQ)
    assert reused.rows_available == built.rows_available
    for i in range(built.rows_available):
        for a, b in zip(built[i], reused[i]):
            np.testing.assert_array_equal(a, b)


def test_parquet_dataset_matches_jax_item_by_item(tmp_path):
    """Right-padded rows, truncation and wraparound (a virtual length above
    the corpus), from a directory of shards."""
    tok = make_tokenizer()
    write_corpus(tmp_path / "shards" / "a.parquet", TEXTS[:10])
    write_corpus(tmp_path / "shards" / "b.parquet", TEXTS[10:])
    port = ParquetTextDataset(tmp_path / "shards", tok, SEQ, training_samples=30)
    ref = JaxParquet(tmp_path / "shards", tok, SEQ, training_samples=30)
    assert len(port) == len(ref) == 30 and port.pad_token_id == ref.pad_token_id
    for i in range(30):
        np.testing.assert_array_equal(port[i], ref[i])


class _Wedged:
    """A dataset whose reads block until released: a hung data source."""

    def __init__(self):
        self.release = threading.Event()

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        self.release.wait(10)
        return np.ones(SEQ + 1, np.int32)


def test_stall_timeout_raises_loader_stall_error():
    ds = _Wedged()
    loader = DataLoader(ds, StatefulSampler(len(ds), 2, seed=0), 0, device="cpu", prefetch=2,
                        num_workers=1, stall_timeout=0.3)
    t0 = time.monotonic()
    try:
        with pytest.raises(LoaderStallError, match="no batch for"):
            next(loader)
        assert 0.25 < time.monotonic() - t0 < 5
        assert loader.stall_count == 1
    finally:
        ds.release.set()
        loader.stop()
    assert loader._thread is None


def test_worker_error_reaches_the_consumer():
    class Broken(SyntheticTextDataset):
        def __getitem__(self, idx):
            raise KeyError(f"row {idx} is missing")

    ds = Broken(num_samples=8, seq_len=SEQ, vocab_size=50)
    loader = DataLoader(ds, StatefulSampler(8, 2, seed=0), 0, device="cpu", prefetch=2)
    try:
        with pytest.raises(KeyError, match="is missing"):
            next(loader)
    finally:
        loader.stop()


def test_resume_through_the_prefetching_loader_sees_the_straight_batches():
    """The producer draws ahead of the step; a resume seeks a fresh sampler
    to the CONSUMED count (what a checkpoint records) and continues with
    exactly the batches a straight run takes next."""
    ds = SyntheticTextDataset(num_samples=20, seq_len=SEQ, vocab_size=97, seed=1)

    def take(sampler, n):
        loader = DataLoader(ds, sampler, 0, device="cpu", prefetch=3, num_workers=4)
        try:
            return [next(loader)[1]["inputs"].numpy() for _ in range(n)], loader
        finally:
            loader.stop()

    straight, _ = take(StatefulSampler(len(ds), BATCH, seed=9), 12)
    live = StatefulSampler(len(ds), BATCH, seed=9)
    first, loader = take(live, 4)
    assert loader.sampler.cursor != 4 * BATCH or live.epoch != 0  # it ran ahead
    saved = live.state_dict_at(4)
    fresh = StatefulSampler(len(ds), BATCH, seed=9)
    for _ in range(4):
        fresh.next_batch()
    assert saved == fresh.state_dict()  # what the checkpoint records
    resumed = StatefulSampler(len(ds), BATCH, seed=9)
    resumed.seek(4)
    rest, _ = take(resumed, 8)
    for a, b in zip(first + rest, straight):
        np.testing.assert_array_equal(a, b)


def test_trainer_dataset_flags_follow_jax(tmp_path):
    """--dataset/--tokenizer-name-or-path/--pack-sequences build the same
    dataset as the JAX trainer, and the tokenizer's vocab raises the model's
    only when it is larger; --loader-stall-timeout reaches the loader."""
    from pyrecover_tpu.config import get_args as jax_get_args
    from pyrecover_tpu.train import build_dataset as jax_build_dataset

    tok_dir = tmp_path / "tok"
    make_tokenizer().save_pretrained(tok_dir)
    path = write_corpus(tmp_path / "corpus" / "texts.parquet")
    for vocab in ("5", "64"):
        argv = ["--dataset", str(path), "--tokenizer-name-or-path", str(tok_dir),
                "--pack-sequences", "--sequence-length", str(SEQ), "--vocab-size", vocab,
                "--loader-stall-timeout", "7.5"]
        cfg, jcfg = get_args(argv + ["--device", "cpu"]), jax_get_args(argv)
        assert (cfg.dataset, cfg.pack_sequences, cfg.loader_stall_timeout) == (
            jcfg.dataset, jcfg.pack_sequences, jcfg.loader_stall_timeout)
        ds, pad, model = port_train.build_dataset(cfg)
        jds, jpad, jmodel = jax_build_dataset(jcfg)
        assert isinstance(ds, PackedParquetTextDataset) and pad == jpad
        assert model.vocab_size == jmodel.vocab_size == max(len(make_tokenizer()), int(vocab))
        for i in range(len(ds)):
            for a, b in zip(ds[i], jds[i]):
                np.testing.assert_array_equal(a, b)
        loader = port_train.build_loader(cfg, ds, pad, StatefulSampler(len(ds), 2), "cpu")
        assert loader.stall_timeout == 7.5
    defaults, jdefaults = get_args([]), jax_get_args([])
    for name in ("dataset", "tokenizer_name_or_path", "pack_sequences", "loader_stall_timeout"):
        assert getattr(defaults, name) == getattr(jdefaults, name), name


def test_cli_trains_on_packed_parquet_on_cpu(tmp_path):
    """The trainer end to end on a packed parquet corpus: segment ids reach
    the flash attention's plain path, every loss is finite."""
    tok_dir = tmp_path / "tok"
    make_tokenizer().save_pretrained(tok_dir)
    path = write_corpus(tmp_path / "corpus" / "texts.parquet")
    out = port_train.main([
        "--device", "cpu", "--dataset", str(path), "--tokenizer-name-or-path", str(tok_dir),
        "--pack-sequences", "--sequence-length", str(SEQ), "--batch-size", "2",
        "--training-steps", "3", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "16",
        "--attention-impl", "flash", "--logging-frequency", "1", "--learning-rate", "1e-3",
        "--checkpoint-dir", str(tmp_path / "ck"),
    ])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
