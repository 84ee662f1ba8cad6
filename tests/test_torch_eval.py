"""The port's held-out evaluation held to the JAX package's: the eval step
(``train_state.make_eval_step``) and the runner (``train.build_eval_runner``
with its pad-filled parquet view), on the same weights (JAX
``init_params`` carried over with ``params_from_jax``) and the same rows,
in fp32 on the CPU. Tolerance: 1e-6 relative on the CE sums and the mean
loss (only summation order differs); the valid-token counts are exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
from pyrecover_tpu.data import StatefulSampler as JaxSampler
from pyrecover_tpu.data import SyntheticTextDataset as JaxDataset
from pyrecover_tpu.data.collate import collate_clm as jax_collate
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.train import build_eval_runner as jax_build_eval_runner
from pyrecover_tpu.train_state import make_eval_step as jax_make_eval_step
from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.config import TrainConfig
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_from_jax
from pyrecover_tpu_torch.train_state import make_eval_step

SEQ, BATCH, RTOL = 32, 4, 1e-6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair(**kw):
    """JAX and port configs, the JAX params and the port model on them."""
    common = dict(sequence_length=SEQ, batch_size=BATCH, model_dtype="fp32", seed=11, **kw)
    jcfg = JaxTrainConfig(model=JaxModelConfig().tiny(), **common)
    pcfg = TrainConfig(model=ModelConfig().tiny(), device="cpu", **common)
    params = jax.tree.map(jnp.asarray, init_params(jax.random.key(2), jcfg.model))
    model = Transformer(pcfg.model)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, pcfg, params, model


def a_batch(segments):
    ds = JaxDataset(num_samples=16, seq_len=SEQ, vocab_size=256, seed=4)
    items = [ds[i] for i in JaxSampler(len(ds), BATCH, seed=4).next_batch()]
    if segments:  # three documents a row, the last one cut by padding
        seg = np.repeat(np.arange(3, dtype=np.int32), (SEQ + 1) // 3 + 1)[:SEQ + 1]
        items = [(t, seg) for t in items]
    return jax_collate(items, 0)


@pytest.mark.parametrize("case", ["plain", "chunked", "segments-flash"])
def test_eval_step_matches_jax(case):
    kw = {"loss_chunk_size": 8} if case == "chunked" else {}
    if case == "segments-flash":
        kw["use_flash_attention"] = True
    jcfg, pcfg, params, model = pair(**kw)
    batch = a_batch(segments=case == "segments-flash")
    want_sum, want_n = jax_make_eval_step(jcfg.model, jcfg.loss_chunk_size)(
        params, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v).long() if k != "segments" else torch.from_numpy(v)
          for k, v in batch.items()}
    got_sum, got_n = make_eval_step(model, pcfg.loss_chunk_size)(tb)
    assert int(got_n) == int(want_n) > 0
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=RTOL)
    assert not got_sum.requires_grad and model.output.grad is None


def make_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[UNK]": 1}
    for w in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"):
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]")


def run_both(jcfg, pcfg, params, model, pad=0):
    """Two evaluations by each runner (the second cycles the one loader)."""
    jrun = jax_build_eval_runner(jcfg, jcfg.model, pad, None)
    prun = port_train.build_eval_runner(pcfg, pcfg.model, pad, "cpu")
    state = types.SimpleNamespace(params=params)
    try:
        want = [jrun(state) for _ in range(2)]
        got = [prun(model) for _ in range(2)]
    finally:
        jrun.loader.stop()
        prun.loader.stop()
    return got, want, prun


def test_eval_runner_matches_jax_on_the_synthetic_split():
    jcfg, pcfg, params, model = pair(eval_frequency=1, eval_samples=6)
    got, want, prun = run_both(jcfg, pcfg, params, model)
    assert prun.batches == 2  # 6 samples round up to two batches of 4
    assert got[0] == got[1] and want[0] == want[1]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert port_train.build_eval_runner(
        TrainConfig(model=ModelConfig().tiny(), device="cpu"), pcfg.model, 0, "cpu") is None


def test_eval_runner_matches_jax_on_a_pad_filled_parquet_set(tmp_path):
    """A 5-document parquet eval set in batches of 4: the last batch holds 3
    all-pad rows, which add nothing to either sum."""
    texts = ["alpha beta gamma delta", "beta gamma", "epsilon zeta eta theta alpha beta",
             "gamma delta epsilon", "theta eta zeta"]
    path = tmp_path / "eval.parquet"
    pq.write_table(pa.table({"text": texts}), path)
    tok_dir = tmp_path / "tok"
    make_tokenizer().save_pretrained(tok_dir)
    jcfg, pcfg, params, model = pair(eval_frequency=1, eval_samples=0, eval_dataset=str(path),
                                     tokenizer_name_or_path=str(tok_dir))
    got, want, prun = run_both(jcfg, pcfg, params, model, pad=99)
    assert prun.batches == 2
    np.testing.assert_allclose(got, want, rtol=RTOL)
    view = prun.loader.dataset
    assert len(view) == 8 and (view[7] == make_tokenizer().pad_token_id).all()


def test_trainer_evaluates_outside_the_step_timing(tmp_path):
    out = port_train.main([
        "--device", "cpu", "--training-steps", "4", "--batch-size", "2",
        "--sequence-length", "32", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
        "--attention-impl", "flash", "--logging-frequency", "4", "--eval-frequency", "2",
        "--eval-samples", "8", "--checkpoint-dir", str(tmp_path), "--checkpoint-frequency", "0",
    ])
    assert [e["step"] for e in out["evals"]] == [2, 4] and out["eval_batches"] == 4
    assert all(np.isfinite(e["loss"]) and e["seconds"] > 0 for e in out["evals"])
    assert out["step_ms"] is not None and len(out["losses"]) == 4
