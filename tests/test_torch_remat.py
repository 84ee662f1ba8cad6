"""The port's rematerialization held to the JAX package's: gradients with
``--remat-policy full`` and ``save-attn`` (``models/llama.py``), and the
``auto`` policy's byte model and decision (``utils/remat.py``).

Gradients are fp32 on the CPU from the same weights (JAX ``init_params``
via ``params_from_jax``) and batch. Recomputing a block reruns the same
operations on the same inputs, so the port's remat gradients equal its
own no-remat gradients exactly; against JAX's (its ``jax.checkpoint``
policies) they hold to 1e-5 of the largest gradient, the tolerance of
tests/test_torch_train.py. Byte counts and decisions are integers and
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.data import StatefulSampler as JaxSampler
from pyrecover_tpu.data import SyntheticTextDataset as JaxDataset
from pyrecover_tpu.data.collate import collate_clm as jax_collate
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward_hidden_with_aux as jax_hidden
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.train_state import chunked_ce as jax_chunked_ce
from pyrecover_tpu.utils import remat as jax_remat
from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, forward_hidden_with_aux
from pyrecover_tpu_torch.models.llama import params_from_jax
from pyrecover_tpu_torch.ops import flash_attention as fa
from pyrecover_tpu_torch.train_state import chunked_ce
from pyrecover_tpu_torch.utils import remat

SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    monkeypatch.delenv(remat.DEVICE_KIND_ENV, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def a_batch():
    ds = JaxDataset(num_samples=8, seq_len=SEQ, vocab_size=256, seed=6)
    items = [ds[i] for i in JaxSampler(len(ds), BATCH, seed=6).next_batch()]
    seg = (np.arange(SEQ + 1) >= 20).astype(np.int32)  # two documents a row
    return jax_collate([(t, seg) for t in items], 0)


def port_grads(np_params, batch, **model_kw):
    cfg = ModelConfig().tiny(compute_dtype="float32", **model_kw)
    model = Transformer(cfg)
    model.load_state_dict(params_from_jax(np_params))
    hidden, _ = forward_hidden_with_aux(model, torch.from_numpy(batch["inputs"]).long(),
                                        torch.from_numpy(batch["segments"]))
    loss, _ = chunked_ce(model, hidden, torch.from_numpy(batch["labels"]).long(), 0)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    layers = {k: np.stack([grads[f"layers.{i}.{k}"] for i in range(cfg.n_layers)])
              for k in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w1", "w3", "w2")}
    return {"tok_embed": grads["tok_embed"], "final_norm": grads["final_norm"],
            "output": grads["output"], "layers": layers}


def jax_grads(np_params, batch, **model_kw):
    cfg = JaxModelConfig().tiny(compute_dtype="float32", **model_kw)
    b = jax.tree.map(jnp.asarray, batch)

    def loss(params):
        hidden, _ = jax_hidden(params, b["inputs"], cfg, segment_ids=b["segments"])
        return jax_chunked_ce(params, hidden, b["labels"], cfg, 0)[0]

    return jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray, np_params)))


@pytest.mark.parametrize("attn", ["sdpa", "flash"])
@pytest.mark.parametrize("policy", ["full", "save-attn"])
def test_remat_gradients_equal_plain_and_jax(policy, attn):
    jcfg = JaxModelConfig().tiny(compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(3), jcfg))
    batch = a_batch()
    plain = port_grads(np_params, batch, attention_impl=attn)
    got = port_grads(np_params, batch, attention_impl=attn, remat=True, remat_policy=policy)
    want = jax_grads(np_params, batch, attention_impl=attn, remat=True, remat_policy=policy)
    for (path, g), (_, p), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                         jax.tree_util.tree_leaves_with_path(plain),
                                         jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(g, p, err_msg=f"remat vs plain {path}")
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"port vs JAX {path}")


@pytest.mark.parametrize("policy,forwards", [(None, 1), ("save-attn", 1), ("full", 2)])
def test_full_remat_reruns_the_flash_forward_and_save_attn_does_not(monkeypatch, policy,
                                                                    forwards):
    """What chip_smoke counts as launches on the card: per layer and step,
    the flash forward runs twice under ``full`` (its rerun in the backward)
    and once under ``save-attn`` and without remat; dq and dk/dv once."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    for key, name in (("fwd", "flash_fwd_reference"), ("dq", "flash_bwd_dq_reference"),
                      ("dkv", "flash_bwd_dkv_reference")):
        monkeypatch.setattr(fa, name, counting(key, getattr(fa, name)))
    jcfg = JaxModelConfig().tiny(compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(3), jcfg))
    kw = {} if policy is None else {"remat": True, "remat_policy": policy}
    port_grads(np_params, a_batch(), attention_impl="flash", **kw)
    layers = jcfg.n_layers
    assert calls == {"fwd": forwards * layers, "dq": layers, "dkv": layers}


LLAMA_1B = dict(dim=2048, n_layers=20, n_heads=16, n_kv_heads=8, vocab_size=32768)
SHAPES = {
    "llama-1b-b2": (LLAMA_1B, dict(), 2, 2048, 0),
    "llama-1b-chunked": (LLAMA_1B, dict(), 2, 2048, 512),
    "llama-1b-bf16-params": (LLAMA_1B, dict(param_dtype="bfloat16"), 8, 2048, 0),
    "tiny": (dict(dim=256, n_layers=4, n_heads=4, n_kv_heads=2, vocab_size=4096), {}, 4, 512, 0),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_auto_table_equals_jax_modelled_bytes(name):
    shape, dtypes, batch, seq, chunk = SHAPES[name]
    cfg = ModelConfig(**shape, **dtypes)
    jcfg = JaxModelConfig(**shape, **dtypes)
    for policy, _, _ in remat.REMAT_POLICIES:
        got = remat.modelled_total_bytes(cfg, batch_size=batch, seq_len=seq, policy=policy,
                                         loss_chunk_size=chunk)
        want = jax_remat.modelled_total_bytes(jcfg, {}, batch_size=batch, seq_len=seq,
                                              policy=policy, loss_chunk_size=chunk)
        assert got == want, (policy, got, want)
    assert remat.param_count(cfg) == sum(
        p.numel() for p in Transformer(cfg, device="meta").parameters())


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", "TPU v5p"])
def test_auto_decision_equals_jax_at_the_same_capacity(name, kind):
    """At the capacity JAX's table gives a device kind, the port picks the
    same policy, fit and suggested batch (its capacity passed in; the
    port's own table holds GPU kinds)."""
    from pyrecover_tpu.utils.perf import tpu_hbm_bytes

    shape, dtypes, batch, seq, chunk = SHAPES[name]
    want = jax_remat.resolve_remat_policy(
        JaxModelConfig(**shape, **dtypes), {}, batch_size=batch, seq_len=seq,
        loss_chunk_size=chunk, device_kind=kind)
    got = remat.resolve_remat_policy(
        ModelConfig(**shape, **dtypes), batch_size=batch, seq_len=seq, loss_chunk_size=chunk,
        capacity_bytes=tpu_hbm_bytes(kind))
    for field in ("policy", "remat", "remat_policy", "fits", "budget_bytes", "table",
                  "suggested_batch_size", "suggested_total_bytes"):
        assert getattr(got, field) == getattr(want, field), field


def test_auto_reads_the_device_kind_override_and_knows_no_cpu_capacity(monkeypatch):
    cfg = ModelConfig(**LLAMA_1B)
    cpu = remat.resolve_remat_policy(cfg, batch_size=2, seq_len=2048, device="cpu")
    assert (cpu.policy, cpu.fits, cpu.budget_bytes, cpu.device_kind) == ("none", None, None, "")
    monkeypatch.setenv(remat.DEVICE_KIND_ENV, "NVIDIA H100 80GB HBM3")
    h100 = remat.resolve_remat_policy(cfg, batch_size=2, seq_len=2048, device="cpu")
    assert h100.device_kind == "NVIDIA H100 80GB HBM3"
    assert h100.budget_bytes == int(80 * 10**9 * 0.9)
    assert h100.fits and h100.policy == "none"  # llama-1b at batch 2 fits 72 GB unrematerialized
    assert h100.table["none"] > h100.table["save-attn"] > h100.table["full"]
    at_32 = remat.resolve_remat_policy(cfg, batch_size=32, seq_len=2048, device="cpu")
    assert at_32.policy in ("save-attn", "full") and at_32.table["none"] > at_32.budget_bytes
    monkeypatch.setenv(remat.DEVICE_KIND_ENV, "some unknown accelerator")
    unknown = remat.resolve_remat_policy(cfg, batch_size=2, seq_len=2048)
    assert (unknown.policy, unknown.fits) == ("none", None)


def test_trainer_resolves_auto_on_the_cpu(tmp_path):
    out = port_train.main([
        "--device", "cpu", "--training-steps", "2", "--batch-size", "2",
        "--sequence-length", "32", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
        "--remat-policy", "auto", "--logging-frequency", "1", "--checkpoint-dir", str(tmp_path),
        "--checkpoint-frequency", "0",
    ])
    assert out["remat"]["policy"] == "none" and out["remat"]["decision"]["fits"] is None
    out = port_train.main([
        "--device", "cpu", "--training-steps", "2", "--batch-size", "2",
        "--sequence-length", "32", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
        "--remat", "--remat-policy", "save-attn", "--logging-frequency", "1",
        "--checkpoint-dir", str(tmp_path), "--checkpoint-frequency", "0",
    ])
    assert out["remat"] == {"policy": "save-attn", "decision": None}
    assert all(np.isfinite(out["losses"]))
