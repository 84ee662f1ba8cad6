"""The port's serving path (``pyrecover_tpu_torch.serving``) held to the JAX
package's: the paged KV pool, the paged forward in native and int8 modes,
the continuous-batching engine, the read-only restore, the load generator,
the metrics registry and the ``generate`` entry point.

Weights come from the JAX ``init_params`` through ``params_from_jax`` and
everything runs on the CPU at fp32 compute. Tolerances: paged logits against
the JAX paged forward and the training forwards 2e-5 (the JAX serving tests'
own limit), int8 pools 1e-4; engine and lockstep greedy tokens must be equal,
token for token; int8 KV quality by the JAX package's own policy
(teacher-forced argmax match >= 90 %, logits within 2 % of the native pool,
free-running match >= 80 %); restored weights bit for bit; workloads and
percentiles exactly.
"""

import dataclasses
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla as jax_save_ckpt_vanilla
from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
from pyrecover_tpu.models.decode import generate_tokens as jax_generate_tokens
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward as jax_forward
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
from pyrecover_tpu.serving import kvpool as jax_kvpool
from pyrecover_tpu.serving import loadgen as jax_loadgen
from pyrecover_tpu.serving.paged import paged_forward as jax_paged_forward
from pyrecover_tpu.telemetry import metrics as jax_metrics
from pyrecover_tpu.train_state import create_train_state
from pyrecover_tpu_torch import generate as generate_cli
from pyrecover_tpu_torch.checkpoint import native_io
from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
from pyrecover_tpu_torch.config import TrainConfig
from pyrecover_tpu_torch.models.decode import generate_tokens
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, forward, params_from_jax
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.serving import (
    BlockPool,
    EngineStoppedError,
    ServingConfig,
    ServingEngine,
    ServingRestoreError,
    blocks_for,
    kv_token_bytes,
    load_serving_params,
    loadgen,
    paged_forward,
    resident_sequences,
    restore,
    serving_smoke,
)
from pyrecover_tpu_torch.serving import engine as engine_module
from pyrecover_tpu_torch.serving.kvpool import TRASH_BLOCK, make_block_table
from pyrecover_tpu_torch.telemetry import metrics
from pyrecover_tpu_torch.train_state import state_leaves

REPO = Path(__file__).resolve().parent.parent
JCFG = JaxModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")


def port_config(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


CFG = port_config(JCFG)


def sidecar_scheme():
    """The port's sidecar scheme: the native engine's when g++ built it."""
    return "xxh64tree" if native_io.available() else "sha256"



@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    torch.set_num_threads(threads)


def pair(seed=0, jcfg=JCFG):
    """JAX params and the port's model on the same weights."""
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(seed), jcfg))
    model = Transformer(port_config(jcfg))
    model.load_state_dict(params_from_jax(np_params))
    return jax.tree.map(jnp.asarray, np_params), model


@pytest.fixture(scope="module")
def weights():
    return pair()


def engine_for(model, **kw):
    return ServingEngine(model, ServingConfig(**kw))


def ragged_prompts(rng, n, lo=3, hi=24):
    return [rng.integers(0, JCFG.vocab_size, (int(rng.integers(lo, hi)),)).tolist()
            for _ in range(n)]


# ---- the block pool ----------------------------------------------------------


def test_pool_alloc_release_leak_accounting():
    pool = BlockPool(CFG, n_blocks=9, block_size=8, device="cpu")
    assert pool.usable_blocks == 8 and pool.free_blocks == 8
    assert pool.arrays["k"].shape == (CFG.n_layers, 9, 8, CFG.n_kv_heads, CFG.head_dim)
    a = pool.alloc("a", 3)
    b = pool.alloc("b", 5)
    assert TRASH_BLOCK not in a + b
    assert len(set(a + b)) == 8 and pool.free_blocks == 0
    assert pool.alloc("c", 1) is None  # exhausted: no partial grants
    with pytest.raises(RuntimeError, match="leak"):
        pool.check_drained()
    pool.release("a")
    assert sorted(pool.alloc("c", 3)) == sorted(a)  # released blocks are claimed again
    pool.release("b")
    pool.release("c")
    pool.check_drained()
    pool.alloc("c", 1)
    with pytest.raises(ValueError, match="already holds"):
        pool.alloc("c", 1)
    pool.release("c")
    with pytest.raises(ValueError, match="positive"):
        pool.alloc("d", 0)
    with pytest.raises(ValueError):
        BlockPool(CFG, n_blocks=1, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="kv_mode"):
        BlockPool(CFG, n_blocks=4, block_size=8, kv_mode="fp8", device="cpu")
    # a fresh pool grants in the JAX pool's order
    jpool = jax_kvpool.BlockPool(JCFG, n_blocks=9, block_size=8)
    pool = BlockPool(CFG, n_blocks=9, block_size=8, device="cpu")
    assert [jpool.alloc(k, n) for k, n in (("x", 3), ("y", 2))] == [
        pool.alloc(k, n) for k, n in (("x", 3), ("y", 2))]


def test_pool_alloc_raise_atomic_mid_grant():
    """alloc takes a slice, not a per-block pop loop: an exception mid-grant
    leaves the free list and the held map as they were."""
    pool = BlockPool(CFG, n_blocks=9, block_size=8, device="cpu")

    class PopBomb(list):
        def pop(self, *a):
            raise KeyboardInterrupt

    pool._free = PopBomb(pool._free)
    assert pool.alloc("a", 3) == [1, 2, 3]
    pool.release("a")

    class DelBomb(list):
        def __delitem__(self, index):
            raise RuntimeError("mid-grant failure")

    pool._free = DelBomb(pool._free)
    with pytest.raises(RuntimeError, match="mid-grant"):
        pool.alloc("b", 2)
    assert "b" not in pool._held and pool.free_blocks == 8
    pool._free = list(pool._free)
    pool.check_drained()


def test_int8_capacity_and_byte_model_parity():
    """Same byte budget: int8 KV holds >= 3x the sequences of fp32, at
    head_dim 16 and 64; and the byte model equals the JAX package's."""
    budget = 64 * 2**20
    for jcfg in (JCFG, JaxModelConfig().tiny(dim=256, n_heads=4, n_kv_heads=2)):
        cfg = port_config(jcfg)
        fp32 = resident_sequences(budget, cfg, 16, "native", 96, dtype="float32")
        int8 = resident_sequences(budget, cfg, 16, "int8", 96)
        assert int8 >= 3 * fp32, (cfg.head_dim, fp32, int8)
        for mode, dtype in (("native", None), ("native", "float32"), ("native", "bfloat16"),
                            ("int8", None)):
            assert kv_token_bytes(cfg, mode, dtype) == jax_kvpool.kv_token_bytes(
                jcfg, mode, dtype)
            assert resident_sequences(budget, cfg, 16, mode, 200, dtype) == (
                jax_kvpool.resident_sequences(budget, jcfg, 16, mode, 200, dtype))
    hd, hkv, n_layers = CFG.head_dim, CFG.n_kv_heads, CFG.n_layers
    assert kv_token_bytes(CFG, "native", "float32") == 2 * hkv * hd * 4 * n_layers
    assert kv_token_bytes(CFG, "int8") == 2 * hkv * (hd + 4) * n_layers
    pool = BlockPool.from_budget(CFG, 10 * kv_token_bytes(CFG, "int8") * 8, 8, kv_mode="int8",
                                 device="cpu")
    assert pool.n_blocks == 10 and pool.pool_bytes() == 10 * pool.block_bytes()
    assert pool.arrays["k"].dtype == torch.int8
    assert pool.arrays["k_scale"].shape == pool.arrays["k"].shape[:-1]


def test_block_table_shapes():
    assert blocks_for(1, 8) == 1 and blocks_for(8, 8) == 1 and blocks_for(9, 8) == 2
    row = make_block_table(4, [5, 7])
    assert row.dtype == np.int32 and row.tolist() == [5, 7, TRASH_BLOCK, TRASH_BLOCK]
    np.testing.assert_array_equal(row, jax_kvpool.make_block_table(4, [5, 7]))
    assert make_block_table(3).tolist() == [TRASH_BLOCK] * 3
    with pytest.raises(ValueError, match="exceed"):
        make_block_table(1, [5, 7])


# ---- the paged forward ---------------------------------------------------------


@pytest.mark.parametrize("kv_mode,atol", [("native", 2e-5), ("int8", 1e-4)])
def test_paged_forward_matches_jax(weights, kv_mode, atol):
    """Both packages' paged forwards on the same pool layout, tables and
    ragged positions: three sequences prefilled in chunks of 8 (the last
    padded), then one decode step at positions 13, 5 and 20 beside an
    inactive row on the trash table. Logits and the final pools agree."""
    params, model = weights
    jpool = jax_kvpool.BlockPool(JCFG, n_blocks=16, block_size=8, kv_mode=kv_mode)
    pool = BlockPool(CFG, n_blocks=16, block_size=8, kv_mode=kv_mode, device="cpu")
    width = pool.table_width(CFG.max_seq_len)
    rng = np.random.default_rng(21)
    lens = [13, 5, 20]
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).tolist() for n in lens]
    tables = np.stack([make_block_table(width, pool.alloc(i, blocks_for(n + 4, 8)))
                       for i, n in enumerate(lens)] + [make_block_table(width)])
    for i, n in enumerate(lens):
        jpool.alloc(i, blocks_for(n + 4, 8))
    jarrays = jpool.arrays

    def both(toks, pos, tbl):
        nonlocal jarrays
        want, jarrays = jax_paged_forward(params, jarrays, jnp.asarray(toks, jnp.int32),
                                          jnp.asarray(pos, jnp.int32), jnp.asarray(tbl), JCFG,
                                          block_size=8, kv_mode=kv_mode)
        got = paged_forward(model, pool.arrays, np.asarray(toks), pos, tbl, block_size=8,
                            kv_mode=kv_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol, atol=atol)

    for i, prompt in enumerate(prompts):
        padded = prompt + [0] * (-len(prompt) % 8)
        for s0 in range(0, len(padded), 8):
            both([padded[s0:s0 + 8]], [s0], tables[i:i + 1])
    both([[p[-1]] for p in prompts] + [[0]], lens + [0], tables)
    for name, arr in pool.arrays.items():
        if name in ("k", "v") and kv_mode == "int8":
            np.testing.assert_array_equal(arr.numpy(), np.asarray(jarrays[name]))
        else:
            np.testing.assert_allclose(arr.numpy(), np.asarray(jarrays[name]), rtol=atol,
                                       atol=atol, err_msg=name)


def test_paged_prefill_matches_training_forward(weights):
    """Chunked prefill through the block table reproduces the training
    forwards' logits at every real position, across block edges and with a
    padded last chunk."""
    params, model = weights
    pool = BlockPool(CFG, n_blocks=16, block_size=8, device="cpu")
    rng = np.random.default_rng(3)
    n = 21  # 4 chunks of 6, the last padded
    toks = rng.integers(0, CFG.vocab_size, (n,)).tolist()
    table = make_block_table(pool.table_width(CFG.max_seq_len), pool.alloc(0, blocks_for(n + 6, 8)))
    padded = toks + [0] * (-n % 6)
    got = torch.cat([
        paged_forward(model, pool.arrays, [padded[s0:s0 + 6]], [s0], table[None], block_size=8)[0]
        for s0 in range(0, len(padded), 6)])[:n]
    with torch.no_grad():
        ref = forward(model, torch.tensor([toks]))[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    want = np.asarray(jax_forward(params, jnp.asarray([toks], jnp.int32), JCFG))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ---- the engine against lockstep ---------------------------------------------


def test_engine_greedy_equals_jax_lockstep_ragged(weights):
    """Greedy decoding through the engine equals the JAX package's lockstep
    ``generate_tokens``, token for token, for every one of six ragged
    requests served together; the pool drains."""
    params, model = weights
    engine = engine_for(model, block_size=8, max_seqs=4, prefill_chunk=16,
                        prefill_token_budget=32)
    rng = np.random.default_rng(7)
    prompts = ragged_prompts(rng, 6)
    news = [int(rng.integers(1, 14)) for _ in prompts]
    rids = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_drained()
    for rid, p, n in zip(rids, prompts, news):
        assert engine.result(rid) == jax_generate_tokens(params, JCFG, p, n), f"rid {rid}"
    engine.pool.check_drained()
    snap = metrics.snapshot()
    assert snap["counters"]["serving_tokens_total"] == sum(news)
    assert all(snap["hists"][h]["count"] == 6 for h in ("ttft_s", "tpot_s", "e2e_s"))


def test_engine_midflight_admission_equality_and_block_reuse(weights):
    """A request submitted while others decode joins without disturbing
    them (every output equals JAX lockstep), and it reuses the blocks a
    finished sequence released."""
    params, model = weights
    engine = engine_for(model, block_size=8, max_seqs=2, prefill_chunk=8,
                        prefill_token_budget=16, num_blocks=2 * 13 + 1)
    rng = np.random.default_rng(11)
    first = [engine.submit([1, 2, 3], 12), engine.submit([9, 5], 4)]
    for _ in range(4):
        engine.step()
    assert engine._slots[0] is not None, "the long request finished too early"
    late_prompt = rng.integers(0, CFG.vocab_size, (10,)).tolist()
    late = engine.submit(late_prompt, 6)
    engine.run_until_drained()
    for rid, p, n in ((first[0], [1, 2, 3], 12), (first[1], [9, 5], 4), (late, late_prompt, 6)):
        assert engine.result(rid) == jax_generate_tokens(params, JCFG, p, n), f"rid {rid}"
    assert set(engine._done[first[1]].blocks) & set(engine._done[late].blocks), (
        "the late request never reused the finished sequence's blocks")
    engine.pool.check_drained()


def test_engine_multipass_prefill_survives_concurrent_decode(weights):
    """A prompt longer than the prefill budget sits mid-prefill with a real
    table while another request decodes: the decode step must not write
    through that table (the first block's KV bytes are unchanged)."""
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=2, prefill_chunk=8, prefill_token_budget=8)
    rng = np.random.default_rng(17)
    a = engine.submit([5, 3], 20)
    engine.step()  # admit and fully prefill the short request
    long_prompt = rng.integers(1, CFG.vocab_size, (30,)).tolist()  # no token 0
    b = engine.submit(long_prompt, 6)
    engine._admit()
    engine._do_prefill()
    req_b = next(r for r in engine._prefill if r.rid == b)
    assert 0 < req_b.prefill_pos < len(long_prompt)
    assert next(r for r in engine._slots if r is not None and r.rid == a).state == "running"
    blk0 = req_b.blocks[0]
    before = engine._arrays["k"][:, blk0].clone()
    assert engine._do_decode()
    torch.testing.assert_close(engine._arrays["k"][:, blk0], before, rtol=0, atol=0)
    engine.run_until_drained()
    assert engine.result(a) == generate_tokens(model, [5, 3], 20)
    assert engine.result(b) == generate_tokens(model, long_prompt, 6)
    engine.pool.check_drained()


def test_engine_int8_quality_within_tolerance(weights):
    """The JAX package's int8-KV policy against the native pool."""
    _, model = weights
    rng = np.random.default_rng(5)
    match = total = 0
    max_rel = 0.0
    for _ in range(4):
        n = int(rng.integers(20, 60))
        toks = [rng.integers(0, CFG.vocab_size, (n,)).tolist()]
        outs = {}
        for mode in ("native", "int8"):
            pool = BlockPool(CFG, n_blocks=16, block_size=8, kv_mode=mode, device="cpu")
            table = make_block_table(pool.table_width(CFG.max_seq_len),
                                     pool.alloc(0, blocks_for(n, 8)))
            outs[mode] = paged_forward(model, pool.arrays, toks, [0], table[None], block_size=8,
                                       kv_mode=mode)[0].numpy()
        match += int((outs["native"].argmax(-1) == outs["int8"].argmax(-1)).sum())
        total += n
        max_rel = max(max_rel, float(np.max(np.abs(outs["int8"] - outs["native"])
                                            / (np.max(np.abs(outs["native"])) + 1e-9))))
    assert match / total >= 0.90, f"teacher-forced match {match}/{total}"
    assert max_rel <= 0.02, f"int8 KV logit drift {max_rel:.4f} > 2%"

    engine = engine_for(model, block_size=8, max_seqs=4, prefill_chunk=16,
                        prefill_token_budget=32, kv_mode="int8")
    prompts = ragged_prompts(rng, 5)
    news = [int(rng.integers(4, 14)) for _ in prompts]
    rids = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_drained()
    free_match = sum(
        a == b
        for rid, p, n in zip(rids, prompts, news)
        for a, b in zip(engine.result(rid)[len(p):], generate_tokens(model, p, n)[len(p):]))
    assert free_match / sum(news) >= 0.80, f"free-running match {free_match}/{sum(news)}"
    engine.pool.check_drained()


# ---- the engine's scheduling contract ------------------------------------------


def test_submit_and_config_validation(weights):
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=1, prefill_chunk=8, prefill_token_budget=8)
    with pytest.raises(ValueError, match="at least one token"):
        engine.submit([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit([1], 0)
    with pytest.raises(ValueError, match="exceeds max_model_len"):
        engine.submit([1] * 90, 10)
    with pytest.raises(ValueError, match="kv_mode"):
        ServingConfig(kv_mode="fp4")
    with pytest.raises(ValueError, match="prefill_token_budget"):
        ServingConfig(prefill_chunk=32, prefill_token_budget=16)
    with pytest.raises(ValueError, match="must be positive"):
        ServingConfig(max_seqs=0)
    with pytest.raises(ValueError, match="max_model_len"):
        engine_for(model, max_model_len=1024)
    assert engine_for(model, max_seqs=3, block_size=16).pool.n_blocks == 3 * 6 + 1


def test_submit_rejects_footprint_beyond_pool_capacity(weights):
    """A request larger than the whole pool fails at submit() instead of
    parking at the head of the queue forever; the queue keeps moving."""
    params, model = weights
    engine = engine_for(model, block_size=8, max_seqs=1, prefill_chunk=8, prefill_token_budget=8,
                        num_blocks=3)
    with pytest.raises(ValueError, match="usable blocks"):
        engine.submit([1] * 10, 8)
    rid = engine.submit([1] * 8, 8)
    engine.run_until_drained()
    assert engine.result(rid) == jax_generate_tokens(params, JCFG, [1] * 8, 8)
    engine.pool.check_drained()


def test_engine_backpressure_then_recovery(weights):
    """A pool too small for the offered load queues and counts one
    backpressure event per stall, then finishes every request with no
    leak."""
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=2, prefill_chunk=8, prefill_token_budget=8,
                        num_blocks=2 * 2 + 1)
    rids = [engine.submit([i + 1] * 6, 8) for i in range(4)]
    engine.run_until_drained()
    for i, rid in enumerate(rids):
        assert engine.result(rid) == generate_tokens(model, [i + 1] * 6, 8)
    engine.pool.check_drained()
    snap = metrics.snapshot()
    assert 1 <= snap["counters"]["serving_backpressure_total"] <= 2
    assert snap["hists"]["e2e_s"]["count"] == 4
    assert snap["gauges"]["kv_pool_usable_blocks"] == 4


def test_engine_background_thread_and_manual_pump_guard(weights):
    """start()/stop(): the background loop serves the client thread's
    submissions, a manual step() while it runs is refused, stop() joins and
    closes the engine to new work until reopen()."""
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=2, prefill_chunk=8, prefill_token_budget=8)
    engine.start()
    try:
        with pytest.raises(RuntimeError, match="background serving loop"):
            engine.step()
        with pytest.raises(RuntimeError, match="already running"):
            engine.start()
        with pytest.raises(RuntimeError, match="reopen"):
            engine.reopen()
        rid = engine.submit([2, 7, 1], 5)
        deadline = time.monotonic() + 60
        while engine.pending and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        engine.stop()
    assert engine._thread is None
    assert engine.result(rid) == generate_tokens(model, [2, 7, 1], 5)
    with pytest.raises(EngineStoppedError):
        engine.submit([1], 1)
    engine.reopen()
    rid = engine.submit([1, 2], 3)
    engine.run_until_drained()
    assert engine.result(rid) == generate_tokens(model, [1, 2], 3)
    engine.pool.check_drained()
    engine.stop()  # idempotent


def test_stop_timeout_leaves_engine_recoverable(weights):
    """stop() on a wedged loop raises TimeoutError; once that thread exits
    on its own, step() and start() work again."""
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=1, prefill_chunk=8, prefill_token_budget=8)
    release = threading.Event()
    wedged = threading.Thread(target=release.wait, name="serving-engine")
    wedged.start()
    engine._thread = wedged  # a loop wedged in a device call
    try:
        with pytest.raises(TimeoutError, match="did not stop"):
            engine.stop(timeout=0.01)
        with pytest.raises(RuntimeError, match="background serving loop"):
            engine.step()
    finally:
        release.set()
        wedged.join(timeout=10)
    assert not wedged.is_alive()
    rid = engine.submit([2, 7], 3)
    engine.run_until_drained()
    assert engine.result(rid) == generate_tokens(model, [2, 7], 3)
    engine.start()
    engine.stop()
    engine.pool.check_drained()


def test_admission_failure_after_grant_releases_blocks(weights, monkeypatch):
    """A failure between the block grant and the request landing in its
    slot hands the blocks back before it propagates."""
    _, model = weights
    engine = engine_for(model, block_size=8, max_seqs=2, prefill_chunk=8, prefill_token_budget=8,
                        num_blocks=8)
    engine.submit([1] * 8, 4)

    def boom(width, block_ids=None):
        raise RuntimeError("table build failed")

    monkeypatch.setattr(engine_module, "make_block_table", boom)
    with pytest.raises(RuntimeError, match="table build failed"):
        engine._admit()
    engine.pool.check_drained()
    assert all(s is None for s in engine._slots)
    monkeypatch.undo()
    rid = engine.submit([1] * 8, 4)
    engine.run_until_drained()
    assert engine.result(rid) == generate_tokens(model, [1] * 8, 4)
    engine.pool.check_drained()


def test_install_params_takes_effect_at_a_pass_boundary(weights):
    """Staged weights go live only at the top of the next scheduler pass;
    the latest of two stagings wins, and requests after the flip decode on
    the new weights."""
    _, model_a = weights
    _, model_b = pair(seed=1)
    engine = engine_for(model_a, block_size=8, max_seqs=2, prefill_chunk=8,
                        prefill_token_budget=8)
    rid_a = engine.submit([1, 2, 3], 4)
    engine.run_until_drained()
    engine.install_params(model_a, step=3)
    engine.install_params(model_b, step=7)
    assert engine.model is model_a and engine.weights_step is None  # staged only
    rid_b = engine.submit([1, 2, 3], 4)
    engine.step()
    assert engine.model is model_b and engine.weights_step == 7
    engine.run_until_drained()
    assert engine.result(rid_a) == generate_tokens(model_a, [1, 2, 3], 4)
    assert engine.result(rid_b) == generate_tokens(model_b, [1, 2, 3], 4)
    assert engine.result(rid_a) != engine.result(rid_b)
    assert metrics.counter("weights_swaps_total").value == 1
    engine.pool.check_drained()


# ---- restore ---------------------------------------------------------------------


def jax_state(jcfg, seed=0):
    optimizer, _ = jax_build_optimizer(JaxTrainConfig())
    return create_train_state(jax.random.key(seed), jcfg, optimizer)


def port_checkpoint(path, cfg, seed=0):
    """A port-written vanilla checkpoint (with a sha256 sidecar) of a model
    at seeded weights; returns the model."""
    model = Transformer(cfg, generator=torch.Generator().manual_seed(seed))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    save_ckpt_vanilla(path, state_leaves(model, optimizer, step=5), verify=True,
                      extra_meta={"step": 5})
    return model


def test_restore_jax_written_checkpoint(tmp_path):
    """A JAX vanilla checkpoint (its sidecar included) serves in the port:
    the weights bit for bit, the forward equal to the JAX forward."""
    state = jax_state(JCFG)
    path = tmp_path / "ckpt_1.ckpt"
    jax_save_ckpt_vanilla(path, state, {}, verify=True)
    model, info = load_serving_params(path, CFG, device="cpu")
    want = jax.tree.map(np.asarray, state.params)
    assert info["engine"] == "vanilla" and info["leaves"] == 12
    assert info["checksum"] in ("sha256", "xxh64tree")
    assert info["bytes"] == sum(x.nbytes for x in jax.tree.leaves(want))
    np.testing.assert_array_equal(model.layers[1].w2.numpy(), want["layers"]["w2"][1])
    np.testing.assert_array_equal(model.tok_embed.numpy(), want["tok_embed"])
    assert not any(p.requires_grad for p in model.parameters())
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 24)).astype(np.int32)
    with torch.no_grad():
        got = forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_forward(state.params, toks, JCFG)),
                               rtol=1e-5, atol=1e-5)


def test_restore_port_written_checkpoint_casts_matrices_once(tmp_path):
    """A port checkpoint restores with the matrices in the compute dtype and
    the norm scales in the parameter dtype: the same values the training
    forward casts at each use, so the bf16 forward is bit-identical."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    path = tmp_path / "ckpt_5.ckpt"
    ref = port_checkpoint(path, cfg)
    model, info = load_serving_params(path, cfg, device="cpu")
    assert info["step"] == 5 and info["checksum"] == sidecar_scheme()
    assert model.layers[0].wq.dtype == torch.bfloat16 and model.output.dtype == torch.bfloat16
    assert model.layers[0].attn_norm.dtype == torch.float32
    for (name, got), (_, want) in zip(model.named_parameters(), ref.named_parameters(),
                                      strict=True):
        torch.testing.assert_close(got, want.detach().to(got.dtype), rtol=0, atol=0, msg=name)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)))
    with torch.no_grad():
        torch.testing.assert_close(forward(model, toks), forward(ref, toks), rtol=0, atol=0)


def test_restore_refuses_a_flipped_byte_before_placement(tmp_path, monkeypatch):
    """A byte flipped after the save, even in an optimizer frame the reader
    would skip, fails the sidecar before any model is built."""
    path = tmp_path / "ckpt_5.ckpt"
    port_checkpoint(path, CFG)
    data = bytearray(path.read_bytes())
    data[-3] ^= 0x40
    path.write_bytes(bytes(data))

    def no_placement(*a, **k):
        raise AssertionError("a model was built before the checksum was checked")

    monkeypatch.setattr(restore, "serving_model", no_placement)
    with pytest.raises(ServingRestoreError, match="checksum sidecar"):
        load_serving_params(path, CFG, device="cpu")


def test_restore_refuses_other_engines_and_files_without_params(tmp_path):
    # a sharded directory without its meta and a missing manifest carry no
    # .params leaves to serve
    (tmp_path / "ckpt_3").mkdir()
    with pytest.raises(ServingRestoreError, match="no .params leaves"):
        load_serving_params(tmp_path / "ckpt_3", CFG, device="cpu")
    with pytest.raises(ServingRestoreError, match="unreadable"):
        load_serving_params(tmp_path / "ckpt_3.zs.json", CFG, device="cpu")
    from pyrecover_tpu_torch.checkpoint.vanilla import Leaf

    step = np.array(3, np.int32)
    save_ckpt_vanilla(tmp_path / "ckpt_4.ckpt", [Leaf(".step", (), "int32", [step])])
    with pytest.raises(ServingRestoreError, match="no .params leaves"):
        load_serving_params(tmp_path / "ckpt_4.ckpt", CFG, device="cpu")
    port_checkpoint(tmp_path / "ckpt_5.ckpt", CFG)
    with pytest.raises(ServingRestoreError, match="does not fit"):
        load_serving_params(tmp_path / "ckpt_5.ckpt", dataclasses.replace(CFG, dim=32),
                            device="cpu")


def _served_logits(path, cfg, toks):
    model, info = load_serving_params(path, cfg, device="cpu")
    with torch.no_grad():
        return forward(model, toks), model, info


def test_restore_zerostall_equals_the_vanilla_restore(tmp_path, monkeypatch):
    """The same state saved by both engines serves the same weights and the
    same logits; the manifest's chunks are verified as they are read, and
    the optimizer's leaves are never assembled."""
    from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore, save_ckpt_zerostall

    monkeypatch.setenv(chunkstore.CHUNK_BYTES_ENV, "3000")
    model = Transformer(CFG, generator=torch.Generator().manual_seed(3))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    leaves = state_leaves(model, optimizer, step=5)
    save_ckpt_vanilla(tmp_path / "ckpt_5.ckpt", leaves, extra_meta={"step": 5})
    save_ckpt_zerostall(tmp_path / "ckpt_5.zs.json", leaves, extra_meta={"step": 5},
                        background=False)
    read = []
    real = chunkstore.assemble_leaf
    monkeypatch.setattr(chunkstore, "assemble_leaf",
                        lambda store, entry: read.append(entry["path"]) or real(store, entry))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 20)))
    want, ref, _ = _served_logits(tmp_path / "ckpt_5.ckpt", CFG, toks)
    got, served, info = _served_logits(tmp_path / "ckpt_5.zs.json", CFG, toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for (name, a), (_, b) in zip(served.named_parameters(), ref.named_parameters(), strict=True):
        assert torch.equal(a, b), name
    assert (info["engine"], info["step"], info["leaves"], info["checksum"]) == (
        "zerostall", 5, 12, "blake2b-chunks")
    assert info["resharded_leaves"] == 0 and read and all(p.startswith(".params") for p in read)


def test_restore_sharded_from_two_gloo_ranks_equals_the_vanilla_restore(tmp_path):
    """A dp2 trainer on two gloo ranks writes a sharded checkpoint; serving
    it gives the logits the vanilla restore of the same state gives (the
    state read into a training model in one process and saved vanilla)."""
    from test_torch_sharded_checkpoint import spawn, train_argv

    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded, read_meta

    spawn("main", {"argv": train_argv(tmp_path, "dp2", "--distributed", "--dp", "2",
                                      "--checkpoint-engine", "sharded",
                                      "--checkpoint-frequency", "2")})
    ckpt = tmp_path / "dp2" / "ckpt_4_final"
    cfg = ModelConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
                      max_seq_len=32, compute_dtype="float32", param_dtype="float32")
    model = Transformer(cfg)
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    leaves = state_leaves(model, optimizer)
    load_ckpt_sharded(ckpt, leaves)
    save_ckpt_vanilla(tmp_path / "ckpt_4.ckpt", leaves, extra_meta={"step": 4})
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 20)))
    want, _, _ = _served_logits(tmp_path / "ckpt_4.ckpt", cfg, toks)
    got, _, info = _served_logits(ckpt, cfg, toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (info["engine"], info["step"], info["checksum"]) == ("sharded", 4, "blake2b-leaves")
    assert read_meta(ckpt)["topology"]["devices"] == 2
    assert info["plan_bytes_moved"] == info["bytes"]  # dp2 -> one serving device


@pytest.mark.parametrize("engine", ["zerostall", "sharded"])
def test_restore_refuses_a_flipped_chunk_or_tensor_byte(tmp_path, monkeypatch, engine):
    from pyrecover_tpu_torch.checkpoint.sharded import save_ckpt_sharded
    from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore, save_ckpt_zerostall

    monkeypatch.setenv(chunkstore.CHUNK_BYTES_ENV, "3000")
    model = Transformer(CFG, generator=torch.Generator().manual_seed(4))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    leaves = state_leaves(model, optimizer, step=5)
    if engine == "zerostall":
        path = tmp_path / "ckpt_5.zs.json"
        save_ckpt_zerostall(path, leaves, extra_meta={"step": 5}, background=False)
        entry = next(e for e in chunkstore.read_manifest(path)["leaves"]
                     if e["path"] == ".params['tok_embed']")
        victim = chunkstore.chunk_path(chunkstore.chunks_root(tmp_path), entry["chunks"][1])
        offset = 17
    else:
        import torch.distributed.checkpoint as dcp

        path = tmp_path / "ckpt_5"
        save_ckpt_sharded(path, leaves, extra_meta={"step": 5})
        md = dcp.FileSystemReader(str(path)).read_metadata()
        info = next(v for k, v in md.storage_data.items() if k.fqn == ".params['tok_embed']")
        victim, offset = path / info.relative_path, int(info.offset) + int(info.length) // 2
    data = bytearray(victim.read_bytes())
    data[offset] ^= 0x40
    victim.write_bytes(bytes(data))
    with pytest.raises(ServingRestoreError, match="digest"):
        load_serving_params(path, CFG, device="cpu")


def test_restore_preflight_refuses_a_state_over_the_budget(tmp_path, monkeypatch):
    """The serving preflight (SC05) runs before any tensor is read."""
    path = tmp_path / "ckpt_5.ckpt"
    port_checkpoint(path, CFG)
    monkeypatch.setenv("PYRECOVER_HBM_BYTES", "1024")
    monkeypatch.setattr(restore, "serving_model",
                        lambda *a, **k: pytest.fail("a model was built past the preflight"))
    with pytest.raises(ServingRestoreError, match="SC05"):
        load_serving_params(path, CFG, device="cpu")


def test_entry_points_run_on_the_card_by_default(tmp_path):
    """With no device asked for, the restore and the smoke go to the card
    and, with none, raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    port_checkpoint(tmp_path / "ckpt_5.ckpt", CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_params(tmp_path / "ckpt_5.ckpt", CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_smoke(tmp_path / "smoke", n_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockPool(CFG, 4, 8)


# ---- load generator and metrics ----------------------------------------------------


def test_workloads_equal_jax():
    for seed in (0, 9):
        kw = dict(vocab_size=64, max_model_len=96, seed=seed)
        assert loadgen.sample_workload(16, **kw) == jax_loadgen.sample_workload(16, **kw)
        long = dict(kw, prompt_lens=(16, 1024), new_tokens=(16, 128), max_model_len=2048,
                    vocab_size=32768)
        assert loadgen.sample_workload(16, **long) == jax_loadgen.sample_workload(16, **long)
        for targets in (1, 3):
            assert loadgen.open_loop_workload(0.4, targets=targets, **kw) == (
                jax_loadgen.open_loop_workload(0.4, targets=targets, **kw))
    w = loadgen.sample_workload(16, vocab_size=64, max_model_len=96, seed=9)
    assert w != loadgen.sample_workload(16, vocab_size=64, max_model_len=96, seed=10)
    assert all(len(r["prompt"]) + r["max_new_tokens"] <= 96 for r in w)
    assert loadgen.request_id(3, 17) == jax_loadgen.request_id(3, 17)
    assert loadgen.split_workload(w, 2, seed=4) == jax_loadgen.split_workload(w, 2, seed=4)
    with pytest.raises(ValueError, match="targets"):
        loadgen.split_workload(w, 0)


def test_histogram_percentiles_equal_jax():
    values = np.concatenate([np.random.default_rng(8).lognormal(-4, 1.5, 500), [0.0, 0.0, 2.5]])
    ours, theirs = metrics.Histogram("ttft_s"), jax_metrics.Histogram("ttft_s")
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    ours.observe(0.3, n=4)
    theirs.observe(0.3, n=4)
    ours.observe(1.0, n=0)
    assert ours.buckets == theirs.buckets and ours.count == theirs.count == 507
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.as_dict() == theirs.as_dict()
    buckets = {None: 2, -3: 5, 4: 1}
    for q in (0.1, 0.5, 1.0):
        assert metrics.percentile_from_buckets(buckets, 8, 0.0, 3.0, q) == (
            jax_metrics.percentile_from_buckets(buckets, 8, 0.0, 3.0, q))
    assert metrics.Histogram("empty").percentile(0.5) is None
    metrics.counter("c").inc(3)
    metrics.gauge("g").set(1.5)
    metrics.histogram("h").observe(0.25)
    snap = metrics.snapshot()
    assert snap["counters"] == {"c": 3} and snap["gauges"] == {"g": 1.5}
    assert snap["hists"]["h"]["p50"] == 0.25
    assert metrics.counter("c") is metrics.counter("c")
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "hists": {}}


@pytest.mark.parametrize("kv_mode", ["native", "int8"])
def test_serving_smoke_on_the_cpu(tmp_path, kv_mode):
    """The smoke end to end on ``device='cpu'``: a saved and restored
    checkpoint, a seeded workload under the load generator, greedy equality
    with lockstep (native), no leaked blocks, a latency report."""
    report = serving_smoke(tmp_path, n_requests=6, seed=0, kv_mode=kv_mode, device="cpu")
    assert report["requests"] == 6 and report["tokens_per_sec"] > 0
    assert report["ttft_s"]["p50"] is not None and report["e2e_s"]["p99"] is not None
    assert report["restore"]["checksum"] == sidecar_scheme()
    if kv_mode == "native":
        assert report["greedy_matches"] == 6


# ---- the generate entry point ----------------------------------------------------

GEN_CFG = ModelConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
                      max_seq_len=48, multiple_of=32)
GEN_FLAGS = ["--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
             "--model-kv-heads", "2", "--vocab-size", "64", "--max-seq-len", "48",
             "--multiple-of", "32", "--device", "cpu"]


def test_generate_cli_round_trips(tmp_path, capsys):
    """The CLI prints what ``generate_tokens`` gives on the restored model:
    one prompt, a batch, a truncated long prompt, and a seeded temperature
    run; malformed requests exit 2 with a message."""
    path = tmp_path / "ckpt_5.ckpt"
    port_checkpoint(path, GEN_CFG)
    model, _ = load_serving_params(path, GEN_CFG, device="cpu")

    def run(*extra):
        rc = generate_cli.main([str(path), *GEN_FLAGS, *extra])
        out = capsys.readouterr()
        return rc, [[int(x) for x in line.split(",")] for line in out.out.split()], out.err

    rc, rows, _ = run("--prompt-ids", "1,2,3", "--max-new-tokens", "5")
    assert rc == 0 and rows == [generate_tokens(model, [1, 2, 3], 5)]
    rc, rows, _ = run("--prompt-ids", "1,2;3,4", "--max-new-tokens", "4")
    assert rc == 0 and rows == generate_tokens(model, [[1, 2], [3, 4]], 4)
    prompt = list(range(1, 47))
    rc, rows, err = run("--prompt-ids", ",".join(map(str, prompt)), "--max-new-tokens", "6")
    assert rc == 0 and "truncated to its last 42 tokens" in err
    assert rows == [prompt[:4] + generate_tokens(model, prompt[4:], 6)]
    rc, rows, _ = run("--prompt-ids", "5,6", "--max-new-tokens", "8", "--temperature", "2",
                      "--seed", "3")
    assert rc == 0 and rows == [generate_tokens(
        model, [5, 6], 8, temperature=2.0, generator=torch.Generator().manual_seed(3))]
    for extra, msg in ((("--prompt-ids", "1,2;3"), "EQUAL length"),
                       (("--prompt-ids", ";"), "at least one token"),
                       (("--prompt", "hello"), "requires --tokenizer")):
        rc, _, err = run(*extra)
        assert rc == 2 and msg in err
    assert generate_cli.main([str(path), "--model-layers", "2"]) == 2
    assert "require --model-dim" in capsys.readouterr().err
    rc, _, err = run("--prompt-ids", "1", "--max-new-tokens", "1", "--vocab-size", "32")
    assert rc == 2 and "ServingRestoreError" in err


def test_generate_module_entry_runs_on_the_card_by_default(tmp_path):
    """``python -m pyrecover_tpu_torch.generate`` with ``--device cpu`` prints
    the ids; without it and with no card, it exits 2 naming the card."""
    path = tmp_path / "ckpt_5.ckpt"
    port_checkpoint(path, GEN_CFG)
    model, _ = load_serving_params(path, GEN_CFG, device="cpu")
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.generate", str(path), *GEN_FLAGS[:-2],
           "--prompt-ids", "7,8,9", "--max-new-tokens", "3"]
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ",".join(map(str, generate_tokens(model, [7, 8, 9], 3)))
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 2 and "no CUDA device" in out.stderr
