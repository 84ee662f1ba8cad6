"""The port's hot-swap (``pyrecover_tpu_torch/serving/hotswap/``) held to the
JAX package's: both packages plan the same chunk fetch from the same
manifests (the port writes the JAX manifest format, and each package's
manifests of the same weights carry the same digests); the incremental fetch
moves only the changed chunks and re-fetches a corrupt cached chunk, a corrupt
store chunk raises; a tampered manifest is rejected while the old weights
keep serving, with no retry loop; a checkpoint of another shape is rejected
before staging; vanilla checkpoints take the full restore; the watcher's
lifecycle is bounded; a swap applies at a pass boundary with in-flight
requests finishing; the post-swap probe equals a cold restore and the JAX
``ServingEngine`` on the same fp32 weights, token for token. Then the
train-and-serve smoke and the SIGKILL-mid-swap chaos drill at the tiny
size, on the CPU."""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.checkpoint.zerostall import save_ckpt_zerostall as jax_save_ckpt_zerostall
from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
from pyrecover_tpu.serving import ServingConfig as JaxServingConfig
from pyrecover_tpu.serving import ServingEngine as JaxServingEngine
from pyrecover_tpu.serving.hotswap import fetch as jax_fetch
from pyrecover_tpu.train_state import create_train_state
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
    chunk_path,
    chunks_root,
    read_manifest,
)
from pyrecover_tpu_torch.models.llama import params_from_jax
from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine, load_serving_params
from pyrecover_tpu_torch.serving.hotswap import (
    HotSwapper,
    diff_manifest_chunks,
    fetch_params_incremental,
    hotswap_chaos_drill,
    hotswap_smoke,
)
from pyrecover_tpu_torch.serving.hotswap import drill
from pyrecover_tpu_torch.telemetry import metrics

JCFG = JaxModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")
CFG = drill.drill_model_config()
SCFG = dict(block_size=8, max_seqs=4, prefill_chunk=16, prefill_token_budget=32)
PROMPTS = ((1, 2, 3, 4), (9, 8, 7), (5, 5, 5, 5, 5), (60, 2, 33, 17, 4, 8))


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # small chunks, so a leaf spans several and the diff is sub-leaf
    monkeypatch.setenv("PYRECOVER_ZS_CHUNK_BYTES", "4096")
    monkeypatch.setenv("PYRECOVER_EMERGENCY", "0")
    metrics.reset()
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def mem_sink():
    sink = telemetry.MemorySink()
    telemetry.add_sink(sink)
    yield sink
    telemetry.remove_sink(sink)


def _events(sink, name):
    return [e for e in sink.events if e["event"] == name]


def state(seed=0):
    model, optimizer = drill._train_state(CFG, seed, torch.device("cpu"))
    return model, optimizer


def engine_for(model):
    return ServingEngine(model, ServingConfig(**SCFG))


def probe(engine, prompts=PROMPTS, n=6):
    engine.reopen()
    rids = [engine.submit(list(p), n) for p in prompts]
    engine.run_until_drained()
    return [engine.result(r) for r in rids]


def restored(path, host=None):
    return load_serving_params(path, CFG, device="cpu", host_bytes=host)[0]


def jax_state(np_params):
    optimizer, _ = jax_build_optimizer(JaxTrainConfig())
    st = create_train_state(jax.random.key(0), JCFG, optimizer)
    return dataclasses.replace(st, params=jax.tree.map(jnp.asarray, np_params))


# ---- the chunk plan ----------------------------------------------------------


def test_diff_manifest_chunks_equals_jax_on_both_packages_manifests(tmp_path):
    """The same weights saved by each package give the same ``.params``
    digests; the diff of two saves (only ``output`` and ``final_norm``
    moved) is the same plan in both packages, over either package's
    manifests, whole or restricted to ``.params``."""
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(0), JCFG))
    moved = {**np_params, "output": np_params["output"] + np.float32(2e-3),
             "final_norm": np_params["final_norm"] + np.float32(2e-3)}
    docs = {}
    for pkg in ("port", "jax"):
        exp = tmp_path / pkg
        exp.mkdir()
        for step, params in ((1, np_params), (2, moved)):
            path = exp / f"ckpt_{step}.zs.json"
            if pkg == "jax":
                jax_save_ckpt_zerostall(path, jax_state(params), {}, background=False,
                                        emergency_tier=False, extra_meta={"step": step})
            else:
                model, optimizer = state()
                model.load_state_dict(params_from_jax(params))
                drill.save_zs(exp, step, model, optimizer)
            docs[pkg, step] = read_manifest(path)

    def params_of(doc):
        return [(e["path"], e["chunks"]) for e in doc["leaves"] if e["path"].startswith(".params")]

    assert params_of(docs["port", 1]) == params_of(docs["jax", 1])
    assert params_of(docs["port", 2]) == params_of(docs["jax", 2])
    for pkg in ("port", "jax"):
        old, new = docs[pkg, 1], docs[pkg, 2]
        for prefix in (None, ".params"):
            plan = diff_manifest_chunks(old, new, prefix=prefix)
            assert plan == jax_fetch.diff_manifest_chunks(old, new, prefix=prefix)
        plan = diff_manifest_chunks(old, new, prefix=".params")
        changed = {r["path"] for r in plan["leaves"] if r["changed"]}
        assert changed == {".params['output']", ".params['final_norm']"}
        assert plan["fetch_bytes"] + plan["reused_bytes"] == sum(
            int(e["nbytes"]) for e in new["leaves"] if e["path"].startswith(".params"))
    # incomparable chunk sizes, and a leaf the old manifest lacks
    alien = json.loads(json.dumps(docs["port", 1]))
    for e in alien["leaves"]:
        e["chunk_bytes"] = int(e["chunk_bytes"]) * 2
    alien["leaves"] = [e for e in alien["leaves"] if e["path"] != ".params['tok_embed']"]
    plan = diff_manifest_chunks(alien, docs["port", 2])
    assert plan == jax_fetch.diff_manifest_chunks(alien, docs["port", 2])
    assert plan["reused_bytes"] == 0
    assert {r["path"]: r["new_leaf"] for r in plan["leaves"]}[".params['tok_embed']"]


# ---- the incremental fetch ---------------------------------------------------


def test_incremental_fetch_moves_only_changed_chunks(tmp_path):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    doc1 = read_manifest(path1)
    flat1, stats1 = fetch_params_incremental(tmp_path, doc1, None, None, manifest_path=path1)
    assert stats1["reused_bytes"] == 0 and stats1["chunks_fetched"] > 0  # cold
    drill.perturb(model, 2)
    path2 = drill.save_zs(tmp_path, 2, model, optimizer)
    doc2 = read_manifest(path2)
    flat2, stats2 = fetch_params_incremental(tmp_path, doc2, doc1, dict(flat1),
                                             manifest_path=path2)
    plan = diff_manifest_chunks(doc1, doc2, prefix=".params")
    assert stats2["fetched_bytes"] == plan["fetch_bytes"] > 0
    assert stats2["chunks_fetched"] == plan["chunks_changed"]
    assert stats2["reused_bytes"] == plan["reused_bytes"] > 0
    assert stats2["changed_leaves"] == plan["changed_leaves"] == 2
    # the jax fetcher over the port's store assembles the same bytes
    ref, _ = jax_fetch.fetch_params_incremental(tmp_path, doc2, None, None, manifest_path=path2)
    for (p, raw), (q, arr) in zip(flat2, ref):
        assert p == q
        np.testing.assert_array_equal(raw, np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def test_incremental_fetch_refetches_a_corrupt_cache_and_rejects_a_corrupt_chunk(tmp_path):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    doc1 = read_manifest(path1)
    flat1, _ = fetch_params_incremental(tmp_path, doc1, None, None, manifest_path=path1)
    host = dict(flat1)
    truth = host[".params['tok_embed']"].copy()
    bad = truth.copy()
    bad[5] ^= 0xFF  # a corrupt byte in the cache of an UNCHANGED leaf
    host[".params['tok_embed']"] = bad
    drill.perturb(model, 2)
    path2 = drill.save_zs(tmp_path, 2, model, optimizer)
    doc2 = read_manifest(path2)
    flat2, stats = fetch_params_incremental(tmp_path, doc2, doc1, host, manifest_path=path2)
    np.testing.assert_array_equal(dict(flat2)[".params['tok_embed']"], truth)
    plan = diff_manifest_chunks(doc1, doc2, prefix=".params")
    assert stats["chunks_fetched"] == plan["chunks_changed"] + 1  # the corrupt one, fetched
    # a corrupt STORE chunk is a hard failure
    entry = next(e for e in doc2["leaves"] if e["path"] == ".params['output']")
    victim = chunk_path(chunks_root(tmp_path), entry["chunks"][0])
    data = bytearray(victim.read_bytes())
    data[0] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="digest|corrupt"):
        fetch_params_incremental(tmp_path, doc2, doc1, dict(flat1), manifest_path=path2)


# ---- the swapper -----------------------------------------------------------------


def test_post_swap_probe_equals_cold_restore_and_jax_engine(tmp_path, mem_sink):
    """Weights from the JAX ``init_params`` (through ``params_from_jax``),
    moved as a training step would move the head, hot-swapped in: the
    probe equals a cold restore of the new manifest and the JAX engine on
    the same fp32 weights, token for token."""
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(3), JCFG))
    model, optimizer = state()
    model.load_state_dict(params_from_jax(np_params))
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    host = {}
    engine = engine_for(restored(path1, host))
    before = probe(engine)
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1, loaded_host=host)
    assert swapper.poll_once() is False  # nothing newer
    rng = np.random.default_rng(4)
    moved = {**np_params,
             "output": np_params["output"] + rng.normal(0, 0.5, np_params["output"].shape)
             .astype(np.float32),
             "final_norm": np_params["final_norm"] + np.float32(0.25)}
    model.load_state_dict(params_from_jax(moved))
    path2 = drill.save_zs(tmp_path, 2, model, optimizer)
    assert swapper.poll_once() is True
    assert engine.weights_step == 1  # staged only, until the next pass
    after = probe(engine)
    assert engine.weights_step == 2 and swapper.loaded_step == 2
    assert after != before
    assert after == probe(engine_for(restored(path2)))
    jax_engine = JaxServingEngine(jax.tree.map(jnp.asarray, moved), JCFG, JaxServingConfig(**SCFG))
    rids = [jax_engine.submit(list(p), 6) for p in PROMPTS]
    jax_engine.run_until_drained()
    assert after == [jax_engine.result(r) for r in rids]
    (fetch,) = _events(mem_sink, "swap_fetch_bytes")
    plan = diff_manifest_chunks(read_manifest(path1), read_manifest(path2), prefix=".params")
    assert fetch["incremental"] and fetch["fetched_bytes"] == plan["fetch_bytes"]
    assert fetch["reused_bytes"] == plan["reused_bytes"] > 0
    (done,) = _events(mem_sink, "weights_swap_done")
    assert done["step"] == 2 and done["from_step"] == 1 and done["swap_s"] >= 0
    assert metrics.gauge("hotswap_loaded_step").value == 2
    assert metrics.counter("weights_swaps_total").value == 1


def test_swap_applies_at_a_pass_boundary_with_in_flight_requests_finishing(tmp_path,
                                                                             mem_sink):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    engine = engine_for(restored(path1))
    old_model = engine.model
    rids = [engine.submit([3, 1, 4, 1, 5], 8), engine.submit([2, 7, 1], 10)]
    for _ in range(3):
        engine.step()
    assert all(engine.result(r) is None for r in rids)  # mid-flight
    drill.perturb(model, 5)
    drill.save_zs(tmp_path, 2, model, optimizer)
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1)
    assert swapper.poll_once()
    assert engine.model is old_model  # staged, not applied inside a pass
    engine.step()
    assert engine.model is not old_model and engine.weights_step == 2
    engine.run_until_drained()
    assert [len(engine.result(r)) for r in rids] == [13, 13]
    engine.pool.check_drained()
    (done,) = _events(mem_sink, "weights_swap_done")
    assert done["in_flight"] == 2


def test_tampered_manifest_rejected_old_weights_keep_serving(tmp_path, mem_sink):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    host = {}
    engine = engine_for(restored(path1, host))
    before = probe(engine)
    drill.perturb(model, 2)
    path2 = drill.save_zs(tmp_path, 2, model, optimizer)
    entry = next(e for e in read_manifest(path2)["leaves"] if e["path"] == ".params['output']")
    victim = chunk_path(chunks_root(tmp_path), entry["chunks"][0])
    data = bytearray(victim.read_bytes())
    data[10] ^= 0xFF
    victim.write_bytes(bytes(data))
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1, loaded_host=host)
    assert swapper.poll_once() is False
    (rejected,) = _events(mem_sink, "weights_swap_rejected")
    assert rejected["to_step"] == 2 and "digest" in rejected["reason"]
    assert list(swapper.rejected) == [path2.name]
    assert swapper.loaded_step == 1 and engine.weights_step == 1
    assert probe(engine) == before
    # no retry loop against the bad artifact...
    assert swapper.poll_once() is False
    assert len(_events(mem_sink, "weights_swap_begin")) == 1
    assert metrics.counter("hotswap_rejected_total").value == 1
    # ...but a NEWER good manifest swaps, reusing the cache
    drill.perturb(model, 3)
    path3 = drill.save_zs(tmp_path, 3, model, optimizer)
    assert swapper.poll_once() is True and swapper.loaded_step == 3
    assert _events(mem_sink, "swap_fetch_bytes")[-1]["reused_bytes"] > 0
    assert probe(engine) == probe(engine_for(restored(path3)))


def test_shape_unstable_checkpoint_rejected_before_staging(tmp_path, mem_sink):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    engine = engine_for(restored(path1))
    served = engine.model
    other_cfg = dataclasses.replace(CFG, vocab_size=32)
    other, other_opt = drill._train_state(other_cfg, 1, torch.device("cpu"))
    drill.save_zs(tmp_path, 2, other, other_opt)
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1)
    assert swapper.poll_once() is False
    (rejected,) = _events(mem_sink, "weights_swap_rejected")
    assert "shape" in rejected["reason"]
    engine.step()
    assert engine.model is served and engine.weights_step == 1
    # a swapper built for another config than the served model's is caught
    # by the parameter-for-parameter check before staging
    drill.perturb(model, 3)
    drill.save_zs(tmp_path, 3, model, optimizer)
    wrong = HotSwapper(engine, tmp_path, dataclasses.replace(CFG, compute_dtype="bfloat16"),
                       loaded_path=path1)
    assert wrong.poll_once() is False
    assert "shape-stable" in _events(mem_sink, "weights_swap_rejected")[-1]["reason"]
    engine.step()
    assert engine.model is served


def test_vanilla_checkpoint_takes_the_full_restore(tmp_path, mem_sink):
    from pyrecover_tpu_torch.train_state import state_leaves

    model, optimizer = state()
    path1 = tmp_path / "ckpt_1.ckpt"
    save_ckpt_vanilla(path1, state_leaves(model, optimizer, step=1), extra_meta={"step": 1})
    engine = engine_for(restored(path1))
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1)
    drill.perturb(model, 4)
    path2 = tmp_path / "ckpt_2.ckpt"
    save_ckpt_vanilla(path2, state_leaves(model, optimizer, step=2), extra_meta={"step": 2})
    assert swapper.poll_once() is True
    assert probe(engine) == probe(engine_for(restored(path2)))
    (fetch,) = _events(mem_sink, "swap_fetch_bytes")
    assert not fetch["incremental"] and fetch["reused_bytes"] == 0 and fetch["fetched_bytes"] > 0


def test_watcher_lifecycle_is_bounded(tmp_path):
    model, optimizer = state()
    path1 = drill.save_zs(tmp_path, 1, model, optimizer)
    engine = engine_for(restored(path1))
    swapper = HotSwapper(engine, tmp_path, CFG, loaded_path=path1, poll_interval_s=0.01)
    swapper.stop()  # not started: a no-op
    swapper.start()
    with pytest.raises(RuntimeError, match="already running"):
        swapper.start()
    engine.start()
    try:
        drill.perturb(model, 2)
        drill.save_zs(tmp_path, 2, model, optimizer)
        deadline = time.monotonic() + 30.0
        while swapper.loaded_step < 2:
            assert time.monotonic() < deadline, "the watcher never swapped"
            time.sleep(0.01)
    finally:
        engine.stop()
        swapper.stop(timeout=10.0)
    assert swapper._thread is None
    # a wedged poll surfaces as a TimeoutError naming the thread
    release = threading.Event()
    swapper.poll_once = lambda: release.wait(30.0)
    swapper.start()
    time.sleep(0.05)
    with pytest.raises(TimeoutError, match="hotswap-watcher"):
        swapper.stop(timeout=0.1)
    release.set()
    swapper.stop(timeout=10.0)
    assert swapper._thread is None


# ---- the drills ------------------------------------------------------------------


def test_hotswap_smoke_on_the_cpu(tmp_path):
    """One process trains and serves: swaps land live, the probe equals a
    cold restore, the fetch reused bytes, p99 within the gate, and the
    exporter was scraped mid-run and after the drain."""
    report = hotswap_smoke(tmp_path, duration_s=2.0, n_saves=2, device="cpu")
    assert report["swaps"] >= 1 and report["rejected"] == 0 and report["token_equal"]
    assert report["final_step"] == 3
    assert 0 < report["fetched_bytes"] and report["reused_bytes"] > 0
    assert report["p99_e2e_s"] <= report["p99_gate_s"]
    mid, final = report["live_scrape"]["mid"], report["live_scrape"]["final"]
    assert mid["e2e_count"] and final["e2e_count"] == report["requests"]
    assert final["seq"] > mid["seq"] and final["step_iter_count"] == 2


def test_hotswap_chaos_drill_on_the_cpu(tmp_path):
    """The server is SIGKILLed at its first ``swap_fetch`` (plan:
    ``{"type": "kill9_during_save", "save_index": 0, "site": "swap_fetch"}``);
    the pin survives, GC leaks nothing, the old manifest serves bit for bit,
    the rewatch finishes the swap, nothing is quarantined."""
    plan = {"faults": [{"type": "kill9_during_save", "save_index": 0, "site": "swap_fetch"}]}
    assert plan["faults"][0]["site"] == "swap_fetch"
    report = hotswap_chaos_drill(tmp_path, device="cpu")
    assert report["kill_rc"] == -9 and report["swap_fetch_kills"] == 1
    assert report["old_manifest_probe_equal"] and report["resumed_swap_probe_equal"]
    assert report["resumed_swap_step"] == 2 and report["quarantined"] == []
    assert report["chunks_leaked"] == 0
    assert report["chunks_on_disk"] == report["chunks_referenced"]
    assert any("ckpt_2.zs.json" in name for name in report["pin_after_kill"])


def test_entry_points_run_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hotswap_smoke(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.main(["--serve", str(tmp_path), "--status", str(tmp_path / "s.jsonl")])
