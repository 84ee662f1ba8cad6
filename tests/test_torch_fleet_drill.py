"""The port's replica-loss chaos drill and its replica process on the CPU:
``fleet_chaos_drill(device="cpu")`` at the tiny drill config passes every
verdict of the JAX drill; the JAX package's ``FleetRouter`` drives two port
replica processes (one SIGKILLed at its ``replica_kill`` seam mid-flight, its
requests redriven by the JAX router) and every ``done`` equals the JAX
``ServingEngine`` on the same ``init_params`` weights (through
``params_from_jax``), exactly, as does the probe; the near-tie rule the card
applies; and the entry points run on the card unless asked otherwise."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu import telemetry as jax_telemetry
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.serving import ServingConfig as JaxServingConfig
from pyrecover_tpu.serving import ServingEngine as JaxServingEngine
from pyrecover_tpu.serving.fleet.router import FleetRouter as JaxFleetRouter
from pyrecover_tpu.serving.hotswap.drill import _probe_workload as jax_probe_workload
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.models.decode import generate_tokens
from pyrecover_tpu_torch.models.llama import params_from_jax
from pyrecover_tpu_torch.serving.fleet import drill, fleet_chaos_drill, replica
from pyrecover_tpu_torch.serving.hotswap import drill as hs_drill
from pyrecover_tpu_torch.serving.loadgen import sample_workload

JCFG = JaxModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")
CFG = hs_drill.drill_model_config()
SCFG = dict(block_size=8, max_seqs=4, prefill_chunk=16, prefill_token_budget=32)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # the replica processes inherit these
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYRECOVER_EMERGENCY", "0")
    monkeypatch.delenv("PYRECOVER_FAULT_PLAN", raising=False)
    yield
    torch.set_num_threads(threads)


def test_fleet_chaos_drill_on_the_cpu(tmp_path):
    """Kill plan ``{"type": "kill9_during_save", "site": "replica_kill",
    "save_index": 0, "after_bytes": 3}`` on replica 1, ``{"type":
    "transient_io_error", "op": "redrive", "fail_count": 1}`` in the parent:
    every verdict holds, exactly (no near-tie is excused on the CPU)."""
    report = fleet_chaos_drill(tmp_path, device="cpu")
    acc = report["accounting"]
    assert report["killed_rc"] == -9 and report["redriven"] >= 1
    assert acc["submitted"] == acc["done"] == report["requests"] and acc["shed"] == 0
    assert report["shed"] == 3 and report["aggregator_targets"] == 2
    assert report["respawns"] == 1 and report["spawn_to_ready_s"]["b"]["1.1"]["ready_s"] > 0
    assert report["quarantine_spawns"] == 3
    assert report["kill_p99_s"] <= report["p99_gate_s"]
    assert report["trace_orphans"] == 0 and report["trace_residual_violations"] == 0
    assert report["trace_completed"] == 2 * report["requests"]
    assert report["trace_redriven_linked"] >= 1 and report["trace_redrive_gap_s"] > 0
    assert report["near_ties_excused"] == 0 and report["near_tie_gaps"] == []
    assert report["peak_mem_bytes"] == {0: 0, 1: 0}
    merged = telemetry.read_events(tmp_path / "fleet_telemetry.jsonl")
    assert len(merged) == report["telemetry_records"]
    fired = {(e.get("replica"), e["site"]) for e in merged if e["event"] == "fault_injected"}
    assert (1, "replica_kill") in fired and (None, "router_redrive") in fired


def _spawn(tmp_path, exp, slot, plan=None):
    status = tmp_path / f"status_{slot}.jsonl"
    proc = drill._spawn_replica(exp, status, tmp_path / f"replica_{slot}.jsonl", CFG, CPU,
                                log=tmp_path / f"replica_{slot}.log", replica_id=slot,
                                fault_plan=plan)
    return proc, status


def _ready(proc, status, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rec = drill._scan_status(status, "ready")
        if rec is not None:
            return rec
        assert proc.poll() is None, f"replica exited {proc.returncode} before ready"
        time.sleep(0.05)
    raise TimeoutError("replica not ready")


def test_jax_router_drives_port_replicas(tmp_path):
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(3), JCFG))
    model, optimizer = hs_drill._train_state(CFG, 0, CPU)
    model.load_state_dict(params_from_jax(np_params))
    exp = tmp_path / "exp"
    exp.mkdir()
    hs_drill.save_zs(exp, 1, model, optimizer)
    kill = {"faults": [{"type": "kill9_during_save", "site": "replica_kill", "save_index": 0,
                        "after_bytes": 2}]}
    procs = [_spawn(tmp_path, exp, 0), _spawn(tmp_path, exp, 1, plan=kill)]
    mem = jax_telemetry.MemorySink()
    jax_telemetry.add_sink(mem)
    router = JaxFleetRouter(max_inflight=3)
    try:
        for slot, (proc, status) in enumerate(procs):
            router.connect(slot, "127.0.0.1", _ready(proc, status)["port"])
        work = sample_workload(12, vocab_size=64, max_model_len=96, seed=5, prompt_lens=(3, 20),
                               new_tokens=(2, 10))
        for req in work:
            router.submit({k: req[k] for k in ("rid", "prompt", "max_new_tokens")})
        router.drain(120.0)
        assert procs[1][0].wait(timeout=30) == -9
        acc = router.accounting()
        assert acc["done"] == len(work) and acc["redriven"] >= 1
        results = router.results
        probe = router.request(0, {"type": "probe", "seed": 0}, "probe_result", timeout_s=60.0)
        status = router.request(0, {"type": "status"}, "status_result", timeout_s=60.0)
    finally:
        router.close()
        jax_telemetry.remove_sink(mem)
        for proc, _ in procs:
            proc.kill()
            proc.wait(timeout=30)
    assert [e["event"] for e in mem.events].count("request_redriven") == acc["redriven"]
    assert status["loaded_step"] == 1 and status["completed"] >= 1

    engine = JaxServingEngine(jax.tree.map(jnp.asarray, np_params), JCFG, JaxServingConfig(**SCFG))
    rids = {req["rid"]: engine.submit(req["prompt"], req["max_new_tokens"]) for req in work}
    jax_probe = jax_probe_workload(0)
    probe_rids = [engine.submit(r["prompt"], r["max_new_tokens"]) for r in jax_probe]
    engine.run_until_drained()
    assert results == {rid: engine.result(erid) for rid, erid in rids.items()}
    assert jax_probe == hs_drill.probe_workload(CFG)  # the same probe, seed 0
    assert probe["seed"] == hs_drill.SEED == 0
    assert probe["tokens"] == [engine.result(r) for r in probe_rids]


def test_the_near_tie_rule(tmp_path, monkeypatch):
    """On the card a divergence is excused only where lockstep decoding of
    the manifest's cold restore has its top two logits within
    ``NEAR_TIE_GAP`` at the first departing token; on the CPU never."""
    model, optimizer = hs_drill._train_state(CFG, 0, CPU)
    manifest = hs_drill.save_zs(tmp_path, 1, model, optimizer)
    req = hs_drill.probe_workload(CFG)[0]
    restored = hs_drill._restore(manifest, CFG, CPU)
    ref = generate_tokens(restored, req["prompt"], req["max_new_tokens"])
    j = len(req["prompt"])
    logits = restored(torch.tensor([ref[:j]]))[0, -1].float()
    top2 = logits.topk(2)
    assert ref[j] == int(top2.indices[0])
    got = list(ref)
    got[j] = int(top2.indices[1])  # the runner-up at the first generated token
    gap = (top2.values[0] - top2.values[1]).item()

    exact = drill._TokenCheck(manifest, CFG, CPU)
    assert exact.same([req], [ref], [ref]) and not exact.same([req], [got], [ref])
    card_rule = drill._TokenCheck(manifest, CFG, CPU, near_ties=True)
    monkeypatch.setattr(drill, "NEAR_TIE_GAP", gap / 2)
    assert not card_rule.same([req], [got], [ref])
    assert card_rule.excused == 0 and card_rule.gaps == []
    monkeypatch.setattr(drill, "NEAR_TIE_GAP", gap * 2)
    assert card_rule.same([req], [got], [ref]) and card_rule.same([req], [ref], [got])
    assert card_rule.excused == 2
    assert card_rule.gaps == pytest.approx([gap, gap], rel=1e-5, abs=1e-6)
    assert not card_rule.same([req], [got[:-1]], [ref])  # a length change is never a tie


def test_entry_points_run_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    model, optimizer = hs_drill._train_state(CFG, 0, CPU)
    hs_drill.save_zs(tmp_path / "exp", 1, model, optimizer)
    args = ["--exp", str(tmp_path / "exp"), "--status", str(tmp_path / "s.jsonl")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica.main(args)
    # nothing to serve: the fast rc-2 exit comes before any device work
    (tmp_path / "empty").mkdir()
    assert replica.main(["--exp", str(tmp_path / "empty"),
                         "--status", str(tmp_path / "e.jsonl")]) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_chaos_drill(tmp_path / "chaos")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.main([str(tmp_path / "canary"), "--drill", "canary"])
