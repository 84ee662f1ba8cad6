"""The port's zerostall engine (pyrecover_tpu_torch/checkpoint/zerostall/)
held to the JAX package's (tests/test_zerostall.py).

Across the packages: the same state saved by both gives the same manifest
leaves and chunk digest lists (chunks cut over a stacked leaf's whole byte
stream, so one chunk spans several of the port's per-layer parts), and each
package restores the other's manifest bit for bit. In the port: the chunk
store (content addressing, dedup, refcounted GC that keeps ``.corrupt/``
and pinned references), the pipeline (background handles, bounded
back-pressure, writer errors at ``wait()``, transient EIO healed by the
retry, torn saves), the pre-check, the emergency tier (publish, restore,
the digest gate, two ranks' peer exchange over gloo), the pin leases, the
mixed-engine registry, and through ``train.train``: a bit-exact resume, a
restore from RAM with the disk tier deleted, the alternating snapshot
buffers, and a kill -9 in the snapshot window. The chunk size is 3000
bytes here (64 KiB through the trainer), so most leaves split into several
chunks and chunk edges fall inside the parts. On the CPU the snapshot is a plain copy; the side
stream and pinned buffers run only on the card (``chip_smoke.py``).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint import elastic
from pyrecover_tpu_torch.checkpoint.registry import (
    VANILLA_SUFFIX,
    ZEROSTALL_SUFFIX,
    checkpoint_path,
    engine_of,
    get_latest_checkpoint,
    list_checkpoints,
    parse_step,
    prune_checkpoints,
)
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    load_ckpt_vanilla,
    save_ckpt_vanilla,
)
from pyrecover_tpu_torch.checkpoint.zerostall import (
    chunkstore,
    emergency,
    load_ckpt_zerostall,
    pins,
    precheck_ckpt_zerostall,
    release,
    save_ckpt_zerostall,
    snapshot,
)
from pyrecover_tpu_torch.resilience import faults
from test_torch_distributed import spawn as _spawn

REPO = Path(__file__).resolve().parent.parent
CHUNK = 3000
TRAIN_CHUNK = 1 << 16


def jax_modules():
    """The JAX package's modules, imported here so that the gloo worker
    processes, which run this file as a script, load the port only."""
    from pyrecover_tpu.checkpoint import vanilla
    from pyrecover_tpu.checkpoint.zerostall import emergency as jax_emergency
    from pyrecover_tpu.checkpoint.zerostall import snapshot as jax_snapshot
    from pyrecover_tpu.resilience import faults as jax_faults

    return vanilla, jax_emergency, jax_snapshot, jax_faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv(chunkstore.CHUNK_BYTES_ENV, str(CHUNK))
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _, jax_emergency, _, jax_faults = jax_modules()
    for mod in (emergency, jax_emergency):
        mod.drop()
    faults.clear()
    jax_faults.clear()
    yield
    for mod in (emergency, jax_emergency):
        mod.drop()
    faults.clear()
    jax_faults.clear()
    telemetry.close()
    telemetry.flight.uninstall()
    torch.set_num_threads(threads)


@pytest.fixture()
def sink():
    s = telemetry.add_sink(telemetry.MemorySink())
    yield s
    telemetry.remove_sink(s)


def events(sink, name):
    return [e for e in sink.events if e["event"] == name]


def make_leaves(seed=0):
    """A tiny model's state (2 layers, dim 64) with random parameters and
    moments, as its `Leaf` list."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import rng_key, state_leaves

    cfg = TrainConfig(model=ModelConfig().tiny(), sequence_length=16, model_dtype="fp32",
                      device="cpu")
    g = torch.Generator().manual_seed(seed)
    model = Transformer(cfg.model, generator=g)
    opt, _ = build_optimizer(cfg, model.parameters())
    for p in model.parameters():
        for m in opt.moments(p):
            m.copy_(torch.randn(m.shape, generator=g))
    return state_leaves(model, opt, step=seed, epoch=0, rng=rng_key(seed))


def leaf_bytes(leaves):
    return [b"".join(chunkstore.byte_view(p).tobytes() for p in leaf.parts) for leaf in leaves]


def zs_path(root, step, exp="exp"):
    return checkpoint_path(root, exp, step, engine="zerostall")


def save(path, leaves, step, **kw):
    kw.setdefault("background", False)
    return save_ckpt_zerostall(path, leaves, {"consumed": step}, extra_meta={"step": step},
                               **kw)


# ---- across the packages ---------------------------------------------------


def jax_and_port_state(tmp_path):
    """A JAX TrainState after two steps and the port's leaves holding the
    same bytes (through a JAX vanilla file)."""
    from test_torch_checkpoint import Pair, batches

    from pyrecover_tpu_torch.train_state import load_state_leaves, state_leaves

    jax_vanilla = jax_modules()[0]
    pair = Pair()
    state, _ = pair.jax_steps(pair.jax_state(), batches(2))
    path = tmp_path / "jax" / "ckpt_2.ckpt"
    jax_vanilla.save_ckpt_vanilla(path, state, {"consumed": 2}, extra_meta={"step": 2})
    leaves = state_leaves(pair.model, pair.opt)
    load_ckpt_vanilla(path, leaves)
    load_state_leaves(leaves, pair.opt)
    return state, leaves


def test_same_state_same_chunk_digests_in_both_packages(tmp_path):
    jax_snapshot = jax_modules()[2]
    state, leaves = jax_and_port_state(tmp_path)
    norms = [leaf for leaf in leaves if leaf.path.endswith("['attn_norm']")]
    # the trap: a stacked norm's per-layer parts are smaller than one chunk
    assert norms and all(p.numel() * 4 < CHUNK for p in norms[0].parts)
    jp, pp = tmp_path / "jax" / "ckpt_2.zs.json", tmp_path / "port" / "ckpt_2.zs.json"
    jax_snapshot.save_ckpt_zerostall(jp, state, {"consumed": 2}, extra_meta={"step": 2},
                                     background=False)
    save(pp, leaves, 2)
    jdoc, pdoc = json.loads(jp.read_text()), json.loads(pp.read_text())
    assert [e["path"] for e in pdoc["leaves"]] == [e["path"] for e in jdoc["leaves"]]
    for je, pe in zip(jdoc["leaves"], pdoc["leaves"]):
        for key in ("dtype", "shape", "nbytes", "chunk_bytes", "chunks"):
            assert pe[key] == je[key], (pe["path"], key)
    assert any(len(e["chunks"]) > 1 for e in pdoc["leaves"])
    assert pdoc["format"] == jdoc["format"] and pdoc["engine"] == jdoc["engine"] == "zerostall"
    assert sorted(p.name for p in (jp.parent / "chunks").rglob("*") if p.is_file()) == \
        sorted(p.name for p in (pp.parent / "chunks").rglob("*") if p.is_file())


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_each_package_restores_the_others_manifest(tmp_path, direction):
    import jax
    from test_torch_checkpoint import Pair

    from pyrecover_tpu_torch.train_state import state_leaves

    jax_snapshot = jax_modules()[2]
    state, leaves = jax_and_port_state(tmp_path)
    path = tmp_path / "x" / "ckpt_2.zs.json"
    if direction == "port-to-jax":
        save(path, leaves, 2)
        target = Pair().jax_state()
        assert jax_snapshot.precheck_ckpt_zerostall(path, verify=True,
                                                    target_state=target) == (True, "")
        got, sampler, doc = jax_snapshot.load_ckpt_zerostall(path, target)
        assert sampler["consumed"] == 2 and doc["step"] == 2
        for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(got), leaf_bytes(leaves)):
            assert np.ascontiguousarray(np.asarray(a)).tobytes() == b, jax.tree_util.keystr(kp)
    else:
        jax_snapshot.save_ckpt_zerostall(path, state, {"consumed": 2}, extra_meta={"step": 2},
                                         background=False)
        other = Pair()
        target = state_leaves(other.model, other.opt)
        assert precheck_ckpt_zerostall(path, verify=True, target=target) == (True, "")
        doc = load_ckpt_zerostall(path, target)
        assert doc["step"] == 2 and doc["sampler"]["consumed"] == 2
        assert leaf_bytes(target) == leaf_bytes(leaves)


# ---- the chunk store -------------------------------------------------------


def test_chunk_digest_is_content_addressed(tmp_path):
    store = chunkstore.ChunkStore(tmp_path)
    d1, d2, d3 = store.put(b"hello world"), store.put(b"hello world"), store.put(b"hello worle")
    assert d1 == d2 != d3
    assert store.written_chunks == 2 and store.reused_chunks == 1
    assert store.get(d1) == b"hello world"
    chunkstore.chunk_path(store.root, d1).write_bytes(b"hello wOrld")
    with pytest.raises(ValueError, match="does not match its address"):
        store.get(d1)


def test_expected_chunk_sizes_layout():
    assert chunkstore.expected_chunk_sizes(0, 4) == [0]
    assert chunkstore.expected_chunk_sizes(4, 4) == [4]
    assert chunkstore.expected_chunk_sizes(9, 4) == [4, 4, 1]


def test_roundtrip_bitexact(tmp_path):
    leaves = make_leaves(1)
    path = zs_path(tmp_path, 3)
    assert path.name == f"ckpt_3{ZEROSTALL_SUFFIX}" and engine_of(path) == "zerostall"
    handle = save_ckpt_zerostall(path, leaves, {"consumed": 3, "cursor": 8},
                                 extra_meta={"step": 3, "epoch": 2}, background=False)
    assert handle.done and handle.blocking_s > 0 and path.exists()
    target = make_leaves(99)
    doc = load_ckpt_zerostall(path, target)
    assert leaf_bytes(target) == leaf_bytes(leaves)
    assert doc["sampler"]["cursor"] == 8 and doc["step"] == 3
    assert doc["manifest"]["num_leaves"] == len(leaves)


def test_second_save_dedups_unchanged_leaves(tmp_path, sink):
    leaves = make_leaves(2)
    save(zs_path(tmp_path, 1), leaves, 1)
    doc1 = chunkstore.read_manifest(zs_path(tmp_path, 1))
    with torch.no_grad():
        leaves[0].parts[0].add_(1.0)  # one hot leaf, the rest cold
    save(zs_path(tmp_path, 2), leaves, 2)
    doc2 = chunkstore.read_manifest(zs_path(tmp_path, 2))
    assert doc2["reuse"]["bytes_written"] < doc1["reuse"]["bytes_written"]
    hot, cold = doc2["leaves"][0], doc2["leaves"][1:]
    assert hot["reused"] < len(hot["chunks"])
    for entry in cold:
        assert entry["reused"] == len(entry["chunks"]), entry["path"]
    assert events(sink, "ckpt_commit")[-1]["reused_bytes"] > 0


def test_gc_collects_orphans_keeps_referenced(tmp_path, sink):
    exp = tmp_path / "exp"
    save(zs_path(tmp_path, 1), make_leaves(3), 1)
    store = chunkstore.ChunkStore(exp)
    orphan = chunkstore.chunk_path(store.root, store.put(b"\x01" * 5000))
    assert orphan.exists()
    assert chunkstore.collect_garbage(exp) == (1, 5000)
    assert not orphan.exists()
    assert precheck_ckpt_zerostall(zs_path(tmp_path, 1), verify=True) == (True, "")
    assert events(sink, "ckpt_gc")


def test_gc_respects_quarantined_manifests_and_pins(tmp_path):
    from pyrecover_tpu_torch.resilience.quarantine import quarantine_checkpoint

    exp = tmp_path / "exp"
    save(zs_path(tmp_path, 1), make_leaves(4), 1)
    save(zs_path(tmp_path, 2), make_leaves(5), 2)

    def n_chunks():
        return sum(1 for p in chunkstore.chunks_root(exp).rglob("*") if p.is_file())

    before = n_chunks()
    quarantine_checkpoint(zs_path(tmp_path, 1), reason="test")
    lease = pins.pin_manifest(exp, zs_path(tmp_path, 2), owner="reader")
    zs_path(tmp_path, 2).unlink()  # retention pruned it under a reader
    assert chunkstore.collect_garbage(exp) == (0, 0)
    assert n_chunks() == before
    lease.release()
    removed, _ = chunkstore.collect_garbage(exp)
    assert removed > 0 and n_chunks() < before


def test_prune_triggers_refcounted_gc_through_save(tmp_path):
    exp = tmp_path / "exp"
    leaves = make_leaves(5)
    for step in (1, 2, 3):
        with torch.no_grad():
            leaves[0].parts[0].add_(step)
        save(zs_path(tmp_path, step), leaves, step, max_keep=2)
    assert [parse_step(p) for p in list_checkpoints(exp, engine="zerostall")] == [2, 3]
    on_disk = {p.name for p in chunkstore.chunks_root(exp).rglob("*") if p.is_file()}
    assert on_disk == chunkstore.referenced_digests(exp)


# ---- the pipeline ----------------------------------------------------------


def test_background_save_handle_and_shadow(tmp_path, sink):
    path = zs_path(tmp_path, 1)
    handle = save(path, make_leaves(6), 1, background=True)
    handle.wait()
    assert handle.error is None and handle.shadow_s > 0 and handle.write_s == handle.shadow_s
    assert path.exists() and handle.reuse["chunks_total"] > 0
    blk, shd = events(sink, "ckpt_save_blocking"), events(sink, "ckpt_save_shadow")
    assert blk[-1]["engine"] == "zerostall" and blk[-1]["background"]
    assert shd[-1]["ok"] and shd[-1]["shadow_s"] >= 0
    names = [e["name"] for e in sink.events if e["event"] == "span_begin"]
    for span in ("ckpt_blocking", "ckpt_snapshot", "ckpt_chunk_write", "ckpt_manifest_commit"):
        assert span in names


def test_backpressure_is_bounded_and_loud(tmp_path, sink, monkeypatch):
    real = chunkstore.commit_manifest

    def slow_commit(path, doc):
        time.sleep(0.3)
        return real(path, doc)

    monkeypatch.setattr(chunkstore, "commit_manifest", slow_commit)
    leaves = make_leaves(7)
    h1 = save(zs_path(tmp_path, 1), leaves, 1, background=True)
    h2 = save(zs_path(tmp_path, 2), leaves, 2, background=True)
    h2.wait()
    assert h1.done and h2.backpressure_s > 0.1
    bp = events(sink, "ckpt_backpressure")
    assert bp and bp[-1]["wait_s"] > 0.1
    # the wait is the back-pressure's, not the second save's blocking window
    assert h2.blocking_s < h2.backpressure_s


def test_background_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    def exploding_commit(path, doc):
        raise RuntimeError("injected commit failure")

    monkeypatch.setattr(chunkstore, "commit_manifest", exploding_commit)
    path = zs_path(tmp_path, 1)
    handle = save(path, make_leaves(8), 1, background=True)
    with pytest.raises(RuntimeError, match="injected commit failure"):
        handle.wait()
    assert not path.exists()


@pytest.mark.parametrize("op", ["chunk_write", "manifest_commit"])
def test_transient_write_errors_heal_via_retry(tmp_path, sink, op):
    plan = {"chunk_write": {"type": "transient_io_error", "op": "chunk_write", "fail_count": 2},
            "manifest_commit": {"type": "transient_io_error", "op": "manifest_commit",
                                "fail_count": 1}}[op]
    faults.install({"seed": 0, "faults": [plan]})
    path = zs_path(tmp_path, 1)
    save(path, make_leaves(9), 1)
    retries = events(sink, "ckpt_io_retry")
    assert [r["op"] for r in retries] == [op] * plan["fail_count"]
    assert {e["site"] for e in events(sink, "fault_injected")} == {f"ckpt_{op}"}
    assert precheck_ckpt_zerostall(path, verify=True) == (True, "")


def test_kill9_site_validation():
    with pytest.raises(faults.FaultPlanError, match="unknown site"):
        faults.FaultEngine({"faults": [{"type": "kill9_during_save", "site": "ckpt_nonsense"}]})
    eng = faults.FaultEngine({"faults": [
        {"type": "kill9_during_save", "site": s}
        for s in ("ckpt_snapshot", "ckpt_chunk_write", "ckpt_manifest_commit")]})
    assert len(eng.faults) == 3


def test_torn_save_leaves_previous_manifest_restorable(tmp_path):
    exp = tmp_path / "exp"
    leaves = make_leaves(10)
    save(zs_path(tmp_path, 1), leaves, 1)
    store = chunkstore.ChunkStore(exp)  # a save that died before its commit
    for raw in leaf_bytes(make_leaves(11)):
        chunkstore.write_leaf(store, np.frombuffer(raw, np.uint8), CHUNK)
    assert store.written_bytes > 0
    assert get_latest_checkpoint(exp, engine="zerostall") == zs_path(tmp_path, 1)
    assert chunkstore.collect_garbage(exp)[0] > 0
    target = make_leaves(12)
    load_ckpt_zerostall(zs_path(tmp_path, 1), target)
    assert leaf_bytes(target) == leaf_bytes(leaves)


def test_gc_unlink_drill_keeps_manifests_restorable(tmp_path):
    exp = tmp_path / "exp"
    save(zs_path(tmp_path, 1), make_leaves(31), 1)
    store = chunkstore.ChunkStore(exp)
    for fill in (1, 2):
        store.put(bytes([fill]) * 3000)
    faults.install({"faults": [
        {"type": "transient_io_error", "op": "gc_unlink", "fail_count": 1}]})
    with pytest.raises(OSError):
        chunkstore.collect_garbage(exp)
    assert precheck_ckpt_zerostall(zs_path(tmp_path, 1), verify=True) == (True, "")
    assert chunkstore.collect_garbage(exp)[0] == 2
    assert precheck_ckpt_zerostall(zs_path(tmp_path, 1), verify=True) == (True, "")


# ---- the pre-check ---------------------------------------------------------


def test_precheck_rejects_torn_manifest_and_missing_chunks(tmp_path):
    path = zs_path(tmp_path, 1)
    save(path, make_leaves(13), 1)
    assert precheck_ckpt_zerostall(path, verify=True) == (True, "")
    torn = path.parent / f"ckpt_2{ZEROSTALL_SUFFIX}"
    torn.write_text(path.read_text()[: len(path.read_text()) // 2])
    ok, why = precheck_ckpt_zerostall(torn)
    assert not ok and why
    victim = chunkstore.read_manifest(path)["leaves"][0]["chunks"][0]
    chunkstore.chunk_path(chunkstore.chunks_root(path.parent), victim).unlink()
    ok, why = precheck_ckpt_zerostall(path)
    assert not ok and "missing chunk" in why


def test_precheck_digest_rehash_catches_bitflips(tmp_path):
    path = zs_path(tmp_path, 1)
    save(path, make_leaves(14), 1)
    doc = chunkstore.read_manifest(path)
    victim = chunkstore.chunk_path(chunkstore.chunks_root(path.parent),
                                   doc["leaves"][0]["chunks"][0])
    data = bytearray(victim.read_bytes())
    data[0] ^= 0xFF
    victim.write_bytes(bytes(data))
    assert precheck_ckpt_zerostall(path) == (True, "")  # same size
    ok, why = precheck_ckpt_zerostall(path, verify=True)
    assert not ok and "digest" in why
    with pytest.raises(ValueError, match="digest"):
        load_ckpt_zerostall(path, make_leaves(15))


def test_precheck_wrong_model_raises_structure_error(tmp_path):
    path = zs_path(tmp_path, 1)
    leaves = make_leaves(16)
    save(path, leaves, 1)
    from pyrecover_tpu_torch.checkpoint.vanilla import Leaf

    wrong = [Leaf(leaf.path, (*leaf.shape[:-1], leaf.shape[-1] + 1) if leaf.shape else (),
                  leaf.dtype, leaf.parts) for leaf in leaves]
    with pytest.raises(CheckpointStructureError, match="does not fit"):
        precheck_ckpt_zerostall(path, target=wrong)


# ---- the emergency tier ----------------------------------------------------


def test_emergency_publish_and_restore(tmp_path, sink):
    exp = tmp_path / "exp"
    leaves = make_leaves(17)
    save(zs_path(tmp_path, 5), leaves, 5)
    assert events(sink, "emergency_publish")
    step, record = emergency.peek(exp)
    assert step == 5 and emergency.verify(record) == (True, "")
    target = make_leaves(18)
    sampler, doc = emergency.restore(exp, target)
    assert leaf_bytes(target) == leaf_bytes(leaves)
    assert sampler["consumed"] == 5 and doc["step"] == 5
    assert events(sink, "emergency_restore")


def test_emergency_strict_digest_gate_rejects_tampered_record(tmp_path):
    exp = tmp_path / "exp"
    save(zs_path(tmp_path, 1), make_leaves(19), 1)
    _, record = emergency.peek(exp)
    record["leaves"][0] = np.array(record["leaves"][0], copy=True)
    record["leaves"][0][0] ^= 1  # RAM rot
    ok, why = emergency.verify(record)
    assert not ok and "digests" in why
    with pytest.raises(ValueError, match="rejected"):
        emergency.restore(exp, make_leaves(20))


def test_emergency_usable_gate(tmp_path):
    exp = tmp_path / "exp"
    save(zs_path(tmp_path, 3), make_leaves(21), 3)
    topo = {"devices": 1, "processes": 1, "mesh": None}
    assert emergency.usable(exp, topo, min_step=3) is not None
    assert emergency.usable(exp, topo, min_step=4) is None  # staler than the disk
    two = {"devices": 2, "processes": 2, "mesh": {"data": 2}}
    assert emergency.usable(exp, two, min_step=0) is None  # another topology


def test_emergency_off_publishes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv(emergency.EMERGENCY_ENV, "0")
    save(zs_path(tmp_path, 1), make_leaves(22), 1)
    assert emergency.peek(tmp_path / "exp") is None


def test_snapshot_buffers_alternate_so_the_record_survives_the_next_snapshot(
        tmp_path, monkeypatch):
    """The record holds one buffer set; the next snapshot fills the other,
    so the record still verifies while that save is being written and after
    it publishes, and the two records never share a set."""
    exp = tmp_path / "exp"
    leaves = make_leaves(23)
    save(zs_path(tmp_path, 1), leaves, 1)
    _, first = emergency.peek(exp)
    gate, real = threading.Event(), chunkstore.commit_manifest

    def held_commit(path, doc):
        assert gate.wait(30)
        return real(path, doc)

    monkeypatch.setattr(chunkstore, "commit_manifest", held_commit)
    with torch.no_grad():
        for leaf in leaves:
            for p in leaf.parts:
                if isinstance(p, torch.Tensor):
                    p.add_(1.0)
    handle = save(zs_path(tmp_path, 2), leaves, 2, background=True)
    assert not handle.done  # snapshot taken, writer held before its commit
    assert emergency.verify(first) == (True, "")
    gate.set()
    handle.wait()
    _, second = emergency.peek(exp)
    assert second["step"] == 2 and emergency.verify(second) == (True, "")
    assert second["buffers"] is not first["buffers"]
    assert emergency.verify(first) == (True, "")  # nothing wrote over it
    save(zs_path(tmp_path, 3), leaves, 3)  # the third reuses the first's set
    assert emergency.peek(exp)[1]["buffers"] is first["buffers"]
    release(exp)


# ---- the emergency peer exchange over two gloo ranks -----------------------


def _peer_worker(args):
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    try:
        os.environ[chunkstore.CHUNK_BYTES_ENV] = str(CHUNK)
        exp = Path(args["dir"]) / "exp"
        leaves = make_leaves(24)
        save_ckpt_zerostall(exp / "ckpt_1.zs.json", leaves, {"consumed": 1},
                            extra_meta={"step": 1, "topology": mesh.topology(2)},
                            background=False)
        mesh.sync_global_devices("saved")
        before = emergency.peek(exp)
        # what the next save's blocking window runs on every rank
        exchanged = emergency.replicate_to_peers(exp)
        got = emergency.peek(exp)
        topo = mesh.topology(2)
        record = emergency.usable(exp, topo) if got else None
        ok = record is not None and emergency.verify(record)[0]
        target = make_leaves(25)
        if ok:
            emergency.restore(exp, target)
        return {"before": before[0] if before else None, "exchanged": exchanged,
                "step": got[0] if got else None, "ok": bool(ok),
                "equal": leaf_bytes(target) == leaf_bytes(leaves)}
    finally:
        mesh.destroy_distributed()


def test_emergency_peer_exchange_fills_every_ranks_ram(tmp_path):
    outs = _spawn(__file__, "peer", {"dir": str(tmp_path)},
                  rank_env=lambda r: {emergency.PEER_EXCHANGE_ENV: "1"} if r == 0 else {})
    assert [o["before"] for o in outs] == [1, None]  # host 0 wrote and published
    assert outs[0] == {"before": 1, "exchanged": True, "step": 1, "ok": True, "equal": True}
    assert outs[1] == dict(outs[0], before=None)  # now rank 1 holds the same record


# ---- pins ------------------------------------------------------------------


def test_pin_publish_failure_leaves_no_orphan_lease(tmp_path, monkeypatch):
    import errno

    mpath = tmp_path / "ckpt_1.zs.json"
    mpath.write_text(json.dumps({"leaves": []}))

    def no_publish(src, dst):
        raise OSError(errno.EIO, "injected publish failure")

    monkeypatch.setattr(os, "replace", no_publish)
    with pytest.raises(OSError):
        pins.pin_manifest(tmp_path, mpath, owner="t")
    pdir = pins.pins_dir(tmp_path)
    assert list(pdir.glob(f"*{pins.PIN_SUFFIX}")) == [] and list(pdir.glob("*.tmp")) == []


def test_pin_release_idempotent_after_expiry(tmp_path):
    mpath = tmp_path / "ckpt_1.zs.json"
    mpath.write_text(json.dumps({"leaves": []}))
    lease = pins.pin_manifest(tmp_path, mpath, owner="t")
    old = time.time() - 1000
    os.utime(lease.path, (old, old))
    assert pins.expire_stale_pins(tmp_path, ttl_s=10) == [lease.path.name]
    lease.release()
    lease.release()


def test_expire_stale_pins_sweeps_tmp_orphans_by_the_same_clock(tmp_path):
    mpath = tmp_path / "ckpt_1.zs.json"
    mpath.write_text(json.dumps({"leaves": []}))
    lease = pins.pin_manifest(tmp_path, mpath, owner="t")
    pdir = pins.pins_dir(tmp_path)
    orphan, fresh = pdir / "ckpt_0.zs.json.dead.pin.x1.tmp", pdir / "ckpt_2.zs.json.pin.x2.tmp"
    for p in (orphan, fresh):
        p.write_bytes(b"{")
    old = time.time() - 1000
    os.utime(orphan, (old, old))
    assert pins.expire_stale_pins(tmp_path, ttl_s=10) == [orphan.name]
    assert fresh.exists() and lease.path.exists()
    with lease:
        pass
    assert not lease.path.exists()


# ---- the registry with three engines ---------------------------------------


def _touch_mixed_exp(exp):
    exp.mkdir(parents=True, exist_ok=True)
    for name in (f"ckpt_10{VANILLA_SUFFIX}", f"ckpt_30{VANILLA_SUFFIX}"):
        (exp / name).write_bytes(b"v")
    for name in ("ckpt_20", "ckpt_40"):
        (exp / name).mkdir()
    for name in (f"ckpt_15{ZEROSTALL_SUFFIX}", f"ckpt_25{ZEROSTALL_SUFFIX}"):
        (exp / name).write_text("{}")


def test_mixed_engine_discovery_and_latest(tmp_path):
    exp = tmp_path / "exp"
    _touch_mixed_exp(exp)
    assert [parse_step(p) for p in list_checkpoints(exp)] == [10, 15, 20, 25, 30, 40]
    for engine, want in (("vanilla", [10, 30]), ("sharded", [20, 40]),
                         ("zerostall", [15, 25])):
        assert [parse_step(p) for p in list_checkpoints(exp, engine=engine)] == want
    assert parse_step(get_latest_checkpoint(exp, engine="zerostall")) == 25
    assert parse_step(get_latest_checkpoint(exp)) == 40


def test_mixed_engine_prune_isolation(tmp_path):
    exp = tmp_path / "exp"
    _touch_mixed_exp(exp)
    assert [p.name for p in prune_checkpoints(exp, 1, engine="vanilla")] == [
        f"ckpt_10{VANILLA_SUFFIX}"]
    assert [parse_step(p) for p in list_checkpoints(exp, engine="zerostall")] == [15, 25]
    assert [p.name for p in prune_checkpoints(exp, 1, engine="zerostall")] == [
        f"ckpt_15{ZEROSTALL_SUFFIX}"]
    assert [parse_step(p) for p in list_checkpoints(exp, engine="sharded")] == [20, 40]


def test_elastic_gate_reads_zerostall_manifests(tmp_path):
    leaves = make_leaves(26)
    path = zs_path(tmp_path, 1)
    save_ckpt_zerostall(path, leaves, {"consumed": 1, "replicas": 1, "global_batch_size": 8},
                        extra_meta={"step": 1, "topology": {"devices": 1, "processes": 1,
                                                            "mesh": None}},
                        background=False)
    meta = elastic.read_saved_meta(path)
    assert meta["topology"]["devices"] == 1 and meta["manifest"]["num_leaves"] == len(leaves)
    one = {"devices": 1, "processes": 1, "mesh": None}
    assert elastic.resume_gate("auto", path, leaves, one)[0] == elastic.GATE_OK
    two = {"devices": 2, "processes": 2, "mesh": {"data": 2}}
    gate, reason, plan = elastic.resume_gate("auto", path, leaves, two)
    assert gate == elastic.GATE_ELASTIC, reason
    assert plan.bytes_moved == plan.total_bytes == sum(leaf.nbytes for leaf in leaves)


# ---- through train.train ---------------------------------------------------


def tiny_config(ckpt_dir, **kw):
    import dataclasses

    from pyrecover_tpu_torch.config import get_args

    argv = ["--device", "cpu", "--batch-size", "4", "--sequence-length", "32",
            "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
            "--model-kv-heads", "2", "--vocab-size", "128", "--attention-impl", "flash",
            "--learning-rate", "1e-3", "--lr-warmup-steps", "2", "--training-samples", "16",
            "--logging-frequency", "1", "--checkpoint-frequency", "2", "--seed", "7",
            "--checkpoint-engine", "zerostall", "--log-loss-to-csv", "--telemetry",
            "--checkpoint-dir", str(ckpt_dir)]
    return dataclasses.replace(get_args(argv), **kw)


def final_chunks(exp, step):
    doc = chunkstore.read_manifest(exp / f"ckpt_{step}_final.zs.json")
    return [(e["path"], e["chunks"]) for e in doc["leaves"]]


def csv_rows(exp):
    return (exp / f"{exp.name}_loss_log.csv").read_text().splitlines()


@pytest.fixture()
def train_chunks(monkeypatch):
    monkeypatch.setenv(chunkstore.CHUNK_BYTES_ENV, str(TRAIN_CHUNK))


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    from pyrecover_tpu_torch.train import train

    root = tmp_path_factory.mktemp("straight")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tests' setting: the sums' order decides the bits
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(chunkstore.CHUNK_BYTES_ENV, str(TRAIN_CHUNK))
            out = train(tiny_config(root, training_steps=6))
    finally:
        torch.set_num_threads(threads)
    emergency.drop()
    exp = root / "default-exp"
    return {"exp": exp, "chunks": final_chunks(exp, 6), "rows": csv_rows(exp), "out": out}


def test_train_zerostall_resume_is_bit_exact(tmp_path, straight, train_chunks):
    from pyrecover_tpu_torch.train import train

    first = train(tiny_config(tmp_path, training_steps=3))
    assert [Path(s["path"]).name for s in first["saves"]] == ["ckpt_2.zs.json",
                                                               "ckpt_3_final.zs.json"]
    assert first["saves"][0]["reuse"]["chunks_total"] > 0 and first["saves"][0]["alloc_s"] >= 0
    emergency.drop()  # the disk tier's turn
    out = train(tiny_config(tmp_path, training_steps=6, resume_from_checkpoint="latest"))
    exp = tmp_path / "default-exp"
    assert out["start_step"] == 3 and out["resumed_from"].endswith("ckpt_3_final.zs.json")
    assert final_chunks(exp, 6) == straight["chunks"]
    assert csv_rows(exp) == straight["rows"]
    assert straight["out"]["saves"][-1]["backpressure_s"] >= 0


def test_train_emergency_restore_with_the_disk_tier_deleted(tmp_path, straight, train_chunks):
    import shutil

    from pyrecover_tpu_torch.train import train

    train(tiny_config(tmp_path, training_steps=3))
    exp = tmp_path / "default-exp"
    for p in exp.glob(f"*{ZEROSTALL_SUFFIX}"):
        p.unlink()
    shutil.rmtree(exp / "chunks")
    assert list_checkpoints(exp) == []
    out = train(tiny_config(tmp_path, training_steps=6, resume_from_checkpoint="latest"))
    assert out["start_step"] == 3 and out["resumed_from"] == "<emergency-ram>"
    assert final_chunks(exp, 6) == straight["chunks"]
    assert csv_rows(exp) == straight["rows"]
    events_ = [json.loads(x) for x in (exp / "default-exp_telemetry.jsonl").read_text()
               .splitlines()]
    assert [e["step"] for e in events_ if e["event"] == "emergency_restore"] == [3]
    assert [e["path"] for e in events_ if e["event"] == "resume"] == ["<emergency-ram>"]


def test_train_rejects_a_tampered_ram_record_and_uses_the_disk(tmp_path, straight, train_chunks):
    from pyrecover_tpu_torch.train import train

    train(tiny_config(tmp_path, training_steps=3))
    exp = tmp_path / "default-exp"
    _, record = emergency.peek(exp)
    record["leaves"][0][0] ^= 1
    out = train(tiny_config(tmp_path, training_steps=6, resume_from_checkpoint="latest"))
    assert out["resumed_from"].endswith("ckpt_3_final.zs.json")
    assert final_chunks(exp, 6) == straight["chunks"]
    evs = [json.loads(x) for x in (exp / "default-exp_telemetry.jsonl").read_text().splitlines()]
    assert [e["event"] for e in evs if e["event"].startswith("emergency_restore")] == [
        "emergency_restore_rejected"]


def test_kill9_in_the_snapshot_window_resumes_from_the_previous_manifest(tmp_path, straight, train_chunks):
    """A trainer subprocess killed at ``ckpt_snapshot`` of its second save:
    the doctor says crash in ``ckpt_snapshot``, the first manifest is the
    newest, and the ``latest`` resume ends with the straight run's state."""
    from pyrecover_tpu_torch.telemetry import doctor
    from pyrecover_tpu_torch.train import train

    argv = ["--device", "cpu", "--batch-size", "4", "--sequence-length", "32",
            "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
            "--model-kv-heads", "2", "--vocab-size", "128", "--attention-impl", "flash",
            "--learning-rate", "1e-3", "--lr-warmup-steps", "2", "--training-samples", "16",
            "--logging-frequency", "1", "--checkpoint-frequency", "2", "--seed", "7",
            "--checkpoint-engine", "zerostall", "--log-loss-to-csv", "--telemetry",
            "--checkpoint-dir", str(tmp_path), "--training-steps", "6"]
    plan = {"seed": 0, "faults": [{"type": "kill9_during_save", "site": "ckpt_snapshot",
                                   "save_index": 2}]}
    env = {**os.environ, faults.PLAN_ENV: json.dumps(plan), "OMP_NUM_THREADS": "1",
           chunkstore.CHUNK_BYTES_ENV: str(TRAIN_CHUNK)}
    proc = subprocess.run([sys.executable, "-m", "pyrecover_tpu_torch.train", *argv], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    exp = tmp_path / "default-exp"
    report = doctor.diagnose(exp)
    assert (report["classification"], report["phase"]) == ("crash", "ckpt_snapshot")
    assert [p.name for p in list_checkpoints(exp)] == ["ckpt_2.zs.json"]
    out = train(tiny_config(tmp_path, training_steps=6, resume_from_checkpoint="latest"))
    assert out["start_step"] == 2
    assert final_chunks(exp, 6) == straight["chunks"]


def test_train_summary_charges_the_backpressure_to_the_saves(straight):
    """The summary's ``ckpt_save_s`` is what the saves stalled the loop:
    each blocking window plus its wait for the save before."""
    out = straight["out"]
    assert len(out["saves"]) == 3
    assert out["ckpt_save_s"] == sum(s["blocking_s"] + s["backpressure_s"] for s in out["saves"])


def test_release_unpins_the_sets_and_pinned_bytes_count_the_rounding(tmp_path, monkeypatch):
    """PyTorch's caching host allocator pins a power of two for each set,
    and keeps a freed block cached (pinned) until its cache is emptied:
    `release` empties it once the sets are dropped, and only when they were
    pinned."""
    assert [snapshot._pinned_size(n) for n in (1, 4096, 4097, 2_969_690_112)] == [
        1, 4096, 8192, 2**32]
    emptied = []
    monkeypatch.setattr(torch.accelerator, "empty_host_cache", None, raising=False)
    monkeypatch.setattr(torch._C, "_host_emptyCache", lambda: emptied.append(1), raising=False)
    save(zs_path(tmp_path, 1), make_leaves(29), 1).wait()
    release(tmp_path / "exp")  # a CPU state: nothing was pinned
    assert emptied == []
    saver = snapshot._saver(tmp_path / "exp")
    saver.sets, saver.pinned_bytes = [torch.empty(8), torch.empty(8)], 2 * 4096
    release(tmp_path / "exp")
    assert emptied == [1] and snapshot._key(tmp_path / "exp") not in snapshot._savers


def test_no_device_sync_path_on_the_cpu_snapshot(tmp_path, monkeypatch):
    """On the CPU the snapshot is a plain copy: no stream, no pinned
    buffers, no completion event."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: pytest.fail("a stream on the CPU"))
    handle = save(zs_path(tmp_path, 1), make_leaves(27), 1)
    assert handle.pinned_bytes == 0
    saver = snapshot._saver(tmp_path / "exp")
    assert saver.stream is None and len(saver.sets) == 2
    assert not any(b.is_pinned() for b in saver.sets)
    release(tmp_path / "exp")


@pytest.mark.gpu
def test_the_card_snapshot_is_pinned_and_on_a_side_stream(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this path on the H100)")
    leaves = make_leaves(28)
    for leaf in leaves:
        leaf.parts = [p.cuda() if isinstance(p, torch.Tensor) else p for p in leaf.parts]
    handle = save(zs_path(tmp_path, 1), leaves, 1)
    saver = snapshot._saver(tmp_path / "exp")
    assert handle.pinned_bytes == 2 * snapshot._pinned_size(saver.layout.nbytes)
    assert all(b.is_pinned() for b in saver.sets)
    target = make_leaves(29)
    load_ckpt_zerostall(zs_path(tmp_path, 1), target)
    assert leaf_bytes(target) == leaf_bytes([type(leaf)(leaf.path, leaf.shape, leaf.dtype, [
        p.cpu() if isinstance(p, torch.Tensor) else p for p in leaf.parts]) for leaf in leaves])
    release(tmp_path / "exp")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    mode, worker_args = sys.argv[2], json.loads(sys.argv[3])
    result = {"peer": _peer_worker}[mode](worker_args)
    print(json.dumps(result), flush=True)
