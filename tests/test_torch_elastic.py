"""The port's elastic preflight (pyrecover_tpu_torch/checkpoint/elastic.py)
held to the JAX package's (tests/test_elastic.py).

Both packages' ``compute_reshard_plan``, ``preflight_elastic`` and
``resume_gate`` take the same saved metadata and must give the same plan
(grids, operations, reads, bytes moved, the sampler's accounting), the same
finding ids and messages and the same gate: a dp2 checkpoint resumed at
dp1, an indivisible sampler, SC05 under a tiny ``$PYRECOVER_HBM_BYTES``,
``--elastic-resume off``. The target specs are the JAX rules' for the plan
math (the port's own are all replicated). Then the port's ``_resume`` walk
through the gate, as the JAX tests hold the JAX one: a shrink emits the
``reshard`` span, ``elastic_resume`` and ``sampler_rescaled``; the same
topology stays plain; ``off`` raises the typed error before any read; a
preflight rejection falls back without quarantine; every candidate rejected
refuses to start; an explicit infeasible checkpoint raises.
"""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from pyrecover_tpu.analysis.shardcheck.manifest import spec_to_json as jax_spec_to_json
from pyrecover_tpu.checkpoint import elastic as jax_elastic
from pyrecover_tpu.parallel.sharding import spec_for_manifest_path
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint import elastic
from pyrecover_tpu_torch.checkpoint.elastic import TopologyMismatchError
from pyrecover_tpu_torch.checkpoint.registry import checkpoint_path
from pyrecover_tpu_torch.checkpoint.vanilla import MAGIC, save_ckpt_vanilla
from pyrecover_tpu_torch.data.sampler import StatefulSampler
from pyrecover_tpu_torch.parallel.mesh import topology


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def sink():
    s = telemetry.add_sink(telemetry.MemorySink())
    yield s
    telemetry.remove_sink(s)


def events(sink, name):
    return [e for e in sink.events if e["event"] == name]


def _topo(n, **axes):
    mesh = {"pipeline": 1, "data": n, "fsdp": 1, "tensor": 1, "sequence": 1, "expert": 1}
    for k, v in axes.items():
        mesh[k] = v
        mesh["data"] = n // int(np.prod(list(axes.values())))
    return {"devices": n, "processes": 1, "mesh": mesh}


def rule_specs(manifest):
    """The JAX package's rule-derived target specs, given to both packages."""
    return {e["path"]: jax_spec_to_json(spec_for_manifest_path(e["path"], len(e["shape"])))
            for e in manifest["leaves"]}


def both_plans(manifest, saved, target, **kw):
    specs = rule_specs(manifest)
    return (elastic.compute_reshard_plan(manifest, saved, target, target_specs=specs, **kw),
            jax_elastic.compute_reshard_plan(manifest, saved, target, target_specs=specs, **kw))


def both_preflights(manifest, saved, target, **kw):
    specs = rule_specs(manifest)
    port = elastic.preflight_elastic(manifest, saved, target, target_specs=specs, **kw)
    ref = jax_elastic.preflight_elastic(manifest, saved, target, target_specs=specs, **kw)
    return port, ref


def findings_of(result):
    return [(f.rule_id, f.rule, f.severity, f.path, f.message) for f in result[0]]


# ---- the plan and the preflight, against the JAX package's -----------------

WQ_NORM = {"leaves": [
    {"path": ".params['layers']['wq']", "shape": [2, 64, 64], "dtype": "float32",
     "spec": ["pipeline", "fsdp", "tensor"]},
    {"path": ".params['final_norm']", "shape": [64], "dtype": "float32", "spec": [None]},
    {"path": ".opt_state[1][0].mu['layers']['wo']", "shape": [2, 64, 64],
     "dtype": "bfloat16", "spec": ["pipeline", "tensor", "fsdp"]},
]}


@pytest.mark.parametrize("saved,target", [
    (_topo(8, fsdp=2, tensor=2), _topo(2, fsdp=2)),
    (_topo(8, fsdp=2, tensor=2), _topo(8, fsdp=2, tensor=2)),
    (_topo(2), _topo(4, fsdp=2, tensor=2)),
    (_topo(2), _topo(1)),
], ids=["concat", "same", "split", "dp2-to-dp1"])
def test_plan_grid_math_matches_jax(saved, target):
    port, ref = both_plans(WQ_NORM, saved, target)
    assert port.as_dict() == ref.as_dict()
    assert (port.feasible, port.resharded_leaves, port.bytes_moved, port.total_bytes) == (
        ref.feasible, ref.resharded_leaves, ref.bytes_moved, ref.total_bytes)


def test_plan_grid_math_split_and_concat():
    port, _ = both_plans(WQ_NORM, _topo(8, fsdp=2, tensor=2), _topo(2, fsdp=2))
    wq = port.leaves[0]
    assert wq.src_grid == (1, 2, 2) and wq.tgt_grid == (1, 2, 1)
    assert wq.ops == ("keep", "keep", "concat 2→1") and wq.reads_per_shard == 2
    assert port.feasible and port.bytes_moved == port.total_bytes


def test_plan_infeasible_dim_is_sc11_in_both():
    manifest = {"leaves": [{"path": ".params['layers']['w1']", "shape": [2, 10, 64],
                            "dtype": "float32", "spec": None}]}
    port, ref = both_preflights(manifest, _topo(2), _topo(6, fsdp=3, tensor=2))
    assert findings_of(port) == findings_of(ref)
    assert [f.rule_id for f in port[0]] == ["SC11"] and not port[1].feasible


def test_preflight_indivisible_sampler_matches_jax():
    sampler = {"global_batch_size": 8, "cursor": 0, "replicas": 4}
    port, ref = both_preflights({"leaves": []}, _topo(4), _topo(3), sampler_state=sampler)
    assert findings_of(port) == findings_of(ref)
    assert port[1].sampler == ref[1].sampler
    assert "not divisible by 3" in port[1].sampler["error"]


def test_preflight_hbm_budget_sc05_matches_jax(monkeypatch):
    monkeypatch.setenv(elastic.HBM_BYTES_ENV, "64")
    manifest = {"leaves": [{"path": ".params['big']", "shape": [64, 64], "dtype": "float32",
                            "spec": None}]}
    port, ref = both_preflights(manifest, _topo(4), _topo(2))
    assert findings_of(port) == findings_of(ref)
    assert [f.rule_id for f in port[0]] == ["SC05"]
    assert port[1].sampler == ref[1].sampler


def test_no_budget_on_the_cpu_without_the_override(monkeypatch):
    monkeypatch.delenv(elastic.HBM_BYTES_ENV, raising=False)
    assert elastic.hbm_budget(torch.device("cpu")) is None and elastic.hbm_budget() is None
    manifest = {"leaves": [{"path": ".params['big']", "shape": [64, 64], "dtype": "float32",
                            "spec": None}]}
    findings, plan = elastic.preflight_elastic(manifest, _topo(4), _topo(2),
                                               device=torch.device("cpu"))
    assert findings == [] and "hbm_state_bytes" not in plan.sampler


@pytest.mark.parametrize("saved,target", [
    (_topo(4), _topo(2)), (_topo(4), _topo(4)), (_topo(4), _topo(4, fsdp=2)),
    (None, _topo(4)), ({}, _topo(4)), (topology(2), topology(1)), (topology(1), topology(1)),
])
def test_topologies_differ_and_describe_match_jax(saved, target):
    assert elastic.topologies_differ(saved, target) == jax_elastic.topologies_differ(saved, target)
    for topo in (saved, target):
        assert elastic.describe_topology(topo) == jax_elastic.describe_topology(topo)


def test_render_plan_matches_jax():
    manifest = {"leaves": [{"path": ".params['layers']['w1']", "shape": [2, 10, 64],
                            "dtype": "float32", "spec": None}] + WQ_NORM["leaves"]}
    (_, port), (_, ref) = both_preflights(manifest, _topo(2), _topo(6, fsdp=3, tensor=2),
                                          sampler_state={"global_batch_size": 8,
                                                         "replicas": 2})
    a, b = io.StringIO(), io.StringIO()
    elastic.render_plan(port, a)
    jax_elastic.render_plan(ref, b)
    assert a.getvalue() == b.getvalue() and "INFEASIBLE" in a.getvalue()


# ---- resume_gate on the same file, in both packages -------------------------


def port_leaves(seed=0):
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import rng_key, state_leaves

    cfg = TrainConfig(model=ModelConfig().tiny(max_seq_len=32), sequence_length=32,
                      model_dtype="fp32", device="cpu")
    model = Transformer(cfg.model, generator=torch.Generator().manual_seed(seed))
    opt, _ = build_optimizer(cfg, model.parameters())
    return state_leaves(model, opt, step=seed, epoch=0, rng=rng_key(seed))


def save_for_resume(exp_dir, leaves, step, *, replicas, gbs=8):
    sampler = StatefulSampler(64, gbs, seed=0)
    path = checkpoint_path(exp_dir.parent, exp_dir.name, step)
    save_ckpt_vanilla(path, leaves, {"consumed": step, "replicas": replicas,
                                     **sampler.state_dict()},
                      extra_meta={"step": step, "epoch": 0, "topology": topology(replicas)})
    return path


def rewrite_meta(path, mutate):
    """Rewrite a vanilla file's meta header in place (frames untouched)."""
    data = path.read_bytes()
    off = len(MAGIC)
    mlen = int.from_bytes(data[off:off + 8], "little")
    meta = json.loads(data[off + 8:off + 8 + mlen].decode())
    mutate(meta)
    blob = json.dumps(meta).encode()
    path.write_bytes(MAGIC + len(blob).to_bytes(8, "little") + blob + data[off + 8 + mlen:])


@pytest.fixture(scope="module")
def jax_target():
    """A JAX TrainState on one device: the JAX gate's target."""
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
    from pyrecover_tpu.train_state import create_train_state

    cfg = JaxTrainConfig(sequence_length=32, model=JaxModelConfig().tiny(max_seq_len=32))
    tx, _ = jax_build_optimizer(cfg)
    return create_train_state(jax.random.key(0), cfg.model, tx)


def plan_accounting(plan):
    if plan is None:
        return None
    return (plan.resharded_leaves, plan.bytes_moved, plan.total_bytes, plan.feasible,
            plan.sampler, [lp.tgt_grid for lp in plan.leaves])


@pytest.mark.parametrize("mode,budget,want", [
    ("auto", None, elastic.GATE_ELASTIC),
    ("on", None, elastic.GATE_ELASTIC),
    ("off", None, elastic.GATE_MISMATCH),
    ("auto", "1024", elastic.GATE_INFEASIBLE),
], ids=["dp2-to-dp1", "on", "off", "sc05"])
def test_resume_gate_matches_jax(tmp_path, jax_target, monkeypatch, mode, budget, want):
    if budget:
        monkeypatch.setenv(elastic.HBM_BYTES_ENV, budget)
    leaves = port_leaves()
    path = save_for_resume(tmp_path / "exp", leaves, 3, replicas=2)
    port = elastic.resume_gate(mode, path, leaves, topology(1))
    ref = jax_elastic.resume_gate(mode, path, jax_target)
    assert port[0] == ref[0] == want
    assert port[1] == ref[1]
    assert plan_accounting(port[2]) == plan_accounting(ref[2])
    if want == elastic.GATE_INFEASIBLE:
        assert "SC05" in port[1]
    if want == elastic.GATE_MISMATCH:
        assert "2 devices" in port[1] and "1 devices" in port[1]


def test_resume_gate_indivisible_sampler_matches_jax(tmp_path, devices8):
    """gbs 6 cannot split over 4 replicas: SC11 in both packages (the JAX
    target on a 4-device mesh, the port's at dp4)."""
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state

    cfg = JaxTrainConfig(sequence_length=32, model=JaxModelConfig().tiny(max_seq_len=32))
    tx, _ = jax_build_optimizer(cfg)
    mesh = create_mesh(MeshConfig(data=4), devices=devices8[:4])
    target = init_sharded_state(jax.random.key(0), cfg.model, tx, mesh)
    leaves = port_leaves()
    path = save_for_resume(tmp_path / "exp", leaves, 3, replicas=2)
    rewrite_meta(path, lambda m: m["sampler"].update(global_batch_size=6, replicas=3))
    port = elastic.resume_gate("auto", path, leaves, dict(topology(4), processes=1))
    ref = jax_elastic.resume_gate("auto", path, target)
    assert port[0] == ref[0] == elastic.GATE_INFEASIBLE
    assert port[1] == ref[1] and "SC11" in port[1] and "not divisible by 4" in port[1]


# ---- the port's _resume walk through the gate ------------------------------


def resume_config(**kw):
    from pyrecover_tpu_torch.config import TrainConfig

    kw.setdefault("resume_from_checkpoint", "latest")
    return TrainConfig(sequence_length=32, batch_size=8, device="cpu", **kw)


def resume(config, exp_dir, leaves, target_topology):
    from pyrecover_tpu_torch.train import _resume

    return _resume(config, exp_dir, leaves, None, target_topology, torch.device("cpu"))


def leaf_bytes(leaves):
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import byte_view

    return [b"".join(byte_view(p).tobytes() for p in leaf.parts) for leaf in leaves]


def test_resume_elastic_shrink_emits_trail(tmp_path, sink):
    from pyrecover_tpu_torch.train import _elastic_accounting

    exp = tmp_path / "exp"
    saved = port_leaves(1)
    save_for_resume(exp, saved, 3, replicas=2)
    target = port_leaves(9)
    meta, cand, _, plan = resume(resume_config(), exp, target, topology(1))
    assert meta["step"] == 3 and plan is not None and cand.name == "ckpt_3.ckpt"
    assert leaf_bytes(target) == leaf_bytes(saved)
    _elastic_accounting(plan, meta, cand, 3)
    (ev,) = events(sink, "elastic_resume")
    assert ev["saved_topology"]["devices"] == 2 and ev["target_topology"]["devices"] == 1
    assert ev["plan_bytes_moved"] == plan.total_bytes > 0 and ev["resharded_leaves"] == 0
    (rs,) = events(sink, "sampler_rescaled")
    assert (rs["saved_replicas"], rs["target_replicas"], rs["consumed"]) == (2, 1, 3)
    assert [e["name"] for e in events(sink, "span_begin")].count("reshard") == 1


def test_resume_same_topology_stays_plain(tmp_path, sink):
    exp = tmp_path / "exp"
    save_for_resume(exp, port_leaves(1), 3, replicas=2)
    meta, _, _, plan = resume(resume_config(), exp, port_leaves(9), topology(2))
    assert meta["step"] == 3 and plan is None
    assert not events(sink, "elastic_resume")
    assert "reshard" not in [e["name"] for e in events(sink, "span_begin")]


def test_resume_off_raises_typed_mismatch_before_any_read(tmp_path, sink):
    exp = tmp_path / "exp"
    save_for_resume(exp, port_leaves(1), 3, replicas=2)
    with pytest.raises(TopologyMismatchError) as ei:
        resume(resume_config(elastic_resume="off"), exp, port_leaves(9), topology(1))
    assert "2 devices" in str(ei.value) and "1 devices" in str(ei.value)
    assert isinstance(ei.value, RuntimeError)
    assert [e["elastic_resume"] for e in events(sink, "topology_mismatch")] == ["off"]
    assert not events(sink, "ckpt_restore_start")


def test_resume_preflight_rejection_falls_back_without_quarantine(tmp_path, sink):
    exp = tmp_path / "exp"
    saved = port_leaves(1)
    save_for_resume(exp, saved, 3, replicas=1)
    newest = save_for_resume(exp, port_leaves(2), 6, replicas=1)
    # an un-rescalable sampler on the newest: gbs 6 over the target's 4 shards
    rewrite_meta(newest, lambda m: m["sampler"].update(global_batch_size=6, replicas=3))
    target = port_leaves(9)
    meta, cand, _, _ = resume(resume_config(), exp, target, topology(4))
    assert meta["step"] == 3 and cand.name == "ckpt_3.ckpt"
    assert leaf_bytes(target) == leaf_bytes(saved)
    (rej,) = events(sink, "elastic_preflight_failed")
    assert rej["path"].endswith("ckpt_6.ckpt") and "SC11" in rej["reason"]
    assert newest.exists() and not (exp / ".corrupt").exists()
    assert [e["path"].endswith("ckpt_3.ckpt") for e in events(sink, "ckpt_restore_start")] == [
        True]


def test_resume_all_rejected_raises_without_io(tmp_path, sink, monkeypatch):
    exp = tmp_path / "exp"
    for step in (3, 6):
        save_for_resume(exp, port_leaves(step), step, replicas=2)
    monkeypatch.setenv(elastic.HBM_BYTES_ENV, "1024")  # nothing fits
    with pytest.raises(RuntimeError, match="rejected by the elastic preflight"):
        resume(resume_config(), exp, port_leaves(9), topology(1))
    assert len(events(sink, "elastic_preflight_failed")) == 2
    assert not events(sink, "ckpt_restore_start")
    assert (exp / "ckpt_3.ckpt").exists() and (exp / "ckpt_6.ckpt").exists()


def test_resume_explicit_infeasible_raises_typed(tmp_path, monkeypatch):
    exp = tmp_path / "exp"
    path = save_for_resume(exp, port_leaves(3), 3, replicas=2)
    monkeypatch.setenv(elastic.HBM_BYTES_ENV, "1024")
    with pytest.raises(TopologyMismatchError, match="SC05"):
        resume(resume_config(resume_from_checkpoint=str(path)), exp, port_leaves(9),
               topology(1))


def test_elastic_resume_on_through_train(tmp_path):
    """``--elastic-resume on`` in the trainer: a dp2 file (its topology
    forged into the header) resumed at dp1 runs the preflight, reshards and
    trains on; the JSONL holds the trail."""
    from test_torch_zerostall import tiny_config

    from pyrecover_tpu_torch.train import train

    cfg = tiny_config(tmp_path, checkpoint_engine="vanilla", training_steps=2)
    train(cfg)
    exp = tmp_path / "default-exp"
    rewrite_meta(exp / "ckpt_2_final.ckpt", lambda m: (
        m.update(topology=topology(2)), m["sampler"].update(replicas=2)))
    out = train(dataclasses.replace(cfg, training_steps=4, resume_from_checkpoint="latest",
                                    elastic_resume="on"))
    assert (out["start_step"], out["end_step"]) == (2, 4)
    evs = [json.loads(x) for x in (exp / "default-exp_telemetry.jsonl").read_text().splitlines()]
    names = [e["event"] for e in evs]
    assert names.count("elastic_resume") == 1 and names.count("sampler_rescaled") == 1
    (er,) = [e for e in evs if e["event"] == "elastic_resume"]
    assert er["plan_bytes_moved"] > 0 and er["step"] == 2
