"""Resumes across sequence and pipeline topologies through the port's
``train.main`` on gloo ranks, serving from a pipeline-sharded checkpoint, a
JAX-written pp 2 checkpoint restored by the port, and the remat table and
elastic plans at sp and pp meshes against JAX's.

* The tiny model (fp32 compute) at ``--pp 2`` with the sharded engine (each
  stage writes its layers), its step-2 checkpoint resumed at pp 1 (``--dp
  2``) with ``--elastic-resume on``; at pp 1 (``--dp 2``) with the vanilla
  engine, its step-2 file resumed at ``--pp 2``; at ``--sp 2`` (vanilla),
  its step-2 file resumed at sp 1 (``--dp 2``); at ``--pp 2`` 1f1b with the
  zerostall engine (host 0 writes the stages' layers gathered whole), its
  step-2 manifest resumed at pp 1. Steps 3-4 of each resume
  within ``RESUME_RTOL`` (1e-5) of the straight run's, one
  ``elastic_resume`` event, and ``sampler_rescaled`` from the saved data x
  fsdp to the live one. The pp 2, sp 2 and dp 2 straight runs train the
  same run within 1e-5.
* ``load_serving_params`` serves the pp 2 sharded checkpoint equal to the
  vanilla reader of the same state, tensor for tensor.
* JAX's step on ``MeshConfig(data=1, pipeline=2)``, its state after 2 steps
  saved by JAX's vanilla writer and restored by the port's 2 stages (each
  takes its layers), then steps 3-4 against JAX's own within 1e-4.
* remat ``auto``'s byte table at sp and pp meshes, composed ones too, and
  the elastic plans pp 2 -> 1, 1 -> 2, sp 2 -> 1, pp 2 x dp 2 -> pp 4 and
  between composed and single-axis topologies, equal JAX's.

``python tests/test_torch_sp_pp_resume.py drift`` prints the bf16 drift of
sp 2 and of each pipeline schedule against one process that
``chip_smoke.py``'s SP and PP limits are set from.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import spawn as _spawn
from test_torch_fsdp_tp import _topo, load_tree, save_tree, write_batches
from test_torch_pipeline import jax_mesh_run, port_model_and_step
from test_torch_wire import (
    BATCH,
    LOSS_RTOL,
    SEQ,
    STEPS,
    VOCAB,
    _load_batches,
    _to_torch,
    assert_close_by_share,
    jax_batches,
)

RESUME_RTOL = 1e-5
EVAL = ["--eval-frequency", "2", "--eval-samples", "8"]
TINY = ["--device", "cpu", "--sequence-length", str(SEQ), "--batch-size", str(BATCH),
        "--training-samples", "32", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", str(VOCAB),
        "--training-steps", "4", "--learning-rate", "1e-3", "--lr-warmup-steps", "2",
        "--logging-frequency", "1", "--log-loss-to-csv", "--telemetry", "--model-dtype", "fp32"]


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def events(d, name, kind):
    path = Path(d) / name / f"{name}_telemetry.jsonl"
    return [e for e in map(json.loads, path.read_text().splitlines()) if e["event"] == kind]


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    """pp 2 (sharded), dp 2 (vanilla) and sp 2 (vanilla) straight, then
    each one's step 2 resumed at the other topology, in one process pair."""
    d = tmp_path_factory.mktemp("sp_pp_resume")
    plan = [
        ("pp2", ["--pp", "2", "--checkpoint-engine", "sharded", "--checkpoint-frequency", "2",
                 *EVAL]),
        ("pp1", ["--dp", "2", "--checkpoint-frequency", "2", *EVAL]),
        ("sp2", ["--sp", "2", "--checkpoint-frequency", "2", *EVAL]),
        ("pp2zs", ["--pp", "2", "--pp-schedule", "1f1b", "--checkpoint-engine", "zerostall",
                   "--checkpoint-frequency", "2"]),
        ("pp1l4", ["--dp", "2", "--model-layers", "4", "--checkpoint-frequency", "0", *EVAL]),
        ("pi2", ["--pp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4",
                 "--pp-virtual-stages", "2", "--model-layers", "4", "--checkpoint-frequency",
                 "0", *EVAL]),
        ("pp2_to_pp1", ["--dp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "pp2" / "ckpt_2")]),
        ("pp1_to_pp2", ["--pp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "pp1" / "ckpt_2.ckpt")]),
        ("sp2_to_sp1", ["--dp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "sp2" / "ckpt_2.ckpt")]),
        ("pp2zs_to_pp1", ["--dp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                          "--checkpoint-engine", "zerostall", "--resume-from-checkpoint",
                          str(d / "pp2zs" / "ckpt_2.zs.json")]),
    ]
    return d, spawn("plan", {"dir": str(d), "plan": plan}, world=2, timeout=240)


@pytest.mark.parametrize("saved,target,axis,replicas", [
    ("pp2", "pp1", "pipeline", (1, 2)), ("pp1", "pp2", "pipeline", (2, 1)),
    ("sp2", "sp1", "sequence", (1, 2)), ("pp2zs", "pp1", "pipeline", (1, 2))])
def test_checkpoint_resumes_across_topologies(resumes, saved, target, axis, replicas):
    d, outs = resumes
    straight = outs[0][saved]["losses"]
    name = f"{saved}_to_{target}"
    for out in outs:
        resumed = out[name]
        assert resumed["start_step"] == 2 and rel(resumed["losses"], straight[2:]) <= RESUME_RTOL
    (e,) = events(d, name, "elastic_resume")
    saved_n = 2 if "2" in saved else 1
    assert e["saved_topology"]["mesh"][axis] == saved_n
    assert e["target_topology"]["mesh"][axis] == 3 - saved_n
    assert [(r["saved_replicas"], r["target_replicas"])
            for r in events(d, name, "sampler_rescaled")] == [replicas]


def test_sp_pp_and_dp_train_the_same_run(resumes):
    """pp 2, sp 2 and dp 2 (the straight runs) within 1e-5 of each other,
    their evals too (the pipeline's forward alone, a sequence rank's
    columns), and interleaved pp 2 at V 2 within 1e-5 of dp 2 at its 4
    layers, its evals through the chunks in their logical order; each
    stage of the sharded pp 2 checkpoint wrote its own layer."""
    import torch.distributed.checkpoint as dcp

    d, outs = resumes
    pairs = [("pp2", "pp1"), ("sp2", "pp1"), ("pp2zs", "pp1"), ("pi2", "pp1l4")]
    for name, ref in pairs:
        assert rel(outs[0][name]["losses"], outs[0][ref]["losses"]) <= RESUME_RTOL, name
    for name, ref in (("pp2", "pp1"), ("sp2", "pp1"), ("pi2", "pp1l4")):
        for out in outs:
            got, want = out[name]["evals"], outs[0][ref]["evals"]
            assert [e["step"] for e in got] == [e["step"] for e in want] == [2, 4]
            assert rel([e["loss"] for e in got], [e["loss"] for e in want]) <= RESUME_RTOL, name
    keys = set(dcp.FileSystemReader(str(d / "pp2" / "ckpt_2")).read_metadata()
               .state_dict_metadata)
    assert {".params['layers']['wq']#0", ".params['layers']['wq']#1"} <= keys


def test_pp2_sharded_checkpoint_serves_as_the_vanilla_reader(resumes):
    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded, param_digests, read_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.serving import load_serving_params
    from pyrecover_tpu_torch.train_state import state_leaves

    d, _ = resumes
    config = get_args(TINY)
    final = d / "pp2" / "ckpt_4_final"
    assert read_meta(final)["topology"]["mesh"]["pipeline"] == 2
    sharded, info = load_serving_params(final, config.model, device="cpu")
    assert info["engine"] == "sharded"
    model = Transformer(config.model)
    optimizer, _ = build_optimizer(config, model.parameters())
    leaves = state_leaves(model, optimizer)
    assert param_digests(final, leaves) == read_meta(final)["leaf_digests"]
    load_ckpt_sharded(final, leaves)
    save_ckpt_vanilla(d / "pp2_as_vanilla.ckpt", leaves)
    vanilla, _ = load_serving_params(d / "pp2_as_vanilla.ckpt", config.model, device="cpu")
    for (name, a), (_, b) in zip(sharded.named_parameters(), vanilla.named_parameters()):
        assert torch.equal(a, b), name


def test_jax_pp2_checkpoint_restores_and_continues(tmp_path, devices8):
    import jax

    from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu.train_state import make_train_step
    from test_torch_pipeline import jax_config

    mesh_kw = dict(data=1, pipeline=2)
    batches = jax_batches(STEPS)
    jm, init, jparams = jax_mesh_run(batches, mesh_kw, {})
    # JAX's state after 2 steps, written by JAX's vanilla writer
    jcfg = jax_config({})
    tx, _ = build_optimizer(jcfg)
    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:2])
    state = init_sharded_state(jax.random.key(0), jcfg.model, tx, mesh)
    step = make_train_step(jcfg.model, tx, donate=False)
    with jax.sharding.set_mesh(mesh):
        for batch in batches[:2]:
            state, _ = step(state, batch)
    save_ckpt_vanilla(tmp_path / "jax_ckpt_2.ckpt", state, {"consumed": 2})
    save_tree(tmp_path / "init.npz", init)
    write_batches(tmp_path, batches)
    outs = spawn("resume_jax", {"dir": str(tmp_path), "mesh": mesh_kw}, world=2, timeout=240)
    for out in outs:
        assert out["step"] == 2
        for a, b in zip(out["metrics"], jm[2:]):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
    assert_close_by_share(jax.tree_util.tree_leaves(load_tree(tmp_path / "resumed.npz")),
                          jax.tree_util.tree_leaves(jparams), "resumed params")


# ---- the remat table and the elastic plans ------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "llama-1b"])
@pytest.mark.parametrize("mesh_kw", [dict(sequence=2), dict(data=2, sequence=2),
                                     dict(tensor=2, sequence=2), dict(pipeline=2),
                                     dict(data=2, pipeline=4), dict(pipeline=2, tensor=2),
                                     dict(pipeline=2, fsdp=2), dict(pipeline=2, data=2),
                                     dict(pipeline=2, sequence=2),
                                     dict(pipeline=2, tensor=2, fsdp=2)],
                         ids=["sp2", "dp2-sp2", "tp2-sp2", "pp2", "dp2-pp4", "pp2-tp2",
                              "pp2-fsdp2", "pp2-dp2", "pp2-sp2", "pp2-tp2-fsdp2"])
def test_remat_auto_table_matches_jax(preset, mesh_kw):
    import dataclasses

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.presets import PRESETS
    from pyrecover_tpu.utils import remat as jax_remat
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.utils import remat

    jmc = JaxModelConfig().tiny(n_layers=4) if preset == "tiny" else PRESETS[preset]()
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pmc = ModelConfig(**{k: getattr(jmc, k) for k in fields if hasattr(jmc, k)})
    shape = {"data": 1, **mesh_kw}
    rows = 8 // (shape["data"] * shape.get("fsdp", 1))
    for sharding in ("none", "zero1"):
        for policy in ("none", "save-attn", "full"):
            want = jax_remat.modelled_total_bytes(
                jmc, dict(mesh_kw), batch_size=8, seq_len=jmc.max_seq_len, policy=policy,
                optimizer_sharding=sharding)
            got = remat.modelled_total_bytes(
                pmc, batch_size=rows, seq_len=jmc.max_seq_len, policy=policy,
                optimizer_sharding=sharding, **shape)
            assert got == want, (sharding, policy)


TOPOLOGIES = {"dp1": _topo(1), "dp2": _topo(2), "pp2": _topo(2, pipeline=2),
              "sp2": _topo(2, sequence=2), "dp2-pp2": _topo(4, pipeline=2),
              "pp4": _topo(4, pipeline=4), "dp4": _topo(4),
              "pp2-tp2": _topo(4, pipeline=2, tensor=2),
              "pp2-fsdp2": _topo(4, pipeline=2, fsdp=2), "tp2-dp2": _topo(4, tensor=2),
              "fsdp2-dp2": _topo(4, fsdp=2), "sp2-dp2": _topo(4, sequence=2)}


@pytest.mark.parametrize("saved,target", [("pp2", "dp2"), ("dp2", "pp2"), ("sp2", "dp2"),
                                          ("dp2-pp2", "pp4"), ("pp2", "dp1"),
                                          ("pp2-tp2", "dp4"), ("pp2-tp2", "tp2-dp2"),
                                          ("pp2-fsdp2", "fsdp2-dp2"), ("sp2-dp2", "dp4"),
                                          ("dp4", "pp2-tp2"), ("dp2-pp2", "pp2-fsdp2")])
def test_elastic_plan_matches_jax(saved, target):
    """The port's plan over a manifest of the tiny model's state (its leaves'
    rules as specs) equals JAX's, leaf for leaf, between pipeline, sequence
    and data topologies."""
    from pyrecover_tpu.checkpoint import elastic as jax_elastic
    from pyrecover_tpu_torch.checkpoint import elastic
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.parallel.sharding import spec_for_manifest_path
    from pyrecover_tpu_torch.train_state import param_leaves

    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ, n_layers=4),
                        device="meta")
    leaves = []
    for leaf in param_leaves(model):
        for prefix in (".params", ".opt_state[1][0].mu", ".opt_state[1][0].nu"):
            path = prefix + leaf.path[len(".params"):]
            leaves.append({"path": path, "shape": list(leaf.shape), "dtype": "float32",
                           "spec": spec_for_manifest_path(path, len(leaf.shape))})
    manifest = {"leaves": leaves}
    specs = {e["path"]: e["spec"] for e in leaves}
    got = elastic.compute_reshard_plan(manifest, TOPOLOGIES[saved], TOPOLOGIES[target],
                                       target_specs=specs)
    want = jax_elastic.compute_reshard_plan(manifest, TOPOLOGIES[saved], TOPOLOGIES[target])
    for g, w in zip(got.leaves, want.leaves):
        assert (g.path, g.src_grid, g.tgt_grid, tuple(g.ops), g.reads_per_shard,
                g.moved_bytes, g.error) == (w.path, tuple(w.src_grid), tuple(w.tgt_grid),
                                            tuple(w.ops), w.reads_per_shard, w.moved_bytes,
                                            w.error)
    assert (got.resharded_leaves, got.bytes_moved, got.feasible) == (
        want.resharded_leaves, want.bytes_moved, want.feasible)


# ---- worker side -----------------------------------------------------------------------


def _plan_worker(args):
    """Every run of the plan through ``train.main`` in this process pair (the
    group joined once)."""
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    out = {}
    for name, extra in args["plan"]:
        sm = train.main(TINY + ["--distributed", "--checkpoint-dir", args["dir"],
                                "--experiment-name", name, *extra])
        out[name] = {"losses": sm["losses"], "start_step": sm["start_step"],
                     "evals": sm.get("evals")}
    mesh.destroy_distributed()
    return out


def _resume_jax_worker(args):
    from pyrecover_tpu_torch.checkpoint.vanilla import load_ckpt_vanilla
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.train_state import load_state_leaves, restore_whole, state_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    # the initial weights only shape the model: the restore overwrites them
    model, step, live = port_model_and_step(load_tree(d / "init.npz"), args["mesh"], {})
    leaves = state_leaves(model, step.optimizer)
    restore_whole(leaves, lambda whole: load_ckpt_vanilla(d / "jax_ckpt_2.ckpt", whole))
    saved_step, _, _ = load_state_leaves(leaves, step.optimizer)
    metrics = [{k: float(v) for k, v in step(_to_torch(b)).items()}
               for b in _load_batches(d)[2:]]
    tree = params_to_numpy(model)
    if mesh.rank() == 0:
        save_tree(d / "resumed.npz", tree)
    mesh.destroy_distributed()
    return {"metrics": metrics, "step": saved_step}


# ---- the bf16 drift the card's limits are set from -----------------------------------

DRIFT = ["--device", "cpu", "--sequence-length", "128", "--batch-size", "4",
         "--training-samples", "16", "--model-dim", "128", "--model-layers", "4",
         "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "256",
         "--training-steps", "4", "--learning-rate", "3e-4", "--lr-warmup-steps", "2",
         "--logging-frequency", "1", "--checkpoint-frequency", "0"]
DRIFT_LEGS = [("sp2", ["--sp", "2"]), ("sp2-packed", ["--sp", "2"]),
              ("pp2-gpipe", ["--pp", "2"]),
              ("pp2-1f1b-m4", ["--pp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4"]),
              ("pp2-v2", ["--pp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4",
                          "--pp-virtual-stages", "2"])]


def _drift_worker(args):
    """The drift legs through ``train.main`` on this rank (bf16 compute)."""
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    out = {}
    for name, extra in DRIFT_LEGS:
        sm = train.main(DRIFT + ["--distributed", "--checkpoint-dir", args["dir"],
                                 "--experiment-name", name, *extra])
        out[name] = {k: sm[k] for k in ("losses", "grad_norms")}
    mesh.destroy_distributed()
    return out


def drift_main():
    """``python tests/test_torch_sp_pp_resume.py drift``: a small model at
    bf16 compute on two gloo ranks (sp 2, and pp 2 under gpipe, 1f1b M 4
    and interleaved V 2) against one process, each step's relative loss
    difference and step 1's gradient norm (the chip check's SP and PP
    limits were set from these)."""
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # run as a script
    from pyrecover_tpu_torch import train

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        one = train.main(DRIFT + ["--checkpoint-dir", d, "--experiment-name", "one"])
        legs = spawn("drift", {"dir": d}, world=2, timeout=600)[0]

    def rels(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    out = {name: {"loss": rels(leg["losses"], one["losses"]),
                  "step1_grad_norm": rels(leg["grad_norms"][:1], one["grad_norms"][:1])[0]}
           for name, leg in legs.items()}
    print(json.dumps({"sp_pp_bf16_drift_vs_one_process": out}), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"plan": _plan_worker, "resume_jax": _resume_jax_worker, "drift": _drift_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["drift"]:
    drift_main()
