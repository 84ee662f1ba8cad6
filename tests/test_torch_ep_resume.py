"""Resumes across expert topologies through the port's ``train.main`` on
gloo ranks, serving from an expert-sharded checkpoint, and a JAX-written
ep 2 checkpoint restored by the port.

* The tiny MoE model (4 experts, top-2, fp32 compute) at ``--ep 2`` with the
  sharded engine (each rank writes its experts' slices), its step-2
  checkpoint resumed at ep 1 (``--dp 2``) with ``--elastic-resume on``; at
  ep 1 (``--dp 2``) with the vanilla engine (host 0 writes the whole
  leaves), its step-2 file resumed at ``--ep 2``. Steps 3-4 of each resume
  within ``RESUME_RTOL`` (1e-5) of the straight run's, one
  ``elastic_resume`` event, and ``sampler_rescaled`` from the saved data x
  fsdp to the live one (1 -> 2, 2 -> 1). The ep 2 and ep 1 straight runs
  train the same run within 1e-5.
* ``load_serving_params`` serves the ep 2 sharded checkpoint (the slices
  assembled whole, held to the meta's whole-leaf digests) equal to the
  vanilla reader of the same state, tensor for tensor.
* JAX's step on ``MeshConfig(data=1, expert=2)``, its state after 2 steps
  saved by JAX's vanilla writer and restored by the port's 2 ranks at ep 2
  (each takes its experts), then steps 3-4 against JAX's own within 1e-4,
  the parameters at tests/test_torch_wire.py's policy.

``python tests/test_torch_ep_resume.py drift`` prints the bf16 drift of the
expert and model axes against one process that ``chip_smoke.py``'s EP limits
are set from.

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
from test_torch_ep import MOE, ep_model_and_step, jax_moe_mesh_run
from test_torch_fsdp_tp import load_tree, save_tree, write_batches
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
TINY = ["--device", "cpu", "--sequence-length", str(SEQ), "--batch-size", str(BATCH),
        "--training-samples", "32", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", str(VOCAB),
        "--moe-experts", str(MOE["n_experts"]), "--moe-top-k", str(MOE["moe_top_k"]),
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
    """ep 2 (sharded) and ep 1 (dp 2, vanilla) straight, then each one's
    step 2 resumed at the other, in one process pair."""
    d = tmp_path_factory.mktemp("ep_resume")
    plan = [
        ("ep2", ["--ep", "2", "--checkpoint-engine", "sharded", "--checkpoint-frequency", "2"]),
        ("ep1", ["--dp", "2", "--checkpoint-frequency", "2"]),
        ("ep2_to_ep1", ["--dp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "ep2" / "ckpt_2")]),
        ("ep1_to_ep2", ["--ep", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "ep1" / "ckpt_2.ckpt")]),
    ]
    return d, spawn("plan", {"dir": str(d), "plan": plan}, world=2, timeout=240)


def test_ep2_sharded_checkpoint_resumes_at_ep1(resumes):
    d, outs = resumes
    straight = outs[0]["ep2"]["losses"]
    for out in outs:
        resumed = out["ep2_to_ep1"]
        assert resumed["start_step"] == 2 and rel(resumed["losses"], straight[2:]) <= RESUME_RTOL
        assert all(np.isfinite(resumed["moe_aux"]))
    (e,) = events(d, "ep2_to_ep1", "elastic_resume")
    assert e["saved_topology"]["mesh"]["expert"] == 2 and e["resharded_leaves"] > 0
    assert e["target_topology"]["mesh"]["expert"] == 1
    assert [(r["saved_replicas"], r["target_replicas"], r["consumed"])
            for r in events(d, "ep2_to_ep1", "sampler_rescaled")] == [(1, 2, 2)]
    # each rank wrote its own experts: keys boxed on the expert dimension
    import torch.distributed.checkpoint as dcp

    keys = set(dcp.FileSystemReader(str(d / "ep2" / "ckpt_2")).read_metadata()
               .state_dict_metadata)
    assert {".params['layers']['moe_w1']#0@0:0:2", ".params['layers']['moe_w1']#0@0:2:4"} <= keys
    assert ".params['layers']['router']#0" in keys


def test_ep1_vanilla_checkpoint_resumes_at_ep2(resumes):
    d, outs = resumes
    straight = outs[0]["ep1"]["losses"]
    for out in outs:
        resumed = out["ep1_to_ep2"]
        assert resumed["start_step"] == 2 and rel(resumed["losses"], straight[2:]) <= RESUME_RTOL
    (e,) = events(d, "ep1_to_ep2", "elastic_resume")
    assert e["target_topology"]["mesh"]["expert"] == 2 and e["resharded_leaves"] > 0
    assert [(r["saved_replicas"], r["target_replicas"])
            for r in events(d, "ep1_to_ep2", "sampler_rescaled")] == [(2, 1)]
    # ep 2 and ep 1 train the same run, aux included
    assert rel(outs[0]["ep2"]["losses"], straight) <= RESUME_RTOL
    assert rel(outs[0]["ep2"]["moe_aux"], outs[0]["ep1"]["moe_aux"]) <= RESUME_RTOL


def test_ep2_sharded_checkpoint_serves_as_the_vanilla_reader(resumes):
    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded, param_digests, read_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.serving import load_serving_params
    from pyrecover_tpu_torch.train_state import state_leaves

    d, _ = resumes
    config = get_args(TINY)
    final = d / "ep2" / "ckpt_4_final"
    assert read_meta(final)["topology"]["mesh"]["expert"] == 2
    sharded, info = load_serving_params(final, config.model, device="cpu")
    assert info["engine"] == "sharded" and info["checksum"] == "blake2b-leaves"
    model = Transformer(config.model)
    optimizer, _ = build_optimizer(config, model.parameters())
    leaves = state_leaves(model, optimizer)
    assert param_digests(final, leaves) == read_meta(final)["leaf_digests"]
    load_ckpt_sharded(final, leaves)
    save_ckpt_vanilla(d / "ep2_as_vanilla.ckpt", leaves)
    vanilla, _ = load_serving_params(d / "ep2_as_vanilla.ckpt", config.model, device="cpu")
    for (name, a), (_, b) in zip(sharded.named_parameters(), vanilla.named_parameters()):
        assert torch.equal(a, b), name


def test_jax_ep2_checkpoint_restores_and_continues(tmp_path):
    import jax

    from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla

    mesh_kw = dict(data=1, expert=2)
    batches = jax_batches(STEPS)
    jm, init, jstate, states = jax_moe_mesh_run(batches, mesh_kw)
    save_ckpt_vanilla(tmp_path / "jax_ckpt_2.ckpt", states[1], {"consumed": 2})
    save_tree(tmp_path / "init.npz", init)
    write_batches(tmp_path, batches)
    outs = spawn("resume_jax", {"dir": str(tmp_path), "mesh": mesh_kw}, world=2, timeout=240)
    for out in outs:
        assert out["step"] == 2 and out["experts"] == MOE["n_experts"] // 2
        for a, b in zip(out["metrics"], jm[2:]):
            for key in ("loss", "grad_norm", "moe_aux"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
    assert_close_by_share(jax.tree_util.tree_leaves(load_tree(tmp_path / "resumed.npz")),
                          jax.tree_util.tree_leaves(jstate.params), "resumed params")


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
        out[name] = {"losses": sm["losses"], "moe_aux": sm["moe_aux"],
                     "start_step": sm["start_step"]}
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
    model, step, live = ep_model_and_step(load_tree(d / "init.npz"), args["mesh"])
    leaves = state_leaves(model, step.optimizer)
    restore_whole(leaves, lambda whole: load_ckpt_vanilla(d / "jax_ckpt_2.ckpt", whole))
    saved_step, _, _ = load_state_leaves(leaves, step.optimizer)
    per = BATCH // live.batch_shards
    rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
    metrics = [{k: float(v) for k, v in step(_to_torch({k: v[rows] for k, v in b.items()}))
                .items()} for b in _load_batches(d)[2:]]
    experts = int(model.layers[0].moe_w1.shape[0])
    tree = params_to_numpy(model)
    if mesh.rank() == 0:
        save_tree(d / "resumed.npz", tree)
    mesh.destroy_distributed()
    return {"metrics": metrics, "step": saved_step, "experts": experts}


# ---- the bf16 drift the card's limits are set from -----------------------------------

DRIFT = ["--device", "cpu", "--sequence-length", "64", "--batch-size", "4",
         "--training-samples", "16", "--model-dim", "128", "--model-layers", "2",
         "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "256",
         "--moe-experts", "4", "--moe-top-k", "2", "--training-steps", "4",
         "--learning-rate", "3e-4", "--lr-warmup-steps", "2", "--logging-frequency", "1",
         "--checkpoint-frequency", "0"]
DRIFT_LEGS = [("ep2-grouped", ["--ep", "2"], "grouped"), ("ep2-auto", ["--ep", "2"], None),
              ("fsdp2", ["--fsdp", "2"], None), ("tp2", ["--tp", "2"], None)]


def _drift_worker(args):
    """The drift legs through ``train.main`` on this rank (bf16 compute), the
    dispatch set in code where a leg names one."""
    import dataclasses

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    out, build = {}, train.build_model
    for name, extra, dispatch in DRIFT_LEGS:
        def with_dispatch(config, device, dispatch=dispatch):
            model = dataclasses.replace(config.model, moe_dispatch=dispatch or "auto")
            return build(dataclasses.replace(config, model=model), device)

        train.build_model = with_dispatch
        sm = train.main(DRIFT + ["--distributed", "--checkpoint-dir", args["dir"],
                                 "--experiment-name", name, *extra])
        out[name] = {k: sm[k] for k in ("losses", "moe_aux", "grad_norms")}
    train.build_model = build
    mesh.destroy_distributed()
    return out


def drift_main():
    """``python tests/test_torch_ep_resume.py drift``: a small MoE at bf16
    compute on two gloo ranks (ep 2 grouped and ``auto``, fsdp 2, tp 2)
    against one process, each step's relative loss and aux difference and
    step 1's gradient norm (the chip check's EP limits are set a few times
    above these)."""
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
                  "aux": rels(leg["moe_aux"], one["moe_aux"]),
                  "step1_grad_norm": rels(leg["grad_norms"][:1], one["grad_norms"][:1])[0]}
           for name, leg in legs.items()}
    print(json.dumps({"ep_bf16_drift_vs_one_process": out}), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"plan": _plan_worker, "resume_jax": _resume_jax_worker, "drift": _drift_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["drift"]:
    drift_main()
