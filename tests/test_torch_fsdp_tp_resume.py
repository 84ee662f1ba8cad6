"""Resumes across topologies with the fsdp and tensor axes, through the
port's ``train.main`` on gloo ranks, and a JAX-written fsdp x tensor
checkpoint restored by the port.

* fsdp 2 with the sharded engine (each rank writes its slices), its step-2
  checkpoint resumed by one process at dp 1 with ``--elastic-resume on``;
  tp 2 with the vanilla engine (host 0 writes the gathered leaves), its
  step-2 checkpoint resumed at fsdp 2. Steps 3-4 of each resume within
  ``RESUME_RTOL`` (1e-5) of the straight run's (fp32 compute),
  one ``elastic_resume`` event, and ``sampler_rescaled`` from the saved
  data x fsdp to the live one (2 -> 1, 1 -> 2). The sharded checkpoint's
  ``.params`` digests are of whole leaves: the fsdp 2 run's final ones equal
  its step-4 state read back by one process, and it serves equal to the
  vanilla reader of the same state.
* JAX's step on ``MeshConfig(data=1, fsdp=2, tensor=2)``, its state after 2
  steps saved by JAX's vanilla writer and restored by the port's 4 ranks at
  fsdp 2 x tp 2 (each takes its slices), then steps 3-4 against JAX's own
  at tests/test_torch_wire.py's tolerances.

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
from test_torch_fsdp_tp import (
    _sharded_model_and_step,
    jax_mesh_run,
    load_tree,
    save_tree,
    write_batches,
)
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
    """fsdp 2 (sharded) and tp 2 (vanilla) straight, tp 2's step 2 resumed
    at fsdp 2 in the same process pair; then fsdp 2's step 2 resumed at dp
    1 in this process."""
    from pyrecover_tpu_torch import train

    d = tmp_path_factory.mktemp("fsdp_tp_resume")
    plan = [
        ("fs2", ["--fsdp", "2", "--checkpoint-engine", "sharded", "--checkpoint-frequency", "2"]),
        ("tp2", ["--tp", "2", "--checkpoint-frequency", "2"]),
        ("tp2_to_fs2", ["--fsdp", "2", "--checkpoint-frequency", "0", "--elastic-resume", "on",
                        "--resume-from-checkpoint", str(d / "tp2" / "ckpt_2.ckpt")]),
    ]
    outs = spawn("plan", {"dir": str(d), "plan": plan}, world=2, timeout=240)
    dp1 = train.main(TINY + ["--checkpoint-dir", str(d), "--experiment-name", "fs2_to_dp1",
                             "--checkpoint-frequency", "0", "--elastic-resume", "on",
                             "--resume-from-checkpoint", str(d / "fs2" / "ckpt_2")])
    return d, outs, dp1


def test_fsdp2_sharded_checkpoint_resumes_at_dp1(resumes):
    d, outs, dp1 = resumes
    straight = outs[0]["fs2"]["losses"]
    assert dp1["start_step"] == 2 and len(dp1["losses"]) == 2
    assert rel(dp1["losses"], straight[2:]) <= RESUME_RTOL
    (e,) = events(d, "fs2_to_dp1", "elastic_resume")
    assert (e["saved_topology"]["mesh"]["fsdp"], e["target_topology"]["devices"]) == (2, 1)
    assert [(r["saved_replicas"], r["target_replicas"], r["consumed"])
            for r in events(d, "fs2_to_dp1", "sampler_rescaled")] == [(2, 1, 2)]
    # each rank wrote its own slices: keys with two-dimension boxes
    import torch.distributed.checkpoint as dcp

    keys = set(dcp.FileSystemReader(str(d / "fs2" / "ckpt_2")).read_metadata()
               .state_dict_metadata)
    assert any(k.startswith(".params['layers']['wq']#0@0:0:") for k in keys)
    assert not any(k == ".params['output']" for k in keys)


def test_sharded_digests_are_of_whole_leaves(resumes):
    """The meta's digests hash whole leaves: they equal the digests of the
    final state read back by one process into an unsharded model."""
    from pyrecover_tpu_torch.checkpoint.sharded import param_digests, read_meta
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import state_leaves

    d, _, _ = resumes
    config = get_args(TINY)
    model = Transformer(config.model, device="meta")
    optimizer, _ = build_optimizer(config, model.parameters())
    leaves = state_leaves(model, optimizer)
    final = d / "fs2" / "ckpt_4_final"
    assert param_digests(final, leaves) == read_meta(final)["leaf_digests"]
    assert read_meta(final)["topology"]["mesh"]["fsdp"] == 2


def test_tp2_vanilla_checkpoint_resumes_at_fsdp2(resumes):
    d, outs, _ = resumes
    straight = outs[0]["tp2"]["losses"]
    for out in outs:
        resumed = out["tp2_to_fs2"]
        assert resumed["start_step"] == 2 and rel(resumed["losses"], straight[2:]) <= RESUME_RTOL
    (e,) = events(d, "tp2_to_fs2", "elastic_resume")
    assert e["saved_topology"]["mesh"]["tensor"] == 2 and e["resharded_leaves"] > 0
    assert e["target_topology"]["mesh"]["fsdp"] == 2
    assert [(r["saved_replicas"], r["target_replicas"])
            for r in events(d, "tp2_to_fs2", "sampler_rescaled")] == [(1, 2)]
    # fsdp 2 and tp 2 train the same run: the straight losses agree too
    assert rel(outs[0]["fs2"]["losses"], straight) <= RESUME_RTOL


def test_model_sharded_checkpoints_serve(resumes):
    """``load_serving_params`` serves fsdp 2's sharded checkpoint (each
    rank's slices, assembled whole and held to the meta's whole-leaf
    digests) and tp 2's vanilla one; the sharded one's parameters equal the
    vanilla reader's of the same state, tensor for tensor."""
    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.serving import load_serving_params
    from pyrecover_tpu_torch.train_state import state_leaves

    d, _, _ = resumes
    config = get_args(TINY)
    sharded, info = load_serving_params(d / "fs2" / "ckpt_4_final", config.model, device="cpu")
    assert info["engine"] == "sharded" and info["checksum"] == "blake2b-leaves"
    model = Transformer(config.model)
    optimizer, _ = build_optimizer(config, model.parameters())
    leaves = state_leaves(model, optimizer)
    load_ckpt_sharded(d / "fs2" / "ckpt_4_final", leaves)
    save_ckpt_vanilla(d / "fs2_as_vanilla.ckpt", leaves)
    vanilla, _ = load_serving_params(d / "fs2_as_vanilla.ckpt", config.model, device="cpu")
    for (name, a), (_, b) in zip(sharded.named_parameters(), vanilla.named_parameters()):
        assert torch.equal(a, b), name
    _, info = load_serving_params(d / "tp2" / "ckpt_4_final.ckpt", config.model, device="cpu")
    assert info["engine"] == "vanilla"


def test_jax_fsdp2_tp2_checkpoint_restores_and_continues(tmp_path):
    import jax

    from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla

    mesh_kw = dict(data=1, fsdp=2, tensor=2)
    batches = jax_batches(STEPS)
    jm, init, jstate, states = jax_mesh_run(batches, mesh_kw)
    save_ckpt_vanilla(tmp_path / "jax_ckpt_2.ckpt", states[1], {"consumed": 2})
    save_tree(tmp_path / "init.npz", init)
    write_batches(tmp_path, batches)
    outs = spawn("resume_jax", {"dir": str(tmp_path), "mesh": mesh_kw}, world=4, timeout=240)
    for out in outs:
        assert out["step"] == 2
        for a, b in zip(out["metrics"], jm[2:]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=LOSS_RTOL)
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
        out[name] = {"losses": sm["losses"], "start_step": sm["start_step"]}
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
    model, step, live = _sharded_model_and_step(load_tree(d / "init.npz"), args["mesh"])
    leaves = state_leaves(model, step.optimizer)
    restore_whole(leaves, lambda whole: load_ckpt_vanilla(d / "jax_ckpt_2.ckpt", whole))
    saved_step, _, _ = load_state_leaves(leaves, step.optimizer)
    per = BATCH // live.batch_shards
    rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
    metrics = [{k: float(v) for k, v in step(_to_torch({k: v[rows] for k, v in b.items()}))
                .items()} for b in _load_batches(d)[2:]]
    tree = params_to_numpy(model)
    if mesh.rank() == 0:
        save_tree(d / "resumed.npz", tree)
    mesh.destroy_distributed()
    return {"metrics": metrics, "step": saved_step}


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"plan": _plan_worker, "resume_jax": _resume_jax_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
