"""The port's sharded checkpoint engine (checkpoint/sharded.py, on
torch.distributed.checkpoint) and the trainer's data-parallel saves and
resumes across both engines, on the CPU with gloo.

* a DCP round trip of the whole training state in one process and in two
  (each rank writing its share), bit for bit;
* an asynchronous save overlapped by an optimizer step, then ``wait``: the
  checkpoint holds the state at the save, not the step's update;
* A = B1 + B2 at dp2: a straight 4-step run, a run stopped at step 2 by
  host 0's deadline and its ``latest`` resume end with bit-equal
  ``.params`` digests and loss CSVs;
* a dp2 checkpoint (sharded and vanilla) resumed at dp1, with
  ``sampler_rescaled``, the same consumed position and steps 3-4 within
  1e-5 of the dp2 run's; the vanilla file's paths stay the JAX package's
  (no ``module.``) and the JAX reader opens it;
* the pre-check catches a truncated shard, and resume falls back and
  quarantines it; retention is scoped by engine; the ``.params`` digests
  verify and catch a flipped byte; the fault seams fire and their
  transient errors are retried.

Worker processes run this file as a script (``python tests/... worker``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import CLUSTER_VARS, spawn as _spawn
from pyrecover_tpu_torch.checkpoint.elastic import TopologyMismatchError

REPO = Path(__file__).resolve().parent.parent
TRAIN_FLAGS = ["--device", "cpu", "--sequence-length", "32", "--batch-size", "4",
               "--training-samples", "32", "--model-dim", "64", "--model-layers", "2",
               "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
               "--model-dtype", "fp32", "--learning-rate", "1e-3", "--logging-frequency", "1",
               "--log-loss-to-csv", "--telemetry", "--training-steps", "4",
               "--checkpoint-frequency", "2", "--max-kept-checkpoints", "3"]


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


def train_argv(ckpt_dir, name, *extra):
    return TRAIN_FLAGS + ["--checkpoint-dir", str(ckpt_dir), "--experiment-name", name, *extra]


def events(exp, name=None):
    path = exp / f"{exp.name}_telemetry.jsonl"
    evs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [e for e in evs if name is None or e["event"] == name]


def losses(exp):
    rows = (exp / f"{exp.name}_loss_log.csv").read_text().splitlines()[1:]
    return {int(r.split(",")[0]): float(r.split(",")[1]) for r in rows}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from pyrecover_tpu_torch import telemetry
    from pyrecover_tpu_torch.resilience import faults

    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYRECOVER_IO_RETRIES", "5")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    telemetry.close()
    yield
    faults.clear()
    telemetry.close()
    telemetry.flight.uninstall()
    torch.set_num_threads(threads)


# ---- the engine alone ----------------------------------------------------------


def tiny_state(seed, steps=1):
    """A tiny model and its optimizer after ``steps`` updates, with the
    state's leaves."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import make_train_step, rng_key, state_leaves

    cfg = TrainConfig(model=ModelConfig().tiny(), sequence_length=16, batch_size=2,
                      model_dtype="fp32", device="cpu", learning_rate=1e-2)
    model = Transformer(cfg.model, generator=torch.Generator().manual_seed(seed))
    opt, _ = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt)
    g = torch.Generator().manual_seed(seed)
    batch = {"inputs": torch.randint(0, 256, (2, 16), generator=g),
             "labels": torch.randint(0, 256, (2, 16), generator=g)}
    for _ in range(steps):
        step(batch)
    return model, opt, step, batch, state_leaves(model, opt, step=steps, epoch=0,
                                                 rng=rng_key(seed))


def leaf_bytes(leaves):
    out = {}
    for leaf in leaves:
        parts = [p.detach().clone() if isinstance(p, torch.Tensor) else np.array(p)
                 for p in leaf.parts]
        out[leaf.path] = parts
    return out


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), k
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_round_trip_in_one_process(tmp_path):
    from pyrecover_tpu_torch.checkpoint.sharded import (
        load_ckpt_sharded,
        precheck_ckpt_sharded,
        read_meta,
        save_ckpt_sharded,
        verify_param_digests,
    )
    from pyrecover_tpu_torch.train_state import load_state_leaves

    _, _, _, _, leaves = tiny_state(0, steps=2)
    want = leaf_bytes(leaves)
    path = tmp_path / "ckpt_2"
    save_ckpt_sharded(path, leaves, {"consumed": 2, "replicas": 1}, extra_meta={"step": 2})
    assert (path / ".metadata").exists() and not list(tmp_path.glob(".*partial"))
    assert precheck_ckpt_sharded(path, target=leaves) == (True, "")
    meta = read_meta(path)
    assert meta["step"] == 2 and meta["sampler"]["replicas"] == 1
    assert set(meta["leaf_digests"]) == {leaf.path for leaf in leaves
                                         if leaf.path.startswith(".params")}
    assert verify_param_digests(path, leaves)
    _, opt, _, _, target = tiny_state(1, steps=1)  # other weights, other counts
    load_ckpt_sharded(path, target, verify=True)
    assert_same(leaf_bytes(target), want)
    assert load_state_leaves(target, opt)[0] == 2 and opt.count == 2


def test_round_trip_in_two_processes(tmp_path):
    outs = spawn("roundtrip", {"dir": str(tmp_path)})
    assert all(o["equal"] for o in outs)
    files = sorted(p.name for p in (tmp_path / "ckpt_3").iterdir())
    # every rank wrote a share: nothing was gathered onto rank 0
    assert any(f.startswith("__0_") for f in files) and any(f.startswith("__1_") for f in files)
    assert outs[0]["digests"] == outs[1]["digests"]


def test_async_save_overlapped_by_a_step_holds_the_saved_state(tmp_path):
    from pyrecover_tpu_torch.checkpoint.sharded import ShardedCheckpointer, load_ckpt_sharded

    model, _, step, batch, leaves = tiny_state(2)
    want = leaf_bytes(leaves)
    with ShardedCheckpointer(use_async=True) as ckptr:
        handle = ckptr.save(tmp_path / "ckpt_1", leaves, {"consumed": 1})
        step(batch)  # updates every parameter and moment in place
        assert not torch.equal(model.output.detach(), want[".params['output']"][0])
        ckptr.wait()
    assert handle.done and handle.error is None and handle.bytes > 0
    _, _, _, _, target = tiny_state(3)
    load_ckpt_sharded(tmp_path / "ckpt_1", target)
    assert_same(leaf_bytes(target), want)


def test_precheck_catches_a_truncated_shard_and_digests_catch_a_flip(tmp_path):
    from pyrecover_tpu_torch.checkpoint.sharded import (
        precheck_ckpt_sharded,
        save_ckpt_sharded,
        verify_param_digests,
    )
    from pyrecover_tpu_torch.checkpoint.vanilla import CheckpointStructureError

    _, _, _, _, leaves = tiny_state(4)
    path = tmp_path / "ckpt_1"
    save_ckpt_sharded(path, leaves)
    import torch.distributed.checkpoint as dcp

    # flip a byte inside the stored output projection
    md = dcp.FileSystemReader(str(path)).read_metadata()
    info = next(v for k, v in md.storage_data.items() if k.fqn == ".params['output']")
    shard = path / info.relative_path
    data = bytearray(shard.read_bytes())
    data[info.offset + info.length // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    assert precheck_ckpt_sharded(path, target=leaves) == (True, "")  # a structural check
    assert not verify_param_digests(path, leaves)
    assert precheck_ckpt_sharded(path, verify=True, target=leaves) == (
        False, "params digest mismatch")
    shard.write_bytes(bytes(data[:len(data) // 3]))
    ok, why = precheck_ckpt_sharded(path, target=leaves)
    assert not ok and "truncated shard file" in why
    assert precheck_ckpt_sharded(tmp_path / "nothing") == (False, "not a directory")
    (tmp_path / "torn").mkdir()
    assert "missing DCP .metadata" in precheck_ckpt_sharded(tmp_path / "torn")[1]
    # a checkpoint of another model is a structure error, not corruption
    save_ckpt_sharded(tmp_path / "ckpt_2", leaves)
    from pyrecover_tpu_torch.checkpoint.vanilla import Leaf

    other = leaves[:-1] + [Leaf(".rng", (3,), "uint32", [np.zeros(3, np.uint32)])]
    with pytest.raises(CheckpointStructureError):
        precheck_ckpt_sharded(tmp_path / "ckpt_2", target=other)


def test_retention_is_scoped_by_engine(tmp_path):
    from pyrecover_tpu_torch.checkpoint.registry import (
        checkpoint_path,
        engine_of,
        get_latest_checkpoint,
        list_checkpoints,
    )
    from pyrecover_tpu_torch.checkpoint.sharded import ShardedCheckpointer
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla

    _, _, _, _, leaves = tiny_state(5)
    for step in (1, 5):
        save_ckpt_vanilla(checkpoint_path(tmp_path, "e", step), leaves)
    with ShardedCheckpointer(use_async=True) as ckptr:
        for step in (2, 3, 4):
            ckptr.save(checkpoint_path(tmp_path, "e", step, engine="sharded"), leaves,
                       max_keep=2)
    exp = tmp_path / "e"
    assert [p.name for p in list_checkpoints(exp, engine="sharded")] == ["ckpt_3", "ckpt_4"]
    assert [p.name for p in list_checkpoints(exp, engine="vanilla")] == [
        "ckpt_1.ckpt", "ckpt_5.ckpt"]
    assert get_latest_checkpoint(exp).name == "ckpt_5.ckpt"
    assert get_latest_checkpoint(exp, engine="sharded").name == "ckpt_4"
    assert engine_of(exp / "ckpt_4") == "sharded" and engine_of(exp / "ckpt_5.ckpt") == "vanilla"
    assert checkpoint_path(tmp_path, "e", 1, engine="zerostall").name == "ckpt_1.zs.json"
    with pytest.raises(ValueError, match="unknown checkpoint engine"):
        checkpoint_path(tmp_path, "e", 1, engine="orbax")


SITE_PLANS = {
    "ckpt_write": {"type": "transient_io_error", "op": "write", "fail_count": 2},
    "ckpt_rename": {"type": "transient_io_error", "op": "rename", "fail_count": 1},
    "ckpt_read": {"type": "transient_io_error", "op": "read", "fail_count": 2},
}


@pytest.mark.parametrize("site", list(SITE_PLANS))
def test_fault_seams_fire_and_transient_errors_are_retried(tmp_path, site):
    from pyrecover_tpu_torch import telemetry
    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded, save_ckpt_sharded
    from pyrecover_tpu_torch.resilience import faults

    _, _, _, _, leaves = tiny_state(6)
    want = leaf_bytes(leaves)
    if site == "ckpt_read":
        save_ckpt_sharded(tmp_path / "ckpt_1", leaves)
    sink = telemetry.add_sink(telemetry.MemorySink())
    faults.install({"faults": [SITE_PLANS[site]]})
    if site != "ckpt_read":
        save_ckpt_sharded(tmp_path / "ckpt_1", leaves)
    _, _, _, _, target = tiny_state(7)
    load_ckpt_sharded(tmp_path / "ckpt_1", target)
    assert_same(leaf_bytes(target), want)
    names = [e["event"] for e in sink.events]
    assert {e["site"] for e in sink.events if e["event"] == "fault_injected"} == {site}
    assert names.count("ckpt_io_retry") == SITE_PLANS[site]["fail_count"]
    assert "ckpt_commit" in names or site == "ckpt_read"
    assert {"ckpt_restore_start", "ckpt_restore_done"} <= set(names)


def test_save_begin_counts_sharded_saves_for_save_indexed_faults(tmp_path):
    from pyrecover_tpu_torch.checkpoint.sharded import save_ckpt_sharded
    from pyrecover_tpu_torch.resilience import faults

    _, _, _, _, leaves = tiny_state(8)
    faults.install({"faults": [{"type": "corrupt_ckpt_bytes", "save_index": 2}]})
    save_ckpt_sharded(tmp_path / "ckpt_1", leaves)
    save_ckpt_sharded(tmp_path / "ckpt_2", leaves)
    assert faults.active().save_index == 2  # a directory is not the vanilla file it corrupts


# ---- the trainer at dp2 ---------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A (4 steps straight), B1 (stopped at step 2 by host 0's deadline) and
    B2 (its `latest` resume), each at dp2 with the sharded engine; and V2,
    dp2 with the vanilla engine."""
    root = tmp_path_factory.mktemp("dp2runs")
    base = ["--distributed", "--dp", "2", "--checkpoint-engine", "sharded"]
    spawn("main", {"argv": train_argv(root, "a", *base)})
    spawn("main", {"argv": train_argv(root, "b", *base, "--timeaware-checkpointing",
                                      "--job-end-time", "1000",
                                      "--preempt-check-interval", "2")})
    spawn("main", {"argv": train_argv(root, "b", *base, "--resume-from-checkpoint", "latest")})
    spawn("main", {"argv": train_argv(root, "v", "--distributed", "--dp", "2")})
    return root


def test_a_equals_b1_plus_b2_at_dp2(runs):
    from pyrecover_tpu_torch.checkpoint.sharded import read_meta

    a, b = runs / "a", runs / "b"
    assert (a / "DONE").exists() and (b / "DONE").exists() and not (b / "REQUEUE").exists()
    stops = [e for e in events(b, "preempt_stop")]
    assert [e["step"] for e in stops] == [2] and {e["host"] for e in stops} == {0}
    assert [e["step"] for e in events(b, "resume")] == [2]
    final_a, final_b = read_meta(a / "ckpt_4_final"), read_meta(b / "ckpt_4_final")
    assert final_a["leaf_digests"] == final_b["leaf_digests"]
    assert final_a["sampler"] == final_b["sampler"] and final_a["sampler"]["replicas"] == 2
    assert losses(a) == losses(b) and sorted(losses(a)) == [1, 2, 3, 4]
    assert final_a["topology"]["mesh"]["data"] == 2


@pytest.mark.parametrize("engine", ["sharded", "vanilla"])
def test_a_dp2_checkpoint_resumes_at_dp1(runs, tmp_path, engine):
    """One process resumes the dp2 run's step-2 checkpoint (DCP reshards the
    sharded one onto one rank); the sampler is rescaled from 2 replicas to
    1 at the same consumed position, and steps 3-4 follow the dp2 run's
    losses (1e-5: only the order of the sums differs)."""
    from pyrecover_tpu_torch import train

    src = runs / ("a" if engine == "sharded" else "v")
    ckpt = src / ("ckpt_2" if engine == "sharded" else "ckpt_2.ckpt")
    out = train.main(train_argv(tmp_path, "one", "--resume-from-checkpoint", str(ckpt)))
    exp = tmp_path / "one"
    assert out["start_step"] == 2 and out["end_step"] == 4
    [rescaled] = events(exp, "sampler_rescaled")
    assert (rescaled["saved_replicas"], rescaled["target_replicas"], rescaled["consumed"]) == (
        2, 1, 2)
    got, want = losses(exp), losses(src)
    assert sorted(got) == [3, 4]
    for step in (3, 4):
        np.testing.assert_allclose(got[step], want[step], rtol=1e-5)
    with pytest.raises(TopologyMismatchError, match="was saved on 2 devices"):
        train.main(train_argv(tmp_path, "off", "--resume-from-checkpoint", str(ckpt),
                              "--elastic-resume", "off"))


def test_the_dp2_vanilla_file_is_host0s_and_the_jax_packages(runs):
    """Host 0 alone wrote the vanilla files; their manifest paths are the
    JAX TrainState's (no DDP ``module.`` prefix), and the JAX package's
    reader opens them."""
    from pyrecover_tpu.checkpoint.vanilla import read_ckpt_meta as jax_read_meta

    from pyrecover_tpu_torch.checkpoint.vanilla import read_ckpt_meta

    exp = runs / "v"
    assert sorted(p.name for p in exp.glob("ckpt_*")) == ["ckpt_2.ckpt", "ckpt_4_final.ckpt"]
    meta = read_ckpt_meta(exp / "ckpt_4_final.ckpt")
    assert jax_read_meta(exp / "ckpt_4_final.ckpt")["paths"] == meta["paths"]
    assert not [p for p in meta["paths"] if "module" in p]
    assert meta["paths"][0] == ".params['final_norm']" and meta["sampler"]["replicas"] == 2
    assert {e["host"] for e in events(exp)} == {0}
    assert len([e for e in events(exp, "ckpt_commit")]) == 2


def test_resume_falls_back_past_a_truncated_shard_and_quarantines_it(runs, tmp_path):
    """`latest` pre-checks the newest sharded checkpoint, finds a truncated
    shard, moves it into .corrupt/ and resumes from the one before."""
    import shutil

    from pyrecover_tpu_torch import train

    exp = tmp_path / "a"
    shutil.copytree(runs / "a", exp)
    (exp / "DONE").unlink()
    shard = next((exp / "ckpt_4_final").glob("__1_*.distcp"))
    shard.write_bytes(shard.read_bytes()[:100])
    out = train.main(train_argv(tmp_path, "a", "--resume-from-checkpoint", "latest",
                                "--dp", "1", "--checkpoint-engine", "sharded",
                                "--training-steps", "5"))
    assert out["start_step"] == 2 and out["end_step"] == 5
    failed = events(exp, "ckpt_precheck_failed")
    assert len(failed) == 1 and "truncated shard file" in failed[0]["reason"]
    assert (exp / ".corrupt" / "ckpt_4_final").is_dir()


# ---- worker side ---------------------------------------------------------------


def _roundtrip_worker(args):
    from pyrecover_tpu_torch.checkpoint.sharded import (
        ShardedCheckpointer,
        param_digests,
        read_meta,
    )
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    _, _, _, _, leaves = tiny_state(0, steps=3)
    want = leaf_bytes(leaves)
    path = Path(args["dir"]) / "ckpt_3"
    with ShardedCheckpointer(use_async=False) as ckptr:
        ckptr.save(path, leaves, {"consumed": 3, "replicas": 2})
        mesh.sync_global_devices("published")
        _, _, _, _, target = tiny_state(9, steps=1)
        ckptr.restore(path, target, verify=True)
    got = leaf_bytes(target)
    equal = True
    try:
        assert_same(got, want)
    except AssertionError:
        equal = False
    out = {"equal": equal, "digests": read_meta(path)["leaf_digests"]}
    assert param_digests(path, target) == out["digests"]
    mesh.destroy_distributed()
    return out


def _main_worker(args):
    from pyrecover_tpu_torch import train

    out = train.main(args["argv"])
    return {"end_step": out["end_step"], "stopped_early": out["stopped_early"]}


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    mode, worker_args = sys.argv[2], json.loads(sys.argv[3])
    result = {"roundtrip": _roundtrip_worker, "main": _main_worker}[mode](worker_args)
    print(json.dumps(result), flush=True)
