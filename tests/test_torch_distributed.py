"""The port's process groups (pyrecover_tpu_torch/parallel/mesh.py) and the
data path's per-replica view, held to the JAX package's.

* ``initialize_distributed``'s failure policy, as
  tests/test_distributed_init.py holds it for JAX: required without a
  cluster environment raises, a cluster environment whose rendezvous fails
  raises, neither is a no-op; and the checkpoint-directory guard.
* ``broadcast_host0_scalar`` / ``broadcast_host0_obj`` over gloo in real
  processes started here, with payloads of different sizes on the ranks.
* The sampler's split / merge / rescale against the JAX package's, and the
  loader's per-rank rows.
* ``launch/launch_multinode.sh`` running 2 local CPU ranks to DONE.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CLUSTER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "JOB_END_TIME",
                "SLURM_JOB_END_TIME", "PYRECOVER_PREEMPT_FILE", "PYRECOVER_FAULT_PLAN")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script, mode, args, world=2, timeout=150, rank_env=None):
    """Run ``python script worker mode json(args)`` on ``world`` gloo ranks
    (``rank_env(rank)`` adds variables); returns each rank's last stdout
    line, parsed as JSON. The other port test files start their ranks
    through it."""
    port = free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
        env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.update((rank_env or (lambda _: {}))(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), "worker", mode, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture
def no_cluster(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ---- initialize_distributed's policy -----------------------------------------


def test_required_without_cluster_env_raises(no_cluster):
    from pyrecover_tpu_torch.parallel.mesh import initialize_distributed

    with pytest.raises(RuntimeError, match="no cluster environment"):
        initialize_distributed(required=True, device_type="cpu")


@pytest.mark.parametrize("env", ["torchrun-unreachable", "torchrun-no-address", "slurm"])
def test_detected_cluster_env_failed_rendezvous_raises(no_cluster, env):
    """A cluster environment naming two processes, with nobody to meet:
    raise, never continue as one process."""
    from pyrecover_tpu_torch.parallel.mesh import initialize_distributed, is_distributed

    if env == "slurm":
        no_cluster.setenv("SLURM_NTASKS", "2")
        no_cluster.setenv("SLURM_PROCID", "0")
    else:
        no_cluster.setenv("WORLD_SIZE", "2")
        no_cluster.setenv("RANK", "0")
    if env == "torchrun-unreachable":
        no_cluster.setenv("MASTER_ADDR", "127.0.0.1")
        no_cluster.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        initialize_distributed(device_type="cpu", timeout_s=2)
    assert not is_distributed()


def test_unrequired_without_cluster_env_is_noop(no_cluster):
    from pyrecover_tpu_torch.parallel.mesh import (
        initialize_distributed,
        is_distributed,
        world_size,
    )

    assert initialize_distributed(device_type="cpu") is None
    no_cluster.setenv("WORLD_SIZE", "1")  # torchrun with one process: still one process
    assert initialize_distributed(device_type="cpu") is None
    assert not is_distributed() and world_size() == 1


def test_cluster_env_reads_torchrun_then_slurm():
    from pyrecover_tpu_torch.parallel.mesh import cluster_env, default_backend

    env = cluster_env({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
                       "MASTER_ADDR": "n0", "MASTER_PORT": "29500"})
    assert env == {"rank": 5, "world_size": 8, "local_rank": 1, "master_addr": "n0",
                   "master_port": "29500", "source": "slurm"}
    env = cluster_env({"SLURM_NTASKS": "8", "WORLD_SIZE": "4", "RANK": "3",
                       "LOCAL_RANK": "3"})
    assert (env["source"], env["rank"], env["world_size"], env["local_rank"]) == (
        "torchrun", 3, 4, 3)
    assert cluster_env({}) is None
    assert default_backend("cuda") == "cuda:nccl,cpu:gloo" and default_backend("cpu") == "gloo"


def test_local_rank_past_the_cards_raises_and_never_wraps(monkeypatch):
    """LOCAL_RANK names the card; a rank past the card count raises instead
    of sharing a card (no ``% device_count``)."""
    import torch

    from pyrecover_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.local_device("cuda", {"WORLD_SIZE": "4", "LOCAL_RANK": "1"}) == \
        torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 but this host has 2"):
        mesh.local_device("cuda", {"WORLD_SIZE": "4", "LOCAL_RANK": "3"})
    assert mesh.local_device("cpu") == torch.device("cpu")


def test_mesh_config_ports_the_data_axis_only():
    from pyrecover_tpu_torch.parallel.mesh import MeshConfig, topology

    assert MeshConfig().resolve(4) == 4 and MeshConfig(data=2).resolve(2) == 2
    with pytest.raises(ValueError, match="--dp 2 != 4 processes"):
        MeshConfig(data=2).resolve(4)
    # the fsdp, tensor and expert axes are ported (tests/test_torch_fsdp_tp.py,
    # tests/test_torch_ep.py); the data axis takes what they leave
    assert MeshConfig(fsdp=2).resolve(4) == 2 and MeshConfig(fsdp=2, tensor=2).resolve(4) == 1
    assert MeshConfig(expert=2).resolve(4) == 2
    # the sequence and pipeline axes too (tests/test_torch_ring.py,
    # tests/test_torch_pipeline.py), pipeline outermost as in JAX's order
    for axis in ("sequence", "pipeline"):
        assert MeshConfig(**{axis: 2}).resolve(4) == 2
        assert MeshConfig(**{axis: 2}).shape(4)[axis] == 2
        assert topology(MeshConfig(**{axis: 2}).shape(4))["mesh"][axis] == 2
    with pytest.raises(ValueError, match="--sp must be >= 1"):
        MeshConfig(sequence=0)
    assert topology(1) == {"devices": 1, "processes": 1, "mesh": None}
    assert topology(2)["mesh"]["data"] == 2 and topology(2)["devices"] == 2


def test_ckpt_dir_collision_guard(tmp_path):
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.train import train

    bogus = tmp_path / "ckpts"
    bogus.write_text("not a directory")
    cfg = TrainConfig(sequence_length=32, batch_size=2, training_steps=1, device="cpu",
                      checkpoint_dir=str(bogus), model=ModelConfig().tiny())
    with pytest.raises(NotADirectoryError):
        train(cfg)


# ---- the host-0 broadcasts, over gloo ------------------------------------------


def test_host0_broadcasts_over_gloo():
    """Each rank offers a payload of its own size; every rank gets host 0's,
    and the identity-in-one-process helpers agree with the two-rank ones."""
    outs = spawn(__file__, "broadcast", {})
    want_obj = {"candidates": ["ckpt_9", "ckpt_3"], "verdict": 1, "pad": "x" * 3}
    for rank, out in enumerate(outs):
        assert out["rank"] == rank and out["world"] == 2
        assert out["scalar"] == 7.5 and out["flag"] is True
        assert out["obj"] == want_obj
        assert out["none"] is None
        assert out["host"] == rank  # the telemetry stamp re-resolved after the rendezvous


def _broadcast_worker(args):
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.telemetry import bus

    bus._process_index()  # cache the pre-rendezvous stamp (0 everywhere)
    mesh.initialize_distributed(required=True, device_type="cpu")
    rank = mesh.rank()
    obj = {"candidates": ["ckpt_9", "ckpt_3"], "verdict": 1, "pad": "x" * 3} if rank == 0 \
        else {"candidates": ["other"] * 40, "verdict": 0}
    out = {
        "rank": rank, "world": mesh.world_size(),
        "scalar": mesh.broadcast_host0_scalar(7.5 if rank == 0 else -1.0),
        "flag": mesh.broadcast_host0_scalar(rank == 0),
        "obj": mesh.broadcast_host0_obj(obj),
        "none": mesh.broadcast_host0_obj(None if rank == 0 else {"x": list(range(100))}),
        "host": bus._process_index(),
    }
    mesh.sync_global_devices("done")
    mesh.destroy_distributed()
    return out


# ---- the sampler's per-replica view and the loader's rows ----------------------


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_sampler_split_merge_rescale_match_jax(replicas):
    from pyrecover_tpu.data import sampler as jax_sampler
    from pyrecover_tpu_torch.data import sampler

    s = sampler.StatefulSampler(dataset_len=50, global_batch_size=8, seed=3)
    for _ in range(9):  # into the second epoch
        s.next_batch()
    state = s.state_dict()
    views = sampler.split_sampler_state(state, replicas)
    assert views == jax_sampler.split_sampler_state(state, replicas)
    assert [v["local_rows"] for v in views] == [
        [r * 8 // replicas, (r + 1) * 8 // replicas] for r in range(replicas)]
    assert sampler.merge_sampler_states(views) == jax_sampler.merge_sampler_states(views)
    merged, again = sampler.rescale_sampler_state(state, replicas)
    assert merged == {k: state[k] for k in merged} and again == views
    assert set(merged) == set(state)


def test_sampler_rescale_refuses_what_cannot_split_or_merge():
    from pyrecover_tpu_torch.data import sampler

    state = sampler.StatefulSampler(dataset_len=64, global_batch_size=6).state_dict()
    with pytest.raises(ValueError, match="not divisible by 4 replicas"):
        sampler.rescale_sampler_state(state, 4)
    views = sampler.split_sampler_state(state, 3)
    with pytest.raises(ValueError, match="incomplete"):
        sampler.merge_sampler_states(views[:2])
    views[1] = {**views[1], "consumed_batches": 5}
    with pytest.raises(ValueError, match="diverged on progress"):
        sampler.merge_sampler_states(views)


def test_loader_collates_each_ranks_rows_of_the_global_batch():
    """Rank r of n takes rows [r*gbs/n, (r+1)*gbs/n) of every global batch;
    the ranks' batches, stacked, are the one-process batch; the sampler keeps
    counting global batches."""
    import torch

    from pyrecover_tpu_torch.data import DataLoader, StatefulSampler, SyntheticTextDataset

    ds = SyntheticTextDataset(num_samples=32, seq_len=16, vocab_size=64, seed=1)

    def batches(rank, world, n=3):
        sampler = StatefulSampler(len(ds), 4, seed=2)
        loader = DataLoader(ds, sampler, 0, device="cpu", prefetch=0, rank=rank, world_size=world)
        out = [next(loader)[1] for _ in range(n)]
        assert sampler.state_dict_at(n) == sampler.state_dict()  # global batches
        return out

    whole = batches(0, 1)
    for world in (2, 4):
        parts = [batches(r, world) for r in range(world)]
        for i, full in enumerate(whole):
            for key in full:
                torch.testing.assert_close(torch.cat([p[i][key] for p in parts]), full[key],
                                           rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by 3 data-parallel ranks"):
        DataLoader(ds, StatefulSampler(len(ds), 4), 0, device="cpu", rank=0, world_size=3)


# ---- the multi-node launcher ---------------------------------------------------


def test_multinode_launcher_runs_two_local_cpu_ranks(tmp_path):
    """launch_multinode.sh on one node with 2 processes: torch.distributed.run
    starts both ranks with --distributed, they train dp2 to DONE through
    run_resilient.sh, host 0 alone writes the checkpoints, the markers and
    the loss CSV (one row a step)."""
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
    env.update(PYTHON=sys.executable, NPROC_PER_NODE="2", NNODES="1", NODE_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), MAX_RESTARTS="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        ["bash", str(REPO / "pyrecover_tpu_torch" / "launch" / "launch_multinode.sh"),
         "--dp", "2", "--device", "cpu", "--sequence-length", "32", "--batch-size", "4",
         "--training-samples", "32", "--model-dim", "64", "--model-layers", "2",
         "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
         "--logging-frequency", "1", "--checkpoint-frequency", "2", "--training-steps", "4",
         "--checkpoint-dir", str(tmp_path), "--experiment-name", "mn", "--log-loss-to-csv",
         "--telemetry"],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "node 0 of 1, 2 process(es)" in proc.stdout
    exp = tmp_path / "mn"
    assert (exp / "DONE").exists() and not (exp / "REQUEUE").exists()
    assert sorted(p.name for p in exp.glob("ckpt_*")) == ["ckpt_2.ckpt", "ckpt_4_final.ckpt"]
    rows = (exp / "mn_loss_log.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "1", "2", "3", "4"]
    events = [json.loads(line) for line in (exp / "mn_telemetry.jsonl").read_text().splitlines()]
    start = [e for e in events if e["event"] == "run_start"]
    assert len(start) == 1 and start[0]["processes"] == 2 and start[0]["mesh"] == {"data": 2}
    assert {e["host"] for e in events} == {0}
    assert [e["status"] for e in events if e["event"] == "run_summary"] == ["finished"]


def _worker_main(mode, args):
    out = {"broadcast": _broadcast_worker}[mode](args)
    print(json.dumps(out), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker_main(sys.argv[2], json.loads(sys.argv[3]))
