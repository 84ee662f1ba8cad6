"""ZeRO-1 in the port (``--optimizer-sharding zero1``: ``optim.py``,
``parallel/sharding.py``, the state bridge and the engines), held to the
JAX package's.

* ``zero1_leaf_spec`` and ``live_target_specs`` against JAX's for the same
  shapes (the moments data-sharded where the data width divides them, the
  int8 residual's rows on the data axis); remat ``auto``'s table at dp 2
  under zero1 and int8 against JAX's SC05 rows.
* The dp2 step at zero1 fp32 and zero1 + int8 against JAX's dp2 step over 4
  steps, at tests/test_torch_wire.py's tolerances; and, bit for bit inside
  the port: zero1 fp32 = none, zero1 + int8 = int8, two fp32 bucket caps.
  Each rank holds half of every moment leaf.
* Flag flips across a resume, through ``train.main`` on 2 gloo ranks, on the
  vanilla and sharded engines: zero1 -> none and none -> zero1 continue
  bit-equal to the straight run, an fp32 bucket-cap change too; int8 +
  buckets -> int8 restores the residual and continues within the int8
  policy; int8 -> fp32 drops the residual and fp32 -> int8 starts it at
  zero. The zerostall engine saves and restores a zero1 state.
* A JAX-written int8 checkpoint (dp2, with its residual) restores in the
  port and continues within the tolerance.

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
from test_torch_wire import (
    BATCH,
    LOSS_RTOL,
    SEQ,
    STEPS,
    VOCAB,
    _load_batches,
    _port_model_and_step,
    _to_torch,
    assert_close_by_share,
    jax_batches,
    jax_run,
    port_params_tree,
    write_inputs,
)


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- specs -----------------------------------------------------------------------


@pytest.mark.parametrize("rule,shape,mesh", [
    (("pipeline", "fsdp", "tensor"), (8, 64, 32), {"data": 4, "fsdp": 2, "tensor": 1,
                                                   "pipeline": 1}),
    (("pipeline", "fsdp", "tensor"), (2, 64, 32), {"data": 4, "fsdp": 2, "tensor": 1,
                                                   "pipeline": 1}),
    ((None, None), (3, 5), {"data": 4}),
    (("data", None), (8, 4), {"data": 4}),
    ((None,), (8,), {"data": 1}),
    (None, (8, 8), {"data": 4}),
    ((None, ("tensor", "fsdp")), (32768, 2048), {"data": 2}),
    (("pipeline", None), (2, 2048), {"data": 2}),
    ((None,), (2048,), {"data": 2}),
    (("pipeline", "fsdp", "tensor"), (3, 6, 8), {"data": 2}),
])
def test_zero1_leaf_spec_matches_jax(rule, shape, mesh):
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.analysis.shardcheck.manifest import spec_to_json
    from pyrecover_tpu.parallel.sharding import zero1_leaf_spec as jax_spec
    from pyrecover_tpu_torch.parallel.sharding import zero1_leaf_spec

    jrule = None if rule is None else P(*rule)
    prule = None if rule is None else [list(e) if isinstance(e, tuple) else e for e in rule]
    assert zero1_leaf_spec(prule, shape, mesh) == spec_to_json(jax_spec(jrule, shape, mesh))


def test_live_target_specs_match_jax():
    """JAX's live specs of a zero1 + int8 state on a dp2 mesh, and the port's
    for the same model: every moment leaf and the residual alike (the
    parameters the port reports replicated, which the data axis is)."""
    import jax

    from pyrecover_tpu.checkpoint.elastic import live_target_specs as jax_specs
    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu_torch.checkpoint.elastic import live_target_specs
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import OptaxAdamW
    from pyrecover_tpu_torch.parallel.collectives import padded_flat_len
    from pyrecover_tpu_torch.train_state import GradResidual, state_leaves
    from test_torch_wire import jax_config

    jcfg = jax_config(optimizer_sharding="zero1", grad_allreduce="int8")
    tx, _ = build_optimizer(jcfg)
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    want = jax_specs(init_sharded_state(jax.random.key(0), jcfg.model, tx, mesh,
                                        optimizer_sharding="zero1", grad_allreduce="int8"))
    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ))
    opt = OptaxAdamW(model.parameters(), lambda _: 1e-3, max_norm=1.0)
    opt.shard_moments(model, world=2, rank=1)
    n = sum(p.numel() for p in model.parameters())
    leaves = state_leaves(model, opt, residual=GradResidual(2, 1, padded_flat_len(n, 2), "cpu"))
    got = live_target_specs(leaves)
    compared = [p for p in got if p.startswith(".opt_state") and ("mu" in p or "nu" in p)]
    assert len(compared) == 2 * 12
    for path in compared + [".grad_residual"]:
        assert got[path] == want[path], path
    assert any("data" in json.dumps(got[p]) for p in compared)
    # each rank holds half of each moment leaf the data width divides
    for leaf in leaves:
        if leaf.shard is not None and leaf.path != ".grad_residual":
            held = sum(p.numel() for p in leaf.parts)
            assert held * 2 == int(np.prod(leaf.shape)), leaf.path


def test_reshard_plan_prices_zero1_target():
    """JAX's ``test_reshard_plan_prices_zero1_target`` on the port: a ``none``
    state saved at dp 4, resumed onto a zero1 run at dp 2: the plan from the
    live specs is feasible and regrids the data-sharded moments."""
    from pyrecover_tpu_torch.checkpoint.elastic import compute_reshard_plan, live_target_specs
    from pyrecover_tpu_torch.checkpoint.manifest import state_manifest
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import OptaxAdamW
    from pyrecover_tpu_torch.parallel.mesh import topology
    from pyrecover_tpu_torch.train_state import state_leaves

    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ))
    saved = state_manifest(state_leaves(model, OptaxAdamW(model.parameters(), lambda _: 1e-3)))
    opt = OptaxAdamW(model.parameters(), lambda _: 1e-3)
    opt.shard_moments(model, world=2, rank=0)
    plan = compute_reshard_plan(saved, topology(4), topology(2),
                                target_specs=live_target_specs(state_leaves(model, opt)))
    assert plan.feasible
    mu = [lp for lp in plan.leaves if ".mu" in lp.path]
    assert mu and any(t > 1 for lp in mu for t in lp.tgt_grid)
    assert all(t == 1 for lp in plan.leaves if lp.path.startswith(".params")
               for t in lp.tgt_grid)


@pytest.mark.parametrize("preset", ["tiny", "llama-1b"])
@pytest.mark.parametrize("sharding,wire", [("zero1", "fp32"), ("none", "int8"),
                                           ("zero1", "int8")])
def test_remat_auto_table_matches_jax_at_dp2(preset, sharding, wire):
    import dataclasses

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.presets import PRESETS
    from pyrecover_tpu.utils import remat as jax_remat
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.utils import remat

    jmc = JaxModelConfig().tiny() if preset == "tiny" else PRESETS[preset]()
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pmc = ModelConfig(**{k: getattr(jmc, k) for k in fields if hasattr(jmc, k)})
    for policy in ("none", "save-attn", "full"):
        want = jax_remat.modelled_total_bytes(
            jmc, {"data": 2}, batch_size=8, seq_len=jmc.max_seq_len, policy=policy,
            optimizer_sharding=sharding, grad_allreduce=wire)
        got = remat.modelled_total_bytes(
            pmc, batch_size=4, seq_len=jmc.max_seq_len, policy=policy, data=2,
            optimizer_sharding=sharding, grad_allreduce=wire)
        assert got == want, policy
    assert remat.resolve_remat_policy(
        pmc, batch_size=4, seq_len=jmc.max_seq_len, capacity_bytes=80 * 10**9, data=2,
        optimizer_sharding=sharding, grad_allreduce=wire).table == jax_remat.resolve_remat_policy(
        jmc, {"data": 2}, batch_size=8, seq_len=jmc.max_seq_len, device_kind="",
        optimizer_sharding=sharding, grad_allreduce=wire).table


# ---- the dp2 step ------------------------------------------------------------------

RUNS = {"none": {}, "none-buckets": dict(grad_bucket_mb=0.05),
        "zero1": dict(optimizer_sharding="zero1"), "int8": dict(grad_allreduce="int8"),
        "zero1-int8": dict(optimizer_sharding="zero1", grad_allreduce="int8")}


@pytest.fixture(scope="module")
def dp2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    batches = jax_batches(STEPS)
    jax_out = {name: jax_run(batches, **RUNS[name]) for name in ("zero1", "zero1-int8")}
    write_inputs(tmp, batches, jax_out["zero1"][1])
    outs = spawn("train", {"dir": str(tmp), "runs": RUNS}, timeout=240)
    return tmp, jax_out, outs


@pytest.mark.parametrize("name", ["zero1", "zero1-int8"])
def test_dp2_zero1_step_matches_jax(dp2_runs, name):
    import jax

    tmp, jax_out, outs = dp2_runs
    jm, _, jstate, _ = jax_out[name]
    for a, b in zip(outs[0][name]["metrics"], jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    assert_close_by_share(jax.tree_util.tree_leaves(port_params_tree(
        tmp / f"params_{name}_rank0.npz")), jax.tree_util.tree_leaves(jstate.params), name)


@pytest.mark.parametrize("a,b", [("zero1", "none"), ("zero1-int8", "int8"),
                                 ("none-buckets", "none")])
def test_port_runs_bit_equal(dp2_runs, a, b):
    tmp, _, outs = dp2_runs
    for out in outs:
        assert out[a]["metrics"] == out[b]["metrics"]
    for rank in (0, 1):
        with np.load(tmp / f"params_{a}_rank{rank}.npz") as x, \
                np.load(tmp / f"params_{b}_rank{rank}.npz") as y:
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{a} vs {b}: {k}")
    if a.startswith("zero1"):
        # half of the moments on each rank, all of them over the two
        assert outs[0][a]["moment_elems"] * 2 == outs[0][b]["moment_elems"]


# ---- checkpoints ---------------------------------------------------------------------

TINY = ["--device", "cpu", "--distributed", "--dp", "2", "--sequence-length", str(SEQ),
        "--batch-size", str(BATCH), "--training-samples", "32", "--model-dim", "64",
        "--model-layers", "2", "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size",
        str(VOCAB), "--training-steps", "4", "--checkpoint-frequency", "2",
        "--learning-rate", "1e-3", "--lr-warmup-steps", "2", "--logging-frequency", "1",
        "--log-loss-to-csv", "--telemetry"]


def _flip_plan(d, engine):
    """``[(name, extra argv)]``: straight runs, then resumes from their step-2
    checkpoint with a flag flipped."""
    e = ["--checkpoint-engine", engine]
    ck = {"vanilla": "ckpt_2.ckpt", "sharded": "ckpt_2", "zerostall": "ckpt_2.zs.json"}[engine]

    def resume(name):
        return ["--resume-from-checkpoint", str(Path(d) / f"{engine}_{name}" / ck)]

    z1, q8 = ["--optimizer-sharding", "zero1"], ["--grad-allreduce", "int8"]
    plan = [("none", e), ("z1", e + z1), ("z1_to_none", e + resume("z1")),
            ("none_to_z1", e + z1 + resume("none"))]
    if engine != "zerostall":
        plan += [("qb", e + q8 + ["--grad-bucket-mb", "0.05"]), ("qb_to_q", e + q8 + resume("qb")),
                 ("f1", e + ["--grad-bucket-mb", "0.05"]),
                 ("f1_to_f2", e + ["--grad-bucket-mb", "0.2"] + resume("f1")),
                 ("q_to_fp32", e + resume("qb")), ("fp32_to_q", e + q8 + resume("none"))]
    return [(f"{engine}_{name}", extra) for name, extra in plan]


def _csv(d, name):
    rows = (Path(d) / name / f"{name}_loss_log.csv").read_text().splitlines()[1:]
    return {int(r.split(",")[0]): r.split(",")[1] for r in rows}


@pytest.fixture(scope="module")
def flips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flips")
    plan = [p for engine in ("vanilla", "sharded", "zerostall") for p in _flip_plan(tmp, engine)]
    spawn("flips", {"dir": str(tmp), "plan": plan}, timeout=240)
    return tmp


@pytest.mark.parametrize("engine,flip,base", [
    (engine, flip, base) for engine in ("vanilla", "sharded", "zerostall")
    for flip, base in (("z1_to_none", "none"), ("none_to_z1", "none"), ("f1_to_f2", "f1"))
    if engine != "zerostall" or base == "none"  # the zerostall leg pins the zero1 flips
])
def test_flag_flip_resume_is_bit_equal(flips, engine, flip, base):
    straight, resumed = _csv(flips, f"{engine}_{base}"), _csv(flips, f"{engine}_{flip}")
    assert sorted(resumed) == [3, 4]
    assert all(resumed[s] == straight[s] for s in (3, 4))
    if flip.startswith("z1"):
        assert _csv(flips, f"{engine}_z1") == straight  # zero1 itself is the none run
    if engine == "vanilla":
        a = (flips / f"vanilla_{base}" / "ckpt_4_final.ckpt").read_bytes()
        assert (flips / f"vanilla_{flip}" / "ckpt_4_final.ckpt").read_bytes() == a
    if engine == "sharded":
        from pyrecover_tpu_torch.checkpoint.sharded import read_meta

        assert (read_meta(flips / f"sharded_{flip}" / "ckpt_4_final")["leaf_digests"]
                == read_meta(flips / f"sharded_{base}" / "ckpt_4_final")["leaf_digests"])


@pytest.mark.parametrize("engine", ["vanilla", "sharded"])
def test_int8_buckets_to_int8_restores_the_residual(flips, engine):
    """The residual's shape does not depend on the layout: the flip restores
    it (no structure error) and continues within the int8 policy."""
    straight, resumed = _csv(flips, f"{engine}_qb"), _csv(flips, f"{engine}_qb_to_q")
    assert sorted(resumed) == [3, 4]
    for s in (3, 4):
        assert abs(float(resumed[s]) - float(straight[s])) / float(straight[s]) < 2e-3
    events = [json.loads(x) for x in (flips / f"{engine}_qb_to_q" /
                                      f"{engine}_qb_to_q_telemetry.jsonl").read_text().split("\n")
              if x]
    assert [e["step"] for e in events if e["event"] == "resume"] == [2]


@pytest.mark.parametrize("engine", ["vanilla", "sharded"])
@pytest.mark.parametrize("flip,base", [("q_to_fp32", "qb"), ("fp32_to_q", "none")])
def test_grad_allreduce_flip_drops_or_zero_starts_the_residual(flips, engine, flip, base):
    """int8 -> fp32 reads the saved residual into a scratch leaf and drops
    it; fp32 -> int8 starts the residual at zero. Either resumes at step 2
    and continues within the int8 policy of the straight run."""
    straight, resumed = _csv(flips, f"{engine}_{base}"), _csv(flips, f"{engine}_{flip}")
    assert sorted(resumed) == [3, 4]
    for s in (3, 4):
        assert abs(float(resumed[s]) - float(straight[s])) / float(straight[s]) < 2e-3


def test_jax_int8_checkpoint_restores_and_continues(tmp_path):
    """JAX's dp2 int8 state after 2 steps, saved by JAX, restored by the
    port's two ranks (each takes its residual row), then steps 3-4 against
    JAX's own."""
    import jax

    from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla

    batches = jax_batches(STEPS)
    jm, init, jstate, states = jax_run(batches, grad_allreduce="int8")
    save_ckpt_vanilla(tmp_path / "jax_ckpt_2.ckpt", states[1], {"consumed": 2})
    write_inputs(tmp_path, batches, init)
    outs = spawn("resume_jax", {"dir": str(tmp_path)})
    assert outs[0]["residual_absmax"] > 0
    for a, b in zip(outs[0]["metrics"], jm[2:]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    assert_close_by_share(
        jax.tree_util.tree_leaves(port_params_tree(tmp_path / "params_resumed_rank0.npz")),
        jax.tree_util.tree_leaves(jstate.params), "resumed params")
    rows = [np.load(tmp_path / f"residual_resumed_rank{r}.npy")[0] for r in range(2)]
    assert_close_by_share(rows, list(np.asarray(jstate.grad_residual)), "resumed residual")


# ---- worker side -----------------------------------------------------------------------


def _local_batches(d, rank, world):
    per = BATCH // world
    return [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()} for b in _load_batches(d)]


def _train_worker(args):
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    rank = mesh.rank()
    d = Path(args["dir"])
    local = _local_batches(d, rank, mesh.world_size())
    out = {}
    for name, kw in args["runs"].items():
        model, step = _port_model_and_step(d / "params.npz", **kw)
        metrics = [{k: float(v) for k, v in step(_to_torch(b)).items()} for b in local]
        moments = sum(s["mu"].numel() for s in step.optimizer.state.values())
        out[name] = {"metrics": metrics, "moment_elems": moments}
        np.savez(d / f"params_{name}_rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    mesh.destroy_distributed()
    return out


def _flips_worker(args):
    """Every run of the plan through ``train.main`` in this process pair (the
    group joined once, so ``train`` leaves it standing)."""
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    for name, extra in args["plan"]:
        train.main(TINY + ["--checkpoint-dir", args["dir"], "--experiment-name", name, *extra])
    mesh.destroy_distributed()
    return {}


def _resume_jax_worker(args):
    from pyrecover_tpu_torch.checkpoint.vanilla import load_ckpt_vanilla
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.train_state import load_state_leaves, restore_whole, state_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    rank = mesh.rank()
    d = Path(args["dir"])
    model, step = _port_model_and_step(d / "params.npz", grad_allreduce="int8")
    leaves = state_leaves(model, step.optimizer, residual=step.residual)
    restore_whole(leaves, lambda whole: load_ckpt_vanilla(d / "jax_ckpt_2.ckpt", whole))
    load_state_leaves(leaves, step.optimizer)
    absmax = float(step.residual.row.abs().max())
    metrics = [{k: float(v) for k, v in step(_to_torch(b)).items()}
               for b in _local_batches(d, rank, mesh.world_size())[2:]]
    np.savez(d / f"params_resumed_rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    np.save(d / f"residual_resumed_rank{rank}.npy", step.residual.row.numpy())
    mesh.destroy_distributed()
    return {"metrics": metrics, "residual_absmax": absmax}


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker, "flips": _flips_worker, "resume_jax": _resume_jax_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
