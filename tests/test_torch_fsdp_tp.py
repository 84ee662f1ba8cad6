"""The fsdp and tensor axes of the port (``parallel/mesh.py``,
``parallel/sharding.py``, the autograd collectives, the sharded forward and
step, the optimizer over slices), held to the JAX package's.

* The step at ``MeshConfig(data=1, fsdp=2)``, ``(data=1, tensor=2)``,
  ``(data=2, fsdp=2)`` and ``(data=1, fsdp=2, tensor=2)``: JAX's on 2 or 4
  of the suite's virtual CPU devices and the port's on as many gloo ranks,
  from JAX's initial weights (loaded whole, then sliced by ``shard_model``) over
  the same batches, 4 steps at fp32. Losses and the global gradient norm
  within ``LOSS_RTOL`` (1e-4) relative on every rank, the label counts
  equal; the final parameters (gathered by ``params_to_numpy``) at
  tests/test_torch_wire.py's policy: at most ``ELEM_SHARE`` (0.5 %) of the
  elements beyond ``ELEM_ATOL`` (1e-5) and none beyond 2·lr·steps (AdamW's
  first steps move a parameter by about lr whatever its gradient's size,
  so a gradient near zero that the two packages round to opposite signs
  moves it apart by up to 2·lr). Measured on this input: losses within
  2.0e-7 and norms within 1.7e-7 of JAX's, no parameter element beyond
  1e-5 (the worst 2.9e-6); ``MEASURED`` records each run's share.
* Inside the port: fsdp 2 against dp 2 (DDP) step for step, losses within
  1e-6 relative and the parameters at the same policy (not bit for bit: the
  loss and the clip's norm sum in another order; measured 1.1e-7 apart in
  the losses, 7.5e-9 in the parameters); each rank holds 1/(fsdp x tensor) of every leaf the rules
  split, parameters and moments; zero1 on dp 2 x fsdp 2 equals fsdp without
  it bit for bit, with a quarter of each moment leaf the data width divides
  on every rank.
* The mesh: coordinates and groups in JAX's axis order; the composition
  rules raise as JAX's do; remat ``auto``'s table at fsdp 2 and tp 2 equals
  JAX's SC05 rows; the elastic plans between dp, fsdp and tp topologies
  equal JAX's ``compute_reshard_plan`` on the same manifest.
* The collective probe: two gloo ranks take every collective the model
  axes use (``all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, and the others a wider port would), and
  FSDP2's ``fully_shard`` as ``shard_model`` drives it (a dim-1 placement,
  summed gradients) and DTensor's column/row styles run forward and
  backward. On a card::

      python tests/test_torch_fsdp_tp.py probe [--device cuda] [--elems N]

  prints each rank's ``{call: {ok, s} or {ok, error}}`` (default: one
  llama-1b FFN matrix of f32 and of bf16); it exits 2 without a card.

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
    LR,
    SEQ,
    STEPS,
    VOCAB,
    _load_batches,
    _to_torch,
    assert_close_by_share,
    jax_batches,
    jax_config,
)

# name -> (JAX MeshConfig fields, gloo ranks)
MESHES = {"fsdp2": dict(data=1, fsdp=2), "tp2": dict(data=1, tensor=2),
          "dp2-fsdp2": dict(data=2, fsdp=2), "fsdp2-tp2": dict(data=1, fsdp=2, tensor=2)}
PORT_ONLY_RTOL = 1e-6
MEASURED = {}


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def world_of(mesh_kw):
    return mesh_kw.get("data", 1) * mesh_kw.get("fsdp", 1) * mesh_kw.get("tensor", 1)


# ---- the JAX side ----------------------------------------------------------------


def jax_mesh_run(batches, mesh_kw, steps=None):
    """JAX's step on ``MeshConfig(**mesh_kw)`` over ``batches``: per-step
    metrics, the initial params (numpy), the final state as numpy and the
    state after each step."""
    import jax

    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu.train_state import make_train_step

    jcfg = jax_config()
    tx, _ = build_optimizer(jcfg)
    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:world_of(mesh_kw)])
    state = init_sharded_state(jax.random.key(0), jcfg.model, tx, mesh)
    init = jax.tree.map(np.asarray, state.params)
    step = make_train_step(jcfg.model, tx, donate=False)
    metrics, states = [], []
    with jax.sharding.set_mesh(mesh):
        for batch in batches[:steps]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(state)
    return metrics, init, jax.tree.map(np.asarray, state), states


def save_tree(path, tree):
    np.savez(path, **{k: v for k, v in tree.items() if k != "layers"},
             **{f"layers/{k}": v for k, v in tree["layers"].items()})


def load_tree(path):
    with np.load(path) as z:
        tree = {"layers": {}}
        for k in z.files:
            if k.startswith("layers/"):
                tree["layers"][k.split("/", 1)[1]] = z[k]
            else:
                tree[k] = z[k]
    return tree


def write_batches(d, batches):
    np.savez(d / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                   for k, v in b.items()})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """JAX's and the port's runs at every mesh of ``MESHES``, and the port's
    dp2 and zero1 runs beside them, from the same weights and batches."""
    tmp = tmp_path_factory.mktemp("fsdp_tp")
    batches = jax_batches(STEPS)
    write_batches(tmp, batches)
    jax_out = {name: jax_mesh_run(batches, kw) for name, kw in MESHES.items()}
    for name, (_, init, _, _) in jax_out.items():
        save_tree(tmp / f"init_{name}.npz", init)
    two = {"fsdp2": {"mesh": MESHES["fsdp2"], "init": "fsdp2"},
           "tp2": {"mesh": MESHES["tp2"], "init": "tp2"},
           "dp2": {"mesh": dict(data=2), "init": "fsdp2"}}
    four = {"dp2-fsdp2": {"mesh": MESHES["dp2-fsdp2"], "init": "dp2-fsdp2"},
            "dp2-fsdp2-zero1": {"mesh": MESHES["dp2-fsdp2"], "init": "dp2-fsdp2",
                                "kw": {"optimizer_sharding": "zero1"}},
            "fsdp2-tp2": {"mesh": MESHES["fsdp2-tp2"], "init": "fsdp2-tp2"}}
    outs = {}
    for runs, world in ((two, 2), (four, 4)):
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=240)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step_matches_jax(mesh_runs, name):
    import jax

    tmp, jax_out, outs = mesh_runs
    jm, _, jstate, _ = jax_out[name]
    for out in outs[name]:  # every rank logs the global loss
        assert len(out["metrics"]) == STEPS
        for step, (a, b) in enumerate(zip(out["metrics"], jm)):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL, err_msg=f"step {step}")
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=LOSS_RTOL,
                                       err_msg=f"step {step}")
            assert a["n_tokens"] == b["n_tokens"]
    got = jax.tree_util.tree_leaves(load_tree(tmp / f"final_{name}.npz"))
    want = jax.tree_util.tree_leaves(jstate.params)
    MEASURED[name] = assert_close_by_share(got, want, f"{name} params")


def test_fsdp2_follows_dp2(mesh_runs):
    import jax

    tmp, _, outs = mesh_runs
    dp = [m["loss"] for m in outs["dp2"][0]["metrics"]]
    fs = [m["loss"] for m in outs["fsdp2"][0]["metrics"]]
    assert max(abs(a - b) / b for a, b in zip(fs, dp)) <= PORT_ONLY_RTOL
    got = jax.tree_util.tree_leaves(load_tree(tmp / "final_fsdp2.npz"))
    want = jax.tree_util.tree_leaves(load_tree(tmp / "final_dp2.npz"))
    MEASURED["fsdp2_vs_dp2"] = assert_close_by_share(got, want, "fsdp2 vs dp2 params")


@pytest.mark.parametrize("name", ["fsdp2", "tp2", "fsdp2-tp2"])
def test_each_rank_holds_its_slices(mesh_runs, name):
    """Every leaf the rules split, parameters and moments, holds 1/(fsdp x
    tensor) of its elements on every rank; the norms stay whole."""
    _, _, outs = mesh_runs
    kw = MESHES[name]
    pieces = kw.get("fsdp", 1) * kw.get("tensor", 1)
    for out in outs[name]:
        held = out["held"]
        for path, share in held.items():
            if "norm" in path:
                assert share == 1.0, path
            else:
                assert share == pytest.approx(1 / pieces), path
        assert any(p.startswith(".opt_state") and "mu" in p for p in held)


def test_zero1_with_fsdp_equals_fsdp(mesh_runs):
    tmp, _, outs = mesh_runs
    for plain, z1 in zip(outs["dp2-fsdp2"], outs["dp2-fsdp2-zero1"]):
        assert plain["metrics"] == z1["metrics"]
        # wq's moments (L 2, D 64, 64) take the data axis on the layer
        # dimension: each rank a quarter
        assert z1["held"][".opt_state[1][0].mu['layers']['wq']"] == pytest.approx(1 / 4)
        assert plain["held"][".opt_state[1][0].mu['layers']['wq']"] == pytest.approx(1 / 2)
    with np.load(tmp / "final_dp2-fsdp2.npz") as a, \
            np.load(tmp / "final_dp2-fsdp2-zero1.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---- the mesh, the rules, the plan -------------------------------------------------


def test_mesh_coordinates_and_groups_in_jax_order():
    from pyrecover_tpu_torch.parallel import mesh

    shape = mesh.MeshConfig(fsdp=2, tensor=2).shape(8)
    assert shape == {"data": 2, "fsdp": 2, "tensor": 2, "expert": 1}
    assert [tuple(mesh.coords_of(r, shape).values()) for r in range(8)] == [
        (d, f, t, 0) for d in range(2) for f in range(2) for t in range(2)]
    assert mesh.group_ranks("tensor", 5, shape) == [4, 5]
    assert mesh.group_ranks("fsdp", 5, shape) == [5, 7]
    assert mesh.group_ranks("data", 5, shape) == [1, 5]
    assert mesh.group_ranks("batch", 5, shape) == [1, 3, 5, 7]
    assert mesh.group_ranks("model", 5, shape) == [4, 5, 6, 7]
    live = mesh.DeviceMesh(shape, 6)
    assert (live.batch_index, live.batch_shards) == (3, 4) and live.model_sharded
    with pytest.raises(ValueError, match="not divisible"):
        mesh.MeshConfig(fsdp=3).shape(4)
    topo = mesh.topology(shape)
    assert topo["devices"] == 8 and topo["mesh"]["tensor"] == 2 and topo["mesh"]["pipeline"] == 1


def test_tok_embed_box_puts_tensor_major():
    """JAX's ``(tensor, fsdp)`` order on tok_embed's model dimension."""
    from pyrecover_tpu_torch.parallel.sharding import RULES, leaf_box

    shape = {"data": 1, "fsdp": 2, "tensor": 2}
    starts = {(f, t): leaf_box(RULES["tok_embed"], (128, 64), shape,
                               {"fsdp": f, "tensor": t})[1][0]
              for f in range(2) for t in range(2)}
    assert starts == {(0, 0): 0, (1, 0): 16, (0, 1): 32, (1, 1): 48}


BASE = ["--device", "cpu", "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
        "--model-kv-heads", "2", "--vocab-size", "128"]


@pytest.mark.parametrize("extra,err,match", [
    (["--fsdp", "2", "--grad-allreduce", "int8"], ValueError, "pure data-parallel replicas"),
    (["--tp", "2", "--grad-allreduce", "bf16"], ValueError, "pure data-parallel replicas"),
    (["--fsdp", "2", "--grad-bucket-mb", "4"], ValueError, "pure data-parallel replicas"),
    (["--sp", "2"], None, "ring"),
    (["--pp", "2"], None, "sdpa"),
    (["--ep", "2", "--sp", "2"], None, "ring"),
    (["--fsdp", "2", "--moe-experts", "4", "--pp", "2"], None, "sdpa"),
    (["--tp", "2", "--moe-experts", "4", "--sp", "2"], None, "ring"),
    (["--tp", "3", "--model-heads", "6", "--model-kv-heads", "2"], ValueError, "heads split"),
])
def test_composition_rules_raise(extra, err, match):
    """The port raises where JAX's ``config.py:200-231`` does, with its
    wording for the wire and buckets; the sequence and pipeline axes
    resolve as in JAX (``err`` None: the mesh and the attention JAX picks,
    ``match``), composed too (an MoE model over them, the pipeline beside
    fsdp), and ``--fsdp`` with ``--tp`` and zero1 resolves."""
    from pyrecover_tpu.config import get_args as jax_get_args
    from pyrecover_tpu_torch.config import get_args

    if err is None:
        port, ref = get_args(BASE + extra), jax_get_args(BASE[2:] + extra)
        assert (port.sp, port.pp, port.ep, port.fsdp, port.tp, port.model.n_experts) == (
            ref.mesh.sequence, ref.mesh.pipeline, ref.mesh.expert, ref.mesh.fsdp,
            ref.mesh.tensor, ref.model.n_experts)
        assert port.model.attention_impl == ref.model.attention_impl == match
        return
    with pytest.raises(err, match=match):
        get_args(BASE + extra)
    if err is ValueError and "heads" not in match:
        with pytest.raises(ValueError, match=match):
            jax_get_args(BASE[2:] + extra)
    port = get_args(BASE + ["--fsdp", "2", "--tp", "2", "--optimizer-sharding", "zero1"])
    assert (port.fsdp, port.tp, port.optimizer_sharding) == (2, 2, "zero1")


@pytest.mark.parametrize("preset", ["tiny", "llama-1b"])
@pytest.mark.parametrize("mesh_kw", [dict(fsdp=2), dict(tensor=2), dict(data=2, fsdp=2),
                                     dict(fsdp=2, tensor=2)], ids=["fsdp2", "tp2", "dp2-fsdp2",
                                                                  "fsdp2-tp2"])
def test_remat_auto_table_matches_jax(preset, mesh_kw):
    import dataclasses

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.presets import PRESETS
    from pyrecover_tpu.utils import remat as jax_remat
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.utils import remat

    jmc = JaxModelConfig().tiny() if preset == "tiny" else PRESETS[preset]()
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pmc = ModelConfig(**{k: getattr(jmc, k) for k in fields if hasattr(jmc, k)})
    shape = {"data": 1, "fsdp": 1, "tensor": 1, **mesh_kw}
    rows = 8 // (shape["data"] * shape["fsdp"])
    for sharding in ("none", "zero1"):
        for policy in ("none", "save-attn", "full"):
            want = jax_remat.modelled_total_bytes(
                jmc, dict(mesh_kw), batch_size=8, seq_len=jmc.max_seq_len, policy=policy,
                optimizer_sharding=sharding)
            got = remat.modelled_total_bytes(
                pmc, batch_size=rows, seq_len=jmc.max_seq_len, policy=policy,
                optimizer_sharding=sharding, **shape)
            assert got == want, (sharding, policy)


def _topo(n, **axes):
    mesh = {"pipeline": 1, "data": n, "fsdp": 1, "tensor": 1, "sequence": 1, "expert": 1}
    for k, v in axes.items():
        mesh[k] = v
        mesh["data"] = n // int(np.prod(list(axes.values())))
    return {"devices": n, "processes": n, "mesh": mesh}


TOPOLOGIES = {"dp2": _topo(2), "dp1": _topo(1), "fsdp2": _topo(2, fsdp=2),
              "tp2": _topo(2, tensor=2), "fsdp2-tp2": _topo(4, fsdp=2, tensor=2),
              "dp2-fsdp2": _topo(4, fsdp=2)}


@pytest.mark.parametrize("saved,target", [("fsdp2", "dp1"), ("tp2", "fsdp2"),
                                          ("fsdp2-tp2", "fsdp2-tp2"), ("dp2", "fsdp2-tp2"),
                                          ("dp2-fsdp2", "tp2"), ("fsdp2-tp2", "dp2")])
def test_elastic_plan_matches_jax(saved, target):
    """The port's plan over a manifest of the tiny model's state (its leaves'
    rules as specs) equals JAX's, leaf for leaf, between dp, fsdp and tp
    topologies, with the live specs of the target mesh."""
    from pyrecover_tpu.checkpoint import elastic as jax_elastic
    from pyrecover_tpu_torch.checkpoint import elastic
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.parallel.sharding import spec_for_manifest_path
    from pyrecover_tpu_torch.train_state import param_leaves

    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ), device="meta")
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


def test_probe_finds_the_collectives_on_the_cpu():
    """The probe (module docstring) on CPU tensors: two gloo ranks take
    every call the model axes use, and FSDP2 as the port drives it and
    DTensor's styles run; without a card ``--device cuda`` exits 2."""
    for rank in spawn("probe", {"device": "cpu", "elems": 1024}, timeout=120):
        for call in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
            assert rank[f"{call}_float32"]["ok"] and rank[f"{call}_bfloat16"]["ok"], call
        assert rank["fsdp2_fully_shard_fwd_bwd"]["ok"], rank["fsdp2_fully_shard_fwd_bwd"]
        assert rank["dtensor_colwise_rowwise_fwd_bwd"]["ok"]
    if not torch.cuda.is_available():
        assert probe_main(["--device", "cuda"]) == 2


def test_eval_leaves_the_model_sharded():
    """An eval (a forward no backward follows) before and between fsdp 2
    steps changes no loss or norm, and the leaves read after it are the
    shards (FSDP2 would keep the weights it gathered for the forward)."""
    plain, with_eval = spawn("eval_order", {"orders": ["tt", "ette"]})[0]
    assert [m for m in with_eval if m[0] == "train"] == plain
    for m in with_eval:
        if m[0] == "eval":
            assert m[2] == {"tok_embed": 0.5, "wq": 0.5}  # this rank's shares


# ---- worker side -------------------------------------------------------------------


def _sharded_model_and_step(tree, mesh_kw, **kw):
    """The tiny model with JAX's weights ``tree``, sliced onto a live mesh
    of ``mesh_kw``, and its optimizer and step. Returns ``(model, step,
    mesh)``."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_from_jax
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.parallel.sharding import shard_model
    from pyrecover_tpu_torch.train_state import make_train_step

    cfg = TrainConfig(model=ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ),
                      sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                      lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32",
                      device="cpu", dp=mesh_kw.get("data", 1), fsdp=mesh_kw.get("fsdp", 1),
                      tp=mesh_kw.get("tensor", 1), **kw)
    shape = mesh.MeshConfig(data=cfg.dp, fsdp=cfg.fsdp, tensor=cfg.tp).shape(mesh.world_size())
    live = mesh.build_mesh(shape)
    model = Transformer(cfg.model)
    model.load_state_dict(params_from_jax(tree))
    shard_model(model, live)
    opt, _ = build_optimizer(cfg, model.parameters(), model=model)
    return model, make_train_step(model, opt), live


def _held(leaves):
    """``{leaf path: the share of its elements this rank's parts hold}``."""
    return {leaf.path: sum(p.numel() for p in leaf.parts) / float(np.prod(leaf.shape))
            for leaf in leaves if isinstance(leaf.parts[0], torch.Tensor)}


def _train_worker(args):
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.train_state import state_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    batches = _load_batches(d)
    out = {}
    for name, run in args["runs"].items():
        model, step, live = _sharded_model_and_step(load_tree(d / f"init_{run['init']}.npz"),
                                                    run["mesh"], **run.get("kw", {}))
        per = BATCH // live.batch_shards
        rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
        metrics = [{k: float(v) for k, v in step(_to_torch({k: v[rows] for k, v in b.items()}))
                    .items()} for b in batches]
        held = _held(state_leaves(model, step.optimizer))
        tree = params_to_numpy(model)  # every rank: a collective on a sharded model
        if mesh.rank() == 0:
            save_tree(d / f"final_{name}.npz", tree)
        out[name] = {"metrics": metrics, "held": held}
    mesh.destroy_distributed()
    return out


def _eval_order_worker(args):
    """Each of ``args["orders"]`` from the same weights at fsdp 2 (bf16
    compute): ``t`` a train step on this rank's rows (the optimizer and the
    step built at the first), ``e`` an eval of the whole batch, then the
    shares of tok_embed and wq that this rank's leaves hold."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.parallel.sharding import shard_model
    from pyrecover_tpu_torch.train_state import make_eval_step, make_train_step, param_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    cfg = TrainConfig(model=ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ),
                      sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                      lr_warmup_steps=2, training_steps=STEPS, device="cpu", fsdp=2)
    live = mesh.build_mesh({"data": 1, "fsdp": 2, "tensor": 1})
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, VOCAB, (BATCH, SEQ), generator=g) for k in ("inputs", "labels")}
    per = BATCH // live.batch_shards
    rows = {k: v[live.batch_index * per:(live.batch_index + 1) * per] for k, v in batch.items()}
    out = []
    for order in args["orders"]:
        model = shard_model(Transformer(cfg.model, generator=torch.Generator().manual_seed(0)),
                            live)
        evaluate = make_eval_step(model, loss_chunk_size=8)
        step, run = None, []
        for op in order:
            if op == "t":
                if step is None:
                    opt, _ = build_optimizer(cfg, model.parameters(), model=model)
                    step = make_train_step(model, opt, loss_chunk_size=8)
                m = step(rows)
                run.append(["train", float(m["loss"]), float(m["grad_norm"])])
            else:
                ce, _ = evaluate(batch)
                held = {key: sum(p.numel() for p in leaf.parts) / float(np.prod(leaf.shape))
                        for leaf in param_leaves(model) for key in ("tok_embed", "wq")
                        if leaf.path.endswith(f"['{key}']")}
                run.append(["eval", float(ce), held])
        out.append(run)
    mesh.destroy_distributed()
    return out


LLAMA_1B_FFN = 2048 * 7168


def _probe_worker(args):
    """One rank of the probe: each call on f32 and bf16 tensors of
    ``args["elems"]`` elements, then FSDP2 and DTensor over two ``Linear``
    layers; ``{call: {ok, s} or {ok, error}}``."""
    import time

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = args["device"]
    if device == "cuda":
        torch.cuda.set_device(0)  # both ranks on the one card, as the dp phase's pairs
    dist.init_process_group("gloo")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    res = {}

    def probe(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            res[name] = {"ok": True, "s": round(time.perf_counter() - t0, 4)}
        except Exception as e:  # the finding: this call is not taken
            res[name] = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}

    n = args["elems"] - args["elems"] % 2
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, device=dev).to(dtype)
        tag = str(dtype).split(".")[-1]
        probe(f"all_reduce_{tag}", lambda: dist.all_reduce(x.clone()))
        probe(f"all_reduce_max_{tag}", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX))
        probe(f"all_gather_into_tensor_{tag}",
              lambda: dist.all_gather_into_tensor(x.new_empty(2 * n), x))
        probe(f"reduce_scatter_tensor_{tag}",
              lambda: dist.reduce_scatter_tensor(x.new_empty(n // 2), x))
        probe(f"all_to_all_single_{tag}", lambda: dist.all_to_all_single(torch.empty_like(x), x))
        probe(f"broadcast_{tag}", lambda: dist.broadcast(x.clone(), 0))

    def layers():
        return torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.Linear(256, 64)).to(dev)

    def fsdp2():
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        model = layers()
        for layer in model:
            fully_shard(layer, mesh=init_device_mesh(device, (2,)),
                        shard_placement_fn=lambda p: Shard(p.dim() - 1))
            layer.set_gradient_divide_factor(1.0)
            layer.set_force_sum_reduction_for_comms(True)
        model(torch.randn(4, 64, device=dev)).sum().backward()

    def dtensor_tp():
        from torch.distributed.tensor.parallel import (
            ColwiseParallel,
            RowwiseParallel,
            parallelize_module,
        )

        model = layers()
        parallelize_module(model, init_device_mesh(device, (2,)),
                           {"0": ColwiseParallel(), "1": RowwiseParallel()})
        model(torch.randn(4, 64, device=dev)).sum().backward()

    probe("fsdp2_fully_shard_fwd_bwd", fsdp2)
    probe("dtensor_colwise_rowwise_fwd_bwd", dtensor_tp)
    dist.destroy_process_group()
    return res


def probe_main(argv):
    """The probe's command line (module docstring): 0 after the ranks ran,
    whatever they found; 2 when ``--device cuda`` has no card."""
    import argparse

    ap = argparse.ArgumentParser(prog="test_torch_fsdp_tp.py probe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--elems", type=int, default=LLAMA_1B_FFN)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe: no CUDA device: pass --device cpu to probe the CPU", file=sys.stderr)
        return 2
    ranks = spawn("probe", vars(args), timeout=300)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu", "torch": torch.__version__, "cuda": torch.version.cuda,
                      "elems": args.elems, "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker, "probe": _probe_worker, "eval_order": _eval_order_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["probe"]:
    sys.exit(probe_main(sys.argv[2:]))
