"""The pipeline beside the other axes (``parallel/pipeline.py`` over a
stage's sharded blocks): the port's step on composed meshes held to the
JAX package's, mirroring ``tests/test_pipeline.py``'s composed cases.

* The step at ``pp2-tp2``, ``pp2-fsdp2``, ``1f1b-pp2-tp2`` (M 4),
  ``1f1b-pp2-fsdp2`` (M 4: FSDP2's gathers and reduce-scatters a
  microbatch at a time, forwards and backwards interleaved),
  ``ilv2-pp2-tp2-m8`` (V 2, M 8), ``pp2-sp2`` (the ring inside a stage),
  ``pp2-dp2`` under ZeRO-1, on four gloo ranks, and
  ``ilv2-pp2-tp2-fsdp2-m4`` on eight, from JAX's initial weights and
  batches, 4 fp32 steps: every step's loss and gradient norm within 1e-4 of
  JAX's, the label counts equal, every parameter after the steps within
  JAX's own ``rtol = atol = 2e-3`` (``tests/test_pipeline.py``). The
  references are JAX's step at ``pp2-tp2-fsdp2`` interleaved (V 2, M 4) on
  eight virtual CPU devices, where the port runs that mesh, and JAX's
  single-device step otherwise: JAX's pipelined meshes give that step's
  numbers (``test_pipelined_step_matches_single_device``), and JAX's ring
  inside a pipeline stage raises (a custom-VJP type error), so ``pp2-sp2``
  has no JAX run of its own.
* Each rank's box of ``wq`` equals the slice JAX's ``P("pipeline", "fsdp",
  "tensor")`` gives its device, on the composed meshes; the ranks hold
  those shapes.
* ZeRO-1's moment specs over a pipelined leaf equal JAX's
  ``zero1_leaf_spec`` (``P(("pipeline", "data"), "fsdp", "tensor")``), and
  each data rank's moments are its piece of its stage's layers.
* The fault that hung ``--sp 4`` over NCCL: at a sequence axis alone every
  rank past sequence 0 owns no element of the gradient norm, and its norm
  collective took a host zero, which a group of two backends
  (``cuda:nccl,cpu:gloo``) sends over gloo while its peers' device sums go
  over NCCL. Every rank's norm collective now takes a tensor on the
  gradients' device (the meta device stands in for the card here).

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
from test_torch_fsdp_tp import load_tree, save_tree, write_batches
from test_torch_pipeline import LAYERS, jax_mesh_run, port_model_and_step, world_of
from test_torch_wire import (
    BATCH,
    LOSS_RTOL,
    SEQ,
    STEPS,
    VOCAB,
    _load_batches,
    _to_torch,
    jax_batches,
)

# JAX's own tolerance for a pipelined step's parameters (tests/test_pipeline.py)
PARAM_TOL = 2e-3
ILV = dict(pp_schedule="1f1b", pp_virtual_stages=2)
# name -> (mesh axes, model fields, TrainConfig fields); the port runs as many gloo ranks
MESHES = {
    "pp2-tp2": (dict(pipeline=2, tensor=2), {}, {}),
    "pp2-fsdp2": (dict(pipeline=2, fsdp=2), {}, {}),
    "1f1b-pp2-tp2": (dict(pipeline=2, tensor=2), dict(pp_schedule="1f1b", pp_microbatches=4),
                     {}),
    "1f1b-pp2-fsdp2": (dict(pipeline=2, fsdp=2), dict(pp_schedule="1f1b", pp_microbatches=4),
                       {}),
    "ilv2-pp2-tp2-m8": (dict(pipeline=2, tensor=2), dict(ILV, pp_microbatches=8), {}),
    "pp2-sp2": (dict(pipeline=2, sequence=2), {}, {}),
    "pp2-dp2-zero1": (dict(pipeline=2, data=2), {}, dict(optimizer_sharding="zero1")),
    "ilv2-pp2-tp2-fsdp2-m4": (dict(pipeline=2, tensor=2, fsdp=2), dict(ILV, pp_microbatches=4),
                              {}),
}
# the one composed mesh JAX runs here (8 virtual devices): its own reference
JAX_COMPOSED = "ilv2-pp2-tp2-fsdp2-m4"


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def composed_runs(tmp_path_factory, devices8):
    """JAX's single-device run and its run at ``JAX_COMPOSED``, and the
    port's at every mesh of ``MESHES`` (one 4-rank and one 8-rank launch),
    from one set of weights and batches."""
    tmp = tmp_path_factory.mktemp("pp_compose")
    batches = jax_batches(STEPS)
    write_batches(tmp, batches)
    mesh_kw, model_kw, _ = MESHES[JAX_COMPOSED]
    jax_out = {"one": jax_mesh_run(batches, dict(data=1), {}),
               JAX_COMPOSED: jax_mesh_run(batches, dict(data=1, **mesh_kw), model_kw)}
    save_tree(tmp / "init.npz", jax_out["one"][1])
    outs = {}
    for world in (4, 8):
        runs = {name: {"mesh": m, "model": mk, "kw": kw}
                for name, (m, mk, kw) in MESHES.items() if world_of(m) == world}
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=300)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


def reference(name):
    return name if name == JAX_COMPOSED else "one"


def assert_steps_match(port_ranks, jax_metrics):
    for out in port_ranks:  # every rank reports the global loss
        assert len(out["metrics"]) == len(jax_metrics)
        for step, (a, b) in enumerate(zip(out["metrics"], jax_metrics)):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                           err_msg=f"{key} step {step}")
            assert a["n_tokens"] == b["n_tokens"]


def assert_params_match(got, want, what):
    import jax

    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", list(MESHES))
def test_composed_step_matches_jax(composed_runs, name):
    tmp, jax_out, outs = composed_runs
    jm, _, jparams = jax_out[reference(name)]
    assert_steps_match(outs[name], jm)
    assert_params_match(load_tree(tmp / f"final_{name}.npz"), jparams, name)


def test_jax_composed_mesh_is_the_single_device_step(composed_runs):
    """JAX's own interleaved pp2 x tp2 x fsdp2 step gives its single-device
    numbers (so the single-device run is the reference of the meshes JAX
    is not run at here)."""
    _, jax_out, _ = composed_runs
    assert_steps_match([{"metrics": jax_out[JAX_COMPOSED][0]}], jax_out["one"][0])


# ---- each rank's box of a leaf, and ZeRO-1's specs ------------------------------------


WQ_MESHES = {"pp2-tp2": dict(pipeline=2, tensor=2), "pp2-fsdp2": dict(pipeline=2, fsdp=2),
             "pp2-tp2-fsdp2": dict(pipeline=2, tensor=2, fsdp=2),
             "pp4-tp2": dict(pipeline=4, tensor=2)}


@pytest.mark.parametrize("name", list(WQ_MESHES))
def test_wq_boxes_equal_jax_partition(name, devices8):
    """Each rank's box of the stacked ``wq`` (L, dim, heads x hd) under the
    port's rule equals the slice JAX's ``P("pipeline", "fsdp", "tensor")``
    gives the device at the same mesh position (``tests/test_pipeline.py::
    test_layer_leaves_sharded_over_pipeline``): the stage's contiguous
    layers, the fsdp rows and the tensor columns."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu_torch.parallel.mesh import MeshConfig as PortMesh
    from pyrecover_tpu_torch.parallel.sharding import RULES, LeafShard

    axes = WQ_MESHES[name]
    n = world_of(axes)
    shape = (8, 64, 64)
    mesh = create_mesh(MeshConfig(data=1, **axes), devices=jax.devices()[:n])
    want = NamedSharding(mesh, P("pipeline", "fsdp", "tensor")).devices_indices_map(shape)
    rank_of = {d: i for i, d in enumerate(mesh.devices.flat)}
    mesh_shape = PortMesh(data=1, **{k if k != "pipeline" else "pipeline": v
                                     for k, v in axes.items()}).shape(n)
    assert RULES["wq"] == ["pipeline", "fsdp", "tensor"]
    for device, index in want.items():
        shard = LeafShard.of_spec(RULES["wq"], shape, mesh_shape, rank_of[device], stacked=True)
        got = ((shard.layer_ids[0], len(shard.layer_ids)),) + tuple(shard.box[1:])
        assert list(shard.layer_ids) == list(range(shard.layer_ids[0],
                                                   shard.layer_ids[-1] + 1))
        assert got == tuple((s.start or 0, (s.stop or shape[d]) - (s.start or 0))
                            for d, s in enumerate(index)), (name, rank_of[device])


def test_ranks_hold_their_boxes(composed_runs):
    """On the composed meshes the ranks hold the local ``wq`` shapes JAX's
    spec gives them (layers a stage x fsdp rows x tensor columns)."""
    _, _, outs = composed_runs
    L, dim, cols = LAYERS, 64, 64
    for name in ("pp2-tp2", "pp2-fsdp2", "ilv2-pp2-tp2-fsdp2-m4"):
        m = MESHES[name][0]
        want = [L // m["pipeline"], dim // m.get("fsdp", 1), cols // m.get("tensor", 1)]
        for out in outs[name]:
            assert out["wq_local"] == want, name


@pytest.mark.parametrize("shape,mesh_shape,want", [
    ((8, 64, 32), {"pipeline": 2, "data": 2, "fsdp": 1, "tensor": 1},
     [["pipeline", "data"], "fsdp", "tensor"]),
    ((8, 64, 32), {"pipeline": 2, "data": 2, "fsdp": 2, "tensor": 2},
     [["pipeline", "data"], "fsdp", "tensor"]),
    ((2, 64, 32), {"pipeline": 2, "data": 2, "fsdp": 2, "tensor": 1},
     ["pipeline", ["fsdp", "data"], "tensor"]),
    ((4, 64, 32), {"pipeline": 4, "data": 2, "fsdp": 1, "tensor": 1},
     ["pipeline", ["fsdp", "data"], "tensor"]),
])
def test_zero1_spec_over_a_pipelined_leaf_equals_jax(shape, mesh_shape, want):
    """``zero1_leaf_spec`` of a layer leaf on a mesh with a pipeline axis
    equals JAX's (``tests/test_bandwidth_lean.py::test_zero1_leaf_spec``):
    the data axis folds into the layer dimension when the stages x data
    divide it, else into the next that divides."""
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.parallel.sharding import zero1_leaf_spec as jax_spec
    from pyrecover_tpu_torch.parallel.sharding import zero1_leaf_spec

    got = zero1_leaf_spec(["pipeline", "fsdp", "tensor"], shape, mesh_shape)
    assert got == want
    ref = jax_spec(P("pipeline", "fsdp", "tensor"), shape, mesh_shape)
    assert [list(e) if isinstance(e, tuple) else e for e in ref] == want


@pytest.mark.parametrize("virtual", [1, 2])
def test_zero1_moments_are_a_piece_of_the_stage(virtual):
    """Under ``P(("pipeline", "data"), ...)`` each rank's moment layers are
    its data piece of its own stage's layers (interleaved chunks too), and
    the ranks' pieces cover every layer once."""
    from pyrecover_tpu_torch.parallel.mesh import coords_of
    from pyrecover_tpu_torch.parallel.sharding import LeafShard, stage_layers

    mesh_shape = {"pipeline": 2, "data": 2, "fsdp": 1, "tensor": 1, "expert": 1}
    spec = [["pipeline", "data"], "fsdp", "tensor"]
    seen = []
    for rank in range(4):
        shard = LeafShard.of_spec(spec, (8, 16, 16), mesh_shape, rank, stacked=True,
                                  virtual=virtual)
        c = coords_of(rank, mesh_shape)
        stage = stage_layers(8, 2, virtual, c["pipeline"])
        assert shard.layer_ids == stage[2 * c["data"]:2 * c["data"] + 2]
        assert shard.local_shape == (2, 16, 16)
        seen += shard.layer_ids
    assert sorted(seen) == list(range(8))


def test_zero1_moments_held_within_a_stage(composed_runs):
    """pp2 x dp2 under ZeRO-1: each rank holds the moments of half its
    stage's layers."""
    _, _, outs = composed_runs
    for out in outs["pp2-dp2-zero1"]:
        assert out["moment_layers"] == LAYERS // 4


@pytest.mark.parametrize("mesh_shape", [{"sequence": 2}, {"sequence": 4},
                                        {"sequence": 2, "tensor": 2}])
def test_norm_collective_stays_on_the_gradients_device(mesh_shape, monkeypatch):
    """Every rank of a sequence mesh hands the gradient norm's all-reduce a
    tensor on its gradients' device, the ranks that own no element too, so
    a two-backend group sends every rank's over one backend."""
    import torch.distributed as dist

    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import OptaxAdamW
    from pyrecover_tpu_torch.parallel.mesh import MeshConfig, coords_of
    from pyrecover_tpu_torch.train_state import norm_owners

    seen = []
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: seen.append(t.device))
    shape = MeshConfig(data=1, **mesh_shape).shape(world_of(mesh_shape))
    owned = []
    for rank in range(world_of(mesh_shape)):
        live = type("Live", (), {"shape": shape, "coords": coords_of(rank, shape)})()
        model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ), device="meta")
        owners = norm_owners(model, live)
        owned.append(any(owners.values()))
        opt = OptaxAdamW(list(model.parameters()), lr=lambda _: 0.0)
        opt.set_norm_mesh("model-group", owners)
        opt.grad_norm({p: torch.empty_like(p) for p in model.parameters()})
    assert owned[0] and not all(owned)  # the trigger: ranks that own nothing
    assert seen == [torch.device("meta")] * len(owned)


# ---- worker side -----------------------------------------------------------------------


def _train_worker(args):
    """Each run of ``args["runs"]`` on this rank: its metrics, its local
    ``wq`` shape and moment layers; rank 0 saves the final parameters."""
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.train_state import param_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    batches = _load_batches(d)
    out = {}
    for name, run in args["runs"].items():
        model, step, live = port_model_and_step(load_tree(d / "init.npz"), run["mesh"],
                                                run["model"], **run["kw"])
        per = BATCH // live.batch_shards
        rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
        metrics = [{k: float(v) for k, v in
                    step(_to_torch({k: v[rows] for k, v in b.items()})).items()}
                   for b in batches]
        wq = next(leaf for leaf in param_leaves(model) if leaf.path.endswith("['wq']"))
        regions = step.optimizer.regions
        tree = params_to_numpy(model)  # every rank: a collective on a sharded model
        if mesh.rank() == 0:
            save_tree(d / f"final_{name}.npz", tree)
        out[name] = {"metrics": metrics,
                     "wq_local": [len(wq.parts), *wq.parts[0].shape],
                     "moment_layers": sum(regions.get(p, ()) is not None for p in wq.parts)}
    mesh.destroy_distributed()
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
