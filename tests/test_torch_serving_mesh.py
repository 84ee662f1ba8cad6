"""Serving on a mesh in the port (``serving/restore.py::load_serving_params(
mesh=)``, the forwards over a rank's boxes, the per-rank pool, the engine's
lockstep, ``HotSwapper(mesh=)``), held to the JAX package's
``load_serving_params(mesh=)`` and ``ServingEngine`` on the same mesh.

One JAX-written vanilla checkpoint (the tiny fp32 ``CFG`` of
tests/test_serving.py, and an MoE variant for the expert axis) is served by
JAX on the suite's virtual CPU devices and by the port on as many gloo
ranks (each mesh of one world size in one spawn, `mesh_runs`):

* (a) the restore's ``resharded_leaves`` and ``plan_bytes_moved`` equal
  JAX's exactly, and every rank's parameters equal, bit for bit, the box
  JAX's placement puts on the device at that rank's mesh position;
* (b) the paged prefill logits of one prompt (rank 0's) are within
  ``PREFILL_REL`` (1e-5) relative norm of JAX's on that mesh, and the
  engine serves JAX's greedy tokens, token for token, at fp32; a bf16
  restore at tensor 2 is within the serving line's 5e-2 of JAX's bf16
  logits;
* (c) a tensor axis that does not divide ``n_kv_heads`` raises SC11 and an
  impossible memory budget SC05, both before any tensor is read;
* (d) a hot swap between two zerostall manifests at tensor 2: the requests
  after the flip serve what a cold restore of the new manifest serves at
  that mesh, and both ranks flip at the same engine step;
* a follower rank that fails a step makes both ranks raise
  ``MeshServingError`` (no hang, no result), and ``submit`` on a follower
  raises.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrecover_tpu_torch.serving.restore import MATRIX_KEYS
from test_torch_distributed import spawn as _spawn

# name -> (mesh axes, config key)
MESHES = {"data2": ({"data": 2}, "dense"), "fsdp2": ({"fsdp": 2}, "dense"),
          "tensor2": ({"tensor": 2}, "dense"), "sequence2": ({"sequence": 2}, "dense"),
          "pipeline2": ({"pipeline": 2}, "dense"), "expert2": ({"expert": 2}, "moe"),
          "tensor2-bf16": ({"tensor": 2}, "bf16"),
          "pipeline2-tensor2": ({"pipeline": 2, "tensor": 2}, "dense")}
CONFIGS = {"dense": {}, "bf16": {"compute_dtype": "bfloat16"},
           "moe": {"n_experts": 4, "moe_top_k": 2}}
SERVE = dict(block_size=8, max_seqs=4, prefill_chunk=16, prefill_token_budget=32)
N_REQUESTS, NEW_TOKENS, PROMPT = 4, 8, 40
PREFILL_REL = {"float32": 1e-5, "bfloat16": 5e-2}


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


def world_of(axes):
    return int(np.prod(list(axes.values())))


def base_kw(key):
    return {"max_seq_len": 96, "vocab_size": 64, "compute_dtype": "float32",
            "param_dtype": "float32", **CONFIGS[key]}


def requests():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, (int(rng.integers(3, 24)),)).tolist()
            for _ in range(N_REQUESTS)]


def prompt():
    return np.random.default_rng(1).integers(0, 64, (PROMPT,)).tolist()


def rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the JAX side ----------------------------------------------------------------


def jax_checkpoint(path, key):
    import jax

    from pyrecover_tpu.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu.config import TrainConfig
    from pyrecover_tpu.models import ModelConfig
    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.train_state import create_train_state

    cfg = ModelConfig().tiny(**base_kw("moe" if key == "moe" else "dense"))
    optimizer, _ = build_optimizer(TrainConfig())
    save_ckpt_vanilla(path, create_train_state(jax.random.key(0), cfg, optimizer), {})


def jax_serve(path, axes, key):
    """JAX's restore onto ``MeshConfig(**axes)`` (None: one device), its
    paged prefill of `prompt` and its engine's greedy tokens."""
    import jax
    import jax.numpy as jnp

    from pyrecover_tpu.models import ModelConfig
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.serving import BlockPool, ServingConfig, ServingEngine
    from pyrecover_tpu.serving import load_serving_params, paged_forward
    from pyrecover_tpu.serving.kvpool import make_block_table

    cfg = ModelConfig().tiny(**base_kw(key))
    mesh = None
    if axes is not None:
        mesh = create_mesh(MeshConfig(**{"data": 1, **axes}),
                           devices=jax.devices()[:world_of(axes)])
    params, info = load_serving_params(path, cfg, mesh=mesh)
    pool = BlockPool(cfg, 8, SERVE["block_size"])
    table = make_block_table(pool.table_width(cfg.max_seq_len), pool.alloc(0, 6))[None]
    logits, _ = paged_forward(params, pool.arrays, jnp.asarray([prompt()]),
                              jnp.asarray([0], jnp.int32), jnp.asarray(table), cfg,
                              block_size=SERVE["block_size"])
    engine = ServingEngine(params, cfg, ServingConfig(**SERVE))
    rids = [engine.submit(p, NEW_TOKENS) for p in requests()]
    engine.run_until_drained()
    boxes = None
    if mesh is not None:
        boxes = jax_boxes(params, mesh)
    return {"info": info, "logits": np.asarray(logits[0]),
            "tokens": [engine.result(r) for r in rids], "boxes": boxes}


def jax_boxes(params, mesh):
    """``{rank: {leaf: value}}``: the slice of each leaf JAX placed on the
    device at the mesh position of the port's rank of that index."""
    from pyrecover_tpu_torch.parallel.mesh import MESH_AXES, coords_of

    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = {}
    for rank in range(mesh.devices.size):
        coords = coords_of(rank, shape)
        device = mesh.devices[tuple(coords.get(a, 0) for a in MESH_AXES)]
        leaves = {}
        for key in ("tok_embed", "output", "final_norm"):
            leaves[key] = _slice(params[key], device)
        for key, value in params["layers"].items():
            leaves[f"layers/{key}"] = _slice(value, device)
        out[rank] = leaves
    return out


def _slice(arr, device):
    index = arr.sharding.devices_indices_map(arr.shape)[device]
    return np.asarray(arr)[index]


# ---- the port's ranks ------------------------------------------------------------


def _local_tree(model):
    """This rank's parameters as numpy, layer leaves stacked."""
    def np_of(t):
        return t.detach().float().numpy()

    tree = {key: np_of(getattr(model, key)) for key in ("tok_embed", "output", "final_norm")}
    for key, _ in model.layers[0].named_parameters(recurse=False):
        tree[f"layers/{key}"] = np.stack([np_of(getattr(layer, key)) for layer in model.layers])
    return tree


def _config(key):
    from pyrecover_tpu_torch.models.llama import ModelConfig

    return ModelConfig().tiny(**base_kw(key))


def _serve_worker(args):
    """Each run of ``args["runs"]`` on this rank: the restore's figures and
    this rank's weights, the paged prefill of `prompt` (every rank, the same
    inputs), the engine's greedy tokens (rank 0 pumps, the others follow);
    then the hot swap and the failure legs where named."""
    from pyrecover_tpu_torch.models.decode import kv_layout
    from pyrecover_tpu_torch.parallel import mesh as meshmod
    from pyrecover_tpu_torch.serving import (
        BlockPool,
        ServingConfig,
        ServingEngine,
        load_serving_params,
        paged_forward,
    )
    from pyrecover_tpu_torch.serving.kvpool import make_block_table

    meshmod.initialize_distributed(required=True, device_type="cpu")
    rank = meshmod.rank()
    d = Path(args["dir"])
    out = {}
    for name, run in args["runs"].items():
        if name == "swap":
            out[name] = _swap_leg(d, run)
            continue
        if name == "fail":
            out[name] = _fail_leg(d)
            continue
        mesh = meshmod.build_mesh(meshmod.MeshConfig(**{"data": 1, **run["axes"]}).shape(
            meshmod.world_size()))
        cfg = _config(run["key"])
        model, info = load_serving_params(d / run["ckpt"], cfg, device="cpu", mesh=mesh)
        np.savez(d / f"{name}_rank{rank}.npz", **_local_tree(model))
        pool = BlockPool(cfg, 8, SERVE["block_size"], device="cpu", **kv_layout(model))
        table = make_block_table(pool.table_width(cfg.max_seq_len), pool.alloc(0, 6))[None]
        logits = paged_forward(model, pool.arrays, [prompt()], [0], table,
                               block_size=SERVE["block_size"])[0]
        engine = ServingEngine(model, ServingConfig(**SERVE))
        if rank == 0:
            rids = [engine.submit(p, NEW_TOKENS) for p in requests()]
            engine.run_until_drained()
            engine.release_followers()
            tokens = [engine.result(r) for r in rids]
            np.save(d / f"{name}_logits.npy", logits.numpy())
        else:
            try:
                engine.submit([1, 2, 3], 2)
                raise AssertionError("submit() on a follower did not raise")
            except RuntimeError as e:
                assert "rank 0 owns admission" in str(e)
            engine.follow()
            tokens = None
        engine.pool.check_drained()
        out[name] = {"info": {k: info[k] for k in ("resharded_leaves", "plan_bytes_moved")},
                     "tokens": tokens, "steps": engine.steps_run,
                     "pool_shape": list(pool.arrays["k"].shape)}
    meshmod.destroy_distributed()
    return out


def _swap_leg(d, run):
    """(d): serve ckpt_1 at tensor 2, hot-swap to ckpt_2 with requests in
    flight, then serve the probe; a cold restore of ckpt_2 serves it again.
    Returns this rank's flips and rank 0's tokens."""
    from pyrecover_tpu_torch.parallel import mesh as meshmod
    from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine, load_serving_params
    from pyrecover_tpu_torch.serving.hotswap import HotSwapper

    mesh = meshmod.build_mesh(meshmod.MeshConfig(data=1, tensor=2).shape(2))
    cfg = _config("dense")
    exp = d / "swap"
    host = {}
    model, _ = load_serving_params(exp / "ckpt_1.zs.json", cfg, device="cpu", mesh=mesh,
                                   host_bytes=host)
    engine = ServingEngine(model, ServingConfig(**SERVE))
    swapper = HotSwapper(engine, exp, cfg, loaded_path=exp / "ckpt_1.zs.json",
                         loaded_host=host, mesh=mesh)
    probe = requests()[:2]
    out = {}
    if meshmod.rank() == 0:
        first = [engine.submit(p, NEW_TOKENS) for p in requests()]
        engine.step()
        assert swapper.swap_to(exp / "ckpt_2.zs.json")
        engine.run_until_drained()
        while engine.weights_step != 2:  # the followers' fetch may outlast the requests
            engine.step()
        second = [engine.submit(p, NEW_TOKENS) for p in probe]
        engine.run_until_drained()
        engine.release_followers()
        out["before"] = [engine.result(r) for r in first]
        out["after"] = [engine.result(r) for r in second]
    else:
        engine.follow()
        swapper.join_fetch()
    out["flips"] = engine.flips
    cold, _ = load_serving_params(exp / "ckpt_2.zs.json", cfg, device="cpu", mesh=mesh)
    cold_engine = ServingEngine(cold, ServingConfig(**SERVE))
    if meshmod.rank() == 0:
        rids = [cold_engine.submit(p, NEW_TOKENS) for p in probe]
        cold_engine.run_until_drained()
        cold_engine.release_followers()
        out["cold"] = [cold_engine.result(r) for r in rids]
    else:
        cold_engine.follow()
    return out


def _fail_leg(d):
    """A follower whose third forward raises: both ranks raise
    MeshServingError and rank 0 returns no result."""
    from pyrecover_tpu_torch.parallel import mesh as meshmod
    from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine, load_serving_params
    from pyrecover_tpu_torch.serving.engine import MeshServingError

    mesh = meshmod.build_mesh(meshmod.MeshConfig(data=1, tensor=2).shape(2))
    model, _ = load_serving_params(d / "dense.ckpt", _config("dense"), device="cpu", mesh=mesh)
    engine = ServingEngine(model, ServingConfig(**SERVE))
    if meshmod.rank() == 1:
        real = engine._run_forward

        def broken(*a):
            if engine.steps_run == 2:
                raise ValueError("planted follower fault")
            return real(*a)
        engine._run_forward = broken
    try:
        if meshmod.rank() == 0:
            rids = [engine.submit(p, NEW_TOKENS) for p in requests()]
            engine.run_until_drained()
            return {"raised": None, "results": [engine.result(r) for r in rids]}
        engine.follow()
        return {"raised": None}
    except MeshServingError as e:
        return {"raised": str(e), "steps": engine.steps_run}


# ---- the runs ----------------------------------------------------------------------


def port_swap_checkpoints(exp):
    """Two zerostall manifests of a port model at other weights (steps 1, 2)."""
    from pyrecover_tpu_torch.checkpoint.zerostall import save_ckpt_zerostall
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import state_leaves

    exp.mkdir(parents=True)
    for step in (1, 2):
        model = Transformer(_config("dense"), generator=torch.Generator().manual_seed(step))
        optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
        save_ckpt_zerostall(exp / f"ckpt_{step}.zs.json",
                            state_leaves(model, optimizer, step=step),
                            extra_meta={"step": step}, background=False)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    for key in ("dense", "moe"):
        jax_checkpoint(tmp / f"{key}.ckpt", key)
    port_swap_checkpoints(tmp / "swap")
    jax_out = {name: jax_serve(tmp / f"{'moe' if key == 'moe' else 'dense'}.ckpt", axes, key)
               for name, (axes, key) in MESHES.items()}
    jax_out["one"] = jax_serve(tmp / "dense.ckpt", None, "dense")
    runs = {2: {}, 4: {}}
    for name, (axes, key) in MESHES.items():
        runs[world_of(axes)][name] = {"axes": axes, "key": key,
                                      "ckpt": "moe.ckpt" if key == "moe" else "dense.ckpt"}
    runs[2]["swap"] = {}
    runs[2]["fail"] = {}  # last: it leaves the process group
    outs = {}
    for world, named in runs.items():
        per_rank = spawn("serve", {"dir": str(tmp), "runs": named}, world=world, timeout=240)
        for name in named:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


@pytest.mark.parametrize("name", list(MESHES))
def test_restore_plan_and_boxes_equal_jax(mesh_runs, name):
    """(a): the plan's figures are JAX's, and each rank holds the box JAX
    places on the device at its mesh position, bit for bit."""
    tmp, jax_out, outs = mesh_runs
    want = jax_out[name]
    for rank, out in enumerate(outs[name]):
        assert out["info"] == {k: want["info"][k]
                               for k in ("resharded_leaves", "plan_bytes_moved")}
        assert out["info"]["plan_bytes_moved"] > 0
        with np.load(tmp / f"{name}_rank{rank}.npz") as got:
            boxes = want["boxes"][rank]
            assert sorted(got.files) == sorted(boxes)
            for key in got.files:
                w = torch.from_numpy(np.array(boxes[key], np.float32))
                if name.endswith("bf16") and key.split("/")[-1] in MATRIX_KEYS:
                    w = w.to(torch.bfloat16).float()  # the restore casts matrices once
                np.testing.assert_array_equal(got[key], w.numpy(), err_msg=f"{name} rank {rank} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_serves_what_jax_serves(mesh_runs, name):
    """(b): rank 0's paged prefill logits within the dtype's limit of JAX's
    on the same mesh; at fp32 the engine's greedy tokens equal JAX's."""
    tmp, jax_out, outs = mesh_runs
    want = jax_out[name]
    dtype = "bfloat16" if name.endswith("bf16") else "float32"
    got = np.load(tmp / f"{name}_logits.npy")
    assert rel_norm(got, want["logits"]) <= PREFILL_REL[dtype]
    if dtype == "float32":
        assert outs[name][0]["tokens"] == want["tokens"]
        assert want["tokens"] == jax_out["one"]["tokens"] or MESHES[name][1] != "dense"
    # every rank ran every lockstep step, against its own part of the pool
    assert len({o["steps"] for o in outs[name]}) == 1
    axes = MESHES[name][0]
    layers = 2 // axes.get("pipeline", 1)
    heads = 2 // axes.get("tensor", 1)
    for out in outs[name]:
        assert out["pool_shape"][0] == layers and out["pool_shape"][3] == heads


def test_hot_swap_on_a_tensor_mesh_flips_every_rank_at_one_step(mesh_runs):
    """(d): the requests after the flip serve what a cold restore of the new
    manifest serves on the same mesh, and both ranks flip at one step."""
    _, _, outs = mesh_runs
    rank0, rank1 = outs["swap"]
    assert rank0["flips"] == rank1["flips"] and [s for _, s in rank0["flips"]] == [2]
    assert rank0["after"] == rank0["cold"]
    assert all(len(t) > 3 for t in rank0["before"])


def test_a_failing_follower_makes_every_rank_raise(mesh_runs):
    _, _, outs = mesh_runs
    rank0, rank1 = outs["fail"]
    assert "rank 1 failed at lockstep step 2" in rank1["raised"]
    assert "planted follower fault" in rank1["raised"]
    assert rank0["raised"] and "results" not in rank0


# ---- the preflight, in one process ------------------------------------------------


def _fake_mesh(axes):
    from pyrecover_tpu_torch.parallel.mesh import DeviceMesh

    return DeviceMesh(axes, 0)


@pytest.mark.parametrize("axes,rule", [({"tensor": 3}, "SC11"), ({"expert": 3}, "SC11"),
                                       ({"tensor": 2}, "SC05")])
def test_infeasible_mesh_raises_before_any_read(tmp_path, monkeypatch, axes, rule):
    """(c): an indivisible mesh raises SC11 and an impossible budget SC05,
    with no tensor read and no model built; JAX's preflight finds the same
    rule on the same mesh."""
    from pyrecover_tpu_torch.checkpoint.elastic import HBM_BYTES_ENV
    from pyrecover_tpu_torch.serving import ServingRestoreError, restore

    key = "moe" if "expert" in axes else "dense"
    path = tmp_path / "c.ckpt"
    jax_checkpoint(path, key)
    if rule == "SC05":
        monkeypatch.setenv(HBM_BYTES_ENV, "1024")
    monkeypatch.setattr(restore, "serving_model", lambda *a: pytest.fail("model built"))
    with pytest.raises(ServingRestoreError, match=rule):
        restore.load_serving_params(path, _config(key), device="cpu", mesh=_fake_mesh(axes))
    if rule == "SC11" and "tensor" in axes:
        import jax

        from pyrecover_tpu.models import ModelConfig
        from pyrecover_tpu.serving import ServingRestoreError as JaxError
        from pyrecover_tpu.serving import load_serving_params as jax_load
        from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh

        mesh = create_mesh(MeshConfig(data=1, tensor=3), devices=jax.devices()[:3])
        with pytest.raises(JaxError, match="SC11"):
            jax_load(path, ModelConfig().tiny(**base_kw(key)), mesh=mesh)


def test_serving_topology_and_specs_equal_jax(tmp_path):
    """The preflight's target topology and specs are JAX's on a mesh of the
    same shape (the process count aside: JAX's single controller is one)."""
    import jax

    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.serving import restore as jax_restore
    from pyrecover_tpu_torch.checkpoint.elastic import read_saved_meta
    from pyrecover_tpu_torch.checkpoint.manifest import manifest_from_ckpt_meta
    from pyrecover_tpu_torch.serving import restore

    path = tmp_path / "c.ckpt"
    jax_checkpoint(path, "dense")
    manifest = manifest_from_ckpt_meta(read_saved_meta(path))
    for axes in ({"tensor": 2}, {"pipeline": 2, "fsdp": 2}):
        jmesh = create_mesh(MeshConfig(**{"data": 1, **axes}),
                            devices=jax.devices()[:world_of(axes)])
        mesh = _fake_mesh(axes)
        want = jax_restore.serving_topology(jmesh)
        got = restore.serving_topology(mesh)
        assert (got["devices"], got["mesh"]) == (want["devices"], want["mesh"])
        jspecs = jax_restore.serving_target_specs(manifest, jmesh)
        assert restore.serving_target_specs(manifest, mesh) == json.loads(json.dumps(jspecs))
    assert restore.serving_target_specs(manifest, None) == jax_restore.serving_target_specs(
        manifest, None)


def test_int8_scales_are_per_head():
    """A pool split over the kv heads keeps, for each held head, the scales
    the whole pool keeps: int8 quantises one scale per head per token."""
    from pyrecover_tpu_torch.serving.paged import _append_block_kv

    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(np.float32))
            for _ in range(2))
    phys = torch.tensor([[1, 1, 1, 1, 1]])
    off = torch.arange(5)[None]

    def pool(heads):
        return {"k": torch.zeros(3, 8, heads, 16, dtype=torch.int8),
                "v": torch.zeros(3, 8, heads, 16, dtype=torch.int8),
                "k_scale": torch.ones(3, 8, heads), "v_scale": torch.ones(3, 8, heads)}

    whole = pool(4)
    _append_block_kv(whole, k, v, phys, off, "int8")
    for piece in range(2):
        part = pool(2)
        heads = slice(2 * piece, 2 * piece + 2)
        _append_block_kv(part, k[:, :, heads], v[:, :, heads], phys, off, "int8")
        for name in part:
            torch.testing.assert_close(part[name], whole[name][:, :, heads], rtol=0, atol=0)


def test_entry_points_raise_without_a_card():
    """The mesh restore runs on the card unless the CPU is asked for."""
    from pyrecover_tpu_torch.serving import load_serving_params

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        load_serving_params("missing.ckpt", _config("dense"), mesh=_fake_mesh({"tensor": 2}))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    result = {"serve": _serve_worker}[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
