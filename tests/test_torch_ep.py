"""The expert axis of the port (``parallel/mesh.py``'s expert groups,
``parallel/sharding.py``'s expert slices, ``models/moe.py``'s sharded
dispatch, the mesh step and the optimizer over expert slices), held to the
JAX package's.

* The EP function: ``_moe_ffn_grouped_ep`` on 2 gloo ranks (ep 2) and on 4
  (ep 2 x tp 2) against JAX's on as many of the suite's virtual CPU
  devices, with capacity drops forced (cf 0.6), as JAX's
  ``test_grouped_ep_gradients_match_scatter``: ``y``, ``aux`` and the
  gradients of ``h``, ``router_w``, ``w1``, ``w3`` and ``w2`` of
  ``sum(y**2) + mean(aux)`` within rtol 1e-4, atol 1e-5. The same run with
  the backward sum over expert x tensor dropped or doubled misses JAX's
  ``h`` and router gradients by far more.
* The step at ``MeshConfig(expert=2)``, ``(data=2, expert=2)``,
  ``(expert=2, tensor=2)``, ``(fsdp=2, expert=2)`` and the MoE model at
  ``(fsdp=2)`` and ``(tensor=2)``: JAX's on 2 or 4 virtual CPU devices and
  the port's on as many gloo ranks, from JAX's initial weights, 4 fp32
  steps. Losses, gradient norms and aux within ``LOSS_RTOL`` (1e-4), the
  label counts equal; the final parameters at tests/test_torch_wire.py's
  policy. ``MEASURED`` records each run's share.
* Inside the port: ``grouped``, ``scatter`` and ``einsum`` at ep 2 agree
  with each other and with ep 1 (dp 2) step for step within
  ``PORT_ONLY_RTOL``; each rank holds E/ep experts of every ``moe_w*`` leaf,
  parameters and moments (JAX's
  ``test_expert_weights_sharded_over_expert_axis``); zero1 at data 2 x
  expert 2 equals it without zero1 bit for bit.
* The transfer-guard probe (``python tests/test_torch_ep.py guard-probe``,
  two gloo ranks on the card: does gloo's CUDA staging trip
  ``--transfer-guard disallow``?) runs on the CPU and exits 2 without a card.
* The guards raise as JAX's ``test_grouped_ep_guards``; ``auto``'s pick at
  ep 2 is JAX's slot-size rule (``scatter`` at fp32); the composition rules
  of ``--ep`` as JAX's config; remat ``auto``'s table at the ep meshes
  and the elastic plans ep 2 -> 1, 1 -> 2 and fsdp 2 -> ep 2 equal JAX's.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import spawn as _spawn
from test_torch_fsdp_tp import load_tree, save_tree, write_batches
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
)

MOE = dict(n_experts=4, moe_top_k=2)
# name -> JAX MeshConfig fields (the port runs as many gloo ranks)
MESHES = {"ep2": dict(data=1, expert=2), "dp2-ep2": dict(data=2, expert=2),
          "ep2-tp2": dict(data=1, tensor=2, expert=2), "fsdp2-ep2": dict(data=1, fsdp=2, expert=2),
          "moe-fsdp2": dict(data=1, fsdp=2), "moe-tp2": dict(data=1, tensor=2)}
FN_RTOL, FN_ATOL = 1e-4, 1e-5
# the port's backends at ep 2 and ep 1 against each other: the same function
# summed in other orders (fp32)
PORT_ONLY_RTOL = 1e-5
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
    return int(np.prod([mesh_kw.get(a, 1) for a in ("data", "fsdp", "tensor", "expert")]))


def jax_moe_config():
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig

    return JaxTrainConfig(model=JaxModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ, **MOE),
                          sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                          lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32")


def jax_moe_mesh_run(batches, mesh_kw, steps=None):
    """JAX's MoE step on ``MeshConfig(**mesh_kw)``: per-step metrics, the
    initial params (numpy), the final state as numpy and each step's
    state."""
    import jax

    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu.train_state import make_train_step

    jcfg = jax_moe_config()
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


# ---- (a) the EP function -----------------------------------------------------------


def fn_inputs(seed=3):
    """JAX's gradient-pin inputs at the tiny MoE shape, drawn with numpy:
    ``(cfg fields, h, router, w1, w3, w2)``, cf 0.6 to force drops."""
    from pyrecover_tpu_torch.models.llama import ModelConfig

    cfg = ModelConfig().tiny(max_seq_len=SEQ, vocab_size=VOCAB, moe_capacity_factor=0.6,
                             compute_dtype="float32", **MOE)
    E, D, F = cfg.n_experts, cfg.dim, cfg.expert_hidden_dim
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((8, SEQ, D)), rng.standard_normal((D, E)) * 0.5,
              rng.standard_normal((E, D, F)) * 0.02, rng.standard_normal((E, D, F)) * 0.02,
              rng.standard_normal((E, F, D)) * 0.02]
    return cfg, [a.astype(np.float32) for a in arrays]


def jax_fn(mesh_kw, arrays):
    """JAX's ``_moe_ffn_grouped_ep`` on ``mesh_kw``: ``(y, aux, grads)``."""
    import jax
    import jax.numpy as jnp

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.moe import _moe_ffn_grouped_ep
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh

    cfg = JaxModelConfig().tiny(max_seq_len=SEQ, vocab_size=VOCAB, moe_capacity_factor=0.6,
                                **MOE)
    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:world_of(mesh_kw)])

    def loss(*a):
        y, aux = _moe_ffn_grouped_ep(*a, cfg, mesh)
        return jnp.sum(y ** 2) + jnp.mean(aux), (y, aux)

    with jax.sharding.set_mesh(mesh):
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                          has_aux=True))(*map(jnp.asarray, arrays))
    return np.asarray(y), np.asarray(aux), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def fn_runs(tmp_path_factory):
    """The EP function at ep 2 and ep 2 x tp 2, JAX's and the port's (the
    port's also with the backward sum dropped and doubled)."""
    tmp = tmp_path_factory.mktemp("ep_fn")
    _, arrays = fn_inputs()
    np.savez(tmp / "fn.npz", *arrays)
    out = {}
    for name, kw, world in (("ep2", dict(data=1, expert=2), 2),
                            ("ep2-tp2", dict(data=1, tensor=2, expert=2), 4)):
        modes = ["ok", "drop", "double"] if name == "ep2" else ["ok"]
        port = spawn("fn", {"dir": str(tmp), "mesh": kw, "modes": modes}, world=world,
                     timeout=180)
        out[name] = (jax_fn(kw, arrays), port)
    return out


def _assemble(per_rank, mode, which):
    """The whole ``which`` gradient from the ranks' slices (their boxes)."""
    first = per_rank[0][mode][which]
    full = np.zeros(first["shape"], np.float32)
    for r in per_rank:
        g = r[mode][which]
        full[tuple(slice(a, a + n) for a, n in g["box"])] = np.asarray(g["value"], np.float32)
    return full


GRADS = ("h", "router", "w1", "w3", "w2")


@pytest.mark.parametrize("name", ["ep2", "ep2-tp2"])
def test_grouped_ep_function_matches_jax(fn_runs, name):
    (y, aux, grads), port = fn_runs[name]
    for r in port:  # every rank returns the whole output and aux
        np.testing.assert_allclose(np.asarray(r["ok"]["y"]), y, rtol=FN_RTOL, atol=FN_ATOL)
        np.testing.assert_allclose(np.asarray(r["ok"]["aux"]), aux, rtol=FN_RTOL, atol=FN_ATOL)
    for which, want in zip(GRADS, grads):
        np.testing.assert_allclose(_assemble(port, "ok", which), want, rtol=FN_RTOL,
                                   atol=FN_ATOL, err_msg=which)


@pytest.mark.parametrize("mode", ["drop", "double"])
def test_grouped_ep_backward_sum_is_needed(fn_runs, mode):
    """Without the backward's sum over expert x tensor (or with it taken
    twice) each rank's ``h`` and router gradients miss JAX's; the expert
    weights' do not depend on it."""
    (_, _, grads), port = fn_runs["ep2"]
    for which, want in zip(GRADS, grads):
        got = _assemble(port, mode, which)
        off = np.abs(got - want).max() / np.abs(want).max()
        if which in ("h", "router"):
            assert off > 1e-2, (which, off)
        else:
            np.testing.assert_allclose(got, want, rtol=FN_RTOL, atol=FN_ATOL, err_msg=which)


# ---- (b)-(d) the step --------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """JAX's and the port's runs at every mesh of ``MESHES``, and the port's
    backends at ep 2, dp 2 and zero1 beside them, from the same weights and
    batches."""
    tmp = tmp_path_factory.mktemp("ep_step")
    batches = jax_batches(STEPS)
    write_batches(tmp, batches)
    jax_out = {name: jax_moe_mesh_run(batches, kw) for name, kw in MESHES.items()}
    save_tree(tmp / "init.npz", jax_out["ep2"][1])
    for name, (_, init, _, _) in jax_out.items():  # one seed: one set of weights
        for a, b in zip(_flat(init), _flat(jax_out["ep2"][1])):
            np.testing.assert_array_equal(a, b)
    two = {name: {"mesh": MESHES[name]} for name in ("ep2", "moe-fsdp2", "moe-tp2")}
    two.update({"ep2-grouped": {"mesh": MESHES["ep2"], "dispatch": "grouped"},
                "ep2-einsum": {"mesh": MESHES["ep2"], "dispatch": "einsum"},
                "dp2": {"mesh": dict(data=2)}})
    four = {name: {"mesh": MESHES[name]} for name in ("dp2-ep2", "ep2-tp2", "fsdp2-ep2")}
    four["dp2-ep2-zero1"] = {"mesh": MESHES["dp2-ep2"], "kw": {"optimizer_sharding": "zero1"}}
    outs = {}
    for runs, world in ((two, 2), (four, 4)):
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=240)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


def _flat(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("name", list(MESHES))
def test_ep_mesh_step_matches_jax(mesh_runs, name):
    tmp, jax_out, outs = mesh_runs
    jm, _, jstate, _ = jax_out[name]
    for out in outs[name]:  # every rank logs the global loss
        assert len(out["metrics"]) == STEPS
        for step, (a, b) in enumerate(zip(out["metrics"], jm)):
            for key in ("loss", "grad_norm", "moe_aux"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                           err_msg=f"{key} step {step}")
            assert a["n_tokens"] == b["n_tokens"]
    MEASURED[name] = assert_close_by_share(_flat(load_tree(tmp / f"final_{name}.npz")),
                                           _flat(jstate.params), f"{name} params")


@pytest.mark.parametrize("name", ["ep2-grouped", "ep2-einsum", "dp2"])
def test_ep2_backends_agree_with_each_other_and_ep1(mesh_runs, name):
    """At ep 2 the ``auto`` backend at fp32 is ``scatter``; ``grouped`` and
    ``einsum`` and ep 1 (dp 2, one process's backend) train the same run."""
    tmp, _, outs = mesh_runs
    ref = outs["ep2"][0]["metrics"]
    for a, b in zip(outs[name][0]["metrics"], ref):
        for key in ("loss", "grad_norm", "moe_aux"):
            assert abs(a[key] - b[key]) <= PORT_ONLY_RTOL * abs(b[key]), (key, a, b)
    MEASURED[f"{name}_vs_ep2"] = assert_close_by_share(
        _flat(load_tree(tmp / f"final_{name}.npz")), _flat(load_tree(tmp / "final_ep2.npz")),
        f"{name} vs ep2 params")


@pytest.mark.parametrize("name", ["ep2", "dp2-ep2", "ep2-tp2", "fsdp2-ep2"])
def test_each_rank_holds_its_experts(mesh_runs, name):
    """Every ``moe_w*`` leaf, parameters and moments, holds E/ep experts on
    every rank (each cut further by fsdp and tensor); the router and the
    norms stay whole."""
    _, _, outs = mesh_runs
    kw = MESHES[name]
    ep = kw["expert"]
    for out in outs[name]:
        for path, (share, local_experts) in out["held"].items():
            if "moe_w" in path:
                assert local_experts == MOE["n_experts"] // ep, path
                assert share == pytest.approx(1 / (ep * kw.get("fsdp", 1) * kw.get("tensor", 1)))
            elif "router" in path or "norm" in path:
                assert share == 1.0, path
        assert any(p.startswith(".opt_state") and "moe_w1" in p for p in out["held"])


def test_zero1_with_ep_equals_ep(mesh_runs):
    """zero1 on data 2 x expert 2 (JAX composes zero1 with the expert axis)
    trains bit for bit as without it, with half of each expert slice's
    moments on every data rank."""
    tmp, _, outs = mesh_runs
    for plain, z1 in zip(outs["dp2-ep2"], outs["dp2-ep2-zero1"]):
        assert plain["metrics"] == z1["metrics"]
        path = ".opt_state[1][0].mu['layers']['moe_w1']"
        assert z1["held"][path][0] == pytest.approx(plain["held"][path][0] / 2)
    with np.load(tmp / "final_dp2-ep2.npz") as a, np.load(tmp / "final_dp2-ep2-zero1.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---- (e) guards and rules ------------------------------------------------------------


class _StubMesh:
    """A mesh's shape and coordinates, without groups (the guards raise
    before any collective)."""

    def __init__(self, **shape):
        self.shape = shape
        self.coords = {a: 0 for a in shape}
        self.model_sharded = True

    def group(self, name):
        return None


def test_grouped_ep_guards():
    """JAX's ``test_grouped_ep_guards`` on both packages: a sharded sequence
    axis and an expert count the expert axis does not divide raise."""
    import jax
    import jax.numpy as jnp

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.moe import _moe_ffn_grouped_ep as jax_ep
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.models.moe import _moe_ffn_grouped_ep

    jcfg = JaxModelConfig().tiny(max_seq_len=SEQ, vocab_size=VOCAB, **MOE)
    cfg = ModelConfig().tiny(max_seq_len=SEQ, vocab_size=VOCAB, **MOE)
    D, F = cfg.dim, cfg.expert_hidden_dim
    for E, mesh_kw, match in ((4, dict(data=2, sequence=2, expert=2), "sequence"),
                              (3, dict(data=4, expert=2), "n_experts")):
        ws = [np.zeros((E, D, F), np.float32), np.zeros((E, D, F), np.float32),
              np.zeros((E, F, D), np.float32)]
        h, router = np.zeros((8, SEQ, D), np.float32), np.zeros((D, E), np.float32)
        jmesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:8])
        with pytest.raises(ValueError, match=match):
            jax_ep(jnp.asarray(h), jnp.asarray(router), *map(jnp.asarray, ws),
                   dataclasses.replace(jcfg, n_experts=E), jmesh)
        with pytest.raises(ValueError, match=match):
            _moe_ffn_grouped_ep(torch.from_numpy(h), torch.from_numpy(router),
                                *map(torch.from_numpy, ws), dataclasses.replace(cfg, n_experts=E),
                                _StubMesh(**mesh_kw))


@pytest.mark.parametrize("seq,dtype", [(32, "bfloat16"), (4096, "bfloat16"), (32, "float32")])
def test_auto_pick_at_ep2_matches_jax(seq, dtype):
    """``auto`` at ep 2 on a data 4 x expert 2 mesh: JAX's slot-size rule
    (einsum up to 64 Mi slot elements a device, else scatter), which the
    port follows over its rank's rows; at fp32 the port keeps ``scatter``
    (its grouped products read their offsets on the host there)."""
    import jax
    import jax.numpy as jnp

    import pyrecover_tpu.models.moe as jax_moe
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.models.moe import dispatch_backend

    jcfg = JaxModelConfig().tiny(max_seq_len=seq, vocab_size=VOCAB, **MOE)
    E, D, F = jcfg.n_experts, jcfg.dim, jcfg.expert_hidden_dim
    picked = []
    names = {"_moe_ffn_impl": "scatter", "_moe_ffn_einsum": "einsum",
             "_moe_ffn_grouped": "grouped", "_moe_ffn_grouped_ep": "grouped"}
    real = {name: getattr(jax_moe, name) for name in names}
    try:
        for name in names:
            setattr(jax_moe, name, lambda *a, _n=name, **kw: picked.append(names[_n])
                    or real[_n](*a, **kw))
        mesh = create_mesh(MeshConfig(data=4, expert=2), devices=jax.devices()[:8])
        with jax.sharding.set_mesh(mesh):
            jax.eval_shape(lambda *a: jax_moe.moe_ffn(*a, jcfg),
                           jax.ShapeDtypeStruct((8, seq, D), jnp.float32),
                           jax.ShapeDtypeStruct((D, E), jnp.float32),
                           jax.ShapeDtypeStruct((E, D, F), jnp.float32),
                           jax.ShapeDtypeStruct((E, D, F), jnp.float32),
                           jax.ShapeDtypeStruct((E, F, D), jnp.float32))
    finally:
        for name, fn in real.items():
            setattr(jax_moe, name, fn)
    cfg = ModelConfig().tiny(max_seq_len=seq, vocab_size=VOCAB, compute_dtype=dtype, **MOE)
    got = dispatch_backend(cfg, _StubMesh(data=4, expert=2), rows=8 // 4, seq_len=seq)
    assert got == (picked[0] if dtype == "bfloat16" else "scatter"), (picked, got)
    assert picked[0] == ("einsum" if seq == 32 else "scatter")
    assert dispatch_backend(cfg, _StubMesh(data=4, expert=1), 2, seq) == (
        "grouped" if dtype == "bfloat16" else "scatter")


BASE = ["--device", "cpu", "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
        "--model-kv-heads", "2", "--vocab-size", "128"]


@pytest.mark.parametrize("extra,err,match", [
    (["--ep", "2", "--grad-allreduce", "int8"], ValueError, "pure data-parallel replicas"),
    (["--ep", "2", "--moe-experts", "4", "--grad-bucket-mb", "4"], ValueError,
     "pure data-parallel replicas"),
    (["--ep", "3", "--moe-experts", "4"], ValueError, "n_experts % ep"),
    (["--sp", "2", "--moe-experts", "4"], None, "ring"),
    (["--pp", "2", "--ep", "2"], None, "sdpa"),
])
def test_ep_composition_rules_raise(extra, err, match):
    """The port raises where JAX's ``config.py:200-231`` does, with its
    wording for the wire and buckets at ep > 1; an expert count the expert
    axis does not divide raises before a weight is sliced; an MoE model
    over the sequence axis and the pipeline beside the expert axis resolve
    as JAX's (``err`` None: the axes and the attention JAX picks,
    ``match``)."""
    from pyrecover_tpu.config import get_args as jax_get_args
    from pyrecover_tpu_torch.config import get_args

    if err is None:
        port, ref = get_args(BASE + extra), jax_get_args(BASE[2:] + extra)
        assert (port.sp, port.pp, port.ep, port.model.n_experts) == (
            ref.mesh.sequence, ref.mesh.pipeline, ref.mesh.expert, ref.model.n_experts)
        assert port.model.attention_impl == ref.model.attention_impl == match
        return
    with pytest.raises(err, match=match):
        get_args(BASE + extra)
    if "pure data-parallel" in match:
        with pytest.raises(ValueError, match=match):
            jax_get_args(BASE[2:] + extra)


@pytest.mark.parametrize("extra", [["--ep", "2"], ["--ep", "2", "--moe-experts", "4"],
                                   ["--fsdp", "2", "--ep", "2", "--moe-experts", "4",
                                    "--optimizer-sharding", "zero1"],
                                   ["--tp", "2", "--moe-experts", "4"]])
def test_ep_settings_resolve_as_in_jax(extra):
    """``--ep`` (a dense model too: its expert peers replicate it, as JAX
    accepts) and an MoE model under the model axes parse in both packages;
    the mesh resolves the data axis as JAX's ``MeshConfig.resolve``."""
    from pyrecover_tpu.config import get_args as jax_get_args
    from pyrecover_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.parallel.mesh import MeshConfig

    port, jax_cfg = get_args(BASE + extra), jax_get_args(BASE[2:] + extra)
    assert (port.ep, port.fsdp, port.tp) == (jax_cfg.mesh.expert, jax_cfg.mesh.fsdp,
                                             jax_cfg.mesh.tensor)
    shape = MeshConfig(data=port.dp, fsdp=port.fsdp, tensor=port.tp, expert=port.ep).shape(8)
    p, d, f, t, s, e = JaxMeshConfig(data=-1, fsdp=port.fsdp, tensor=port.tp,
                                     expert=port.ep).resolve(8)
    assert shape == {"data": d, "fsdp": f, "tensor": t, "expert": e}


def test_mesh_expert_axis_in_jax_order():
    """Expert innermost: rank ((d·F + f)·T + t)·X + x, as JAX's device
    order; the batch group skips expert peers, the expert_tensor group is
    the MoE sum's and the model group holds one replica's slices."""
    from pyrecover_tpu_torch.parallel import mesh

    shape = mesh.MeshConfig(fsdp=2, tensor=2, expert=2).shape(16)
    assert shape == {"data": 2, "fsdp": 2, "tensor": 2, "expert": 2}
    assert [tuple(mesh.coords_of(r, shape).values()) for r in range(16)] == [
        (d, f, t, x) for d in range(2) for f in range(2) for t in range(2) for x in range(2)]
    assert mesh.group_ranks("expert", 5, shape) == [4, 5]
    assert mesh.group_ranks("expert_tensor", 5, shape) == [4, 5, 6, 7]
    assert mesh.group_ranks("batch", 5, shape) == [1, 5, 9, 13]
    assert mesh.group_ranks("model", 5, shape) == list(range(8))
    live = mesh.DeviceMesh(shape, 13)
    assert (live.batch_index, live.batch_shards) == (3, 4) and live.model_sharded
    with pytest.raises(ValueError, match="not divisible by pipeline\\*fsdp\\*tensor"):
        mesh.MeshConfig(expert=3).shape(4)
    assert mesh.topology(shape)["mesh"]["expert"] == 2


# ---- (f) remat and elastic ------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny-moe", "moe-8x1b"])
@pytest.mark.parametrize("mesh_kw", [dict(expert=2), dict(data=2, expert=2),
                                     dict(expert=2, tensor=2), dict(fsdp=2, expert=2)],
                         ids=["ep2", "dp2-ep2", "ep2-tp2", "fsdp2-ep2"])
def test_remat_auto_table_matches_jax_at_ep(preset, mesh_kw):
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.presets import PRESETS
    from pyrecover_tpu.utils import remat as jax_remat
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.utils import remat

    jmc = JaxModelConfig().tiny(**MOE) if preset == "tiny-moe" else PRESETS[preset]()
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pmc = ModelConfig(**{k: getattr(jmc, k) for k in fields if hasattr(jmc, k)})
    shape = {"data": 1, "fsdp": 1, "tensor": 1, "expert": 1, **mesh_kw}
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
    mesh.update(axes)
    mesh["data"] = n // int(np.prod(list(axes.values()) or [1]))
    return {"devices": n, "processes": n, "mesh": mesh}


TOPOLOGIES = {"ep2": _topo(2, expert=2), "ep1": _topo(1), "dp2": _topo(2),
              "fsdp2": _topo(2, fsdp=2), "dp2-ep2": _topo(4, expert=2)}


@pytest.mark.parametrize("saved,target", [("ep2", "ep1"), ("ep1", "ep2"), ("fsdp2", "ep2"),
                                          ("ep2", "dp2"), ("dp2-ep2", "fsdp2")])
def test_elastic_plan_matches_jax_at_ep(saved, target):
    """The port's plan over a manifest of the tiny MoE model's state (its
    leaves' rules as specs) equals JAX's, leaf for leaf, between expert
    topologies."""
    from pyrecover_tpu.checkpoint import elastic as jax_elastic
    from pyrecover_tpu_torch.checkpoint import elastic
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.parallel.sharding import spec_for_manifest_path
    from pyrecover_tpu_torch.train_state import param_leaves

    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ, **MOE),
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
    assert any("moe_w1" in lp.path and lp.src_grid != lp.tgt_grid for lp in want.leaves)
    for g, w in zip(got.leaves, want.leaves):
        assert (g.path, g.src_grid, g.tgt_grid, tuple(g.ops), g.reads_per_shard,
                g.moved_bytes, g.error) == (w.path, tuple(w.src_grid), tuple(w.tgt_grid),
                                            tuple(w.ops), w.reads_per_shard, w.moved_bytes,
                                            w.error)
    assert (got.resharded_leaves, got.bytes_moved, got.feasible) == (
        want.resharded_leaves, want.bytes_moved, want.feasible)


# ---- worker side -------------------------------------------------------------------


def ep_model_and_step(tree, mesh_kw, dispatch=None, **kw):
    """The tiny MoE model with JAX's weights ``tree``, sliced onto a live
    mesh of ``mesh_kw`` (its dispatch set in code, as JAX's tests set it),
    its optimizer and its step. Returns ``(model, step, mesh)``."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_from_jax
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.parallel.sharding import shard_model
    from pyrecover_tpu_torch.train_state import make_train_step

    model_cfg = ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ, **MOE)
    if dispatch:
        model_cfg = dataclasses.replace(model_cfg, moe_dispatch=dispatch)
    cfg = TrainConfig(model=model_cfg, sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                      lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32", device="cpu",
                      dp=mesh_kw.get("data", 1), fsdp=mesh_kw.get("fsdp", 1),
                      tp=mesh_kw.get("tensor", 1), ep=mesh_kw.get("expert", 1), **kw)
    shape = mesh.MeshConfig(data=cfg.dp, fsdp=cfg.fsdp, tensor=cfg.tp,
                            expert=cfg.ep).shape(mesh.world_size())
    model = Transformer(cfg.model)
    model.load_state_dict(params_from_jax(tree))
    live = mesh.build_mesh(shape)
    if live.model_sharded:
        shard_model(model, live)
    opt, _ = build_optimizer(cfg, model.parameters(), model=model)
    return model, make_train_step(model, opt), live


def _held(leaves):
    """``{leaf path: (the share of its elements this rank holds, the experts
    of its first part)}``."""
    return {leaf.path: (sum(p.numel() for p in leaf.parts) / float(np.prod(leaf.shape)),
                        int(leaf.parts[0].shape[0]))
            for leaf in leaves if isinstance(leaf.parts[0], torch.Tensor) and leaf.parts[0].dim()}


def _train_worker(args):
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.train_state import state_leaves

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    batches = _load_batches(d)
    out = {}
    for name, run in args["runs"].items():
        model, step, live = ep_model_and_step(load_tree(d / "init.npz"), run["mesh"],
                                              run.get("dispatch"), **run.get("kw", {}))
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


def _fn_worker(args):
    """The port's ``_moe_ffn_grouped_ep`` on this rank's slices of the
    inputs, for each of ``args["modes"]``: ``ok``; ``drop`` (the backward's
    sum over expert x tensor left out) or ``double`` (taken twice). Returns
    ``y``, ``aux`` and each gradient with this rank's box of it."""
    from pyrecover_tpu_torch.models import moe
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.parallel.sharding import leaf_box

    mesh.initialize_distributed(required=True, device_type="cpu")
    shape = mesh.MeshConfig(**args["mesh"]).shape(mesh.world_size())
    live = mesh.build_mesh(shape)
    cfg, _ = fn_inputs()
    with np.load(Path(args["dir"]) / "fn.npz") as z:
        arrays = [z[f"arr_{i}"] for i in range(5)]
    specs = [[None] * 3, [None] * 2, ["expert", "fsdp", "tensor"], ["expert", "fsdp", "tensor"],
             ["expert", "tensor", "fsdp"]]
    boxes = [leaf_box(spec, a.shape, live.shape, live.coords) for spec, a in zip(specs, arrays)]
    real_in = moe._ep_in
    out = {}
    for mode in args["modes"]:
        if mode == "drop":
            moe._ep_in = lambda x, group: x
        elif mode == "double":
            moe._ep_in = lambda x, group: real_in(real_in(x, group), group)
        ts = [torch.from_numpy(a[tuple(slice(s, s + n) for s, n in box)].copy()).requires_grad_()
              for a, box in zip(arrays, boxes)]
        y, aux = moe._moe_ffn_grouped_ep(*ts, cfg, live)
        ((y ** 2).sum() + aux.mean()).backward()
        moe._ep_in = real_in
        out[mode] = {"y": y.detach().numpy().tolist(), "aux": aux.detach().numpy().tolist()}
        for which, t, box, a in zip(GRADS, ts, boxes, arrays):
            out[mode][which] = {"value": t.grad.numpy().tolist(), "box": box,
                                "shape": list(a.shape)}
    mesh.destroy_distributed()
    return out


def _guard_probe_worker(args):
    """One rank of the transfer-guard probe: gloo's ``all_reduce`` and
    ``all_gather_into_tensor`` of a tensor on ``args["device"]`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (the port's ``--transfer-guard
    disallow``); ``{call: "silent" or the error}``."""
    import torch.distributed as dist

    cuda = args["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)  # both ranks on the one card, as chip_smoke's pairs
    dist.init_process_group("gloo")
    x = torch.ones(1024, device=torch.device("cuda", 0) if cuda else "cpu")
    calls = {"all_reduce": lambda: dist.all_reduce(x),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(x.new_empty(2048), x)}
    out = {}
    for name, call in calls.items():
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            out[name] = "silent"
        except RuntimeError as e:  # the finding: the guard fires
            out[name] = str(e)[:200]
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    dist.destroy_process_group()
    return out


def guard_probe_main(argv):
    """``python tests/test_torch_ep.py guard-probe [--device cuda|cpu]``:
    each rank's ``{call: "silent" or the error}`` as one JSON line; exits 2
    when ``--device cuda`` has no card."""
    import argparse

    ap = argparse.ArgumentParser(prog="test_torch_ep.py guard-probe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("guard-probe: no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    ranks = spawn("guard_probe", vars(args), timeout=120)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu", "torch": torch.__version__, "ranks": ranks}), flush=True)
    return 0


def test_guard_probe_on_the_cpu():
    """The probe's ranks run over gloo on the CPU (where no sync-debug mode
    applies, so every call is silent); without a card ``--device cuda``
    exits 2."""
    for rank in spawn("guard_probe", {"device": "cpu"}, timeout=120):
        assert rank == {"all_reduce": "silent", "all_gather_into_tensor": "silent"}
    if not torch.cuda.is_available():
        assert guard_probe_main(["--device", "cuda"]) == 2


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker, "fn": _fn_worker, "guard_probe": _guard_probe_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["guard-probe"]:
    sys.exit(guard_probe_main(sys.argv[2:]))
