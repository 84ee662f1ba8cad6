"""The MoE model over the sequence and pipeline axes (``models/moe.py``:
whole-row routing under ``--sp``, einsum dispatch inside a pipeline
stage), held to the JAX package's, mirroring ``tests/test_moe.py`` and
``tests/test_pipeline.py``'s MoE cases.

* ``dispatch_backend`` at every mesh of JAX's
  ``test_auto_dispatch_policy_matrix`` picks the backend JAX's ``moe_ffn``
  runs there (JAX's ``_moe_ffn_grouped`` and ``_moe_ffn_grouped_ep`` are
  the port's ``grouped`` over a rank's rows), and inside a pipeline stage
  ``einsum`` whatever was asked, as JAX's manual-region rule.
* The MoE step (the tiny model, 4 experts, top 2, fp32, 4 steps) from JAX's
  initial weights and batches: ``moe-pp2-ep2`` (gpipe over two stages, each
  rank 2 of 4 experts), ``moe-1f1b-pp2-packed`` (1F1B, M 4, packed rows:
  JAX's ``test_1f1b_composes_with_moe_and_packing_segments``),
  ``moe-ilv2-pp2-remat`` (interleaved V 2, full remat: JAX's
  ``test_interleaved_1f1b_composes_with_moe_and_remat``), ``moe-sp2`` and
  ``moe-sp2-tp2`` (rows routed whole across the sequence ranks, by the
  fp32 ``scatter`` dispatch), ``moe-sp2-einsum`` (the same by ``einsum``,
  which ``auto`` picks at bf16 under sp), and ``moe-sp2-grouped`` (an
  explicit ``grouped`` under sp: the same numbers, one warning a
  process). Every step's loss and gradient norm within 1e-4
  of JAX's single-device step, the aux within 1e-5, every parameter within
  JAX's ``rtol = atol = 2e-3``; the sequence meshes also against JAX's own
  ``data2-seq2-tensor2`` run.
* A negative control: ``moe-sp2-chunk`` routes each sequence chunk as if
  it were a row (capacity and aux per chunk, the port's routing before
  whole-row routing, monkeypatched in) and misses JAX.

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
from test_torch_pipeline import jax_mesh_run, port_model_and_step, world_of
from test_torch_pp_compose import assert_params_match, assert_steps_match
from test_torch_wire import BATCH, SEQ, STEPS, _load_batches, _to_torch, jax_batches

MOE = dict(n_experts=4, moe_top_k=2)
AUX_RTOL = 1e-5
ILV = dict(pp_schedule="1f1b", pp_virtual_stages=2, pp_microbatches=4)
# name -> (mesh axes, model fields, packed rows, what the worker plants)
MESHES = {
    "moe-pp2-ep2": (dict(pipeline=2, expert=2), dict(MOE), False, None),
    "moe-1f1b-pp2-packed": (dict(pipeline=2), dict(MOE, pp_schedule="1f1b", pp_microbatches=4),
                            True, None),
    "moe-ilv2-pp2-remat": (dict(pipeline=2), dict(MOE, **ILV, remat=True), False, None),
    "moe-sp2": (dict(sequence=2), dict(MOE), False, None),
    "moe-sp2-tp2": (dict(sequence=2, tensor=2), dict(MOE), False, None),
    "moe-sp2-grouped": (dict(sequence=2), dict(MOE, moe_dispatch="grouped"), False, None),
    "moe-sp2-einsum": (dict(sequence=2), dict(MOE, moe_dispatch="einsum"), False, None),
    "moe-sp2-chunk": (dict(sequence=2), dict(MOE), False, "chunk"),
}


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def packed(batches, seed=5):
    """``batches`` with packed-row segment ids: each row two or three
    documents at seeded cut points."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        seg = np.ones((BATCH, SEQ), np.int32)
        for row in seg:
            for cut in sorted(rng.choice(np.arange(4, SEQ - 4), rng.integers(1, 3),
                                         replace=False)):
                row[cut:] += 1
        out.append({**b, "segments": seg})
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory, devices8):
    """JAX's single-device MoE step (plain and packed rows) and its
    ``data2-seq2-tensor2`` step, and the port's at every mesh of
    ``MESHES`` (one 2-rank and one 4-rank launch)."""
    tmp = tmp_path_factory.mktemp("moe_sp_pp")
    plain = jax_batches(STEPS)
    rows = packed(plain)
    write_batches(tmp, plain)
    (tmp / "packed").mkdir()
    write_batches(tmp / "packed", rows)
    jax_out = {"one": jax_mesh_run(plain, dict(data=1), MOE),
               "one-packed": jax_mesh_run(rows, dict(data=1), MOE),
               "d2s2t2": jax_mesh_run(plain, dict(data=2, sequence=2, tensor=2), MOE)}
    save_tree(tmp / "init.npz", jax_out["one"][1])
    outs = {}
    for world in (2, 4):
        runs = {name: {"mesh": m, "model": mk, "packed": p, "plant": plant}
                for name, (m, mk, p, plant) in MESHES.items() if world_of(m) == world}
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=300)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


def assert_aux_matches(port_ranks, jax_metrics):
    for out in port_ranks:
        for step, (a, b) in enumerate(zip(out["metrics"], jax_metrics)):
            np.testing.assert_allclose(a["moe_aux"], b["moe_aux"], rtol=AUX_RTOL,
                                       err_msg=f"moe_aux step {step}")


@pytest.mark.parametrize("name", [n for n, v in MESHES.items() if v[3] is None])
def test_moe_step_over_sp_and_pp_matches_jax(moe_runs, name):
    tmp, jax_out, outs = moe_runs
    ref = "one-packed" if MESHES[name][2] else "one"
    jm, _, jparams = jax_out[ref]
    assert_steps_match(outs[name], jm)
    assert_aux_matches(outs[name], jm)
    assert_params_match(load_tree(tmp / f"final_{name}.npz"), jparams, name)


@pytest.mark.parametrize("name", ["moe-sp2", "moe-sp2-tp2", "moe-sp2-einsum"])
def test_moe_over_sequence_matches_jax_sequence_mesh(moe_runs, name):
    """The sequence meshes against JAX's own ``data2-seq2-tensor2`` MoE run
    (``tests/test_moe.py``): JAX routes the whole row there, as the port
    does across its sequence ranks (``moe-sp2-einsum``: the einsum dispatch
    ``auto`` picks for a bf16 sp run's rows)."""
    tmp, jax_out, outs = moe_runs
    jm, _, jparams = jax_out["d2s2t2"]
    assert_steps_match(outs[name], jm)
    assert_aux_matches(outs[name], jm)
    assert_params_match(load_tree(tmp / f"final_{name}.npz"), jparams, name)


def test_explicit_grouped_under_sp_warns_once(moe_runs):
    """An explicit ``grouped`` under a sharded sequence axis warns once a
    process, in JAX's words, on host 0 (its numbers are held above)."""
    _, _, outs = moe_runs
    assert [o["grouped_sp_warnings"] for o in outs["moe-sp2-grouped"]] == [1, 0]


def test_per_chunk_routing_misses_jax(moe_runs):
    """The negative control: capacity and aux taken per sequence chunk (each
    chunk routed as a row of its own) does not give JAX's numbers."""
    _, jax_out, outs = moe_runs
    jm = jax_out["one"][0]
    got = outs["moe-sp2-chunk"][0]["metrics"]
    aux_err = max(abs(a["moe_aux"] - b["moe_aux"]) / abs(b["moe_aux"]) for a, b in zip(got, jm))
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got, jm))
    assert aux_err > 10 * AUX_RTOL or loss_err > 1e-4, (aux_err, loss_err)
    with pytest.raises(AssertionError):
        assert_aux_matches(outs["moe-sp2-chunk"], jm)


# ---- the dispatch rules -----------------------------------------------------------------


POLICY_MESHES = {"none": None, "data4-fsdp2": dict(data=4, fsdp=2),
                 "data4-seq2": dict(data=4, sequence=2), "data4-ep2": dict(data=4, expert=2),
                 "data2-seq2-tp2": dict(data=2, sequence=2, tensor=2),
                 "seq2-ep2-dp2": dict(data=2, sequence=2, expert=2)}
JAX_TO_PORT = {"_moe_ffn_grouped": "grouped", "_moe_ffn_grouped_ep": "grouped",
               "_moe_ffn_impl": "scatter", "_moe_ffn_einsum": "einsum"}


@pytest.mark.parametrize("dispatch", ["auto", "scatter", "einsum"])
@pytest.mark.parametrize("name", list(POLICY_MESHES))
def test_dispatch_policy_matches_jax(name, dispatch, devices8, monkeypatch):
    """JAX's ``test_auto_dispatch_policy_matrix`` meshes (and more): the
    backend JAX's ``moe_ffn`` runs there at bf16 compute is the one the
    port's ``dispatch_backend`` picks for a rank's rows of whole rows."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import pyrecover_tpu.models.moe as jax_moe
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.llama import init_params
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.models.moe import dispatch_backend
    from pyrecover_tpu_torch.parallel.mesh import DeviceMesh
    from pyrecover_tpu_torch.parallel.mesh import MeshConfig as PortMesh

    calls = []
    for fn in JAX_TO_PORT:
        real = getattr(jax_moe, fn)

        def wrapper(*a, _real=real, _name=fn, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(jax_moe, fn, wrapper)
    jcfg = JaxModelConfig().tiny(max_seq_len=32, vocab_size=128, n_layers=2, **MOE,
                                 moe_dispatch=dispatch)
    B, S = 8, 32
    h = jnp.zeros((B, S, jcfg.dim), jnp.bfloat16)
    lp = jax.tree_util.tree_map(lambda x: x[0], init_params(jax.random.PRNGKey(1), jcfg)["layers"])
    args = (h, lp["router"], lp["moe_w1"], lp["moe_w3"], lp["moe_w2"])
    axes = POLICY_MESHES[name]
    if axes is None:
        jax.eval_shape(lambda *a: jax_moe.moe_ffn(*a, jcfg), *args)
        live, rows = None, B
    else:
        n = world_of(axes)
        mesh = create_mesh(MeshConfig(**axes), devices=jax.devices()[:n])
        with jax.sharding.set_mesh(mesh):
            jax.eval_shape(lambda *a: jax_moe.moe_ffn(*a, jcfg), *args)
        live = DeviceMesh(PortMesh(**axes).shape(n), 0)  # rank 0's place (no groups)
        rows = B // (axes.get("data", 1) * axes.get("fsdp", 1))
    pcfg = dataclasses.replace(ModelConfig().tiny(**MOE, moe_dispatch=dispatch),
                               compute_dtype="bfloat16")
    assert dispatch_backend(pcfg, live, rows, S) == JAX_TO_PORT[calls[0]]


@pytest.mark.parametrize("dispatch", ["auto", "grouped", "scatter", "einsum"])
def test_pipeline_stage_dispatches_einsum(dispatch):
    """Inside a pipeline stage JAX's ``moe_ffn`` runs the masked einsum
    whatever was asked (the manual region's rule); so does the port's."""
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.models.moe import dispatch_backend
    from pyrecover_tpu_torch.parallel.mesh import DeviceMesh

    cfg = ModelConfig().tiny(**MOE, moe_dispatch=dispatch)
    for shape in ({"pipeline": 2}, {"pipeline": 2, "expert": 2}, {"pipeline": 2, "sequence": 2}):
        assert dispatch_backend(cfg, DeviceMesh(shape, 0), 4, 32) == "einsum"


# ---- worker side -----------------------------------------------------------------------


def _moe_train_worker(args):
    """Each run of ``args["runs"]`` on this rank: its metrics and how often
    it warned of ``grouped`` under sp; rank 0 saves the final parameters."""
    import logging

    from pyrecover_tpu_torch.models import moe
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    warned = []

    class Count(logging.Handler):
        def emit(self, record):
            if "sharded sequence axis" in record.getMessage():
                warned.append(record)

    logging.getLogger().addHandler(Count())
    out = {}
    for name, run in args["runs"].items():
        batches = _load_batches(d / "packed" if run["packed"] else d)
        model, step, live = port_model_and_step(load_tree(d / "init.npz"), run["mesh"],
                                                run["model"])
        per = BATCH // live.batch_shards
        rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
        real = moe._seq_ctx
        if run["plant"] == "chunk":  # each sequence chunk routed as a row of its own
            moe._seq_ctx = lambda mesh: None
        moe._WARNED_GROUPED_SP.clear()
        warned.clear()
        try:
            metrics = [{k: float(v) for k, v in
                        step(_to_torch({k: v[rows] for k, v in b.items()})).items()}
                       for b in batches]
        finally:
            moe._seq_ctx = real
        tree = params_to_numpy(model)  # every rank: a collective on a sharded model
        if mesh.rank() == 0:
            save_tree(d / f"final_{name}.npz", tree)
        out[name] = {"metrics": metrics, "grouped_sp_warnings": len(warned)}
    mesh.destroy_distributed()
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _moe_train_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
