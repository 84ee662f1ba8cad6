"""The pipeline axis of the port (``parallel/pipeline.py``: JAX's 1F1B and
interleaved tables, GPipe, 1F1B and interleaved 1F1B over per-stage gloo
ranks; ``parallel/sharding.py``'s stage layers; the mesh step), held to the
JAX package's, mirroring ``tests/test_pipeline.py``.

* The tables: `build_1f1b_tables` and `build_interleaved_tables` equal
  JAX's element for element at every (M, S, V) JAX's tests build, the
  interleaved bubble is the closed form, and `interleave_layer_chunks` and
  its inverse equal JAX's.
* The step at pp 2 (gpipe), pp 2 x dp 2 (gpipe), pp 2 (1f1b, M 4), pp 2
  (interleaved, V 2, 4 layers) and pp 4 (interleaved, V 2, 8 layers): JAX's
  step on as many virtual CPU devices and the port's on as many gloo
  ranks, from JAX's initial weights, 4 fp32 steps: losses and gradient
  norms within 1e-4, label counts equal, the final parameters at
  tests/test_torch_wire.py's policy. Each stage holds its layers (JAX's
  ``interleave_layer_chunks`` order at V 2).
* JAX's rules raise with JAX's words: a batch the microbatches do not
  divide, layers the stages (x virtual stages) do not divide, interleaving
  without 1f1b or with M % S != 0, 1f1b beside gradient accumulation.
* The point-to-point probe (``python tests/test_torch_pipeline.py
  p2p-probe``: gloo's ``send``/``recv`` and ``batch_isend_irecv`` of
  tensors on the card, and the port's host-staged `p2p_exchange`, two
  ranks on one card, each call in a process pair of its own) runs here on
  the CPU and exits 2 without a card. On the H100 (torch 2.11) gloo refuses
  a CUDA tensor in ``send`` ("writev ... Bad address"), so the port stages
  through host buffers on gloo.

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

# name -> (JAX MeshConfig fields, model fields); the port runs as many gloo ranks
MESHES = {
    "pp2-gpipe": (dict(data=1, pipeline=2), dict()),
    "pp2-dp2": (dict(data=2, pipeline=2), dict()),
    "pp2-1f1b-m4": (dict(data=1, pipeline=2), dict(pp_schedule="1f1b", pp_microbatches=4)),
    "pp2-v2": (dict(data=1, pipeline=2),
               dict(pp_schedule="1f1b", pp_microbatches=4, pp_virtual_stages=2)),
    "pp4-v2-l8": (dict(data=1, pipeline=4),
                  dict(pp_schedule="1f1b", pp_microbatches=4, pp_virtual_stages=2, n_layers=8)),
}
LAYERS = 4
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
    return int(np.prod(list(mesh_kw.values())))


# ---- the tables ---------------------------------------------------------------------

ONE_F_ONE_B = [(2, 2), (4, 2), (8, 4), (16, 4), (2, 4), (1, 3), (6, 3), (32, 4)]
INTERLEAVED = [(4, 2, 2), (8, 4, 2), (16, 4, 2), (8, 2, 4), (16, 4, 4), (6, 3, 2), (4, 4, 2)]


@pytest.mark.parametrize("M,S", ONE_F_ONE_B)
def test_1f1b_tables_equal_jax(M, S):
    from pyrecover_tpu.parallel.pipeline import build_1f1b_tables as jax_tables
    from pyrecover_tpu_torch.parallel.pipeline import build_1f1b_tables

    for a, b in zip(build_1f1b_tables(M, S), jax_tables(M, S)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("M,S,V", INTERLEAVED)
def test_interleaved_tables_equal_jax(M, S, V):
    from pyrecover_tpu.parallel.pipeline import build_interleaved_tables as jax_tables
    from pyrecover_tpu_torch.parallel.pipeline import build_interleaved_tables

    port, ref = build_interleaved_tables(M, S, V), jax_tables(M, S, V)
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert port[4] == ref[4]


def test_interleaved_tables_cut_the_bubble():
    """JAX's ``test_interleaved_tables_cut_the_bubble`` on the port's
    tables: the simulated bubble is (S-1)/(M+S-1) at V 1 and the smaller
    (S-1)/(VM+S-1) at V 2 and 4."""
    from pyrecover_tpu_torch.parallel.pipeline import (
        build_1f1b_tables,
        build_interleaved_tables,
    )

    M, S = 16, 4

    def wall(fwd, bwd, v):
        return sum(max((fwd[t, s] >= 0) + (bwd[t, s] >= 0) for s in range(S))
                   for t in range(fwd.shape[0])) / v

    f1, b1 = build_1f1b_tables(M, S)
    bubble1 = 1 - 2 * M / wall(f1, b1, 1)
    np.testing.assert_allclose(bubble1, (S - 1) / (M + S - 1), atol=1e-9)
    for v in (2, 4):
        fm, _, bm, _, _ = build_interleaved_tables(M, S, v)
        np.testing.assert_allclose(1 - 2 * M / wall(fm, bm, v), (S - 1) / (v * M + S - 1),
                                   atol=1e-9)


@pytest.mark.parametrize("S,V", [(2, 2), (4, 2), (2, 4)])
def test_layer_chunk_interleaving_equals_jax(S, V):
    """`interleave_layer_chunks` and its inverse equal JAX's on a stacked
    leaf, and a stage's contiguous block of the interleaved order is the
    layers `stage_layers` gives it."""
    import jax.numpy as jnp

    from pyrecover_tpu.parallel.pipeline import interleave_layer_chunks as jax_il
    from pyrecover_tpu.parallel.pipeline import uninterleave_layer_chunks as jax_un
    from pyrecover_tpu_torch.parallel.pipeline import (
        interleave_layer_chunks,
        uninterleave_layer_chunks,
    )
    from pyrecover_tpu_torch.parallel.sharding import stage_layers

    L = 2 * S * V
    x = np.arange(L * 3, dtype=np.float32).reshape(L, 3)
    want = np.asarray(jax_il({"w": jnp.asarray(x)}, S, V)["w"])
    np.testing.assert_array_equal(interleave_layer_chunks(x, S, V), want)
    np.testing.assert_array_equal(interleave_layer_chunks(torch.from_numpy(x), S, V).numpy(),
                                  want)
    np.testing.assert_array_equal(uninterleave_layer_chunks(want, S, V),
                                  np.asarray(jax_un({"w": jnp.asarray(want)}, S, V)["w"]))
    per = L // S
    for s in range(S):
        np.testing.assert_array_equal(want[s * per:(s + 1) * per, 0] // 3,
                                      np.array(stage_layers(L, S, V, s)))


# ---- JAX's rules ----------------------------------------------------------------------


def test_pipeline_guards_raise_with_jax_words():
    """The divisibility rules (JAX ``pipeline.py:131-137, 420, 579-585``) and
    the interleaving rule (``models/llama.py``'s config)."""
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.parallel.pipeline import build_interleaved_tables as jax_tables
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.parallel.pipeline import build_interleaved_tables, check_pipeline

    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches"):
        check_pipeline(4, 8, 2, 3, 1)
    with pytest.raises(ValueError, match="n_layers=3 not divisible by pipeline stages"):
        check_pipeline(3, 8, 2, 2, 1)
    with pytest.raises(ValueError, match=r"n_layers=4 not divisible .* virtual stages"):
        check_pipeline(4, 8, 2, 4, 4)
    for build in (build_interleaved_tables, jax_tables):
        with pytest.raises(ValueError, match="divisible"):
            build(6, 4, 2)
    for cfg in (ModelConfig().tiny(), JaxModelConfig().tiny()):
        with pytest.raises(ValueError, match="pp-schedule 1f1b"):
            dataclasses.replace(cfg, pp_virtual_stages=2)


def test_1f1b_rejects_grad_accumulation():
    """JAX's ``test_1f1b_rejects_grad_accumulation`` on the port's
    ``make_train_step``; the explicit wire and buckets are refused beside
    1f1b too."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import make_train_step

    model = Transformer(ModelConfig().tiny(pp_schedule="1f1b"))
    opt, _ = build_optimizer(TrainConfig(device="cpu"), model.parameters(), model=model)
    with pytest.raises(ValueError, match="pp-microbatches instead"):
        make_train_step(model, opt, grad_accumulation_steps=2)
    with pytest.raises(ValueError, match="gpipe schedule only"):
        make_train_step(model, opt, grad_allreduce="int8")


# ---- the step at the pipeline meshes -----------------------------------------------------


def jax_config(model_kw, attention_impl=None):
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig

    kw = {"n_layers": LAYERS, **model_kw}
    if attention_impl:
        kw["attention_impl"] = attention_impl
    return JaxTrainConfig(model=JaxModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ, **kw),
                          sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                          lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32")


def jax_mesh_run(batches, mesh_kw, model_kw, attention_impl=None):
    """JAX's step on ``MeshConfig(**mesh_kw)``: per-step metrics, the
    initial params and the final params (numpy)."""
    import jax

    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu.train_state import make_train_step

    jcfg = jax_config(model_kw, attention_impl)
    tx, _ = build_optimizer(jcfg)
    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:world_of(mesh_kw)])
    state = init_sharded_state(jax.random.key(0), jcfg.model, tx, mesh)
    init = jax.tree.map(np.asarray, state.params)
    step = make_train_step(jcfg.model, tx, donate=False)
    metrics = []
    with jax.sharding.set_mesh(mesh):
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, init, jax.tree.map(np.asarray, state.params)


def port_model_and_step(tree, mesh_kw, model_kw, **kw):
    """The tiny model with JAX's weights ``tree`` on a live mesh of
    ``mesh_kw`` (any of the six axes; each stage keeping its layers), its
    optimizer and its step: ``(model, step, mesh)``."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_from_jax
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.parallel import mesh
    from pyrecover_tpu_torch.parallel.sharding import shard_model
    from pyrecover_tpu_torch.train_state import make_train_step

    model_kw = dict(model_kw)
    pp = {k: model_kw.pop(k) for k in ("pp_schedule", "pp_microbatches", "pp_virtual_stages")
          if k in model_kw}
    model_cfg = ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ,
                                   **{"n_layers": LAYERS, **model_kw})
    cfg = TrainConfig(model=model_cfg, sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                      lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32", device="cpu",
                      dp=mesh_kw.get("data", 1), fsdp=mesh_kw.get("fsdp", 1),
                      tp=mesh_kw.get("tensor", 1), sp=mesh_kw.get("sequence", 1),
                      pp=mesh_kw.get("pipeline", 1), ep=mesh_kw.get("expert", 1), **pp, **kw)
    shape = mesh.MeshConfig(data=cfg.dp, fsdp=cfg.fsdp, tensor=cfg.tp, sequence=cfg.sp,
                            pipeline=cfg.pp, expert=cfg.ep).shape(mesh.world_size())
    model = Transformer(cfg.model)
    model.load_state_dict(params_from_jax(tree))
    live = mesh.build_mesh(shape)
    shard_model(model, live)
    opt, _ = build_optimizer(cfg, model.parameters(), model=model)
    return model, make_train_step(model, opt), live


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, devices8):
    """JAX's and the port's runs at every mesh of ``MESHES`` from one set
    of weights and batches."""
    tmp = tmp_path_factory.mktemp("pp_step")
    batches = jax_batches(STEPS)
    write_batches(tmp, batches)
    jax_out = {name: jax_mesh_run(batches, *MESHES[name]) for name in MESHES}
    save_tree(tmp / "init.npz", jax_out["pp2-gpipe"][1])
    save_tree(tmp / "init_l8.npz", jax_out["pp4-v2-l8"][1])
    outs = {}
    for world in (2, 4):
        runs = {name: {"mesh": m, "model": mk, "init": "init_l8.npz" if "l8" in name
                       else "init.npz"}
                for name, (m, mk) in MESHES.items() if world_of(m) == world}
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=240)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


def assert_steps_match(port_ranks, jax_metrics):
    for out in port_ranks:  # every rank logs the global loss
        assert len(out["metrics"]) == len(jax_metrics)
        for step, (a, b) in enumerate(zip(out["metrics"], jax_metrics)):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                           err_msg=f"{key} step {step}")
            assert a["n_tokens"] == b["n_tokens"]


@pytest.mark.parametrize("name", list(MESHES))
def test_pipelined_step_matches_jax(mesh_runs, name):
    tmp, jax_out, outs = mesh_runs
    jm, _, jparams = jax_out[name]
    assert_steps_match(outs[name], jm)
    got = load_tree(tmp / f"final_{name}.npz")
    import jax

    MEASURED[name] = assert_close_by_share(jax.tree_util.tree_leaves(got),
                                           jax.tree_util.tree_leaves(jparams), f"{name} params")


@pytest.mark.parametrize("name", ["pp2-gpipe", "pp2-v2", "pp4-v2-l8"])
def test_each_stage_holds_its_layers(mesh_runs, name):
    """A stage holds L/S blocks, and at V 2 JAX's interleaved chunks; the
    embedding, the final norm and the output stay whole on every stage."""
    from pyrecover_tpu_torch.parallel.sharding import stage_layers

    _, _, outs = mesh_runs
    mesh_kw, model_kw = MESHES[name]
    S, V = mesh_kw["pipeline"], model_kw.get("pp_virtual_stages", 1)
    L = model_kw.get("n_layers", LAYERS)
    for rank, out in enumerate(outs[name]):
        assert tuple(out["layers"]) == stage_layers(L, S, V, rank % S)
        for path, share in out["held"].items():
            want = 1 / S if "['layers']" in path else 1.0
            assert share == pytest.approx(want), path


# ---- the point-to-point probe -------------------------------------------------------


P2P_CALLS = ("p2p_exchange", "send_recv", "batch_isend_irecv")


def _p2p_probe_worker(args):
    """One rank of one probe call (``args["call"]``, in a process group of
    its own: a refused send leaves the pair's connection dead): plain
    ``send``/``recv``, ``batch_isend_irecv`` of a tensor on
    ``args["device"]`` over gloo, or the port's `p2p_exchange`; ``{"route":
    its route, call: "ok" or the error}``."""
    import torch.distributed as dist

    from pyrecover_tpu_torch.parallel.mesh import p2p_exchange, p2p_route

    cuda = args["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)  # both ranks on the one card, as chip_smoke's pairs
    dist.init_process_group("gloo")
    rank, peer = dist.get_rank(), 1 - dist.get_rank()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    x = torch.full((4096,), float(rank + 1), device=dev)

    def check(got):
        return "ok" if float(got.float().mean()) == peer + 1 else f"wrong value {got[:4]}"

    def send_recv():
        buf = torch.empty_like(x)
        if rank == 0:
            dist.send(x, peer)
            dist.recv(buf, peer)
        else:
            dist.recv(buf, peer)
            dist.send(x, peer)
        return check(buf)

    def batched():
        buf = torch.empty_like(x)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, buf, peer)]):
            w.wait()
        return check(buf)

    calls = {"send_recv": send_recv, "batch_isend_irecv": batched,
             "p2p_exchange": lambda: check(p2p_exchange([(x, peer)], [(x, peer)])[0])}
    out = {"route": p2p_route(dev)}
    try:
        out[args["call"]] = calls[args["call"]]()
    except RuntimeError as e:  # the finding: gloo refuses this tensor
        out[args["call"]] = str(e)[:200]
    dist.destroy_process_group()
    return out


def p2p_probe(device):
    """Each call of the probe in its own process pair: ``[rank 0's, rank
    1's]`` findings, merged over the calls."""
    ranks = [{}, {}]
    for call in P2P_CALLS:
        for mine, got in zip(ranks, spawn("p2p_probe", {"device": device, "call": call},
                                          timeout=120)):
            mine.update(got)
    return ranks


def p2p_probe_main(argv):
    """``python tests/test_torch_pipeline.py p2p-probe [--device cuda|cpu]``:
    each rank's findings as one JSON line; exits 2 when ``--device cuda``
    has no card."""
    import argparse

    ap = argparse.ArgumentParser(prog="test_torch_pipeline.py p2p-probe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("p2p-probe: no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu", "torch": torch.__version__,
                      "ranks": p2p_probe(args.device)}), flush=True)
    return 0


def test_p2p_probe_on_the_cpu():
    """The probe's ranks over gloo on the CPU: every call moves the peer's
    tensor, directly; without a card ``--device cuda`` exits 2."""
    for rank in p2p_probe("cpu"):
        assert rank == {"route": "direct", "send_recv": "ok", "batch_isend_irecv": "ok",
                        "p2p_exchange": "ok"}
    if not torch.cuda.is_available():
        assert p2p_probe_main(["--device", "cuda"]) == 2


# ---- the ring probe: the exchange over NCCL, one rank a card ------------------------


RING_ORDERS = ("port", "pairs")
NS_CHUNK = (1, 2048, 8, 128)  # a --sp 4 rank's k or v at llama-1b, seq 8192 (b, s, kv, d)


def _ring_probe_worker(args):
    """One rank of one order of the ring probe (a process group of its own:
    a hung order must not hold the next), one rank a card (``--device
    cuda``) or on the CPU, over ``args["backend"]``. k- and v-sized chunks shift
    round the ring of every rank ``args["shifts"]`` times from this thread
    and as many from autograd's backward (the ring's backward pass shifts
    from there), then a pipeline's activation goes down the stages one tick
    at a time and its cotangent back. ``"port"`` exchanges through
    `p2p_exchange` (all of a rank's sends and receives in one batch);
    ``"pairs"`` peer by peer, the peers in the global order of their rank
    pairs. Returns ``{order: "ok" or the wrong moves, "shift_ms": a forward
    shift's mean wall ms}``."""
    import os
    import time

    import torch.distributed as dist

    from pyrecover_tpu_torch.parallel import mesh

    cuda = args["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(args["backend"])
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    group = dist.group.WORLD
    mesh.p2p_ready(dev, group)

    def pairs(sends, recvs):
        outs = [None] * len(recvs)
        for peer in sorted({p for _, p in sends} | {p for _, p in recvs},
                           key=lambda p: (min(rank, p), max(rank, p))):
            ops, got = [], []
            for t, p in sends:
                if p == peer:
                    ops.append(dist.P2POp(dist.isend, t.contiguous(), p))
            for i, (t, p) in enumerate(recvs):
                if p == peer:
                    got.append((i, torch.empty_like(t)))
                    ops.append(dist.P2POp(dist.irecv, got[-1][1], p))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for i, buf in got:
                outs[i] = buf
        return outs

    exchange = {"port": lambda sends, recvs: mesh.p2p_exchange(sends, recvs, group),
                "pairs": pairs}[args["order"]]
    nxt, prev = (rank + 1) % world, (rank - 1) % world
    k = torch.full(args["shape"], float(rank), dtype=torch.bfloat16, device=dev)
    wrong, shift_s = [], []

    def ring(where):
        held = [k, k + 0.5]
        for i in range(args["shifts"]):
            t0 = time.perf_counter()
            held = exchange([(t, nxt) for t in held], [(t, prev) for t in held])
            want = float((rank - i - 1) % world)
            got = (float(held[0].float().mean()), float(held[1].float().mean()))
            shift_s.append(time.perf_counter() - t0)
            if got != (want, want + 0.5):
                wrong.append(f"{where} shift {i}: {got}, want {want}")

    class Shifted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            ring("backward")
            return g

    ring("forward")
    forward_ms = 1e3 * sum(shift_s[1:]) / max(len(shift_s) - 1, 1)  # the first sets links up
    Shifted.apply(torch.ones(4, device=dev, requires_grad=True)).sum().backward()
    for tick in list(range(world - 1)) + [-t for t in range(world - 1, 0, -1)]:
        src, dst = (tick, tick + 1) if tick >= 0 else (-tick, -tick - 1)
        sends = [(k, dst)] if rank == src else []
        got = exchange(sends, [(k, src)] if rank == dst else [])
        if got and float(got[0].float().mean()) != src:
            wrong.append(f"stage send {src} -> {dst}: {float(got[0].float().mean())}")
    dist.destroy_process_group()
    return {args["order"]: "; ".join(wrong) or "ok", "shift_ms": forward_ms}


def ring_probe(device, world, shape=NS_CHUNK, shifts=8, timeout=120, backend=None):
    """Each order of the ring probe in its own group of ``world`` ranks over
    ``backend`` (the trainer's, `mesh.default_backend`, by default):
    ``{order: [each rank's findings] or how the group failed}``."""
    import subprocess

    from pyrecover_tpu_torch.parallel.mesh import default_backend

    out = {}
    for order in RING_ORDERS:
        args = {"device": device, "order": order, "shape": list(shape), "shifts": shifts,
                "backend": backend or default_backend(device)}
        try:
            out[order] = spawn("ring_probe", args, world=world, timeout=timeout)
        except subprocess.TimeoutExpired:
            out[order] = f"hung: no end within {timeout} s"
        except AssertionError as e:  # a rank exited non-zero
            out[order] = f"failed: {str(e)[-400:]}"
    return out


def ring_probe_main(argv):
    """``python tests/test_torch_pipeline.py ring-probe [--device cuda|cpu]
    [--world N] [--timeout S] [--backend B]``: each order's findings as one
    JSON line (``--device cuda``: one rank a card, N the cards by default;
    B the trainer's backend by default); exits 2 when ``--device cuda`` has
    fewer than 2 cards."""
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # run as a script
    ap = argparse.ArgumentParser(prog="test_torch_pipeline.py ring-probe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--world", type=int, default=0)
    ap.add_argument("--timeout", type=int, default=120)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and cards < 2:
        print("ring-probe: fewer than 2 CUDA devices: pass --device cpu", file=sys.stderr)
        return 2
    world = args.world or (cards if args.device == "cuda" else 4)
    shape = NS_CHUNK if args.device == "cuda" else (1, 64, 2, 16)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu", "torch": torch.__version__, "world": world,
                      "shape": list(shape), "backend": args.backend or "the trainer's",
                      "orders": ring_probe(args.device, world, shape, timeout=args.timeout,
                                           backend=args.backend)}), flush=True)
    return 0


def test_ring_probe_on_the_cpu():
    """The ring probe's orders over gloo on four CPU ranks: every shift,
    from this thread and from autograd's backward, and every stage send
    moves the right chunk; with fewer than two cards ``--device cuda``
    exits 2."""
    got = ring_probe("cpu", 4, shape=(1, 64, 2, 16), shifts=5)
    for order in RING_ORDERS:
        assert [{k: v for k, v in r.items() if k != "shift_ms"} for r in got[order]] == [
            {order: "ok"}] * 4, got[order]
    if torch.cuda.device_count() < 2:
        assert ring_probe_main(["--device", "cuda"]) == 2


# ---- the worker ------------------------------------------------------------------------


def _held(model, step):
    """``{leaf path: the share of its elements this rank holds}`` over the
    parameters and the moments."""
    from pyrecover_tpu_torch.train_state import state_leaves

    return {leaf.path: sum(p.numel() for p in leaf.parts) / float(np.prod(leaf.shape))
            for leaf in state_leaves(model, step.optimizer)
            if isinstance(leaf.parts[0], torch.Tensor) and leaf.parts[0].dim()}


def _train_worker(args):
    """Each run of ``args["runs"]`` on this rank: its metrics, the shares it
    holds and its stage's layers; rank 0 saves the final parameters."""
    from pyrecover_tpu_torch.models import llama
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    batches = _load_batches(d)
    out = {}
    for name, run in args["runs"].items():
        model, step, live = port_model_and_step(load_tree(d / run["init"]), run["mesh"],
                                                run["model"], **run.get("kw", {}))
        per = BATCH // live.batch_shards
        rows = slice(live.batch_index * per, (live.batch_index + 1) * per)
        real = llama.sequence_offset
        if run.get("no_offset"):  # a sequence rank that drops its RoPE offset
            llama.sequence_offset = lambda model, s_local: 0
        try:
            metrics = [{k: float(v) for k, v in
                        step(_to_torch({k: v[rows] for k, v in b.items()})).items()}
                       for b in batches]
        finally:
            llama.sequence_offset = real
        tree = params_to_numpy(model)  # every rank: a collective on a sharded model
        if mesh.rank() == 0:
            save_tree(d / f"final_{name}.npz", tree)
        out[name] = {"metrics": metrics, "held": _held(model, step),
                     "layers": list(getattr(model, "stage_layer_ids", ()))}
    mesh.destroy_distributed()
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker, "p2p_probe": _p2p_probe_worker,
               "ring_probe": _ring_probe_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["p2p-probe"]:
    sys.exit(p2p_probe_main(sys.argv[2:]))
elif __name__ == "__main__" and sys.argv[1:2] == ["ring-probe"]:
    sys.exit(ring_probe_main(sys.argv[2:]))
