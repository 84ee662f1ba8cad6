"""Ring attention of the port (``ops/ring_attention.py``, the sequence ring
over 2 and 4 gloo ranks, its blocks on the flash kernels' plain versions
here) held to the JAX package's ``ring_attention`` on as many of the
suite's virtual CPU devices, mirroring ``tests/test_ring_attention.py``.

* Output and dq, dk, dv of ``sum(sin(out))``, fp32, within rtol 1e-5 /
  atol 1e-6: causal and not at sp 2 and sp 4; a ``block_kv`` that does not
  divide the chunk (inert in the port, whose kernels tile on their own);
  packed rows whose documents cross the chunk boundaries and end inside
  them, so off-diagonal blocks give the keys other segment ids than the
  queries (``seg_k``) and some query rows no key at all (zero weight in the
  merge, not NaN).
* The fallback without a mesh is the sdpa path, as JAX's.
* The model level: logits of the tiny model with ``attention_impl="ring"``
  at sp 2 against JAX's forward on a data 4 x sequence 2 mesh; a sequence
  rank that drops its RoPE offset (``sequence_offset`` monkeypatched to 0)
  misses JAX's logits by far more.
* The kernels' plain versions with a ``seg_k`` of their own equal the
  masked-by-hand reference.
* The step at sp 2, dp 2 x sp 2 and tp 2 x sp 2 (ring attention, each rank
  its chunk of its rows' columns): JAX's step on as many virtual CPU
  devices and the port's on as many gloo ranks, 4 fp32 steps, losses and
  gradient norms within 1e-4, label counts equal, the final parameters at
  tests/test_torch_wire.py's policy; at sp 2 with the RoPE offset dropped
  the losses and norms miss JAX's beyond that tolerance.

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

RTOL, ATOL = 1e-5, 1e-6
SHAPE = dict(b=4, s=64, hq=4, hkv=2, d=32)
# name -> (sp, causal, block_kv, segments)
CASES = {
    "sp2-causal": (2, True, 512, False), "sp2-full": (2, False, 512, False),
    "sp4-causal": (4, True, 512, False), "sp4-full": (4, False, 512, False),
    "sp2-block20-causal": (2, True, 20, False), "sp2-block20-full": (2, False, 20, False),
    "sp2-seg-512": (2, True, 512, True), "sp2-seg-8": (2, True, 8, True),
    "sp2-seg-20": (2, True, 20, True), "sp4-seg-full": (4, False, 512, True),
}
MODEL_SEQ, MODEL_VOCAB = 64, 128


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_qkv(seed=0):
    rng = np.random.default_rng(seed)
    b, s, hq, hkv, d = (SHAPE[k] for k in ("b", "s", "hq", "hkv", "d"))
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def make_segments(seed=5):
    """Ragged documents a row (JAX's test's recipe over the whole batch):
    boundaries at random positions, so documents cross chunk edges and
    some rows' queries meet no key of theirs in another chunk."""
    rng = np.random.default_rng(seed)
    b, s = SHAPE["b"], SHAPE["s"]
    seg = np.zeros((b, s), np.int32)
    for row in range(b):
        for i, lo in enumerate(sorted(rng.choice(np.arange(4, s - 4), size=3, replace=False))):
            seg[row, lo:] = i + 1
    return seg


def jax_ring(arrays, seg, sp, causal, block_kv):
    """JAX's ring on data (8/sp) x sequence sp: ``(out, dq, dk, dv)`` of
    ``sum(sin(out))``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.ops.ring_attention import ring_attention
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(data=8 // sp, sequence=sp), devices=jax.devices()[:8])
    sh = NamedSharding(mesh, P("data", "sequence", None, None))
    q, k, v = (jax.device_put(jnp.asarray(a), sh) for a in arrays)
    segs = None if seg is None else jax.device_put(jnp.asarray(seg),
                                                   NamedSharding(mesh, P("data", "sequence")))

    def loss(q, k, v):
        o = ring_attention(q, k, v, causal=causal, block_kv=block_kv, segment_ids=segs)
        return jnp.sum(jnp.sin(o)), o

    with jax.sharding.set_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def jax_model(cfg_kw, tree, tokens):
    """JAX's forward with ``attention_impl="ring"`` on data 4 x sequence 2."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.models import ModelConfig, forward
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh

    cfg = ModelConfig(**cfg_kw, attention_impl="ring")
    mesh = create_mesh(MeshConfig(data=4, sequence=2), devices=jax.devices()[:8])
    tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", "sequence")))
    with jax.sharding.set_mesh(mesh):
        return np.asarray(jax.jit(lambda p, t: forward(p, t, cfg))(tree, tok))


MODEL_CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=MODEL_VOCAB,
                 multiple_of=32, max_seq_len=MODEL_SEQ, param_dtype="float32",
                 compute_dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """JAX's ring at every case and its model, and the port's on 2 and 4
    gloo ranks."""
    import jax

    from pyrecover_tpu.models import ModelConfig, init_params
    from test_torch_fsdp_tp import save_tree

    tmp = tmp_path_factory.mktemp("ring")
    arrays, seg = make_qkv(), make_segments()
    np.savez(tmp / "inputs.npz", q=arrays[0], k=arrays[1], v=arrays[2], seg=seg)
    want = {name: jax_ring(arrays, seg if segs else None, sp, causal, block)
            for name, (sp, causal, block, segs) in CASES.items()}
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**MODEL_CFG)))
    save_tree(tmp / "model.npz", tree)
    tokens = np.random.default_rng(1).integers(0, MODEL_VOCAB, (4, MODEL_SEQ)).astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    want["model"] = jax_model(MODEL_CFG, tree, tokens)
    for sp in (2, 4):
        names = [n for n, c in CASES.items() if c[0] == sp]
        spawn("ring", {"dir": str(tmp), "cases": {n: CASES[n] for n in names},
                       "model": sp == 2}, world=sp, timeout=180)
    got = {}
    for sp in (2, 4):
        for r in range(sp):
            with np.load(tmp / f"ring_sp{sp}_rank{r}.npz") as z:
                for key in z.files:
                    got.setdefault(key, {})[r] = z[key]
    return want, got


def _whole(got, key, world):
    """The ranks' sequence chunks of ``key`` side by side (dim 1)."""
    return np.concatenate([got[key][r] for r in range(world)], axis=1)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(runs, name):
    want, got = runs
    sp = CASES[name][0]
    for i, which in enumerate(("out", "dq", "dk", "dv")):
        have = _whole(got, f"{name}/{which}", sp)
        assert np.isfinite(have).all(), (name, which)
        np.testing.assert_allclose(have, want[name][i], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {which}")


def test_model_level_ring_matches_jax(runs):
    """The tiny model's logits at sp 2 (each rank its columns, RoPE at its
    global positions) equal JAX's ring forward; without the offset they do
    not."""
    want, got = runs
    np.testing.assert_allclose(_whole(got, "model/logits", 2), want["model"], rtol=1e-4,
                               atol=1e-5)
    off = np.abs(_whole(got, "model/no_offset", 2) - want["model"]).max()
    assert off > 10 * (1e-5 + 1e-4 * np.abs(want["model"]).max()), off


def test_ring_fallback_without_mesh():
    """No mesh (or sequence 1): the sdpa path, as JAX's fallback."""
    import jax.numpy as jnp

    from pyrecover_tpu.ops.ring_attention import ring_attention as jax_ring_attention
    from pyrecover_tpu_torch.ops.ring_attention import ring_attention

    q, k, v = make_qkv()
    want = np.asarray(jax_ring_attention(*map(jnp.asarray, (q, k, v)), causal=True))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_take_key_segments(causal):
    """``flash_fwd``/``flash_bwd_dq``/``flash_bwd_dkv`` with a ``seg_k`` of
    their own (s != sk, as a ring block) equal attention masked by hand,
    and a query row no key shares a segment with gets zero weight when two
    blocks merge by their lse."""
    from pyrecover_tpu_torch.ops import flash_attention as fa
    from pyrecover_tpu_torch.ops.ring_attention import _merge

    rng = np.random.default_rng(7)
    b, s, sk, hq, hkv, d = 2, 16, 24, 4, 2, 8
    q = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, sk, hkv, d)).astype(np.float32))
            for _ in range(2))
    seg_q = torch.tensor([[0] * 8 + [1] * 8, [2] * 16], dtype=torch.int32)
    seg_k = torch.tensor([[0] * 12 + [1] * 12, [1] * 24], dtype=torch.int32)
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, seg_q, causal, scale, seg_k=seg_k)
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    mask = (seg_q[:, :, None] == seg_k[:, None, :])[:, None, None]
    if causal:
        mask = mask & (torch.arange(s)[:, None] >= torch.arange(sk)[None])
    p = torch.softmax(sc.masked_fill(~mask, -1e30), -1)
    ref = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, hq, d)
    live = mask.any(-1)[:, 0, 0]  # (b, s): rows with a key of their segment
    np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(), rtol=1e-5, atol=1e-6)
    assert not live[1].any() and (lse[1] < -1e29).all()  # row 1 meets no key of its own
    # merged with a block whose every row is live, the dead block weighs nothing
    o2, l2 = fa.flash_fwd(q, q.reshape(b, s, hkv, 2 * d)[..., :d].contiguous(),
                          q.reshape(b, s, hkv, 2 * d)[..., :d].contiguous(), None, False, scale)
    acc, _ = _merge(*_merge(None, None, o2, l2), out, lse)
    np.testing.assert_allclose(acc[1].numpy(), o2[1].numpy(), rtol=1e-6, atol=1e-7)
    assert torch.isfinite(acc).all()
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    args = (q, k, v, seg_q, out, lse, dout, causal, scale)
    dq = fa.flash_bwd_dq(*args, seg_k=seg_k)
    dk, dv = fa.flash_bwd_dkv(*args, seg_k=seg_k)
    # against autograd through the exact softmax (the saved lse fixes p): on
    # the rows that meet a key of their segment; dk/dv get nothing from the
    # others
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.reshape(b, s, hkv, hq // hkv, d), kr) * scale
    pr = torch.softmax(sc.masked_fill(~mask, -1e30), -1) * live[:, None, None, :, None]
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, vr).reshape(b, s, hq, d)
    (o * dout).sum().backward()
    np.testing.assert_allclose(dq[live].numpy(), qr.grad[live].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), kr.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), vr.grad.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="key segment ids"):
        fa.flash_fwd(q, k, v, seg_q, causal, scale, seg_k=seg_k[:, :8].contiguous())


# ---- the step at the sequence meshes ------------------------------------------------

SP_MESHES = {"sp2": dict(data=1, sequence=2), "dp2-sp2": dict(data=2, sequence=2),
             "tp2-sp2": dict(data=1, tensor=2, sequence=2)}


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory, devices8):
    from test_torch_fsdp_tp import save_tree, write_batches
    from test_torch_pipeline import jax_mesh_run
    from test_torch_wire import STEPS, jax_batches

    tmp = tmp_path_factory.mktemp("sp_step")
    batches = jax_batches(STEPS)
    write_batches(tmp, batches)
    jax_out = {name: jax_mesh_run(batches, kw, {}, attention_impl="ring")
               for name, kw in SP_MESHES.items()}
    save_tree(tmp / "init.npz", jax_out["sp2"][1])
    outs = {}
    for world, names in ((2, ["sp2", "sp2-no-offset"]), (4, ["dp2-sp2", "tp2-sp2"])):
        runs = {n: {"mesh": SP_MESHES[n.replace("-no-offset", "")], "model": {},
                    "init": "init.npz", "no_offset": n.endswith("no-offset")} for n in names}
        per_rank = spawn("train", {"dir": str(tmp), "runs": runs}, world=world, timeout=240)
        for name in runs:
            outs[name] = [o[name] for o in per_rank]
    return tmp, jax_out, outs


@pytest.mark.parametrize("name", list(SP_MESHES))
def test_sequence_mesh_step_matches_jax(sp_runs, name):
    import jax

    from test_torch_fsdp_tp import load_tree
    from test_torch_pipeline import assert_steps_match
    from test_torch_wire import assert_close_by_share

    tmp, jax_out, outs = sp_runs
    jm, _, jparams = jax_out[name]
    assert_steps_match(outs[name], jm)
    assert_close_by_share(jax.tree_util.tree_leaves(load_tree(tmp / f"final_{name}.npz")),
                          jax.tree_util.tree_leaves(jparams), f"{name} params")


def test_sequence_rank_without_its_rope_offset_misses_jax(sp_runs):
    """The same sp 2 run with `sequence_offset` monkeypatched to 0 (the
    second rank rotates its chunk as if it began the row): its losses and
    gradient norms miss JAX's by more than the 1e-4 the run with the offset
    holds, so the step's parity test fails without the offset."""
    _, jax_out, outs = sp_runs
    miss = max(abs(a[key] - b[key]) / abs(b[key])
               for a, b in zip(outs["sp2-no-offset"][0]["metrics"], jax_out["sp2"][0])
               for key in ("loss", "grad_norm"))
    assert miss > 1e-4, miss


# ---- the worker ------------------------------------------------------------------


def _ring_worker(args):
    from pyrecover_tpu_torch.ops.ring_attention import ring_attention
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    world = mesh.world_size()
    live = mesh.build_mesh({"sequence": world})
    i = live.coords["sequence"]
    with np.load(d / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    n = SHAPE["s"] // world
    cols = slice(i * n, (i + 1) * n)
    out = {}
    for name, (_, causal, block, segs) in args["cases"].items():
        q, k, v = (torch.from_numpy(np.ascontiguousarray(inputs[x][:, cols])).requires_grad_(True)
                   for x in ("q", "k", "v"))
        seg = torch.from_numpy(np.ascontiguousarray(inputs["seg"][:, cols])) if segs else None
        o = ring_attention(q, k, v, causal=causal, mesh=live, block_kv=block, segment_ids=seg)
        torch.sin(o).sum().backward()
        for which, t in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{name}/{which}"] = t.detach().numpy()
    if args["model"]:
        out.update(_model_logits(d, live, cols))
    np.savez(d / f"ring_sp{world}_rank{i}.npz", **out)
    mesh.destroy_distributed()
    return {}


def _model_logits(d, live, cols):
    """The tiny model's logits of this rank's columns, and again with the
    RoPE offset dropped."""
    from pyrecover_tpu_torch.models import llama
    from pyrecover_tpu_torch.parallel.sharding import shard_model
    from test_torch_fsdp_tp import load_tree

    cfg = llama.ModelConfig(**MODEL_CFG, attention_impl="ring")
    model = llama.Transformer(cfg)
    model.load_state_dict(llama.params_from_jax(load_tree(d / "model.npz")))
    shard_model(model, live)
    tokens = torch.from_numpy(np.load(d / "tokens.npy")[:, cols].copy()).long()
    with torch.no_grad():
        logits = llama.forward(model, tokens).numpy()
        real = llama.sequence_offset
        llama.sequence_offset = lambda model, s_local: 0
        try:
            dropped = llama.forward(model, tokens).numpy()
        finally:
            llama.sequence_offset = real
    return {"model/logits": logits, "model/no_offset": dropped}


def _train_worker(args):
    from test_torch_pipeline import _train_worker as train

    return train(args)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"ring": _ring_worker, "train": _train_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
