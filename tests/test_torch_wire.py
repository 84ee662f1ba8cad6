"""The quantized gradient wire of the port (``parallel/collectives.py``,
``--grad-allreduce bf16|int8`` in ``train_state.make_train_step``), held to
the JAX package's.

* ``quantized_psum_flat`` over 2 gloo ranks against JAX's over a 2-device
  ``shard_map``, on the same seeded inputs: ``reduced`` and the int8
  ``deficit`` agree within 1e-6 of the block's absmax (measured on this
  input: bf16 bit-equal; int8 ``reduced`` apart on one block of 256
  elements by at most 8.1e-8 of its absmax and the deficits by at most
  8.6e-8, where XLA's and torch's scale division round apart), and the
  error-feedback identity
  reduced + Σ_r deficit_r = Σ_r x_r holds.
* ``quantized_roundtrip_local``, the helpers and JAX's
  ``test_error_feedback_rescues_coarse_quantization`` on the port.
* The dp2 train step at int8, int8 over JAX's bucket layout and bf16,
  against JAX's dp2 step on JAX's initial weights over 4 steps: losses
  and the synced gradient's norm within 1e-4 relative; parameters and the residual rows with at most 0.5 %
  of their elements beyond 1e-5 absolute and none beyond 2·lr·steps. An
  element near a rounding boundary lands on the other int8 level when the
  two packages' gradients differ by ~1e-7, and AdamW turns that into an
  update difference of up to ~lr (``MEASURED_SHARE`` records the shares).
* One rank at int8 quantizes, as the JAX single-device step does.
* The ``grad_quantize`` and ``grad_bucket`` events carry JAX's fields.

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

SEQ, BATCH, STEPS, LR, VOCAB = 32, 8, 4, 1e-3, 128
BLOCK = 256
LOSS_RTOL, ELEM_ATOL, ELEM_SHARE = 1e-4, 1e-5, 5e-3
BUCKET_MB = 0.05  # the soak's cap: 7 buckets of the tiny model
MODES = {"int8": dict(grad_allreduce="int8"),
         "int8-buckets": dict(grad_allreduce="int8", grad_bucket_mb=BUCKET_MB),
         "bf16": dict(grad_allreduce="bf16")}


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the JAX side ----------------------------------------------------------------


def jax_batches(n, seed=3):
    from pyrecover_tpu.data import StatefulSampler, SyntheticTextDataset
    from pyrecover_tpu.data.collate import collate_clm

    ds = SyntheticTextDataset(num_samples=64, seq_len=SEQ, vocab_size=VOCAB, seed=seed)
    sampler = StatefulSampler(len(ds), BATCH, seed=seed)
    return [collate_clm([ds[i] for i in sampler.next_batch()], 0) for _ in range(n)]


def jax_config(**kw):
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig

    return JaxTrainConfig(model=JaxModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ),
                          sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                          lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32", **kw)


def jax_run(batches, data=2, steps=None, **kw):
    """JAX's step on a ``data``-replica mesh over ``batches``: per-step
    metrics, the initial params (numpy), the final state as numpy, and the
    state after each step (for resumes)."""
    import jax

    from pyrecover_tpu.optim import build_optimizer
    from pyrecover_tpu.parallel.mesh import MeshConfig, create_mesh
    from pyrecover_tpu.train import init_sharded_state
    from pyrecover_tpu.train_state import make_train_step

    jcfg = jax_config(**{k: v for k, v in kw.items() if k != "grad_bucket_mb"})
    tx, _ = build_optimizer(jcfg)
    mesh = create_mesh(MeshConfig(data=data), devices=jax.devices()[:data])
    state = init_sharded_state(jax.random.key(0), jcfg.model, tx, mesh,
                               optimizer_sharding=jcfg.optimizer_sharding,
                               grad_allreduce=jcfg.grad_allreduce)
    init = jax.tree.map(np.asarray, state.params)
    step = make_train_step(jcfg.model, tx, donate=False,
                           optimizer_sharding=jcfg.optimizer_sharding,
                           grad_allreduce=jcfg.grad_allreduce,
                           grad_bucket_mb=kw.get("grad_bucket_mb", 0.0))
    metrics, states = [], []
    with jax.sharding.set_mesh(mesh):
        for batch in batches[:steps]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(state)
    return metrics, init, jax.tree.map(np.asarray, state), states


def write_inputs(tmp_path, batches, np_params):
    from pyrecover_tpu_torch.models.llama import params_from_jax

    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params_from_jax(np_params).items()})
    np.savez(tmp_path / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                          for k, v in b.items()})


def port_params_tree(path):
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_to_numpy

    model = Transformer(ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ,
                                           compute_dtype="float32"))
    with np.load(path) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    return params_to_numpy(model)


def share_beyond(got, want):
    """``(share of elements beyond ELEM_ATOL, largest difference)`` over
    paired numpy arrays."""
    n = bad = 0
    worst = 0.0
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        n, bad, worst = n + d.size, bad + int((d > ELEM_ATOL).sum()), max(worst, float(d.max()))
    return bad / n, worst


def assert_close_by_share(got, want, what):
    share, worst = share_beyond(got, want)
    assert share <= ELEM_SHARE and worst <= 2 * LR * STEPS, (what, share, worst)
    return share, worst


# ---- the collective ------------------------------------------------------------


def jax_psum(xs, mode):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pyrecover_tpu.parallel.collectives import quantized_psum_flat
    from pyrecover_tpu.parallel.mesh import AXIS_DATA, MeshConfig, create_mesh

    n = xs.shape[0]
    mesh = create_mesh(MeshConfig(data=n), devices=jax.devices()[:n])

    def region(xloc):
        red, dfc = quantized_psum_flat(xloc[0], mode=mode, block=BLOCK, axis_name=AXIS_DATA)
        return red[None], (jnp.zeros_like(xloc[0]) if dfc is None else dfc)[None]

    with jax.sharding.set_mesh(mesh):
        red, dfc = jax.jit(jax.shard_map(
            region, mesh=mesh, in_specs=(P(AXIS_DATA),), out_specs=(P(AXIS_DATA), P(AXIS_DATA)),
            axis_names={AXIS_DATA}, check_vma=False))(jnp.asarray(xs))
    return np.asarray(red), np.asarray(dfc)


@pytest.fixture(scope="module")
def psum_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    xs = np.random.default_rng(1).standard_normal((2, 2 * BLOCK * 3)).astype(np.float32)
    xs[:, :BLOCK] *= 1e-3  # a block of small values beside larger ones
    np.save(tmp / "xs.npy", xs)
    outs = spawn("psum", {"dir": str(tmp), "modes": ["int8", "bf16"]})
    return xs, outs


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_psum_matches_jax(psum_pair, mode):
    xs, outs = psum_pair
    jred, jdfc = jax_psum(xs, mode)
    absmax = np.abs(xs).reshape(2, -1, BLOCK).max(axis=(0, 2)).repeat(BLOCK) * 2
    for rank, out in enumerate(outs):
        red = np.asarray(out[mode]["reduced"], np.float32)
        np.testing.assert_array_equal(red, np.asarray(outs[0][mode]["reduced"], np.float32))
        assert (np.abs(red - jred[rank]) <= 1e-6 * absmax).all()
        if mode == "int8":
            dfc = np.asarray(out[mode]["deficit"], np.float32)
            assert (np.abs(dfc - jdfc[rank]) <= 1e-6 * absmax).all()
        else:
            assert out[mode]["deficit"] is None
    if mode == "int8":
        # the feedback identity: the deficits owe what the result lacks
        true = xs.astype(np.float64).sum(0)
        total = np.asarray(outs[0][mode]["reduced"], np.float64) + sum(
            np.asarray(o[mode]["deficit"], np.float64) for o in outs)
        np.testing.assert_allclose(total, true, rtol=0, atol=2e-5 * np.abs(true).max())
    if mode == "bf16":  # a cast and a sum: bit-equal
        assert all(np.array_equal(np.asarray(o[mode]["reduced"], np.float32), jred[r])
                   for r, o in enumerate(outs))


def test_roundtrip_local_and_helpers_match_jax():
    import jax.numpy as jnp

    from pyrecover_tpu.parallel import collectives as jc
    from pyrecover_tpu_torch.parallel import collectives as pc

    x = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    for mode in ("int8", "bf16", "fp32"):
        jr, jd = jc.quantized_roundtrip_local(jnp.asarray(x), mode=mode, block=BLOCK)
        pr, pd = pc.quantized_roundtrip_local(torch.from_numpy(x), mode=mode, block=BLOCK)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        assert (pd is None) == (jd is None)
        if pd is not None:
            np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
            np.testing.assert_allclose((pr + pd).numpy(), x, atol=1e-7)
    for args in ((1000, 4, 256), (1025, 4, 256), (11, 2, 8), (0, 1, 256)):
        assert pc.padded_flat_len(*args) == jc.padded_flat_len(*args)
    for args in (("fp32",), ("bf16",), ("int8", 256), ("int8", 64), ("fp32", 256, 2)):
        assert pc.wire_bytes_per_element(*args) == jc.wire_bytes_per_element(*args)
    grads = [torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), torch.ones(5)]
    flat, unflatten = pc.flatten_grads(grads, pc.padded_flat_len(11, 2, 8))
    assert flat.shape == (16,) and flat.dtype == torch.float32
    back = unflatten(flat)
    assert back[0].dtype == torch.bfloat16 and back[0].shape == (2, 3)
    with pytest.raises(ValueError, match="padded_len"):
        pc.flatten_grads(grads, 4)


def test_error_feedback_rescues_coarse_quantization():
    """JAX's test on the port's ``quantized_roundtrip_local``: SGD on a
    quadratic whose gradient has one dominant oscillating coordinate; with
    one scale block the tiny coordinates round to zero without feedback and
    never move, while the residual carries them through."""
    from pyrecover_tpu_torch.parallel.collectives import quantized_roundtrip_local

    target = np.full(256, 0.05, np.float32)
    eta = 0.5

    def run(feedback, steps=400):
        x = np.zeros(256, np.float32)
        res = np.zeros(256, np.float32)
        tail = []
        for t in range(steps):
            g = x - target
            g[0] += 100.0 * (1 if t % 2 == 0 else -1)
            if feedback:
                g = g + res
            q, dfc = quantized_roundtrip_local(torch.from_numpy(g), mode="int8", block=256)
            if feedback:
                res = dfc.numpy()
            x = x - eta * q.numpy()
            if t >= steps // 2:
                tail.append(x.copy())
        return np.mean(tail, axis=0)

    assert np.abs(run(False) - target)[1:].max() >= 0.05 * 0.99
    assert np.abs(run(True) - target)[1:].max() < 0.01


# ---- the train step ---------------------------------------------------------------

MEASURED_SHARE = {}


@pytest.fixture(scope="module")
def dp2_runs(tmp_path_factory):
    """JAX's dp2 step and the port's (2 gloo ranks) in every wire mode, from
    the same initial weights over the same batches."""
    tmp = tmp_path_factory.mktemp("wire")
    batches = jax_batches(STEPS)
    jax_out = {name: jax_run(batches, **kw) for name, kw in MODES.items()}
    write_inputs(tmp, batches, jax_out["int8"][1])
    outs = spawn("train", {"dir": str(tmp), "modes": MODES}, timeout=240)
    return tmp, jax_out, outs


@pytest.mark.parametrize("name", list(MODES))
def test_dp2_step_matches_jax(dp2_runs, name):
    tmp, jax_out, outs = dp2_runs
    jm, _, jstate, _ = jax_out[name]
    for out in outs:  # both ranks log the global loss
        for step, (a, b) in enumerate(zip(out[name]["metrics"], jm)):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL, err_msg=f"step {step}")
            # the norm of the synced gradient: the wire's sum itself
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=LOSS_RTOL,
                                       err_msg=f"step {step}")
            assert a["n_tokens"] == b["n_tokens"]
    import jax

    got = jax.tree_util.tree_leaves(port_params_tree(tmp / f"params_{name}_rank0.npz"))
    want = jax.tree_util.tree_leaves(jstate.params)
    MEASURED_SHARE[name] = {"params": assert_close_by_share(got, want, f"{name} params")}
    if name.startswith("int8"):
        rows = [np.load(tmp / f"residual_{name}_rank{r}.npy")[0] for r in range(2)]
        MEASURED_SHARE[name]["residual"] = assert_close_by_share(
            rows, list(np.asarray(jstate.grad_residual)), f"{name} residual")
        assert all(np.abs(r).max() > 0 for r in rows)
    # the two ranks hold one set of weights
    with np.load(tmp / f"params_{name}_rank0.npz") as a, \
            np.load(tmp / f"params_{name}_rank1.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_buckets_change_the_int8_trajectory_only_in_the_low_bits(dp2_runs):
    """JAX's layout over the tiny model is 7 buckets; the port's step took
    them (the bucketed run differs from the whole-vector one) and stays
    within the policy of it."""
    _, _, outs = dp2_runs
    assert outs[0]["int8-buckets"]["buckets"] == 7
    whole = [m["loss"] for m in outs[0]["int8"]["metrics"]]
    bucketed = [m["loss"] for m in outs[0]["int8-buckets"]["metrics"]]
    assert whole != bucketed
    assert max(abs(a - b) / a for a, b in zip(whole, bucketed)) < 2e-3


def test_one_rank_at_int8_quantizes_as_jax_single_device(tmp_path):
    """A single process at int8 goes through ``quantized_roundtrip_local``
    (JAX :527-529): it matches JAX's one-device int8 step, carries a
    nonzero residual, and is not the fp32 step."""
    import jax

    from pyrecover_tpu_torch.train_state import param_leaves

    batches = jax_batches(STEPS)
    jm, init, jstate, _ = jax_run(batches, data=1, grad_allreduce="int8")
    write_inputs(tmp_path, batches, init)
    model, step = _port_model_and_step(tmp_path / "params.npz", grad_allreduce="int8")
    metrics = [{k: float(v) for k, v in step(_to_torch(b)).items()} for b in batches]
    for a, b in zip(metrics, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    from pyrecover_tpu_torch.models.llama import params_to_numpy

    assert_close_by_share(jax.tree_util.tree_leaves(params_to_numpy(model)),
                          jax.tree_util.tree_leaves(jstate.params), "world-1 params")
    assert step.residual.row.shape == tuple(np.asarray(jstate.grad_residual).shape)
    assert float(step.residual.row.abs().max()) > 0
    fp32_model, fp32_step = _port_model_and_step(tmp_path / "params.npz")
    for b in batches:
        fp32_step(_to_torch(b))
    assert not all(torch.equal(p, q) for p, q in zip(
        (leaf.parts[0] for leaf in param_leaves(model)),
        (leaf.parts[0] for leaf in param_leaves(fp32_model))))


def test_grad_events_carry_jax_fields(tmp_path):
    from pyrecover_tpu_torch import telemetry, train

    sink = telemetry.add_sink(telemetry.MemorySink())
    try:
        train.main(["--device", "cpu", "--training-steps", "2", "--batch-size", "2",
                    "--sequence-length", str(SEQ), "--model-dim", "64", "--model-layers", "2",
                    "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", str(VOCAB),
                    "--checkpoint-frequency", "0", "--checkpoint-dir", str(tmp_path),
                    "--grad-allreduce", "int8", "--optimizer-sharding", "zero1",
                    "--grad-bucket-mb", str(BUCKET_MB)])
    finally:
        telemetry.remove_sink(sink)
    quant = [e for e in sink.events if e["event"] == "grad_quantize"]
    assert len(quant) == 1
    e = quant[0]
    assert set(e) >= {"mode", "optimizer_sharding", "block", "data_replicas", "error_feedback",
                      "grad_bytes_fp32", "wire_bytes_per_leg"}
    assert e["mode"] == "int8" and e["optimizer_sharding"] == "zero1"
    assert e["error_feedback"] is True and e["data_replicas"] == 1 and e["block"] == BLOCK
    assert 0 < e["wire_bytes_per_leg"] < e["grad_bytes_fp32"]
    (bucket,) = [e for e in sink.events if e["event"] == "grad_bucket"]
    assert bucket["buckets"] == 7 and not bucket["degenerate"] and bucket["mode"] == "int8"
    assert sum(bucket["bucket_bytes_f32"]) == e["grad_bytes_fp32"]


# ---- worker side -------------------------------------------------------------------


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k != "segments"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_model_and_step(params_path, **kw):
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import make_train_step

    cfg = TrainConfig(model=ModelConfig().tiny(vocab_size=VOCAB, max_seq_len=SEQ),
                      sequence_length=SEQ, batch_size=BATCH, learning_rate=LR,
                      lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32",
                      device="cpu", **kw)
    model = Transformer(cfg.model)
    with np.load(params_path) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    opt, _ = build_optimizer(cfg, model.parameters(), model=model)
    return model, make_train_step(model, opt, grad_bucket_mb=cfg.grad_bucket_mb,
                                  grad_allreduce=cfg.grad_allreduce)


def _load_batches(d):
    with np.load(d / "batches.npz") as z:
        n = len({k.split("/")[0] for k in z.files})
        return [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                for i in range(n)]


def _psum_worker(args):
    from pyrecover_tpu_torch.parallel import collectives, mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    x = torch.from_numpy(np.load(Path(args["dir"]) / "xs.npy")[mesh.rank()])
    out = {}
    for mode in args["modes"]:
        red, dfc = collectives.quantized_psum_flat(x, mode=mode, block=BLOCK)
        out[mode] = {"reduced": red.tolist(),
                     "deficit": None if dfc is None else dfc.tolist()}
    mesh.destroy_distributed()
    return out


def _train_worker(args):
    """Each wire mode's dp2 run of the saved batches; rank r takes rows
    [r*B/2, (r+1)*B/2). Saves the final params and the residual row."""
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    rank = mesh.rank()
    d = Path(args["dir"])
    per = BATCH // mesh.world_size()
    local = [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()}
             for b in _load_batches(d)]
    out = {}
    for name, kw in args["modes"].items():
        model, step = _port_model_and_step(d / "params.npz", **kw)
        out[name] = {"metrics": [{k: float(v) for k, v in step(_to_torch(b)).items()}
                                 for b in local],
                     "buckets": len(step.layout) if step.layout else 0}
        np.savez(d / f"params_{name}_rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in model.state_dict().items()})
        if step.residual is not None:
            np.save(d / f"residual_{name}_rank{rank}.npy", step.residual.row.numpy())
    mesh.destroy_distributed()
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"psum": _psum_worker, "train": _train_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
