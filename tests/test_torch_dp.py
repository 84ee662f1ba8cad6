"""Data parallelism in the port (train_state.make_train_step under DDP),
held to the JAX package's single-device step on the same global batch.

Two gloo processes on the CPU, each taking its rows of every global batch,
train a tiny fp32 model from the JAX package's initial weights; the JAX
package's step takes the whole batch on one device (its own dp8 is held to
one device in tests/test_parallel.py:48). Tolerances are
tests/test_torch_train.py's: losses 1e-5 relative, parameters after the
steps 1e-5 absolute (updates are ~lr = 1e-3 a step).

* plain rows: dp2 matches JAX, and the port's one-process step;
* packed rows whose label counts differ between the ranks (rank 0's rows
  end in long pad tails): the loss over the global batch's labels matches
  JAX, where a mean of the ranks' own means is shown to be off;
* ``--grad-bucket-mb`` 0 (one sync after the backward), a cap below every
  leaf (a bucket per parameter) and one above the model give bit-equal
  losses and parameters: each is an elementwise fp32 sum;
* ``--grad-accumulation-steps 2`` under DDP (``no_sync`` but for the last
  micro-step) matches JAX's accumulation;
* host 0's deadline stops both ranks on one step, with one REQUEUE marker.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import CLUSTER_VARS, spawn as _spawn

REPO = Path(__file__).resolve().parent.parent
SEQ, BATCH, STEPS, LR = 32, 4, 4, 1e-3


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


# ---- inputs, and the JAX package's single-device run ---------------------------


def plain_batches(n, seed=3):
    from pyrecover_tpu.data import StatefulSampler, SyntheticTextDataset
    from pyrecover_tpu.data.collate import collate_clm

    ds = SyntheticTextDataset(num_samples=64, seq_len=SEQ, vocab_size=256, seed=seed)
    sampler = StatefulSampler(len(ds), BATCH, seed=seed)
    return [collate_clm([ds[i] for i in sampler.next_batch()], 0) for _ in range(n)]


def packed_batches(n, seed=5):
    """Packed rows (segment ids): rank 0's two rows end in pad tails of
    20-26 positions, rank 1's are dense, so rank 0 holds far fewer labels."""
    from pyrecover_tpu_torch.data.collate import PAD_SEGMENT, collate_clm

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items = []
        for row in range(BATCH):
            toks = rng.integers(1, 256, SEQ + 1).astype(np.int32)
            seg = np.ones(SEQ + 1, np.int32)
            seg[rng.integers(6, 14):] = 2  # two documents a row
            if row < BATCH // 2:
                seg[SEQ + 1 - int(rng.integers(20, 27)):] = PAD_SEGMENT
            items.append((toks, seg))
        out.append(collate_clm(items, 0))
    return out


def jax_run(batches, accum=1):
    """The JAX package's single-device step over ``batches``: per-step
    metrics, final params (numpy tree) and the initial params."""
    import jax
    import jax.numpy as jnp

    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.llama import init_params
    from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
    from pyrecover_tpu.train_state import create_train_state
    from pyrecover_tpu.train_state import make_train_step as jax_make_train_step

    jcfg = JaxTrainConfig(model=JaxModelConfig().tiny(), sequence_length=SEQ, batch_size=BATCH,
                          learning_rate=LR, lr_warmup_steps=2, training_steps=STEPS,
                          model_dtype="fp32", grad_accumulation_steps=accum)
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg.model))
    tx, _ = jax_build_optimizer(jcfg)
    state = create_train_state(jax.random.key(0), jcfg.model, tx,
                               params=jax.tree.map(jnp.asarray, np_params))
    step = jax_make_train_step(jcfg.model, tx, donate=False, grad_accumulation_steps=accum)
    metrics = []
    for batch in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params), np_params


def write_inputs(tmp_path, batches, np_params):
    from pyrecover_tpu_torch.models.llama import params_from_jax

    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params_from_jax(np_params).items()})
    np.savez(tmp_path / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                          for k, v in b.items()})


def port_params_tree(path):
    """A port state-dict npz as the JAX params tree (numpy)."""
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_to_numpy

    model = Transformer(ModelConfig().tiny(max_seq_len=SEQ, compute_dtype="float32"))
    with np.load(path) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    return params_to_numpy(model)


def assert_params_close(got, want, atol=1e-5):
    import jax

    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=str(path))


def port_one_process(tmp_path, batches, accum=1):
    """The port's step in this process, no process group: metrics and
    params."""
    model, step = _port_model_and_step(tmp_path / "params.npz", accum, 0.0)
    metrics = [{k: float(v) for k, v in step(_to_torch(b)).items()} for b in batches]
    from pyrecover_tpu_torch.models.llama import params_to_numpy

    return metrics, params_to_numpy(model)


# ---- the tests -----------------------------------------------------------------


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BUCKETS = [0.0, 1e-3, 1000.0]  # one tail sync; a bucket a parameter; one bucket


@pytest.fixture(scope="module")
def plain_dp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2")
    batches = plain_batches(STEPS)
    jm, jparams, np_params = jax_run(batches)
    write_inputs(tmp, batches, np_params)
    outs = spawn("train", {"dir": str(tmp), "buckets": BUCKETS, "accum": 1})
    return tmp, batches, jm, jparams, outs


def test_dp2_matches_the_jax_single_device_step(plain_dp2):
    tmp, _, jm, jparams, outs = plain_dp2
    for out in outs:  # both ranks log the same global loss
        got = out["runs"]["0.0"]
        for step, (a, b) in enumerate(zip(got, jm)):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=f"step {step}")
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
            assert a["n_tokens"] == b["n_tokens"]  # the global count
    assert_params_close(port_params_tree(tmp / "params_0.0_rank0.npz"), jparams)


def test_dp2_matches_the_ports_one_process_step(plain_dp2):
    tmp, batches, _, _, outs = plain_dp2
    pm, pparams = port_one_process(tmp, batches)
    for a, b in zip(outs[0]["runs"]["0.0"], pm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    for rank in (0, 1):  # every replica holds the same weights
        assert_params_close(port_params_tree(tmp / f"params_0.0_rank{rank}.npz"), pparams)


def test_fp32_buckets_are_bit_equal_across_layouts(plain_dp2):
    tmp, _, _, _, outs = plain_dp2
    first = outs[0]["runs"]["0.0"]
    # DDP's buckets after its first iteration: one a parameter, or one in all
    assert outs[0]["n_buckets"]["0.001"] > 10 and outs[0]["n_buckets"]["1000.0"] == 1
    with np.load(tmp / "params_0.0_rank0.npz") as ref:
        for cap in ("0.001", "1000.0"):
            assert outs[0]["runs"][cap] == first, cap  # losses, norms: bit-equal
            with np.load(tmp / f"params_{cap}_rank0.npz") as z:
                for k in ref.files:
                    np.testing.assert_array_equal(z[k], ref[k], err_msg=f"{cap} {k}")


def test_group_of_one_is_the_one_process_step_bit_for_bit(tmp_path):
    """``--distributed --dp 1`` makes a group of one: the step wraps no DDP
    and syncs nothing, at any bucket cap, so its losses, norms and weights
    equal the one-process step's bit for bit."""
    batches = plain_batches(STEPS)
    _, _, np_params = jax_run(batches[:1])
    write_inputs(tmp_path, batches, np_params)
    (out,) = spawn("one", {"dir": str(tmp_path), "buckets": [0.0, 25.0]}, world=1)
    pm, pparams = port_one_process(tmp_path, batches)
    for cap in ("0.0", "25.0"):
        assert out["ddp"][cap] is False, cap
        assert out["runs"][cap] == pm, cap
        got = port_params_tree(tmp_path / f"params_{cap}_rank0.npz")
        assert_params_close(got, pparams, atol=0)


@pytest.mark.parametrize("bucket_mb", [0.0, 0.05, 0.2, 1000.0])
def test_bucket_layout_matches_jax(bucket_mb):
    """The fp32 bucket layout over the model's leaves, in the JAX step's
    reverse-autodiff order, is the JAX package's (``--grad-bucket-mb`` 0 and
    a cap above the model: no layout, one sync)."""
    import jax

    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu.models.llama import init_params
    from pyrecover_tpu.parallel import collectives as jax_collectives
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.parallel import collectives
    from pyrecover_tpu_torch.train_state import param_leaves

    model = Transformer(ModelConfig().tiny())
    jparams = init_params(jax.random.key(0), JaxModelConfig().tiny())
    order = collectives.param_leaf_order(model)
    assert order == jax_collectives.param_leaf_order(jparams)
    sizes = [int(np.prod(leaf.shape)) for leaf in param_leaves(model)]
    assert sizes == [x.size for x in jax.tree_util.tree_leaves(jparams)]
    got = collectives.resolve_bucket_layout(sizes, bucket_mb, replicas=2, order=order)
    want = jax_collectives.resolve_bucket_layout(sizes, bucket_mb, replicas=2, order=order)
    assert got == ([collectives.GradBucket(**vars(b)) for b in want] if want else None)
    if got:
        assert sum(b.n_elems for b in got) == sum(sizes) and len(got) > 1


def test_packed_rows_with_unequal_label_counts_use_the_global_token_loss(tmp_path):
    """Rank 0's rows hold about half rank 1's labels. The dp2 loss and
    weights follow JAX's ΣCE / N_global; the mean of the ranks' own means,
    what DDP's averaging alone would give, is off by far more than the
    tolerance."""
    batches = packed_batches(STEPS)
    counts = [[int((b["labels"][r] != -100).sum()) for r in range(BATCH)] for b in batches]
    assert all(sum(c[:2]) < 0.75 * sum(c[2:]) for c in counts), counts
    jm, jparams, np_params = jax_run(batches)
    write_inputs(tmp_path, batches, np_params)
    outs = spawn("train", {"dir": str(tmp_path), "buckets": [0.0], "accum": 1,
                           "mean_of_means": True})
    for a, b in zip(outs[0]["runs"]["0.0"], jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert a["n_tokens"] == b["n_tokens"]
    assert_params_close(port_params_tree(tmp_path / "params_0.0_rank0.npz"), jparams)
    # step 1, same weights on both sides: the mean of means is another loss
    naive = outs[0]["mean_of_means"]
    assert abs(naive - jm[0]["loss"]) / jm[0]["loss"] > 1e-3, (naive, jm[0]["loss"])


def test_grad_accumulation_under_ddp_matches_jax(tmp_path):
    batches = plain_batches(STEPS, seed=4)
    jm, jparams, np_params = jax_run(batches, accum=2)
    write_inputs(tmp_path, batches, np_params)
    outs = spawn("train", {"dir": str(tmp_path), "buckets": [0.0, 1000.0], "accum": 2})
    for cap in ("0.0", "1000.0"):
        for a, b in zip(outs[0]["runs"][cap], jm):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
        assert_params_close(port_params_tree(tmp_path / f"params_{cap}_rank0.npz"), jparams)


def test_host0_deadline_stops_both_ranks_on_one_step(tmp_path):
    """Only host 0 sees a deadline (already past); rank 1 has none. Host 0's
    decision is broadcast at the first check step, so both ranks stop there,
    each with the same final step, and one REQUEUE marker is written."""
    argv = ["--device", "cpu", "--distributed", "--dp", "2", "--sequence-length", str(SEQ),
            "--batch-size", str(BATCH), "--training-samples", "32", "--model-dim", "64",
            "--model-layers", "2", "--model-heads", "4", "--model-kv-heads", "2",
            "--vocab-size", "128", "--training-steps", "8", "--checkpoint-frequency", "0",
            "--checkpoint-dir", str(tmp_path), "--experiment-name", "stop",
            "--timeaware-checkpointing", "--preempt-check-interval", "3",
            "--logging-frequency", "1", "--log-loss-to-csv"]
    outs = spawn("main", {"argv": argv},
                 rank_env=lambda r: {"JOB_END_TIME": "1000"} if r == 0 else {})
    assert [(o["end_step"], o["stopped_early"]) for o in outs] == [(3, True), (3, True)]
    exp = tmp_path / "stop"
    assert (exp / "REQUEUE").exists() and not (exp / "DONE").exists()
    assert json.loads((exp / "REQUEUE").read_text())["step"] == 3
    assert sorted(p.name for p in exp.glob("ckpt_*")) == ["ckpt_3_final.ckpt"]
    rows = (exp / "stop_loss_log.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["step", "1", "2", "3"]


# ---- worker side ---------------------------------------------------------------


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k != "segments"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_model_and_step(params_path, accum, bucket_mb):
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import make_train_step

    cfg = TrainConfig(model=ModelConfig().tiny(), sequence_length=SEQ, batch_size=BATCH,
                      learning_rate=LR, lr_warmup_steps=2, training_steps=STEPS,
                      model_dtype="fp32", device="cpu", grad_accumulation_steps=accum)
    model = Transformer(cfg.model)
    with np.load(params_path) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    opt, _ = build_optimizer(cfg, model.parameters())
    return model, make_train_step(model, opt, grad_accumulation_steps=accum,
                                  grad_bucket_mb=bucket_mb)


def _train_worker(args):
    """dp training of the saved batches for each bucket cap; rank r takes
    rows [r*B/n, (r+1)*B/n). Saves each run's final params per rank."""
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    rank, world = mesh.rank(), mesh.world_size()
    d = Path(args["dir"])
    with np.load(d / "batches.npz") as z:
        n = len({k.split("/")[0] for k in z.files})
        batches = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                   for i in range(n)]
    per = BATCH // world
    local = [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()} for b in batches]
    out = {"runs": {}, "n_buckets": {}}
    for cap in args["buckets"]:
        model, step = _port_model_and_step(d / "params.npz", args["accum"], cap)
        if args.get("mean_of_means") and cap == args["buckets"][0]:
            out["mean_of_means"] = _mean_of_means(model, local[0])
        out["runs"][str(cap)] = [{k: float(v) for k, v in step(_to_torch(b)).items()}
                                 for b in local]
        out["n_buckets"][str(cap)] = len(step.ddp._get_ddp_logging_data()
                                         .get("rebuilt_bucket_sizes", "").split(", "))
        np.savez(d / f"params_{cap}_rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    mesh.destroy_distributed()
    return out


def _one_worker(args):
    """A group of one: each bucket cap's run of the saved batches, whether
    the step wrapped DDP, and its final params."""
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    d = Path(args["dir"])
    with np.load(d / "batches.npz") as z:
        n = len({k.split("/")[0] for k in z.files})
        batches = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                   for i in range(n)]
    out = {"runs": {}, "ddp": {}}
    for cap in args["buckets"]:
        model, step = _port_model_and_step(d / "params.npz", 1, cap)
        out["ddp"][str(cap)] = step.ddp is not None
        out["runs"][str(cap)] = [{k: float(v) for k, v in step(_to_torch(b)).items()}
                                 for b in batches]
        np.savez(d / f"params_{cap}_rank0.npz",
                 **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    mesh.destroy_distributed()
    return out


def _mean_of_means(model, batch):
    """The ranks' own mean CE, averaged over the ranks (what averaging
    per-rank mean losses would train on), at the current weights."""
    import torch.distributed as dist

    from pyrecover_tpu_torch.models.llama import forward_hidden_with_aux
    from pyrecover_tpu_torch.train_state import chunked_ce

    with torch.no_grad():
        b = _to_torch(batch)
        hidden, _ = forward_hidden_with_aux(model, b["inputs"], b.get("segments"))
        mean = chunked_ce(model, hidden, b["labels"], 0)[0]
        dist.all_reduce(mean)
    return float(mean) / dist.get_world_size()


def _main_worker(args):
    from pyrecover_tpu_torch import train

    out = train.main(args["argv"])
    return {"end_step": out["end_step"], "stopped_early": out["stopped_early"]}


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"train": _train_worker, "main": _main_worker, "one": _one_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
