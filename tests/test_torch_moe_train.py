"""The port's MoE training held to the JAX package's: the train step with the
load-balance aux objective, the optimizer over a tree that mixes an fp32
router with bf16 parameters, data parallelism, checkpoints both ways,
resume, serving restore and the generate CLI.

Both trainers start from the same weights (JAX ``init_params`` through
``params_from_jax``) and take the same batches (the JAX package's synthetic
data) on a tiny MoE model (dim 64, 2 layers, 4 experts, top-2) on the CPU,
with ``tests/test_torch_train.py``'s tolerances: per-step losses and the aux
loss 1e-5 relative; gradients 1e-5 of the largest gradient; parameters
after five AdamW updates 1e-5 absolute; at bf16 parameters the gradient
norm within one bf16 step (2**-8), the fp32 router within 1e-5, and at most 1 % of the
bf16 parameters one bf16 ulp of the largest weights (4.9e-4) apart (twice
the dense share; see ``BF16_PARAM_SHARE``). Two gloo ranks hold to one
process within 1e-6 at step 1 and 1e-5 after. Checkpoint leaves cross
bit for bit.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SEQ, BATCH, STEPS, LR = 32, 4, 5, 1e-3
MOE = dict(n_experts=4, moe_top_k=2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(n, seed=3):
    from pyrecover_tpu.data import StatefulSampler, SyntheticTextDataset
    from pyrecover_tpu.data.collate import collate_clm

    ds = SyntheticTextDataset(num_samples=64, seq_len=SEQ, vocab_size=256, seed=seed)
    sampler = StatefulSampler(len(ds), BATCH, seed=seed)
    return [collate_clm([ds[i] for i in sampler.next_batch()], 0) for _ in range(n)]


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def configs(**kw):
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig

    common = dict(sequence_length=SEQ, batch_size=BATCH, learning_rate=LR, lr_warmup_steps=2,
                  training_steps=8, model_dtype="fp32", **kw)
    return (JaxTrainConfig(model=JaxModelConfig().tiny(**MOE), **common),
            TrainConfig(model=ModelConfig().tiny(**MOE), device="cpu", **common))


class Pair:
    """The JAX state and step, and the port's model, optimizer and step, on
    one configuration from the same initial weights."""

    def __init__(self, **kw):
        import jax

        from pyrecover_tpu.models.llama import init_params
        from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
        from pyrecover_tpu.train_state import make_train_step as jax_make_train_step
        from pyrecover_tpu_torch.models.llama import Transformer, params_from_jax
        from pyrecover_tpu_torch.optim import build_optimizer
        from pyrecover_tpu_torch.train_state import make_train_step

        self.jcfg, self.pcfg = configs(**kw)
        self.np_params = jax.tree.map(np.asarray, init_params(jax.random.key(0), self.jcfg.model))
        self.tx, _ = jax_build_optimizer(self.jcfg)
        self.jstep = jax_make_train_step(
            self.jcfg.model, self.tx, donate=False,
            grad_accumulation_steps=self.jcfg.grad_accumulation_steps)
        self.model = Transformer(self.pcfg.model)
        self.model.load_state_dict(params_from_jax(self.np_params))
        self.opt, _ = build_optimizer(self.pcfg, self.model.parameters())
        self.pstep = make_train_step(self.model, self.opt,
                                     grad_accumulation_steps=self.pcfg.grad_accumulation_steps)

    def jax_state(self, seed=0):
        import jax
        import jax.numpy as jnp

        from pyrecover_tpu.train_state import create_train_state

        return create_train_state(jax.random.key(seed), self.jcfg.model, self.tx,
                                  params=jax.tree.map(jnp.asarray, self.np_params))

    def jax_steps(self, state, batch_list):
        import jax
        import jax.numpy as jnp

        out = []
        for b in batch_list:
            state, m = self.jstep(state, jax.tree.map(jnp.asarray, b))
            out.append({k: float(v) for k, v in m.items()})
        return state, out

    def port_steps(self, batch_list):
        return [{k: float(v) for k, v in self.pstep(to_torch(b)).items()} for b in batch_list]


def leaves_with_path(tree):
    import jax

    return jax.tree_util.tree_leaves_with_path(tree)


# ---- the train step ------------------------------------------------------------


CASES = {"fp32": {}, "bf16-params": {"param_dtype": "bf16"},
         "grad-accum-2": {"grad_accumulation_steps": 2}}
# bf16 parameters: test_torch_train.py's one-ulp bound, and twice its share:
# measured on the CPU, 0.50 % of the bf16 parameters one ulp apart after five
# steps (0.096 % on the dense model): routing amplifies the gradients' own
# bf16 rounding, which flips a pick's gate where two experts are near a tie
BF16_PARAM_SHARE, BF16_PARAM_ATOL = 1e-2, 4.9e-4


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_moe_train_steps_match_jax(case):
    """Five steps of CE + 0.01 · aux in both trainers: the CE loss, the aux
    loss and the gradient norm each step, the final parameters."""
    from pyrecover_tpu_torch.models.llama import params_to_numpy

    import jax

    pair = Pair(**CASES[case])
    data = batches(STEPS)
    state, jm = pair.jax_steps(pair.jax_state(), data)
    pm = pair.port_steps(data)
    bf16 = case == "bf16-params"
    for step, (a, b) in enumerate(zip(pm, jm)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(a["moe_aux"], b["moe_aux"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=2**-8 if bf16 else 1e-5)
        assert a["n_tokens"] == b["n_tokens"]
    assert all(1.5 < m["moe_aux"] < 8 for m in pm)  # two layers, each near 1
    jparams = jax.tree.map(np.asarray, state.params)
    pparams = params_to_numpy(pair.model)
    pairs = [(a, np.asarray(b, np.float32)) for (_, a), (_, b) in
             zip(leaves_with_path(pparams), leaves_with_path(jparams))]
    low = [] if not bf16 else [(a, b) for (path, _), (a, b) in
                               zip(leaves_with_path(pparams), pairs) if "router" not in str(path)]
    if bf16:  # the bf16 leaves; the router stays fp32 and is held as fp32 below
        assert pair.model.layers[0].router.dtype == torch.float32
        assert jparams["layers"]["router"].dtype == np.float32
        differ = sum(int((a != b).sum()) for a, b in low)
        share = differ / sum(a.size for a, _ in low)
        worst = max(float(np.abs(a - b).max()) for a, b in low)
        assert share <= BF16_PARAM_SHARE and worst <= BF16_PARAM_ATOL, (share, worst)
    for (path, _), (a, b) in zip(leaves_with_path(pparams), pairs):
        if not bf16 or "router" in str(path):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(path))


def test_first_step_grads_match_jax():
    """The gradients of CE + 0.01 · aux at the first step, every leaf."""
    import jax
    import jax.numpy as jnp

    from pyrecover_tpu.models.llama import forward_hidden_with_aux as jax_hidden
    from pyrecover_tpu.train_state import chunked_ce as jax_chunked_ce

    pair = Pair()
    batch = batches(1)[0]
    cfg = pair.jcfg.model

    def loss(params):
        hidden, aux = jax_hidden(params, jnp.asarray(batch["inputs"]), cfg)
        ce = jax_chunked_ce(params, hidden, jnp.asarray(batch["labels"]), cfg, 0)[0]
        return ce + cfg.moe_aux_weight * aux

    want = jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray, pair.np_params)))
    pair.pstep(to_torch(batch))
    grads = {n: p.grad.numpy() for n, p in pair.model.named_parameters()}
    for key, w in want["layers"].items():
        g = np.stack([grads[f"layers.{i}.{key}"] for i in range(w.shape[0])])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=key)
    for key in ("tok_embed", "final_norm", "output"):
        np.testing.assert_allclose(grads[key], want[key], rtol=0,
                                   atol=1e-5 * np.abs(want[key]).max(), err_msg=key)


def test_clip_and_adamw_over_a_mixed_dtype_tree_match_optax():
    """Two clipped AdamW updates of a tree holding a bf16 matrix and an fp32
    router (the MoE leaves under ``--param-dtype bf16``): the global norm is
    fp32 (JAX's promotion of the leaves' dtypes), each leaf divides by it
    cast to its own dtype and updates in its own dtype. The bf16 leaf equals
    optax's bit for bit and the router is within the 1e-5 parameter
    tolerance (the norm's cast to bf16 for every leaf put it 2e-3 off)."""
    import jax.numpy as jnp
    import optax

    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.optim import build_optimizer

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((8, 16)) * 0.1).astype(np.float32)
    r = (rng.standard_normal((16, 4)) * 0.1).astype(np.float32)
    grads = [((rng.standard_normal((8, 16)) * s).astype(np.float32),
              (rng.standard_normal((16, 4)) * s).astype(np.float32)) for s in (3.0, 0.7)]
    kw = dict(learning_rate=1e-3, lr_warmup_steps=1, grad_max_norm=1.0)
    tx, _ = jax_build_optimizer(JaxTrainConfig(**kw))
    params = {"w": jnp.asarray(w).astype(jnp.bfloat16), "router": jnp.asarray(r)}
    state = tx.init(params)
    pw = torch.nn.Parameter(torch.from_numpy(w).bfloat16())
    pr = torch.nn.Parameter(torch.from_numpy(r))
    opt, _ = build_optimizer(TrainConfig(device="cpu", **kw), [pr, pw])
    for gw, gr in grads:
        g = {"w": jnp.asarray(gw).astype(jnp.bfloat16), "router": jnp.asarray(gr)}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        pw.grad, pr.grad = torch.from_numpy(gw).bfloat16(), torch.from_numpy(gr)
        opt.step()
    assert pw.dtype == torch.bfloat16 and pr.dtype == torch.float32
    assert opt.moments(pr)[0].dtype == torch.float32
    np.testing.assert_array_equal(pw.detach().float().numpy(),
                                  np.asarray(params["w"].astype(jnp.float32)))
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(params["router"]), rtol=0,
                               atol=1e-5)


# ---- data parallelism ----------------------------------------------------------


def test_dp2_moe_matches_one_process(tmp_path):
    """Two gloo ranks, each on its half of every global batch, against the
    port's one-process step: each rank's aux term is its rows' share of the
    global mean times the world size, so DDP's average is the one-process
    gradient. Step 1 within 1e-6, the later steps and the final weights
    within 1e-5; with and without gradient accumulation."""
    from test_torch_distributed import spawn

    from pyrecover_tpu_torch.models.llama import params_from_jax

    pair = Pair()
    data = batches(3, seed=4)
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params_from_jax(pair.np_params).items()})
    np.savez(tmp_path / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(data)
                                          for k, v in b.items()})
    outs = spawn(__file__, "train", {"dir": str(tmp_path), "accum": [1, 2]})
    for accum in (1, 2):
        model, step = _port_model_and_step(tmp_path / "params.npz", accum)
        one = [{k: float(v) for k, v in step(to_torch(b)).items()} for b in data]
        for out in outs:  # both ranks log the global metrics
            got = out[str(accum)]
            for i, (a, b) in enumerate(zip(got, one)):
                rtol = 1e-6 if i == 0 else 1e-5
                for key in ("loss", "moe_aux", "grad_norm"):
                    np.testing.assert_allclose(a[key], b[key], rtol=rtol,
                                               err_msg=f"accum {accum} step {i} {key}")
                assert a["n_tokens"] == b["n_tokens"]
        with np.load(tmp_path / f"params_{accum}_rank0.npz") as z:
            for name, p in model.state_dict().items():
                np.testing.assert_allclose(z[name], p.numpy(), rtol=0, atol=1e-5, err_msg=name)


# ---- checkpoints ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"], ids=["fp32", "bf16-params"])
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_moe_checkpoints_cross_both_ways(tmp_path, direction, dtype):
    """A checkpoint of either package restores in the other, every leaf bit
    for bit (the MoE leaves in JAX's flatten order, the router and its
    moments fp32 beside bf16 parameters), and the next steps agree."""
    import jax

    from pyrecover_tpu.checkpoint import vanilla as jax_vanilla
    from pyrecover_tpu_torch.checkpoint.vanilla import (
        load_ckpt_vanilla,
        read_ckpt_meta,
        save_ckpt_vanilla,
    )
    from pyrecover_tpu_torch.models.llama import params_to_numpy
    from pyrecover_tpu_torch.train_state import load_state_leaves, rng_key, state_leaves

    pair = Pair(param_dtype=dtype)
    data = batches(5)
    path = tmp_path / "exp" / "ckpt_3.ckpt"
    as_f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    if direction == "port-to-jax":
        pair.port_steps(data[:3])
        save_ckpt_vanilla(path, state_leaves(pair.model, pair.opt, 3, 0, rng_key(0)),
                          {"consumed": 3}, verify=True, extra_meta={"step": 3, "epoch": 0})
        target = pair.jax_state()
        _, paths, raw = jax_vanilla.read_ckpt_raw(path)
        flat = jax.tree_util.tree_flatten_with_path(target)[0]
        assert paths == [jax.tree_util.keystr(p) for p, _ in flat]
        assert [(str(a.dtype), a.shape) for a in raw] == [(str(x.dtype), x.shape) for _, x in flat]
        assert jax_vanilla.precheck_ckpt_vanilla(path, verify=True, target_state=target) == (True, "")
        state, _, _ = jax_vanilla.load_ckpt_vanilla(path, target, verify=True)
    else:
        state, _ = pair.jax_steps(pair.jax_state(), data[:3])
        jax_vanilla.save_ckpt_vanilla(path, state, {"consumed": 3}, verify=True,
                                      extra_meta={"step": 3, "epoch": 0})
        leaves = state_leaves(pair.model, pair.opt)
        load_ckpt_vanilla(path, leaves, verify=True)
        assert load_state_leaves(leaves, pair.opt)[0] == 3
    meta = read_ckpt_meta(path)
    dtypes = dict(zip(meta["paths"], (lm["dtype"] for lm in meta["leaves"])))
    assert dtypes[".params['layers']['router']"] == "float32"
    assert dtypes[".opt_state[1][0].mu['layers']['router']"] == "float32"
    low = "bfloat16" if dtype == "bf16" else "float32"
    assert dtypes[".params['layers']['moe_w1']"] == low
    assert as_f32(state.params).keys() == params_to_numpy(pair.model).keys()
    for (path_, a), (_, b) in zip(leaves_with_path(as_f32(state.params)),
                                  leaves_with_path(params_to_numpy(pair.model))):
        np.testing.assert_array_equal(a, b, err_msg=str(path_))
    _, jm = pair.jax_steps(state, data[3:])
    pm = pair.port_steps(data[3:])
    for a, b in zip(pm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["moe_aux"], b["moe_aux"], rtol=1e-5)


TINY = ["--device", "cpu", "--sequence-length", str(SEQ), "--batch-size", "2",
        "--training-samples", "16", "--model-dim", "64", "--model-layers", "2",
        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
        "--moe-experts", "4", "--attention-impl", "flash", "--learning-rate", "1e-3",
        "--logging-frequency", "1", "--log-loss-to-csv", "--verify-checkpoints"]


@pytest.mark.parametrize("engine", ["vanilla", "zerostall"])
def test_moe_stop_and_resume_is_bit_exact(tmp_path, engine):
    """Through ``train.main``: a straight 4-step MoE run, and a run of 2 steps
    resumed from ``latest`` to 4, end with equal loss CSVs and equal final
    ``.params`` (the checkpoint's leaves, read back)."""
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.serving import load_serving_params
    from pyrecover_tpu_torch.config import get_args

    base = TINY + ["--checkpoint-dir", str(tmp_path), "--checkpoint-frequency", "2",
                   "--checkpoint-engine", engine]
    a = train.main(base + ["--training-steps", "4", "--experiment-name", "a"])
    b1 = train.main(base + ["--training-steps", "2", "--experiment-name", "b"])
    b2 = train.main(base + ["--training-steps", "4", "--experiment-name", "b",
                            "--resume-from-checkpoint", "latest"])
    assert (b1["end_step"], b2["start_step"], b2["end_step"]) == (2, 2, 4)
    assert a["losses"] == b1["losses"] + b2["losses"]
    assert a["moe_aux"] == b1["moe_aux"] + b2["moe_aux"]
    assert (tmp_path / "a" / "a_loss_log.csv").read_text() == \
        (tmp_path / "b" / "b_loss_log.csv").read_text()
    cfg = get_args(base).model
    served = [dict(load_serving_params(Path(x["saves"][-1]["path"]), cfg, device="cpu")[0]
                   .named_parameters()) for x in (a, b2)]
    for name, p in served[0].items():
        assert torch.equal(p, served[1][name]), name
    assert served[0]["layers.0.router"].dtype == torch.float32


def test_moe_serving_restore_generate_cli_and_elastic(tmp_path, capsys):
    """An MoE checkpoint serves: ``load_serving_params`` builds the MoE model
    from its leaves (experts in the compute dtype, the router fp32), a dense
    config is refused, the generate CLI with ``--moe-experts`` decodes the
    same tokens as ``generate_tokens``, and the elastic preflight's live
    specs list the MoE leaves."""
    import dataclasses

    from pyrecover_tpu_torch import generate, train
    from pyrecover_tpu_torch.checkpoint.elastic import live_target_specs
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.decode import generate_tokens
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.serving import load_serving_params
    from pyrecover_tpu_torch.serving.restore import ServingRestoreError
    from pyrecover_tpu_torch.train_state import state_leaves

    out = train.main(TINY + ["--checkpoint-dir", str(tmp_path), "--training-steps", "2",
                             "--experiment-name", "s", "--model-dtype", "bf16"])
    ckpt = Path(out["saves"][-1]["path"])
    cfg = get_args(TINY + ["--model-dtype", "bf16"]).model
    model, info = load_serving_params(ckpt, cfg, device="cpu")
    assert info["leaves"] == 3 + 10 and info["step"] == 2
    assert model.layers[1].moe_w2.dtype == torch.bfloat16
    assert model.layers[1].router.dtype == torch.float32
    with pytest.raises(ServingRestoreError):
        load_serving_params(ckpt, dataclasses.replace(cfg, n_experts=0), device="cpu")
    want = generate_tokens(model, [1, 2, 3], 6, max_len=cfg.max_seq_len)
    rc = generate.main([str(ckpt), "--model-dim", "64", "--model-layers", "2",
                        "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
                        "--max-seq-len", str(SEQ), "--moe-experts", "4", "--device", "cpu",
                        "--prompt-ids", "1,2,3", "--max-new-tokens", "6"])
    assert rc == 0
    assert capsys.readouterr().out.strip() == ",".join(map(str, want))
    train_model = train.build_model(get_args(TINY), "cpu")
    opt, _ = build_optimizer(get_args(TINY), train_model.parameters())
    specs = live_target_specs(state_leaves(train_model, opt))
    for key in ("router", "moe_w1", "moe_w2", "moe_w3"):
        assert f".params['layers']['{key}']" in specs
        assert f".opt_state[1][0].nu['layers']['{key}']" in specs
    assert not any("['w1']" in p for p in specs)


# ---- worker side ---------------------------------------------------------------


def _port_model_and_step(params_path, accum):
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.train_state import make_train_step

    cfg = TrainConfig(model=ModelConfig().tiny(**MOE), sequence_length=SEQ, batch_size=BATCH,
                      learning_rate=LR, lr_warmup_steps=2, training_steps=8, model_dtype="fp32",
                      device="cpu", grad_accumulation_steps=accum)
    model = Transformer(cfg.model)
    with np.load(params_path) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    opt, _ = build_optimizer(cfg, model.parameters())
    return model, make_train_step(model, opt, grad_accumulation_steps=accum)


def _train_worker(args):
    """dp2 training of the saved batches, rank r on its rows, for each
    accumulation count; saves each run's final params."""
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    rank, world = mesh.rank(), mesh.world_size()
    d = Path(args["dir"])
    with np.load(d / "batches.npz") as z:
        n = len({k.split("/")[0] for k in z.files})
        data = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                for i in range(n)]
    per = BATCH // world
    out = {}
    for accum in args["accum"]:
        model, step = _port_model_and_step(d / "params.npz", accum)
        assert step.ddp is not None
        out[str(accum)] = [
            {k: float(v) for k, v in step(to_torch(
                {k: v[rank * per:(rank + 1) * per] for k, v in b.items()})).items()}
            for b in data]
        np.savez(d / f"params_{accum}_rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    mesh.destroy_distributed()
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    result = {"train": _train_worker}[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
