"""The port's train step, optimizer, schedules, data and CLI held to the JAX
package's.

Both trainers start from the same weights (JAX ``init_params`` carried over
with ``params_from_jax``) and take the same batches (the JAX package's
synthetic data) on a tiny fp32 model on the CPU. Tolerances: per-step
losses 1e-5 relative; gradients 1e-5 of the largest gradient; parameters
after five AdamW updates 1e-5 absolute (updates are ~lr = 1e-3 per step);
learning rates 1e-6 relative (optax evaluates schedules in fp32).

The ``bf16-params`` case keeps bf16 master weights in both trainers, where
optax runs AdamW in bf16 with bf16 moments: the port follows its order and
dtypes, the losses agree at 1e-5, the logged gradient norm (bf16 in JAX,
fp32 in the port) at one bf16 step (2**-8), and after five updates at most
0.5 % of the parameters may differ, by at most one bf16 ulp of the largest
weights (4.9e-4). Measured on the CPU: 0.096 %, 2.4e-4 apart (the
gradients' own bf16 rounding differs here and there); an fp32-moment AdamW
leaves 26 % apart.
"""

import csv
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
from pyrecover_tpu.data import StatefulSampler as JaxSampler
from pyrecover_tpu.data import SyntheticTextDataset as JaxDataset
from pyrecover_tpu.data.collate import collate_clm as jax_collate
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward_hidden_with_aux as jax_hidden
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
from pyrecover_tpu.train_state import chunked_ce as jax_chunked_ce
from pyrecover_tpu.train_state import create_train_state
from pyrecover_tpu.train_state import make_train_step as jax_make_train_step
from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.config import TrainConfig
from pyrecover_tpu_torch.data import StatefulSampler, SyntheticTextDataset, collate_clm
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, params_from_jax, params_to_numpy
from pyrecover_tpu_torch.optim import build_optimizer, warmup_constant_schedule, warmup_cosine_schedule
from pyrecover_tpu_torch.train_state import make_train_step

REPO = Path(__file__).resolve().parent.parent
SEQ, BATCH, STEPS = 32, 4, 5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(n, seed=3):
    ds = JaxDataset(num_samples=64, seq_len=SEQ, vocab_size=256, seed=seed)
    sampler = JaxSampler(len(ds), BATCH, seed=seed)
    return [jax_collate([ds[i] for i in sampler.next_batch()], 0) for _ in range(n)]


def to_torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def configs(**kw):
    common = dict(sequence_length=SEQ, batch_size=BATCH, learning_rate=1e-3,
                  lr_warmup_steps=2, training_steps=STEPS, model_dtype="fp32", **kw)
    jcfg = JaxTrainConfig(model=JaxModelConfig().tiny(), **common)
    pcfg = TrainConfig(model=ModelConfig().tiny(), **common)
    return jcfg, pcfg


def run_both(**kw):
    """STEPS steps of both trainers; returns per-step metrics of each, the
    final params of each and the port's first-step gradients."""
    jcfg, pcfg = configs(**kw)
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg.model))
    tx, _ = jax_build_optimizer(jcfg)
    state = create_train_state(jax.random.key(0), jcfg.model, tx,
                               params=jax.tree.map(jnp.asarray, np_params))
    jstep = jax_make_train_step(
        jcfg.model, tx, donate=False, loss_chunk_size=jcfg.loss_chunk_size,
        grad_accumulation_steps=jcfg.grad_accumulation_steps,
    )
    model = Transformer(pcfg.model)
    model.load_state_dict(params_from_jax(np_params))
    opt, _ = build_optimizer(pcfg, model.parameters())
    pstep = make_train_step(model, opt, loss_chunk_size=pcfg.loss_chunk_size,
                            grad_accumulation_steps=pcfg.grad_accumulation_steps)
    jm, pm, grads0 = [], [], None
    for batch in batches(STEPS):
        state, m = jstep(state, jax.tree.map(jnp.asarray, batch))
        jm.append({k: float(v) for k, v in m.items()})
        m = pstep(to_torch(batch))
        pm.append({k: float(v) for k, v in m.items()})
        if grads0 is None:
            grads0 = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert opt.count == STEPS
    return jm, pm, jax.tree.map(np.asarray, state.params), params_to_numpy(model), np_params, grads0


CASES = {
    "plain": {},
    "grad-accum-2": {"grad_accumulation_steps": 2},
    "loss-chunk-16": {"loss_chunk_size": 16},
    "clip-1e-3": {"grad_max_norm": 1e-3},
    "cosine-no-clip": {"lr_schedule": "cosine", "grad_clipping": False},
    # the slice's own path: flash attention in both trainers (JAX's in the
    # Pallas interpreter, the port's through its plain versions)
    "flash": {"use_flash_attention": True},
    # bf16 master weights: optax's AdamW in bf16, bf16 moments
    "bf16-params": {"param_dtype": "bf16"},
}
BF16_PARAM_SHARE, BF16_PARAM_ATOL = 5e-3, 4.9e-4


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_train_steps_match_jax(case, monkeypatch):
    monkeypatch.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    jm, pm, jparams, pparams, _, _ = run_both(**CASES[case])
    bf16 = case == "bf16-params"
    for step, (a, b) in enumerate(zip(pm, jm)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=2**-8 if bf16 else 1e-5)
        assert a["n_tokens"] == b["n_tokens"]
    if case == "clip-1e-3":
        assert all(m["grad_norm"] > 1e-3 for m in pm)  # clipping was active
    pairs = list(zip(jax.tree_util.tree_leaves(pparams), jax.tree_util.tree_leaves(jparams)))
    if bf16:
        differ = sum(int((a != np.asarray(b, np.float32)).sum()) for a, b in pairs)
        share = differ / sum(a.size for a, _ in pairs)
        worst = max(float(np.abs(a - np.asarray(b, np.float32)).max()) for a, b in pairs)
        assert share <= BF16_PARAM_SHARE and worst <= BF16_PARAM_ATOL, (share, worst)
        return
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(pparams),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(path))


def test_first_step_grads_match_jax():
    jcfg = configs()[0]
    _, _, _, _, np_params, grads0 = run_both()
    batch = jax.tree.map(jnp.asarray, batches(1)[0])

    def loss(params):
        hidden, _ = jax_hidden(params, batch["inputs"], jcfg.model)
        return jax_chunked_ce(params, hidden, batch["labels"], jcfg.model, 0)[0]

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, np_params))
    want = jax.tree.map(np.asarray, want)
    got = {"tok_embed": grads0["tok_embed"].numpy(), "final_norm": grads0["final_norm"].numpy(),
           "output": grads0["output"].numpy()}
    for key, w in want["layers"].items():
        g = np.stack([grads0[f"layers.{i}.{key}"].numpy() for i in range(w.shape[0])])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=key)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-5 * np.abs(want[key]).max(), err_msg=key)


@pytest.mark.parametrize("warmup", [0, 1, 3, 10])
def test_lr_schedules_match_optax(warmup):
    from pyrecover_tpu.optim import warmup_constant_schedule as jax_constant
    from pyrecover_tpu.optim import warmup_cosine_schedule as jax_cosine

    pairs = [
        (warmup_constant_schedule(3e-4, warmup), jax_constant(3e-4, warmup)),
        (warmup_cosine_schedule(3e-4, warmup, 25, 0.1), jax_cosine(3e-4, warmup, 25, 0.1)),
    ]
    for port, ref in pairs:
        for step in range(40):
            np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6,
                                       err_msg=f"step {step}")


def test_synthetic_batches_bit_identical():
    port_ds = SyntheticTextDataset(num_samples=40, seq_len=SEQ, vocab_size=97, seed=5)
    jax_ds = JaxDataset(num_samples=40, seq_len=SEQ, vocab_size=97, seed=5)
    port_s = StatefulSampler(len(port_ds), 8, seed=5)
    jax_s = JaxSampler(len(jax_ds), 8, seed=5)
    for _ in range(12):  # crosses two epoch boundaries
        pi, ji = port_s.next_batch(), jax_s.next_batch()
        np.testing.assert_array_equal(pi, ji)
        pb = collate_clm([port_ds[i] for i in pi], 0)
        jb = jax_collate([jax_ds[i] for i in ji], 0)
        assert pb.keys() == jb.keys()
        for key in pb:
            assert pb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(pb[key], jb[key])
    assert port_s.state_dict() == jax_s.state_dict()


TINY_CLI = [
    "--training-steps", "3", "--batch-size", "2", "--sequence-length", "32",
    "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
    "--model-kv-heads", "2", "--vocab-size", "128", "--logging-frequency", "2",
    "--attention-impl", "flash", "--learning-rate", "1e-3",
]


def test_cli_runs_three_steps_on_cpu_and_writes_csv(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pyrecover_tpu_torch.train", "--device", "cpu",
         *TINY_CLI, "--checkpoint-dir", str(tmp_path), "--experiment-name", "cli",
         "--log-loss-to-csv"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "cli" / "cli_loss_log.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "loss"]
    assert [int(r[0]) for r in rows[1:]] == [1, 2, 3]
    assert all(np.isfinite(float(r[1])) for r in rows[1:])
    assert "MFU n/a" in proc.stderr  # no card, no peak: no MFU figure


def test_train_raises_without_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(TINY_CLI + ["--checkpoint-dir", str(tmp_path)])
    out = port_train.main(TINY_CLI + ["--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    assert out["device"] == "cpu" and len(out["losses"]) == 3
    assert out["mfu_pct"] is None and out["peak_mem_gib"] is None


@pytest.mark.parametrize("chunk", [0, 8, 12], ids=["whole", "chunk-8", "chunk-not-dividing"])
def test_masked_and_chunked_ce_match_jax(chunk):
    """The loss functions on their own: masked CE over labels != -100 from
    fp32 logits, and the chunked projection + CE (a chunk that does not
    divide the sequence falls back to one chunk, as in JAX)."""
    from pyrecover_tpu.models.llama import ModelConfig as JaxCfg
    from pyrecover_tpu.train_state import masked_cross_entropy as jax_masked_ce
    from pyrecover_tpu_torch.train_state import chunked_ce, masked_cross_entropy

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, SEQ, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, SEQ)).astype(np.int32)
    labels[rng.random((2, SEQ)) < 0.3] = -100
    got, n = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long())
    want, jn = jax_masked_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    jcfg = JaxCfg().tiny(compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(1), jcfg))
    hidden = rng.standard_normal((2, SEQ, jcfg.dim)).astype(np.float32)
    want, _ = jax_chunked_ce(jax.tree.map(jnp.asarray, np_params), jnp.asarray(hidden),
                             jnp.asarray(labels), jcfg, chunk)
    model = Transformer(ModelConfig().tiny(compute_dtype="float32"))
    model.load_state_dict(params_from_jax(np_params))
    with torch.no_grad():
        got, _ = chunked_ce(model, torch.from_numpy(hidden), torch.from_numpy(labels).long(), chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
