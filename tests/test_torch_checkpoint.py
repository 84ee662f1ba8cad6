"""The port's checkpoints held to the JAX package's: the same ``PYRCKPT2``
files, read and written by either package, and resumes that are bit-exact.

Both trainers start from the same weights (JAX ``init_params``) and take the
same batches on a tiny fp32 model on the CPU. Tolerances, as in
``test_torch_train.py``: forwards and per-step losses 1e-5 relative,
parameters 1e-5 absolute after the steps that follow a restore. What a
checkpoint carries (parameters, ``mu``, ``nu``, ``count``, ``step``,
``epoch``, ``rng``) must come through a save and a load bit for bit. Inside
the port a stopped and resumed run must end with a final checkpoint whose
bytes equal the straight run's.
"""

import csv
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.checkpoint import registry as jax_registry
from pyrecover_tpu.checkpoint import vanilla as jax_vanilla
from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
from pyrecover_tpu.data import StatefulSampler as JaxSampler
from pyrecover_tpu.data import SyntheticTextDataset as JaxDataset
from pyrecover_tpu.data.collate import collate_clm as jax_collate
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward as jax_forward
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.optim import build_optimizer as jax_build_optimizer
from pyrecover_tpu.train_state import create_train_state
from pyrecover_tpu.train_state import make_train_step as jax_make_train_step
from pyrecover_tpu_torch.checkpoint import registry
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    load_ckpt_vanilla,
    precheck_ckpt_vanilla,
    read_ckpt_meta,
    save_ckpt_vanilla,
)
from pyrecover_tpu_torch.config import TrainConfig, get_args
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, forward, params_from_jax, params_to_numpy
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.resilience.quarantine import list_quarantined
from pyrecover_tpu_torch.train import train
from pyrecover_tpu_torch.train_state import (
    load_state_leaves,
    make_train_step,
    rng_fold_in,
    rng_key,
    state_leaves,
)

SEQ, BATCH, SEED = 32, 4, 7


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
                  lr_warmup_steps=2, training_steps=8, model_dtype="fp32", **kw)
    return (JaxTrainConfig(model=JaxModelConfig().tiny(), **common),
            TrainConfig(model=ModelConfig().tiny(), **common))


class Pair:
    """The JAX state and step, and the port's model, optimizer and step,
    built for one configuration from the same initial weights."""

    def __init__(self, **kw):
        self.jcfg, self.pcfg = configs(**kw)
        self.np_params = jax.tree.map(np.asarray, init_params(jax.random.key(0), self.jcfg.model))
        self.tx, _ = jax_build_optimizer(self.jcfg)
        self.jstep = jax_make_train_step(self.jcfg.model, self.tx, donate=False)
        self.model = Transformer(self.pcfg.model)
        self.opt, _ = build_optimizer(self.pcfg, self.model.parameters())
        self.pstep = make_train_step(self.model, self.opt)

    def jax_state(self):
        return create_train_state(jax.random.key(SEED), self.jcfg.model, self.tx,
                                  params=jax.tree.map(jnp.asarray, self.np_params))

    def jax_steps(self, state, batch_list):
        losses = []
        for b in batch_list:
            state, m = self.jstep(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
        return state, losses

    def port_steps(self, batch_list):
        return [float(self.pstep(to_torch(b))["loss"]) for b in batch_list]


def stacked(tensors_by_layer):
    return np.stack([t.detach().numpy() for t in tensors_by_layer])


def port_moments(model, opt, which):
    """The port's mu (0) or nu (1) as the JAX params tree of numpy arrays
    (bf16 moments as their exact fp32 values)."""
    m = {n: opt.moments(p)[which].float().numpy() for n, p in model.named_parameters()}
    layers = {key: np.stack([m[f"layers.{i}.{key}"] for i in range(len(model.layers))])
              for key in ("attn_norm", "ffn_norm", "w1", "w2", "w3", "wk", "wo", "wq", "wv")}
    return {"final_norm": m["final_norm"], "layers": layers, "output": m["output"],
            "tok_embed": m["tok_embed"]}


def assert_trees_equal(a, b):
    for (path, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                                 jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def assert_params_close(model, jparams):
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params_to_numpy(model)),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5, err_msg=str(path))


# ---- (a) a JAX checkpoint resumes in the port ------------------------------


@pytest.mark.parametrize("scheme", ["xxh64tree", "sha256"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, scheme):
    from pyrecover_tpu.checkpoint import native_io

    if scheme == "sha256":
        monkeypatch.setattr(native_io, "available", lambda: False)
    pair = Pair()
    data = batches(6)
    state, _ = pair.jax_steps(pair.jax_state(), data[:3])
    state = dataclasses.replace(state, epoch=jnp.asarray(1, jnp.int32))
    path = tmp_path / "exp" / "ckpt_3.ckpt"
    jax_vanilla.save_ckpt_vanilla(path, state, {"consumed": 3}, verify=True,
                                  extra_meta={"step": 3, "epoch": 1})
    sidecar = path.with_suffix(".ckpt.sha256")
    if scheme == "xxh64tree" and not native_io.available():
        # no native engine to write it: the JAX package's pure-Python tree hash
        from pyrecover_tpu.utils import xxh

        sidecar.write_text(f"xxh64tree:{2**24}:{xxh.tree_hash_file(path, 2**24):016x}")
    assert sidecar.read_text().startswith(f"{scheme}:")

    leaves = state_leaves(pair.model, pair.opt)
    assert precheck_ckpt_vanilla(path, verify=True, target=leaves) == (True, "")
    meta = load_ckpt_vanilla(path, leaves, verify=True)
    step, epoch, rng = load_state_leaves(leaves, pair.opt)
    assert (meta["step"], step, epoch, pair.opt.count) == (3, 3, 1, 3)
    np.testing.assert_array_equal(rng, np.asarray(state.rng))
    adam = state.opt_state[1][0]
    assert int(adam.count) == int(state.opt_state[1][2].count) == 3
    assert_trees_equal(params_to_numpy(pair.model), state.params)
    assert_trees_equal(port_moments(pair.model, pair.opt, 0), adam.mu)
    assert_trees_equal(port_moments(pair.model, pair.opt, 1), adam.nu)

    tokens = data[3]["inputs"]
    with torch.no_grad():
        got = forward(pair.model, torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jax_forward(state.params, jnp.asarray(tokens), pair.jcfg.model))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    state, jl = pair.jax_steps(state, data[3:])
    pl = pair.port_steps(data[3:])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert_params_close(pair.model, state.params)


# ---- (b) a port checkpoint loads in the JAX package ------------------------


@pytest.mark.parametrize("clipping", [True, False], ids=["clip", "no-clip"])
def test_port_checkpoint_loads_in_jax(tmp_path, clipping):
    pair = Pair(grad_clipping=clipping)
    data = batches(6)
    pair.model.load_state_dict(params_from_jax(pair.np_params))
    pair.port_steps(data[:3])
    rng = rng_key(SEED)
    for _ in range(3):
        rng = rng_fold_in(rng, 1)
    path = tmp_path / "exp" / "ckpt_3.ckpt"
    save_ckpt_vanilla(path, state_leaves(pair.model, pair.opt, 3, 0, rng),
                      {"consumed": 3}, verify=True, extra_meta={"step": 3, "epoch": 0})

    target = pair.jax_state()
    _, paths, raw = jax_vanilla.read_ckpt_raw(path)
    flat = jax.tree_util.tree_flatten_with_path(target)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in flat]
    assert [(str(a.dtype), a.shape) for a in raw] == [(str(x.dtype), x.shape) for _, x in flat]
    assert jax_vanilla.precheck_ckpt_vanilla(path, verify=True, target_state=target) == (True, "")
    state, sampler, meta = jax_vanilla.load_ckpt_vanilla(path, target, verify=True)
    assert sampler["consumed"] == 3 and meta["topology"]["devices"] == 1
    assert int(state.step) == 3 and int(state.epoch) == 0

    ref, _ = pair.jax_steps(pair.jax_state(), data[:3])  # JAX's own three steps
    np.testing.assert_array_equal(np.asarray(state.rng), np.asarray(ref.rng))
    adam = state.opt_state[1 if clipping else 0][0]
    assert int(adam.count) == 3
    assert_trees_equal(adam.mu, port_moments(pair.model, pair.opt, 0))
    assert_trees_equal(state.params, params_to_numpy(pair.model))

    state, jl = pair.jax_steps(state, data[3:])
    pl = pair.port_steps(data[3:])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert_params_close(pair.model, state.params)


# ---- (b2) bf16 parameters: optax's bf16 moments, both ways -----------------


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_bf16_moments_cross_without_dtype_drift(tmp_path, caplog, direction):
    """At bf16 parameters AdamW's moments are bf16 in both packages, so a
    checkpoint of either restores in the other with no dtype-drift warning
    and every leaf bit for bit."""
    pair = Pair(param_dtype="bf16")
    pair.model.load_state_dict(params_from_jax(pair.np_params))
    data = batches(3)
    path = tmp_path / "exp" / "ckpt_3.ckpt"
    if direction == "port-to-jax":
        pair.port_steps(data)
        save_ckpt_vanilla(path, state_leaves(pair.model, pair.opt, 3, 0, rng_key(SEED)),
                          {"consumed": 3}, verify=True, extra_meta={"step": 3, "epoch": 0})
        meta = read_ckpt_meta(path)
        moments = [lm["dtype"] for p_, lm in zip(meta["paths"], meta["leaves"])
                   if ".mu[" in p_ or ".nu[" in p_]
        assert moments and set(moments) == {"bfloat16"}
        target = pair.jax_state()
        with caplog.at_level("WARNING"):
            ok = jax_vanilla.precheck_ckpt_vanilla(path, verify=True, target_state=target)
            state, _, _ = jax_vanilla.load_ckpt_vanilla(path, target, verify=True)
        assert ok == (True, "")
        adam = state.opt_state[1][0]
        want_mu = port_moments(pair.model, pair.opt, 0)
    else:
        state, _ = pair.jax_steps(pair.jax_state(), data)
        jax_vanilla.save_ckpt_vanilla(path, state, {"consumed": 3}, verify=True,
                                      extra_meta={"step": 3, "epoch": 0})
        leaves = state_leaves(pair.model, pair.opt)
        with caplog.at_level("WARNING"):
            assert precheck_ckpt_vanilla(path, verify=True, target=leaves) == (True, "")
            load_ckpt_vanilla(path, leaves, verify=True)
        load_state_leaves(leaves, pair.opt)
        adam = state.opt_state[1][0]
        want_mu = port_moments(pair.model, pair.opt, 0)
    assert "restore will cast" not in caplog.text
    as_f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    assert_trees_equal(as_f32(adam.mu), as_f32(want_mu))
    assert_trees_equal(as_f32(state.params), params_to_numpy(pair.model))


def test_fp32_moment_checkpoint_at_bf16_casts_with_the_jax_warning(tmp_path, caplog):
    """A port checkpoint from before the moments followed the parameter
    dtype (bf16 parameters, fp32 moments) still restores at bf16: the
    moments are cast, with the JAX pre-check's dtype-drift warning."""
    old = Pair(param_dtype="bf16")
    old.port_steps(batches(2))
    for p in old.model.parameters():
        old.opt.state[p] = {k: v.float() for k, v in old.opt.state[p].items()}
    path = tmp_path / "exp" / "ckpt_2.ckpt"
    save_ckpt_vanilla(path, state_leaves(old.model, old.opt, 2, 0), {"consumed": 2},
                      verify=True, extra_meta={"step": 2, "epoch": 0})
    new = Pair(param_dtype="bf16")
    leaves = state_leaves(new.model, new.opt)
    with caplog.at_level("WARNING"):
        assert precheck_ckpt_vanilla(path, verify=True, target=leaves) == (True, "")
        load_ckpt_vanilla(path, leaves, verify=True)
    assert "dtype float32 in checkpoint vs bfloat16 in model" in caplog.text
    assert "restore will cast" in caplog.text
    for p_old, p_new in zip(old.model.parameters(), new.model.parameters()):
        for m_old, m_new in zip(old.opt.moments(p_old), new.opt.moments(p_new)):
            assert m_new.dtype == torch.bfloat16
            assert torch.equal(m_new, m_old.to(torch.bfloat16))


# ---- (c), (f), (j): resume inside the port ---------------------------------


def tiny_train_config(ckpt_dir, **kw):
    """The CLI path at a tiny size: flash attention (the plain versions on the
    CPU), bf16 compute, 16 samples (4 batches an epoch, so 8 steps cross an
    epoch boundary)."""
    argv = ["--device", "cpu", "--batch-size", "4", "--sequence-length", "32",
            "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
            "--model-kv-heads", "2", "--vocab-size", "128", "--attention-impl", "flash",
            "--learning-rate", "1e-3", "--lr-warmup-steps", "2", "--training-samples", "16",
            "--logging-frequency", "1", "--checkpoint-frequency", "3", "--verify-checkpoints",
            "--log-loss-to-csv", "--seed", str(SEED), "--checkpoint-dir", str(ckpt_dir)]
    return dataclasses.replace(get_args(argv), **kw)


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


RESUME_CASES = {
    "sync": {"async_checkpoint": False},
    "background": {},
    "no-clip": {"grad_clipping": False},
    "grad-accum-2": {"grad_accumulation_steps": 2},
}


@pytest.mark.parametrize("case", list(RESUME_CASES), ids=list(RESUME_CASES))
def test_resume_is_bit_exact(tmp_path, case):
    kw = RESUME_CASES[case]
    straight = train(tiny_train_config(tmp_path / "a", training_steps=8, **kw))
    first = train(tiny_train_config(tmp_path / "b", training_steps=4, **kw))
    exp = tmp_path / "b" / "default-exp"
    assert (first["end_step"], first["stopped_early"]) == (4, False)
    assert (exp / "DONE").exists()
    resumed = train(tiny_train_config(tmp_path / "b", training_steps=8,
                                      resume_from_checkpoint="latest", **kw))
    assert (resumed["start_step"], resumed["end_step"]) == (4, 8)
    assert resumed["losses"] == straight["losses"][4:]
    want = (tmp_path / "a" / "default-exp" / "ckpt_8_final.ckpt").read_bytes()
    assert (exp / "ckpt_8_final.ckpt").read_bytes() == want
    assert [s["path"].rsplit("/", 1)[-1] for s in resumed["saves"]] == [
        "ckpt_6.ckpt", "ckpt_8_final.ckpt"]
    assert resumed["saves"][-1]["bytes"] == len(want)
    # (f) one loss curve across the resume
    rows = csv_rows(exp / "default-exp_loss_log.csv")
    assert rows == csv_rows(tmp_path / "a" / "default-exp" / "default-exp_loss_log.csv")
    assert [r[0] for r in rows] == ["step"] + [str(i) for i in range(1, 9)]


def test_rng_step_and_epoch_follow_jax(tmp_path):
    """(j) After k steps the saved ``rng`` is ``fold_in(key(seed), 1)`` applied
    k times, ``step`` is k and ``epoch`` is k // batches-per-epoch."""
    out = train(tiny_train_config(tmp_path, training_steps=6))
    assert out["end_step"] == 6
    meta, paths, leaves = jax_vanilla.read_ckpt_raw(tmp_path / "default-exp" / "ckpt_6_final.ckpt")
    got = dict(zip(paths, leaves))
    key = jax.random.key(SEED)
    for _ in range(6):
        key = jax.random.fold_in(key, 1)
    np.testing.assert_array_equal(got[".rng"], np.asarray(jax.random.key_data(key)))
    assert got[".rng"].dtype == np.uint32
    assert (int(got[".step"]), int(got[".epoch"]), meta["epoch"]) == (6, 1, 1)
    assert int(got[".opt_state[1][0].count"]) == int(got[".opt_state[1][2].count"]) == 6


# ---- (d) latest with fallback and quarantine -------------------------------


@pytest.fixture
def two_checkpoints(tmp_path):
    """An experiment holding ckpt_2 and ckpt_4_final, both verified."""
    cfg = tiny_train_config(tmp_path, training_steps=4, checkpoint_frequency=2,
                            async_checkpoint=False)
    train(cfg)
    exp = tmp_path / "default-exp"
    assert [p.name for p in registry.list_checkpoints(exp)] == ["ckpt_2.ckpt", "ckpt_4_final.ckpt"]
    return cfg, exp


def flip_byte(path, offset):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0xFF
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("damage", ["corrupt", "truncated"])
def test_latest_quarantines_a_damaged_newest_and_falls_back(two_checkpoints, damage):
    cfg, exp = two_checkpoints
    newest = exp / "ckpt_4_final.ckpt"
    if damage == "corrupt":
        flip_byte(newest, newest.stat().st_size // 2)
    else:
        with open(newest, "r+b") as f:
            f.truncate(newest.stat().st_size - 100)
        newest.with_suffix(".ckpt.sha256").unlink()
        cfg = dataclasses.replace(cfg, verify_checkpoints=False)  # the frame walk finds it
    out = train(dataclasses.replace(cfg, resume_from_checkpoint="latest"))
    assert (out["start_step"], out["end_step"]) == (2, 4)
    assert [p.name for p in list_quarantined(exp)] == ["ckpt_4_final.ckpt"]
    assert (exp / ".corrupt" / "ckpt_4_final.ckpt.sha256").exists() == (damage == "corrupt")
    # the quarantined file is invisible: the rerun saved a fresh final
    assert registry.get_latest_checkpoint(exp).name == "ckpt_4_final.ckpt"


def test_explicit_corrupt_path_raises(two_checkpoints):
    cfg, exp = two_checkpoints
    newest = exp / "ckpt_4_final.ckpt"
    flip_byte(newest, newest.stat().st_size // 2)
    with pytest.raises(ValueError, match="checksum mismatch"):
        train(dataclasses.replace(cfg, resume_from_checkpoint=str(newest)))
    assert newest.exists() and not list_quarantined(exp)


def test_wrong_model_raises_structure_error_and_moves_nothing(two_checkpoints):
    cfg, exp = two_checkpoints
    before = sorted(p.name for p in exp.iterdir())
    wrong = dataclasses.replace(cfg, resume_from_checkpoint="latest",
                                model=dataclasses.replace(cfg.model, dim=32))
    with pytest.raises(CheckpointStructureError, match="does not fit"):
        train(wrong)
    # nothing moved; the raising run left its postmortem bundle beside them
    assert sorted(p.name for p in exp.iterdir() if p.name != ".postmortem") == before
    bundle = json.loads(next((exp / ".postmortem").glob("*/MANIFEST.json")).read_text())
    assert bundle["exception"]["type"] == "CheckpointStructureError"
    # an explicit path fails the same way, in the load
    with pytest.raises(CheckpointStructureError):
        train(dataclasses.replace(wrong, resume_from_checkpoint=str(exp / "ckpt_2.ckpt")))


def test_all_corrupt_raises(two_checkpoints):
    cfg, exp = two_checkpoints
    for p in registry.list_checkpoints(exp):
        flip_byte(p, 20)  # inside the meta header
    with pytest.raises(RuntimeError, match="every checkpoint"):
        train(dataclasses.replace(cfg, resume_from_checkpoint="latest"))
    assert len(list_quarantined(exp)) == 2


def test_latest_with_nothing_starts_fresh(tmp_path):
    out = train(tiny_train_config(tmp_path, training_steps=2, resume_from_checkpoint="latest"))
    assert (out["start_step"], out["end_step"]) == (0, 2)


# ---- (e) retention and discovery by step number ----------------------------


def test_retention_by_step_number_matches_jax(tmp_path):
    def layout(root):
        root.mkdir()
        for name in ("ckpt_200.ckpt", "ckpt_1000.ckpt", "ckpt_30_final.ckpt"):
            (root / name).write_bytes(b"x")
            (root / (name + ".sha256")).write_text("sha256::0")
        (root / "ckpt_500").mkdir()  # a sharded (directory) checkpoint
        (root / "ckpt_600.zs.json").write_text("{}")  # a zerostall manifest
        (root / ".corrupt").mkdir()
        (root / ".corrupt" / "ckpt_5000.ckpt").write_bytes(b"x")
        return root

    port, ref = layout(tmp_path / "port"), layout(tmp_path / "jax")
    assert [p.name for p in registry.list_checkpoints(port)] == [
        "ckpt_30_final.ckpt", "ckpt_200.ckpt", "ckpt_500", "ckpt_600.zs.json", "ckpt_1000.ckpt"]
    assert registry.get_latest_checkpoint(port, engine="vanilla").name == "ckpt_1000.ckpt"
    gone = registry.prune_checkpoints(port, 2, engine="vanilla")
    want = jax_registry.prune_checkpoints(ref, 2, engine="vanilla")
    assert [p.name for p in gone] == [p.name for p in want] == ["ckpt_30_final.ckpt"]
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in ref.iterdir())
    assert not (port / "ckpt_30_final.ckpt.sha256").exists()
    assert (port / "ckpt_500").is_dir() and (port / "ckpt_600.zs.json").exists()
    assert (port / ".corrupt" / "ckpt_5000.ckpt").exists()
    for step in (0, 7, 1000):
        for final in (False, True):
            assert registry.checkpoint_path("d", "e", step, final=final) == \
                jax_registry.checkpoint_path("d", "e", step, final=final)
            assert registry.parse_step(registry.checkpoint_path("d", "e", step, final=final)) == step


def test_save_writes_meta_and_frames_as_jax_reads_them(tmp_path):
    """The header carries what the JAX package's readers use, a stale sidecar
    never survives an unverified rewrite, and a background save's snapshot
    is a copy: an in-place update after the save call does not reach the
    file."""
    model = Transformer(ModelConfig().tiny(n_layers=3))
    opt, _ = build_optimizer(TrainConfig(model=ModelConfig().tiny(n_layers=3)), model.parameters())
    path = tmp_path / "ckpt_5.ckpt"
    path.with_suffix(".ckpt.sha256").write_text("sha256::stale")
    before = model.output.detach().clone()
    handle = save_ckpt_vanilla(path, state_leaves(model, opt, 5, 2, rng_key(1)), {"consumed": 5},
                               extra_meta={"step": 5, "epoch": 2}, background=True)
    with torch.no_grad():
        model.output.add_(1.0)
    handle.wait(timeout=60)
    assert handle.bytes == path.stat().st_size and handle.write_s > 0
    assert not path.with_suffix(".ckpt.sha256").exists()
    meta = read_ckpt_meta(path)
    assert (meta["format"], meta["step"], meta["epoch"], meta["sampler"]) == (2, 5, 2, {"consumed": 5})
    assert meta["leaves"][2] == {"dtype": "float32", "shape": [3, 64]}  # layers stacked on axis 0
    _, paths, leaves = jax_vanilla.read_ckpt_raw(path)
    got = dict(zip(paths, leaves))
    np.testing.assert_array_equal(got[".params['output']"], before.numpy())
    np.testing.assert_array_equal(got[".params['layers']['wq']"],
                                  stacked([layer.wq for layer in model.layers]))
    assert jax_vanilla.precheck_ckpt_vanilla(path) == (True, "")
    shutil.copy(path, tmp_path / "copy.ckpt")
    assert precheck_ckpt_vanilla(tmp_path / "copy.ckpt", verify=True)[0] is False  # no sidecar


def test_checkpoint_flags_follow_jax():
    from pyrecover_tpu.config import build_parser as jax_build_parser
    from pyrecover_tpu_torch.config import build_parser

    port, ref = vars(build_parser().parse_args([])), vars(jax_build_parser().parse_args([]))
    for key in ("checkpoint_dir", "experiment_name", "checkpoint_frequency",
                "max_kept_checkpoints", "resume_from_checkpoint", "verify_checkpoints",
                "no_async_checkpoint", "timeaware_checkpointing", "default_iter_time",
                "default_ckpt_time", "job_end_time", "preempt_check_interval"):
        assert port[key] == ref[key], key
    assert get_args([]).checkpoint_engine == "vanilla"
    # the sharded engine is ported (checkpoint/sharded.py), under the JAX
    # package's spellings of it
    for argv in (["--checkpoint-engine", "sharded"], ["--sharded-checkpoint"],
                 ["--use-torch-distributed-ckpt"]):
        assert get_args(argv).checkpoint_engine == "sharded"
    # the zerostall engine and the autopilot are ported, with the JAX
    # package's spellings and the static baseline kept under auto
    assert get_args(["--checkpoint-engine", "zerostall"]).checkpoint_engine == "zerostall"
    auto = get_args(["--checkpoint-frequency", "auto"])
    assert (auto.checkpoint_auto, auto.checkpoint_frequency) == (True, 10)
