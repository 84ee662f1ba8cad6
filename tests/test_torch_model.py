"""The port's model (pyrecover_tpu_torch.models) held to the JAX package's.

Weights are made once by the JAX ``init_params`` and carried into the port
with ``params_from_jax`` (the two RNGs cannot agree), tokens are made with
numpy, and both forwards run on the CPU. The JAX flash path runs in the
Pallas interpreter; the port's flash path runs its plain versions.

Tolerances: fp32 logits 1e-4. bf16 compute 1e-2 on logits of magnitude
~0.6: the two frameworks round bf16 at different places (silu, the flash
output), one bf16 step at that magnitude is ~2e-3, and the differences
pass through two layers and the vocab projection.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.models import presets as jax_presets
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward as jax_forward
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.ops.rope import apply_rope as jax_apply_rope
from pyrecover_tpu.ops.rope import precompute_rope as jax_precompute_rope
from pyrecover_tpu_torch.models import presets
from pyrecover_tpu_torch.models.llama import (
    ModelConfig,
    Transformer,
    forward,
    params_from_jax,
    params_to_numpy,
    rms_norm,
)
from pyrecover_tpu_torch.ops.rope import apply_rope, precompute_rope
from pyrecover_tpu_torch.utils.perf import get_num_params

SEQ = 48


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(jcfg):
    """The port's ModelConfig with the fields of a JAX one."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def jax_params_np(jcfg, seed=0):
    params = init_params(jax.random.key(seed), jcfg)
    return jax.tree.map(np.asarray, params)


def port_model(jcfg, np_params):
    model = Transformer(port_config(jcfg))
    model.load_state_dict(params_from_jax(np_params))
    return model


def tokens_and_segments(b=2, s=SEQ, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    # three packed documents per row, boundaries differing by row
    seg = np.stack([
        np.repeat(np.arange(3), [16, 20, 12]),
        np.repeat(np.arange(3), [7, 30, 11]),
    ]).astype(np.int32)
    return tokens, seg


CASES = {
    # id: (compute dtype, attention, segments, atol)
    "fp32-sdpa": ("float32", "sdpa", False, 1e-4),
    "fp32-flash": ("float32", "flash", False, 1e-4),
    "fp32-sdpa-segments": ("float32", "sdpa", True, 1e-4),
    "fp32-flash-segments": ("float32", "flash", True, 1e-4),
    "bf16-sdpa": ("bfloat16", "sdpa", False, 1e-2),
    "bf16-flash": ("bfloat16", "flash", False, 1e-2),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_forward_logits_match_jax(case):
    cdt, attn, use_seg, atol = CASES[case]
    jcfg = JaxModelConfig().tiny(
        compute_dtype=cdt, attention_impl=attn, flash_block_q=16, flash_block_kv=16,
    )
    np_params = jax_params_np(jcfg)
    tokens, seg = tokens_and_segments()
    seg = seg if use_seg else None
    want = jax_forward(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), jcfg,
        segment_ids=None if seg is None else jnp.asarray(seg),
    )
    model = port_model(jcfg, np_params)
    with torch.no_grad():
        got = forward(
            model, torch.from_numpy(tokens).long(),
            None if seg is None else torch.from_numpy(seg),
        )
    assert got.dtype == torch.float32 and got.shape == (2, SEQ, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol, atol=atol)


def test_flash_equals_sdpa_in_the_port():
    """Model-level: the port's flash path (plain versions on the CPU) and
    its sdpa path give the same fp32 logits."""
    jcfg = JaxModelConfig().tiny(compute_dtype="float32")
    model = port_model(jcfg, jax_params_np(jcfg, seed=1))
    tokens = torch.from_numpy(tokens_and_segments(seed=1)[0]).long()
    with torch.no_grad():
        sdpa = forward(model, tokens)
        model.config = dataclasses.replace(model.config, attention_impl="flash")
        flash = forward(model, tokens)
    np.testing.assert_allclose(flash.numpy(), sdpa.numpy(), rtol=2e-5, atol=2e-5)


def test_params_round_trip_bit_exact():
    jcfg = JaxModelConfig().tiny()
    np_params = jax_params_np(jcfg, seed=2)
    back = params_to_numpy(port_model(jcfg, np_params))
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("name", list(presets.PRESETS))
def test_analytic_param_count_matches_jax(name):
    cfg = presets.PRESETS[name]()
    jcfg = jax_presets.PRESETS[name]()
    assert cfg.ffn_hidden_dim == jcfg.ffn_hidden_dim
    for excl in (False, True):
        assert presets.analytic_param_count(cfg, excl) == \
            jax_presets.analytic_param_count(jcfg, excl)


def test_param_count_of_built_model():
    cfg = ModelConfig().tiny()
    model = Transformer(cfg)
    assert get_num_params(model) == presets.analytic_param_count(cfg)
    assert get_num_params(model, exclude_embedding=True) == \
        presets.analytic_param_count(cfg, exclude_embedding=True)
    jcfg = JaxModelConfig().tiny()
    assert sum(x.size for x in jax.tree.leaves(jax_params_np(jcfg))) == get_num_params(model)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    cos, sin = precompute_rope(16, 10)
    jcos, jsin = jax_precompute_rope(16, 10)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6, atol=1e-6)
    got = apply_rope(torch.from_numpy(x), cos, sin)
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    from pyrecover_tpu.models.llama import rms_norm as jax_rms_norm

    scale = rng.standard_normal(16).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    want = jax_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
