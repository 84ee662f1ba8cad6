"""The port's KV-cached decoder (``pyrecover_tpu_torch.models.decode``) and
its int8 block quantiser held to the JAX package's.

Weights come from the JAX ``init_params`` through ``params_from_jax``, token
ids from numpy, and both packages run on the CPU. Tolerances: fp32 logits
2e-5 for a prefill and 1e-4 over many single-token steps or 500-position
fills (the JAX decode tests' own limits against the training forward); the
bf16 prefill 1e-2, as in ``test_torch_model.py``. Greedy tokens must be
equal, and the int8 quantiser's payloads and scales bit-equal, since both
sides round half to even and divide by the scale in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecover_tpu.models.decode import _cached_attention as jax_cached_attention
from pyrecover_tpu.models.decode import decode_forward as jax_decode_forward
from pyrecover_tpu.models.decode import generate_tokens as jax_generate_tokens
from pyrecover_tpu.models.decode import init_kv_cache as jax_init_kv_cache
from pyrecover_tpu.models.llama import ModelConfig as JaxModelConfig
from pyrecover_tpu.models.llama import forward as jax_forward
from pyrecover_tpu.models.llama import init_params
from pyrecover_tpu.parallel.collectives import block_dequantize_int8 as jax_dequantize
from pyrecover_tpu.parallel.collectives import block_quantize_int8 as jax_quantize
from pyrecover_tpu_torch.models.decode import (
    _DECODE_BLOCK,
    _cached_attention,
    decode_forward,
    generate_tokens,
    init_kv_cache,
)
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer, forward, params_from_jax
from pyrecover_tpu_torch.parallel.collectives import block_dequantize_int8, block_quantize_int8

JCFG = JaxModelConfig().tiny(max_seq_len=32, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(jcfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


def pair(jcfg=JCFG, seed=0):
    """JAX params (device arrays) and the port's model on the same weights."""
    np_params = jax.tree.map(np.asarray, init_params(jax.random.key(seed), jcfg))
    model = Transformer(port_config(jcfg))
    model.load_state_dict(params_from_jax(np_params))
    return jax.tree.map(jnp.asarray, np_params), model


def tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def jax_step(jcfg):
    return jax.jit(lambda p, c, t, pos: jax_decode_forward(p, c, t, pos, jcfg))


# ---- the int8 quantiser ---------------------------------------------------


@pytest.mark.parametrize("shape,block", [((3, 5, 2, 16), 16), ((4, 2, 128), 128),
                                         ((2, 512), 256)],
                         ids=["hd16", "hd128", "default-block"])
def test_int8_quantizer_bit_equal_to_jax(shape, block):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3.0
    x[0, ..., :block] = 0.0  # an all-zero block takes scale 1
    # values on a half step of the grid: round half to even on both sides
    x.reshape(-1)[block:block + 4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32) * (
        np.abs(x.reshape(-1)[block:2 * block]).max() / 127.0)
    q, s = block_quantize_int8(torch.from_numpy(x), block=block)
    jq, js = jax_quantize(jnp.asarray(x), block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s.numpy().reshape(-1)[0]) == 1.0
    np.testing.assert_array_equal(
        block_dequantize_int8(q, s, block=block).numpy(),
        np.asarray(jax_dequantize(jq, js, block=block)))


# ---- decode_forward against JAX and the training forward --------------------


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 1e-2)],
                         ids=["fp32", "bf16"])
def test_prefill_matches_jax_and_training_forward(dtype, atol):
    jcfg = dataclasses.replace(JCFG, compute_dtype=dtype)
    params, model = pair(jcfg)
    toks = tokens(jcfg.vocab_size, 2, 16)
    want, _ = jax_step(jcfg)(params, jax_init_kv_cache(jcfg, 2, jcfg.max_seq_len),
                             jnp.asarray(toks), 0)
    cache = init_kv_cache(model.config, 2, jcfg.max_seq_len, device="cpu")
    got = decode_forward(model, cache, torch.from_numpy(toks).long(), 0)
    assert got.dtype == torch.float32 and got.shape == (2, 16, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol, atol=atol)
    with torch.no_grad():
        ref = forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=atol, atol=atol)
    assert cache["k"].shape == (jcfg.n_layers, 2, jcfg.max_seq_len, jcfg.n_kv_heads,
                                jcfg.head_dim)


def test_incremental_steps_match_full_forward():
    """A 5-token prefill, then one token at a time: each step's logits equal
    the JAX training forward's at that position; the cache is written in
    place, only at the step's position."""
    params, model = pair()
    toks = tokens(JCFG.vocab_size, 2, 12)
    ref = np.asarray(jax_forward(params, jnp.asarray(toks), JCFG))
    cache = init_kv_cache(model.config, 2, JCFG.max_seq_len, device="cpu")
    k_buf = cache["k"]
    t = torch.from_numpy(toks).long()
    logits = decode_forward(model, cache, t[:, :5], 0)
    np.testing.assert_allclose(logits.numpy(), ref[:, :5], rtol=2e-5, atol=2e-5)
    for pos in range(5, 12):
        before = cache["k"].clone()
        logits = decode_forward(model, cache, t[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, pos], rtol=1e-4, atol=1e-4,
                                   err_msg=f"pos {pos}")
        changed = (cache["k"] != before).any(dim=(0, 1, 3, 4)).nonzero().flatten().tolist()
        assert changed == [pos]
    assert cache["k"] is k_buf  # written in place, never replaced
    with pytest.raises(ValueError, match="outside the cache"):
        decode_forward(model, cache, t[:, :4], JCFG.max_seq_len - 2)


def test_blockwise_cache_crosses_block_boundaries():
    """A cache longer than one 256 block (640 rounds up to 768): a 520-token
    prefill crosses two block edges, then single steps cross the 512 edge;
    every logit against the JAX training forward."""
    jcfg = dataclasses.replace(JCFG, max_seq_len=640, dim=32, n_layers=1, n_heads=2,
                               n_kv_heads=1)
    params, model = pair(jcfg)
    toks = tokens(jcfg.vocab_size, 1, 530, seed=4)
    ref = np.asarray(jax_forward(params, jnp.asarray(toks), jcfg))
    cache = init_kv_cache(model.config, 1, jcfg.max_seq_len, device="cpu")
    assert cache["k"].shape[2] == 3 * _DECODE_BLOCK
    t = torch.from_numpy(toks).long()
    logits = decode_forward(model, cache, t[:, :520], 0)
    np.testing.assert_allclose(logits[:, -1].numpy(), ref[:, 519], rtol=5e-5, atol=5e-5)
    for pos in range(520, 530):
        logits = decode_forward(model, cache, t[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, pos], rtol=1e-4, atol=1e-4,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("max_len,pos,chunk", [(200, 37, 5), (768, 300, 3), (768, 511, 2)],
                         ids=["single-shot", "blockwise", "block-edge"])
def test_cached_attention_matches_jax(max_len, pos, chunk):
    """The cached attention alone, single-shot and blockwise, on random
    q/k/v with GQA group 2."""
    rng = np.random.default_rng(max_len + pos)
    q = rng.standard_normal((2, chunk, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, max_len, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, max_len, 2, 16)).astype(np.float32)
    want = jax_cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, chunk, 0.25)
    got = _cached_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos,
                            chunk, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---- generate_tokens ----------------------------------------------------------


@pytest.mark.parametrize("prompts,n_new", [([3, 1, 4, 1, 5], 9), ([[1, 2, 3], [7, 5, 9]], 6)],
                         ids=["single", "batched"])
def test_generate_greedy_equals_jax(prompts, n_new):
    params, model = pair()
    want = jax_generate_tokens(params, JCFG, prompts, n_new)
    assert generate_tokens(model, prompts, n_new) == want


def test_generate_batched_matches_individual():
    _, model = pair(seed=1)
    prompts = [[1, 2, 3], [7, 5, 9], [4, 4, 4]]
    individual = [generate_tokens(model, p, 6) for p in prompts]
    assert generate_tokens(model, prompts, 6) == individual
    assert generate_tokens(model, np.asarray(prompts), 6) == individual
    assert generate_tokens(model, iter([1, 2, 3]), 6) == individual[0]
    with pytest.raises(ValueError, match="EQUAL-length"):
        generate_tokens(model, [[1, 2], [3]], 4)
    assert generate_tokens(model, [1, 2, 3], 0) == [1, 2, 3]


def test_generate_validates_max_len_and_overflow():
    """The JAX package's validation: max_len <= 0 or past max_seq_len and a
    prompt + budget past the cache raise; an explicit max_len changes
    nothing else."""
    params, model = pair()
    for bad, match in ((0, "must be positive"), (-3, "must be positive"),
                       (JCFG.max_seq_len + 1, "exceeds the model's trained")):
        with pytest.raises(ValueError, match=match):
            generate_tokens(model, [1, 2], 4, max_len=bad)
        with pytest.raises(ValueError, match=match):
            jax_generate_tokens(params, JCFG, [1, 2], 4, max_len=bad)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        generate_tokens(model, [1] * 30, 3)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        generate_tokens(model, [1] * 10, 8, max_len=16)
    with pytest.raises(ValueError, match="at least one token"):
        generate_tokens(model, [], 2)
    assert generate_tokens(model, [1, 2], 4) == generate_tokens(model, [1, 2], 4,
                                                                max_len=JCFG.max_seq_len)


def test_generate_temperature_draws_from_the_generator():
    """Temperature sampling is reproducible from an explicit generator (the
    JAX PRNG cannot be matched, so it is never held to JAX)."""
    _, model = pair()

    def draw(seed):
        return generate_tokens(model, [[1, 2, 3], [4, 5, 6]], 12, temperature=5.0,
                               generator=torch.Generator().manual_seed(seed))

    first = draw(0)
    assert draw(0) == first
    assert draw(1) != first
    assert all(0 <= t < JCFG.vocab_size for row in first for t in row)
