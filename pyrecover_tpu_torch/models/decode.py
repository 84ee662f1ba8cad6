"""Incremental (KV-cached) decoding, ported from the JAX package's
``models/decode.py``.

The cache is a dict of layer-stacked buffers ``{"k", "v"}`` of shape
``(L, B, max_len, Hkv, head_dim)``, the parameters' leading-layer-axis
convention. ``decode_forward`` runs a chunk of tokens at absolute positions
``[pos, pos + chunk)``: one call over the whole prompt is the prefill, and
chunk-1 calls are the decode loop. It writes the chunk's keys and values
into the cache in place (slice assignment: the cache is never copied for a
step) and then attends to cache positions ``< pos + chunk`` with the causal
band inside the chunk.

Attention against the cache is blockwise, an fp32 online softmax over
256-wide KV blocks whose trip count is bounded by the fill (``pos`` is a
host integer), so a step costs O(fill), not O(max_len); a cache no longer
than one block takes the single-shot path. Scores and the probability-value
product are computed as in ``ops/attention.py``: compute-dtype operands
upcast to fp32 (the JAX package's ``preferred_element_type=f32``). The
blocks reuse the training forward's ``qkv_proj``, ``ffn_sublayer`` and
``rms_norm``, so the two paths cannot drift.

An MoE model decodes with no drops (`no_drop_config`): capacity-based
dropping depends on how many tokens compete for an expert's slots in one
call, so a chunked decode would route differently from the full forward.
At the capacity factor E every pick fits, routing is per token, and a
chunked decode equals the full forward (JAX ``models/decode.py:147-150``).
"""

import dataclasses

import numpy as np
import torch

from pyrecover_tpu_torch.models.llama import ffn_sublayer, project_vocab, qkv_proj, rms_norm
from pyrecover_tpu_torch.ops.rope import precompute_rope
from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

NEG_INF = -1e30
# KV blocks the cached attention takes per step: a step costs O(pos rounded
# up to this), not O(max_len)
_DECODE_BLOCK = 256


def model_device(model):
    return model.tok_embed.device


def no_drop_config(config):
    """``config`` with an MoE model's capacity factor raised to E, where no
    pick is ever dropped (capacity >= S·K); a dense config unchanged."""
    if config.n_experts > 0:
        return dataclasses.replace(config, moe_capacity_factor=float(config.n_experts))
    return config


def init_kv_cache(config, batch_size, max_len, dtype=None, device="cuda"):
    """Zeroed KV cache: {"k", "v"} each (L, B, max_len, Hkv, head_dim).

    The buffer length is rounded up to a multiple of ``_DECODE_BLOCK`` when
    longer than one block, so the blockwise attention takes aligned blocks;
    the tail positions are always masked."""
    dt = resolve_dtype(dtype or config.compute_dtype)
    max_len = int(max_len)
    if max_len > _DECODE_BLOCK and max_len % _DECODE_BLOCK:
        max_len = (max_len // _DECODE_BLOCK + 1) * _DECODE_BLOCK
    shape = (config.n_layers, batch_size, max_len, config.n_kv_heads, config.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def scores_f32(qg, k, scale):
    """qg (B, C, Hkv, G, hd) against k (B, S, Hkv, hd) -> fp32 scores
    (B, Hkv, G, C, S): compute-dtype products summed in fp32."""
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def probs_times_v(p, v):
    """p (B, Hkv, G, C, S) rounded to v's dtype, times v (B, S, Hkv, hd),
    summed in fp32 -> (B, Hkv, G, C, hd)."""
    return torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())


def _cached_attention(q, k_cache, v_cache, pos, chunk, scale):
    """q (B, C, Hq, hd) at absolute positions [pos, pos + C) against the
    cache (B, max_len, Hkv, hd); positions >= pos + C and the future inside
    the chunk are masked. Returns (B, C, Hq * hd) in q's dtype."""
    b, c, hq, d = q.shape
    max_len, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, c, hkv, group, d)
    qpos = pos + torch.arange(c, device=q.device)

    block = _DECODE_BLOCK if max_len % _DECODE_BLOCK == 0 else max_len
    if max_len <= block:
        scores = scores_f32(qg, k_cache, scale)
        kpos = torch.arange(max_len, device=q.device)
        scores = scores.masked_fill(~(kpos[None, :] <= qpos[:, None]), NEG_INF)
        out = probs_times_v(torch.softmax(scores, dim=-1), v_cache)
    else:
        n_blocks = min((pos + c + block - 1) // block, max_len // block)
        m = torch.full((b, hkv, group, c), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, group, c), device=q.device)
        acc = torch.zeros((b, hkv, group, c, d), device=q.device)
        for i in range(n_blocks):
            start = i * block
            s = scores_f32(qg, k_cache[:, start:start + block], scale)
            kpos = start + torch.arange(block, device=q.device)
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]), NEG_INF)
            # block 0 always holds kpos 0 <= qpos, so m is finite after the
            # first block and the rescales never see inf - inf
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + probs_times_v(p, v_cache[:, start:start + block])
            m = m_new
        out = acc / l[..., None]
    # (B, Hkv, G, C, hd) -> (B, C, Hq * hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, hq * d).to(q.dtype)


@torch.inference_mode()
def decode_forward(model, cache, tokens, pos):
    """Run ``tokens`` (B, chunk) at absolute positions [pos, pos + chunk),
    ``pos`` a host integer. Writes those positions of ``cache`` in place and
    returns fp32 logits (B, chunk, vocab). An MoE model routes with no
    drops (`no_drop_config`)."""
    cfg = no_drop_config(model.config)
    cdt = resolve_dtype(cfg.compute_dtype)
    b, c = tokens.shape
    hd = cfg.head_dim
    pos = int(pos)
    max_len = cache["k"].shape[2]
    if pos < 0 or pos + c > max_len:
        raise ValueError(f"positions [{pos}, {pos + c}) lie outside the cache length {max_len}")
    # the table's rows do not depend on its length: rows [pos, pos + c) of
    # a table of pos + c rows are those of the full table
    cos, sin = precompute_rope(hd, pos + c, cfg.rope_theta, device=tokens.device)
    cos, sin = cos[pos:], sin[pos:]
    scale = 1.0 / (hd**0.5)

    x = model.tok_embed.to(cdt)[tokens]
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q, k, v = qkv_proj(h, layer, cfg, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos:pos + c] = k
        vc[:, pos:pos + c] = v
        attn = _cached_attention(q, kc, vc, pos, c, scale)
        x = x + attn @ layer.wo.to(cdt)
        x, _ = ffn_sublayer(x, layer, cfg)
    return project_vocab(model, rms_norm(x, model.final_norm, cfg.norm_eps))


def generate_tokens(model, prompt_ids, max_new_tokens, *, temperature=0.0,
                    generator=None, max_len=None):
    """Greedy or temperature sampling with the KV cache: the prompt(s) in
    one prefill call, then one fill-bounded decode step per new token.

    ``prompt_ids`` is one prompt (a sequence of ints: returns one id list,
    prompt + generated) or a batch of EQUAL-length prompts (list of lists or
    a 2-D array: returns a list of id lists), decoded in lockstep through
    one cache. Ragged prompts are rejected (left-pad them first: silent
    padding would put attended pad positions in the cache). ``max_len``
    (default the model's ``max_seq_len``) must be positive and at most
    ``max_seq_len``. Temperature draws use ``generator`` (a
    ``torch.Generator`` on the model's device); JAX's PRNG cannot be
    matched, so only greedy decoding equals the JAX package's.

    This is the lockstep path, and the equality baseline of the serving
    engine (``pyrecover_tpu_torch.serving``)."""
    cfg = model.config
    if not hasattr(prompt_ids, "__len__"):
        prompt_ids = list(prompt_ids)  # iterators stay accepted
    try:
        arr = np.asarray(prompt_ids, dtype=np.int64)
    except (TypeError, ValueError):
        arr = np.asarray([], dtype=object)
    if arr.ndim not in (1, 2) or arr.dtype == object:
        raise ValueError(
            "prompt_ids must be one int sequence or a batch of EQUAL-length sequences"
        )
    single = arr.ndim == 1
    if single:
        arr = arr[None]
    if arr.shape[1] == 0:
        raise ValueError("prompt must contain at least one token id")
    n_batch, n_prompt = arr.shape
    if max_len is None:
        total = cfg.max_seq_len
    else:
        total = int(max_len)
        if total <= 0:
            raise ValueError(
                f"max_len must be positive, got {max_len} (omit it to use the model's "
                f"max_seq_len {cfg.max_seq_len})"
            )
        if total > cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds the model's trained position range max_seq_len "
                f"{cfg.max_seq_len} — positions past it were never trained and would decode "
                "garbage"
            )
    if n_prompt + max_new_tokens > total:
        raise ValueError(
            f"prompt ({n_prompt}) + max_new_tokens ({max_new_tokens}) exceeds the cache "
            f"length {total}"
        )
    device = model_device(model)
    cache = init_kv_cache(cfg, n_batch, total, device=device)
    out = arr.tolist()
    # the sampled ids stay on the device between steps; one transfer at the end
    generated = []
    with torch.inference_mode():
        last = decode_forward(model, cache, torch.as_tensor(arr, device=device), 0)[:, -1]
        pos = n_prompt
        for i in range(max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = last.argmax(dim=-1)  # the first maximum wins, as in numpy
            generated.append(nxt)
            if i + 1 >= max_new_tokens:
                break
            last = decode_forward(model, cache, nxt[:, None], pos)[:, 0]
            pos += 1
    if generated:  # max_new_tokens=0 returns the prompts unchanged
        for row, col in zip(out, torch.stack(generated, dim=1).tolist()):
            row.extend(col)
    return out[0] if single else out
