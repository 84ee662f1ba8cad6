"""Cached attention through a block table (the paged forward), ported from
the JAX package's ``serving/paged.py``.

The math is ``models/decode.py``'s (the training forward's ``_block_pre`` /
``_block_post``, fp32 softmax, RoPE at absolute positions) with two
serving generalisations:

* **Ragged positions.** Row ``r`` of the batch sits at its own absolute
  position ``pos[r]``: RoPE is gathered per (row, chunk) cell and the causal
  mask compares per-row position columns, so a fresh request decodes in the
  same call as one 900 tokens deep.
* **Block-table indirection.** Each chunk's keys and values are written
  first, into ``(table[p // block_size], p % block_size)``; positions past a
  row's table (prefill padding, inactive slots) go to the trash block. Then
  the live blocks, table columns ``[0, n_blocks)`` up to the deepest fill
  in the batch, are gathered from the pool and attended with one masked
  fp32 softmax. The JAX package loops over those blocks with an online
  softmax; one softmax over the same columns computes the same function
  without a Python loop of small launches per block and layer. ``n_blocks``
  comes from the host-side positions, never from the device.

An MoE model routes with no drops, as ``decode_forward`` does
(``models/decode.py::no_drop_config``), so chunked serving routes as the
training forward does at a capacity no token overflows.

int8 pools quantise on append (``block_quantize_int8`` at
``block=head_dim``) and dequantise the gathered blocks, so the storage format
is the only difference between the modes.

On a serving mesh every rank calls `paged_forward` with the same tokens,
positions and tables (the engine's lockstep, ``serving/engine.py``)
against its own pool, which holds its pipeline stage's layers and its
tensor piece of the kv heads; the walk over the layers is the decode
path's (``models/decode.py::stage_forward``: the training forward's helpers,
fsdp slices gathered a block at a time, the stages' hidden-state sends).
"""

import numpy as np
import torch

from pyrecover_tpu_torch.models.decode import (
    NEG_INF,
    model_device,
    no_drop_config,
    probs_times_v,
    scores_f32,
    stage_forward,
)
from pyrecover_tpu_torch.models.llama import _block_post, _block_pre
from pyrecover_tpu_torch.ops.rope import precompute_rope
from pyrecover_tpu_torch.parallel.collectives import block_dequantize_int8, block_quantize_int8
from pyrecover_tpu_torch.serving.kvpool import TRASH_BLOCK


def _scatter_positions(tables, qpos, block_size):
    """(physical block, offset) of every (row, chunk) position; positions
    past a row's table go to the trash block."""
    width = tables.shape[1]
    blk_idx = qpos // block_size
    off = qpos % block_size
    phys = torch.gather(tables, 1, blk_idx.clamp(max=width - 1))
    return torch.where(blk_idx < width, phys, TRASH_BLOCK), off


def _append_block_kv(layer_pool, k, v, phys, off, kv_mode):
    """Write this chunk's k/v (B, C, Hkv, hd) into one layer's pool tensors
    at ``(phys, off)``, in place. int8 pools quantise on append, one f32
    scale per head per token, so a rank holding a tensor piece of the kv
    heads keeps the scales of its heads, those the whole pool would."""
    b, c = phys.shape
    idx = (phys.reshape(-1), off.reshape(-1))

    def flat(x):
        return x.reshape(b * c, *x.shape[2:])

    if kv_mode == "int8":
        hd = k.shape[-1]
        for name, x in (("k", k), ("v", v)):
            qx, sx = block_quantize_int8(x.float(), block=hd)
            layer_pool[name].index_put_(idx, flat(qx))
            layer_pool[f"{name}_scale"].index_put_(idx, flat(sx[..., 0]))
        return
    for name, x in (("k", k), ("v", v)):
        layer_pool[name].index_put_(idx, flat(x).to(layer_pool[name].dtype))


def paged_attention(q, layer_pool, tables, qpos, scale, block_size, kv_mode, n_blocks):
    """q (B, C, Hq, hd) at absolute positions ``qpos`` (B, C) against one
    layer's pool tensors through ``tables`` (B, width); returns
    (B, C, Hq * hd) in q's dtype. ``n_blocks`` (a host int) is the number of
    table columns that hold the deepest query position in the batch."""
    b, c, hq, d = q.shape
    hkv = layer_pool["k"].shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, d)
    ids = tables[:, :n_blocks]

    def gather(name):
        payload = layer_pool[name][ids]  # (B, n_blocks, block_size, Hkv, hd)
        if kv_mode == "int8":
            payload = block_dequantize_int8(payload, layer_pool[f"{name}_scale"][ids][..., None],
                                            block=d)
        return payload.reshape(b, n_blocks * block_size, hkv, d)

    k, v = gather("k"), gather("v")
    s = scores_f32(qg, k, scale)  # (B, Hkv, G, C, S)
    kpos = torch.arange(n_blocks * block_size, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # per-row causal mask (B, C, S)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    # the online softmax of the JAX loop over one block holding every column:
    # unnormalised probabilities into the value product, divided at the end.
    # Column 0 (kpos 0 <= qpos) is always live, so the max is finite.
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = probs_times_v(p, v) / p.sum(dim=-1)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, hq * d).to(q.dtype)


@torch.inference_mode()
def paged_forward(model, pool_arrays, tokens, pos, tables, *, block_size, kv_mode="native",
                  rope_len=None):
    """Run ``tokens`` (B, C) with row ``r`` at absolute positions
    ``[pos[r], pos[r] + C)`` against the paged pool; returns fp32 logits
    (B, C, vocab) and writes the chunk's keys and values into
    ``pool_arrays`` in place. ``pos`` is host-side (a sequence of ints or a
    numpy array); ``tokens`` and ``tables`` (B, width) may be numpy arrays
    or tensors. RoPE covers ``rope_len`` positions (default the model's
    ``max_seq_len``); padding positions past it take its last row, as the
    JAX gather clamps."""
    cfg = no_drop_config(model.config)
    device = model_device(model)
    tokens = torch.as_tensor(tokens, device=device).long()
    tables = torch.as_tensor(tables, device=device).long()
    b, c = tokens.shape
    hd = cfg.head_dim
    qpos_host = np.asarray(pos, dtype=np.int64).reshape(b, 1) + np.arange(c)
    n_blocks = min((int(qpos_host.max()) + block_size) // block_size, tables.shape[1])
    qpos = torch.as_tensor(qpos_host, device=device)

    rope_len = int(rope_len or cfg.max_seq_len)
    cos_all, sin_all = precompute_rope(hd, rope_len, cfg.rope_theta, device=device)
    rope_idx = qpos.clamp(max=rope_len - 1)
    cos, sin = cos_all[rope_idx], sin_all[rope_idx]  # (B, C, hd / 2)
    scale = 1.0 / (hd**0.5)
    phys, off = _scatter_positions(tables, qpos, block_size)

    def layer_step(i, layer, x):
        layer_pool = {name: arr[i] for name, arr in pool_arrays.items()}
        q, k, v = _block_pre(x, layer, cos, sin, cfg)
        # write the chunk BEFORE attending: queries see their own and earlier
        # positions through the pool, as in the lockstep cache update
        _append_block_kv(layer_pool, k, v, phys, off, kv_mode)
        attn = paged_attention(q, layer_pool, tables, qpos, scale, block_size, kv_mode, n_blocks)
        return _block_post(x, attn, layer, cfg)[0]

    return stage_forward(model, tokens, layer_step)
