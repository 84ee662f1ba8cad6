"""Causal grouped-query attention in plain PyTorch: the ``sdpa`` attention
implementation and the ground truth the flash kernels are held to.

GQA reshapes q to (kv_heads, group) and contracts against the original k/v,
so repeated kv heads are never materialized. Scores and softmax are fp32;
masked scores are filled with -1e30, as in the JAX package's
``ops/attention.py``.
"""

import torch


def sdpa_attention(q, k, v, *, causal=True, scale=None, segment_ids=None):
    """Scaled dot-product attention with GQA.

    q (batch, q_len, n_heads, head_dim), k/v (batch, kv_len, n_kv_heads,
    head_dim) -> (batch, q_len, n_heads, head_dim) in q's dtype. ``causal``
    aligns queries and keys at the END (``qpos + kv_len - q_len >= kpos``);
    ``segment_ids`` (batch, q_len) restricts attention to equal ids and
    requires q_len == kv_len.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"n_heads={hq} not divisible by n_kv_heads={hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)

    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(qpos >= kpos), -1e30)
    if segment_ids is not None:
        if sq != sk:
            raise ValueError("segment_ids requires q_len == kv_len")
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~seg[:, None, None], -1e30)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)
