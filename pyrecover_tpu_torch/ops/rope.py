"""Rotary position embeddings (RoPE), interleaved-pair convention.

Elements (2i, 2i+1) of a head form one rotated pair, as in the JAX
package's ``ops/rope.py`` and the reference's complex formulation. The
table depends only on (head_dim, seq_len, theta) and is never stored.
"""

import torch


def precompute_rope(head_dim, max_seq_len, theta=500000.0, device=None,
                    dtype=torch.float32):
    """Returns (cos, sin), each of shape (max_seq_len, head_dim // 2)."""
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    freqs = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    angles = torch.outer(torch.arange(max_seq_len, dtype=torch.float32, device=device), freqs)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x, cos, sin):
    """Rotate q or k: ``x`` (..., seq, heads, head_dim), cos/sin
    (seq, head_dim // 2). Computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
