"""Symmetric block-scaled int8 quantisation (the JAX package's
``parallel/collectives.py:block_quantize_int8`` and
``block_dequantize_int8``).

The serving path's int8 KV pool stores keys and values with it at
``block=head_dim``: one f32 scale per head per token. Both packages round
half to even (``jnp.round``, ``torch.round``) and divide by the scale, so
``q`` and the scales agree bit for bit. The quantized allreduce with error
feedback that the JAX package builds on these is not ported.
"""

import torch

DEFAULT_QUANT_BLOCK = 256
INT8_MAX = 127.0


def block_quantize_int8(x, block=DEFAULT_QUANT_BLOCK):
    """``x`` (..., L) with ``L % block == 0`` -> ``(q int8 of x.shape,
    scales f32 of (..., L // block))``. All-zero blocks get scale 1, so they
    dequantize exactly (0 / 1 -> 0)."""
    shape = x.shape
    blocks = x.reshape(*shape[:-1], shape[-1] // block, block)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / INT8_MAX, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).reshape(shape), scale


def block_dequantize_int8(q, scale, block=DEFAULT_QUANT_BLOCK):
    """The inverse of `block_quantize_int8`, in f32."""
    shape = q.shape
    blocks = q.to(torch.float32).reshape(*shape[:-1], shape[-1] // block, block)
    return (blocks * scale[..., None].to(torch.float32)).reshape(shape)
