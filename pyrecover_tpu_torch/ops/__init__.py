"""Attention ops: RoPE, the plain GQA attention and the flash kernels."""
