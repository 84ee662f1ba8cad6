"""Parallelism helpers. Only the block int8 quantiser that the serving
path's int8 KV pool uses is ported; the quantized allreduce and the rest of
the JAX package's ``parallel/`` are not."""
