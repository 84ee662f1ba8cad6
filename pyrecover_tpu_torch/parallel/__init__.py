"""Parallelism: the data axis over ``torch.distributed`` (``mesh.py``: the
rendezvous, the host-0 broadcasts), DDP's gradient sync with the fp32
bucket layout, and the block int8 quantiser the serving path's int8 KV pool
uses (``collectives.py``). The quantized gradient all-reduce, ZeRO-1 and
the fsdp, tensor, sequence, pipeline and expert axes of the JAX package's
``parallel/`` are not ported."""
