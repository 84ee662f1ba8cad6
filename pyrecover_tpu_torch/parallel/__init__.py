"""Parallelism: the data axis over ``torch.distributed`` (``mesh.py``: the
rendezvous, the host-0 broadcasts), the gradient sync (``collectives.py``:
DDP with the fp32 bucket layout, the quantized bf16/int8 wire with error
feedback, and the block int8 quantiser the serving path's int8 KV pool also
uses) and ZeRO-1's moment layout (``sharding.py``). The fsdp, tensor,
sequence, pipeline and expert axes of the JAX package's ``parallel/`` are
not ported."""
