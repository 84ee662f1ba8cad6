"""Parallelism: the data, fsdp and tensor axes over ``torch.distributed``
(``mesh.py``: the rendezvous, the host-0 broadcasts, the mesh and its named
groups), the collectives (``collectives.py``: DDP with the fp32 bucket
layout, the quantized bf16/int8 wire with error feedback, the block int8
quantiser the serving path's int8 KV pool also uses, the tensor pair) and
the partition rules (``sharding.py``: each rank's slices, FSDP2 over the
fsdp axis, ZeRO-1's moment layout). The sequence, pipeline and expert axes of
the JAX package's ``parallel/`` are not ported."""
