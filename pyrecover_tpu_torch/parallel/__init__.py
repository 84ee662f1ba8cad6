"""Parallelism: the pipeline, data, fsdp, tensor, sequence and expert axes
over ``torch.distributed`` (``mesh.py``: the rendezvous, the host-0
broadcasts, the mesh, its named groups and the point-to-point sends), the
collectives (``collectives.py``: DDP with the fp32 bucket layout, the
quantized bf16/int8 wire with error feedback, the block int8 quantiser the
serving path's int8 KV pool also uses, the tensor pair), the partition
rules (``sharding.py``: each rank's slices and stage layers, FSDP2 over the
fsdp axis, ZeRO-1's moment layout) and the pipeline schedules
(``pipeline.py``: GPipe, 1F1B and interleaved 1F1B). Ring attention, the
sequence axis's attention, is ``ops/ring_attention.py``."""
