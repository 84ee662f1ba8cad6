"""Checkpoints: the vanilla single-file ``PYRCKPT2`` engine, the sharded
engine on ``torch.distributed.checkpoint`` and the registry (naming,
``latest``, retention, each scoped by engine). The JAX package's zerostall
and elastic engines are not ported."""
