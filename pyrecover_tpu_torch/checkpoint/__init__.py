"""Checkpoints: the vanilla single-file ``PYRCKPT2`` engine, the sharded
engine on ``torch.distributed.checkpoint``, the zerostall engine (a snapshot
moved off the train loop on a side stream, a content-addressed chunk store,
the in-RAM emergency tier), the registry (naming, ``latest``, retention,
each scoped by engine) and the elastic preflight of a resume onto another
topology."""
