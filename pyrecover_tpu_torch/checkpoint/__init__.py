"""Checkpoints: the vanilla single-file ``PYRCKPT2`` engine and the registry
(naming, ``latest``, retention). The JAX package's sharded, zerostall and
elastic engines are not ported."""
