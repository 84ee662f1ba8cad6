"""The zero-stall checkpoint engine (``--checkpoint-engine zerostall``; the
JAX package's ``checkpoint/zerostall/``): a snapshot copied on the card and
moved to pinned host buffers on a side stream, a content-addressed
incremental chunk store, and an in-RAM emergency tier. Layout under the
experiment directory, the JAX package's::

    <exp_dir>/ckpt_<step>[_final].zs.json    one manifest a checkpoint
    <exp_dir>/chunks/<dd>/<digest>           content-addressed chunks

``snapshot.py`` is the save pipeline and the restore, ``chunkstore.py`` the
store and its refcounted GC, ``pins.py`` the readers' leases,
``emergency.py`` the in-RAM tier.
"""

from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore, emergency
from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
    collect_garbage,
    read_manifest,
    referenced_digests,
)
from pyrecover_tpu_torch.checkpoint.zerostall.snapshot import (
    ZerostallSaveHandle,
    backpressure,
    load_ckpt_zerostall,
    precheck_ckpt_zerostall,
    release,
    save_ckpt_zerostall,
)

__all__ = [
    "chunkstore",
    "emergency",
    "save_ckpt_zerostall",
    "load_ckpt_zerostall",
    "precheck_ckpt_zerostall",
    "backpressure",
    "release",
    "ZerostallSaveHandle",
    "collect_garbage",
    "referenced_digests",
    "read_manifest",
]
