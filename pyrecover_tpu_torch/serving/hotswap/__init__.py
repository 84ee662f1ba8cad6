"""pyrecover_tpu_torch.serving.hotswap: zero-downtime weight hot-swap (the
JAX package's ``serving/hotswap``).

The train -> serve distribution plane: a live serving engine tracks a
training run's checkpoint registry, fetches only the chunks whose content
digests changed since the loaded manifest, verifies every byte, and flips
its model reference between scheduler passes with in-flight requests
untouched.

  * :mod:`swap`: :class:`HotSwapper`, the registry watcher (a polling
    thread with a bounded join), the incremental-vs-full fetch dispatch,
    the pin-guarded fetch window, the copies on a stream of its own, the
    shape-stability check and the loud ``weights_swap_rejected`` path.
  * :mod:`fetch`: the chunk-digest diff (``diff_manifest_chunks``) and the
    digest-verified incremental assembly.
  * :mod:`drill`: the one-process train-and-serve smoke, the
    SIGKILL-mid-swap chaos drill, and the drill's server entry
    (``python -m pyrecover_tpu_torch.serving.hotswap.drill --serve ...``).

Events (``telemetry/__init__`` and the README's port event table):
``weights_swap_begin`` / ``weights_swap_done`` / ``weights_swap_rejected`` /
``swap_fetch_bytes``.
"""

from pyrecover_tpu_torch.serving.hotswap.drill import hotswap_chaos_drill, hotswap_smoke
from pyrecover_tpu_torch.serving.hotswap.fetch import (
    diff_manifest_chunks,
    fetch_params_incremental,
)
from pyrecover_tpu_torch.serving.hotswap.swap import HotSwapper

__all__ = [
    "HotSwapper",
    "diff_manifest_chunks",
    "fetch_params_incremental",
    "hotswap_chaos_drill",
    "hotswap_smoke",
]
