"""Host-0-gated structured logging (the JAX package's ``utils/logging.py``).

One process per card: the analogue of the JAX process index is the
``torch.distributed`` rank when a process group is initialised, else 0.
"""

import logging
import sys

_LOGGER_NAME = "pyrecover_tpu_torch"


def get_logger():
    """The package's logger; it propagates to the root logger, which
    ``train.main`` configures."""
    return logging.getLogger(_LOGGER_NAME)


def process_index():
    """The ``torch.distributed`` rank when a process group is initialised,
    else 0. Never imports torch: a process that has not imported it has no
    process group."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def log_host0(msg, *args, level=logging.INFO):
    """Log only on host 0 (reference ``dist_utils.py:89-90`` log_rank0)."""
    if process_index() == 0:
        get_logger().log(level, msg, *args)
