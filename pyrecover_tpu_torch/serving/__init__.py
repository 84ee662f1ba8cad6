"""pyrecover_tpu_torch.serving: the continuous-batching inference engine,
ported from the JAX package's ``serving/``.

* :mod:`kvpool`: the paged KV pool (fixed-size blocks, host free list,
  per-sequence block tables; native or int8 storage).
* :mod:`paged`: cached attention through the block table at ragged
  per-sequence positions.
* :mod:`engine`: the scheduler (admission on free blocks, budgeted chunked
  prefill, fixed-slot decode, ttft/tpot/e2e histograms).
* :mod:`restore`: the read-only ``.params`` restore from a vanilla,
  sharded or zerostall checkpoint, after the elastic preflight.
* :mod:`loadgen`: the seeded load generator, the lockstep baseline and the
  serving smoke.

The hot-swap watcher is :mod:`hotswap`, and the serving fleet (replica
processes behind a router, their supervisor and the canary rollout) is
:mod:`fleet`.
"""

from pyrecover_tpu_torch.serving.engine import (
    EngineStoppedError,
    Request,
    ServingConfig,
    ServingEngine,
)
from pyrecover_tpu_torch.serving.kvpool import (
    BlockPool,
    blocks_for,
    kv_block_bytes,
    kv_token_bytes,
    resident_sequences,
)
from pyrecover_tpu_torch.serving.loadgen import (
    lockstep_baseline,
    open_loop_workload,
    request_id,
    run_loadgen,
    sample_workload,
    serving_smoke,
    split_workload,
)
from pyrecover_tpu_torch.serving.paged import paged_attention, paged_forward
from pyrecover_tpu_torch.serving.restore import ServingRestoreError, load_serving_params

__all__ = [
    "BlockPool",
    "EngineStoppedError",
    "Request",
    "ServingConfig",
    "ServingEngine",
    "ServingRestoreError",
    "blocks_for",
    "kv_block_bytes",
    "kv_token_bytes",
    "load_serving_params",
    "lockstep_baseline",
    "open_loop_workload",
    "paged_attention",
    "paged_forward",
    "request_id",
    "resident_sequences",
    "run_loadgen",
    "sample_workload",
    "serving_smoke",
    "split_workload",
]
