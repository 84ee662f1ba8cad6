"""pyrecover_tpu_torch.serving.fleet: the serving-fleet front door (the JAX
package's ``serving/fleet``).

N serving-replica subprocesses, each a ``ServingEngine`` with a
``HotSwapper``, behind one front-door process, speaking newline-delimited
JSON over TCP, so a replica death is an EOF, never a wedged collective.
Several replica processes share one card.

  * :mod:`protocol`: the NDJSON framing: locked whole-line sends, a reader
    thread per link, EOF as the death signal.
  * :mod:`replica`: the replica subprocess: engine, swapper and metrics
    exporter behind a fleet socket, readiness over a status JSONL, and the
    ``replica_kill`` announce-then-kill fault seam.
  * :mod:`supervisor`: the spawn/ready/dead/backoff state machine per
    replica slot: capped exponential restart backoff and crash-loop
    quarantine after N strikes.
  * :mod:`router`: least-loaded dispatch with optional session affinity,
    SLO-aware admission (bounded per-replica inflight and queue, loud
    shedding) and redrive on death through the ``router_redrive`` fault
    seam under ``io_retry``: never a silent loss.
  * :mod:`rollout`: hot-swap as a rollout policy: canary one replica, gate
    on probe tokens and p99, wave on pass, roll back to the pin-leased old
    manifest on fail.
  * :mod:`drill`: the replica-loss chaos drill and the canary-rollback
    drill (``python -m pyrecover_tpu_torch.serving.fleet.drill``).

Events (``telemetry/__init__`` and the README's port event table):
``replica_spawned``, ``replica_dead``, ``replica_quarantined``,
``request_redriven``, ``fleet_shed``, ``canary_verdict``, ``trace_root``,
``trace_exemplar``, ``fleet_send``, ``fleet_recv``; spans ``req_root`` and
``fleet_attempt``. Fault sites: ``replica_kill``, ``router_redrive``.
"""

from pyrecover_tpu_torch.serving.fleet.drill import (
    canary_rollout_drill,
    fleet_chaos_drill,
    fleet_smoke,
)
from pyrecover_tpu_torch.serving.fleet.protocol import Connection, ProtocolError
from pyrecover_tpu_torch.serving.fleet.rollout import canary_rollout
from pyrecover_tpu_torch.serving.fleet.router import FleetRouter
from pyrecover_tpu_torch.serving.fleet.supervisor import (
    BACKOFF,
    QUARANTINED,
    READY,
    SPAWNING,
    ReplicaSupervisor,
)

__all__ = [
    "BACKOFF",
    "Connection",
    "FleetRouter",
    "ProtocolError",
    "QUARANTINED",
    "READY",
    "ReplicaSupervisor",
    "SPAWNING",
    "canary_rollout",
    "canary_rollout_drill",
    "fleet_chaos_drill",
    "fleet_smoke",
]
