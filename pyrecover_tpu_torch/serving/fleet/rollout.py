"""Canary hot-swap rollout: one replica first, gate, wave or roll back (the
JAX package's ``serving/fleet/rollout.py``).

Hot-swap as a *fleet policy*: given a new manifest, :func:`canary_rollout`

1. **pins** the currently-serving (old) manifest with a pin lease
   (``checkpoint/zerostall/pins.py``), so its chunks stay fetchable for a
   rollback whatever the GC does during the rollout;
2. **canaries** the new manifest on exactly one replica through the fleet
   ``swap`` RPC (the hot-swapper's ``swap_to`` on the other end);
3. **gates** on two signals measured through the canary's live engine: the
   probe's greedy tokens must equal the caller's expected tokens, and the
   probe's p99 e2e latency must stay within ``P99_FACTOR * baseline_p99 +
   P99_SLACK_S`` of the fleet's pre-rollout baseline (the hot-swap drill's
   bound);
4. on **pass**, waves the remaining replicas and releases the pin; on
   **fail** (swap rejected, token mismatch or p99 regression), rolls every
   touched replica back to the old manifest and KEEPS the pin lease: the
   fleet stays pinned on the old weights until an operator releases it (the
   lease rides home in the report).

A ``canary_verdict`` event records every rollout's outcome. The non-canary
replicas never see a failing manifest: a bad artifact's blast radius is one
replica's probe window.
"""

from pathlib import Path

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.serving.hotswap.drill import P99_FACTOR, P99_SLACK_S, SEED


def _p99(samples):
    ordered = sorted(samples)
    if not ordered:
        return 0.0
    return ordered[min(int(round(0.99 * (len(ordered) - 1))), len(ordered) - 1)]


def canary_rollout(router, replica_ids, *, manifest, old_manifest, exp_dir, expected_tokens,
                   baseline_p99_s, timeout_s=120.0, tokens_match=None):
    """Run one canary, gate, wave-or-rollback rollout; see the module
    docstring. The probe is the replicas' one (``hotswap.drill.SEED``).
    ``tokens_match(got, want)`` decides the token gate (default: equality,
    as the JAX package's; the card's drill excuses near-ties).

    Returns a report dict: ``verdict`` ("pass"/"fail"), ``reason``,
    ``canary``, ``waved`` (replicas on the new manifest), ``rolled_back``,
    ``probe_p99_s``, ``p99_gate_s``, ``tokens_equal``, and on failure the
    still-held pin ``lease`` over the old manifest.
    """
    from pyrecover_tpu_torch.checkpoint.zerostall import pins

    replica_ids = list(replica_ids)
    if not replica_ids:
        raise ValueError("canary_rollout: no replicas")
    match = tokens_match or (lambda got, want: got == want)
    canary, rest = replica_ids[0], replica_ids[1:]
    gate_p99 = P99_FACTOR * baseline_p99_s + P99_SLACK_S
    # faultcheck: disable-next=leak-on-error -- deliberate: if the rollout
    # aborts mid-flight (an RPC failure, an impossible rollback) the lease
    # MUST stay held so GC cannot take the old manifest from under a
    # half-rolled fleet; failure reports carry it home for the operator
    lease = pins.pin_manifest(exp_dir, old_manifest, owner="rollout")

    def _swap(replica_id, path):
        return router.request(replica_id, {"type": "swap", "manifest": str(path)},
                              "swap_result", timeout_s=timeout_s)

    reason = ""
    tokens_equal = False
    probe_p99 = 0.0
    touched = []
    rep = _swap(canary, manifest)
    if not rep.get("ok"):
        reason = f"swap_rejected:{rep.get('reason', '')}"
    else:
        touched.append(canary)
        probe = router.request(canary, {"type": "probe", "seed": SEED}, "probe_result",
                               timeout_s=timeout_s)
        tokens_equal = bool(match(probe["tokens"], expected_tokens))
        probe_p99 = _p99(probe["e2e_s"])
        if not tokens_equal:
            reason = "token_mismatch"
        elif probe_p99 > gate_p99:
            reason = "p99_regression"
    waved = []
    if not reason:
        for replica_id in rest:
            rep = _swap(replica_id, manifest)
            if not rep.get("ok"):
                reason = f"wave_swap_rejected:r{replica_id}:{rep.get('reason', '')}"
                break
            touched.append(replica_id)
            waved.append(replica_id)

    report = {"manifest": str(manifest), "old_manifest": str(old_manifest), "canary": canary,
              "tokens_equal": tokens_equal, "probe_p99_s": round(probe_p99, 4),
              "p99_gate_s": round(gate_p99, 4)}
    if reason:
        rolled_back = []
        for replica_id in touched:
            back = _swap(replica_id, Path(old_manifest))
            if not back.get("ok"):
                raise RuntimeError(
                    f"canary rollback failed on replica {replica_id}: {back.get('reason', '')}; "
                    "the old manifest is pinned, this should be impossible")
            rolled_back.append(replica_id)
        telemetry.emit("canary_verdict", verdict="fail", manifest=str(manifest), reason=reason,
                       canary=canary, waved=len(waved), probe_p99_s=report["probe_p99_s"],
                       p99_gate_s=report["p99_gate_s"])
        # the fleet stays pinned to the old weights until the operator acks
        report.update(verdict="fail", reason=reason, waved=waved, rolled_back=rolled_back,
                      lease=lease)
        return report
    telemetry.emit("canary_verdict", verdict="pass", manifest=str(manifest), reason="",
                   canary=canary, waved=len(waved), probe_p99_s=report["probe_p99_s"],
                   p99_gate_s=report["p99_gate_s"])
    lease.release()
    report.update(verdict="pass", reason="", waved=waved, rolled_back=[], lease=None)
    return report
