"""The port's canary rollout: ``canary_rollout_drill(device="cpu")`` at the
tiny drill config (the divergent manifest fails the token gate and rolls back
with the old manifest's pin held, the healthy one waves), then
``canary_rollout`` of both packages against the same scripted fake replicas
(TCP listeners that answer ``swap`` and ``probe`` as each case says): the same
verdict, reason, wave, rollback, swap trail and ``canary_verdict`` event, and
the pin lease held exactly when the rollout failed."""

import json
import socket
import threading
from pathlib import Path

import pytest
import torch

from pyrecover_tpu import telemetry as jax_telemetry
from pyrecover_tpu.checkpoint.zerostall import pins as jax_pins
from pyrecover_tpu.serving.fleet.rollout import canary_rollout as jax_canary_rollout
from pyrecover_tpu.serving.fleet.router import FleetRouter as JaxFleetRouter
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.zerostall import pins
from pyrecover_tpu_torch.serving.fleet import FleetRouter, canary_rollout, canary_rollout_drill


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYRECOVER_EMERGENCY", "0")
    monkeypatch.delenv("PYRECOVER_FAULT_PLAN", raising=False)
    yield
    torch.set_num_threads(threads)


def test_canary_rollout_drill_on_the_cpu(tmp_path):
    report = canary_rollout_drill(tmp_path, device="cpu")
    assert (report["divergent_verdict"], report["divergent_reason"]) == ("fail",
                                                                         "token_mismatch")
    assert report["rolled_back"] == [0]
    assert report["pinned_after_rollback"] == ["ckpt_1.zs.json.rollout.pin"]
    assert report["healthy_verdict"] == "pass" and report["healthy_waved"] == 1
    assert report["probe_p99_s"] <= report["p99_gate_s"]
    # canary to 3, back to 1, canary to 2, wave to 2: each swap moved bytes
    assert [(s["replica"], s["step"]) for s in report["swaps"]] == [(0, 3), (0, 1), (0, 2),
                                                                    (1, 2)]
    assert all(s["fetched_bytes"] > 0 and s["swap_s"] >= 0 for s in report["swaps"])
    assert report["near_ties_excused"] == 0
    assert not pins.live_pins(tmp_path / "exp")  # released: the operator's ack, then the pass
    events = telemetry.read_events(tmp_path / "canary_telemetry.jsonl")
    assert [(e["verdict"], e["reason"]) for e in events if e["event"] == "canary_verdict"] == [
        ("fail", "token_mismatch"), ("pass", "")]


class _ScriptedReplica:
    """A fake replica: answers ``swap`` with ``ok`` unless the manifest's
    name is in ``reject``, and ``probe`` with ``tokens`` and ``e2e_s``;
    records the swaps it was asked for."""

    def __init__(self, *, reject=(), tokens=((1, 2, 3),), e2e_s=(0.01,)):
        self.reject, self.tokens, self.e2e_s = set(reject), [list(t) for t in tokens], e2e_s
        self.swaps = []
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        sock, _ = self._lsock.accept()
        step = 1
        try:
            for line in sock.makefile("rb"):
                msg = json.loads(line)
                if msg["type"] == "swap":
                    name = Path(msg["manifest"]).name
                    ok = name not in self.reject
                    self.swaps.append(name)
                    step = int(name.split("_")[1].split(".")[0]) if ok else step
                    reply = {"type": "swap_result", "ok": ok, "step": step,
                             "reason": "" if ok else "ValueError: digest mismatch"}
                elif msg["type"] == "probe":
                    reply = {"type": "probe_result", "tokens": self.tokens,
                             "e2e_s": list(self.e2e_s)}
                else:
                    continue
                sock.sendall((json.dumps(reply) + "\n").encode())
        except (OSError, ValueError):
            pass
        finally:
            sock.close()
            self._lsock.close()


CASES = {
    "pass": dict(canary={}, other={}, verdict=("pass", ""), waved=[1], rolled_back=[]),
    "token_mismatch": dict(canary={"tokens": [[9, 9, 9]]}, other={},
                           verdict=("fail", "token_mismatch"), waved=[], rolled_back=[0]),
    "p99_regression": dict(canary={"e2e_s": [3.0]}, other={},
                           verdict=("fail", "p99_regression"), waved=[], rolled_back=[0]),
    "swap_rejected": dict(canary={"reject": {"ckpt_2.zs.json"}}, other={},
                          verdict=("fail", "swap_rejected:ValueError: digest mismatch"),
                          waved=[], rolled_back=[]),
    "wave_swap_rejected": dict(canary={}, other={"reject": {"ckpt_2.zs.json"}},
                               verdict=("fail",
                                        "wave_swap_rejected:r1:ValueError: digest mismatch"),
                               waved=[], rolled_back=[0]),
}


def _rollout(pkg, tmp_path, case):
    router_cls, rollout, bus, pin_mod = {
        "port": (FleetRouter, canary_rollout, telemetry, pins),
        "jax": (JaxFleetRouter, jax_canary_rollout, jax_telemetry, jax_pins)}[pkg]
    exp = tmp_path / pkg
    exp.mkdir()
    old = exp / "ckpt_1.zs.json"
    old.write_text(json.dumps({"format": "zerostall", "leaves": []}))
    fakes = [_ScriptedReplica(**CASES[case]["canary"]), _ScriptedReplica(**CASES[case]["other"])]
    router = router_cls()
    mem = bus.MemorySink()
    bus.add_sink(mem)
    try:
        for i, fake in enumerate(fakes):
            router.connect(i, "127.0.0.1", fake.port)
        report = rollout(router, [0, 1], manifest=exp / "ckpt_2.zs.json", old_manifest=old,
                         exp_dir=exp, expected_tokens=[[1, 2, 3]], baseline_p99_s=0.01,
                         timeout_s=30.0)
    finally:
        router.close()
        bus.remove_sink(mem)
    held = [p.name for p in pin_mod.live_pins(exp)]
    lease = report.pop("lease")
    if lease is not None:
        lease.release()
    (verdict,) = [{k: v for k, v in e.items() if k not in ("ts", "host", "manifest")}
                  for e in mem.events if e["event"] == "canary_verdict"]
    report = {k: v for k, v in report.items() if k not in ("manifest", "old_manifest")}
    return report, verdict, held, [f.swaps for f in fakes]


@pytest.mark.parametrize("case", list(CASES))
def test_both_packages_roll_out_alike(tmp_path, case):
    port = _rollout("port", tmp_path, case)
    assert port == _rollout("jax", tmp_path, case)
    report, verdict, held, swaps = port
    want = CASES[case]
    assert (report["verdict"], report["reason"]) == want["verdict"]
    assert report["waved"] == want["waved"] and report["rolled_back"] == want["rolled_back"]
    assert (verdict["verdict"], verdict["reason"]) == want["verdict"]
    # the lease is held exactly when the rollout failed
    assert held == ([] if case == "pass" else ["ckpt_1.zs.json.rollout.pin"])
    # a non-canary replica never sees a manifest the canary failed
    assert "ckpt_2.zs.json" not in swaps[1] or case in ("pass", "wave_swap_rejected")
    assert swaps[0][-1] == ("ckpt_2.zs.json" if case == "pass" else
                            "ckpt_2.zs.json" if case == "swap_rejected" else "ckpt_1.zs.json")
