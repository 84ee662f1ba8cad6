"""``chip_smoke.py``'s routing-pick harness, on the CPU at a tiny MoE.

The card's MT leg (``--tp 2`` at bf16) routes its first forward by ME1's
picks and counts where its own differ. Here: the flags parse out of the
trainer's, a run forced by the picks of an identical run flips nothing and
trains the same losses, and a run forced by another seed's picks counts
flips and trains other losses than its own routing gives.
"""

import pytest
import torch

import chip_smoke
from pyrecover_tpu_torch import train

LAYERS = 2


def argv(tmp_path, name, seed=0):
    return ["--model-dim", "64", "--model-layers", str(LAYERS), "--model-heads", "4",
            "--model-kv-heads", "2", "--vocab-size", "128", "--moe-experts", "4",
            "--moe-top-k", "2", "--sequence-length", "32", "--batch-size", "2",
            "--training-samples", "4", "--training-steps", "2", "--lr-warmup-steps", "1",
            "--logging-frequency", "1", "--seed", str(seed), "--device", "cpu",
            "--checkpoint-frequency", "0", "--checkpoint-dir", str(tmp_path),
            "--experiment-name", name]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(args):
    """``train.main`` of ``args`` under the harness; returns its losses and
    the flips the harness counted."""
    run_argv, smoke = chip_smoke._smoke_flags(args)
    smoke["layers"] = LAYERS
    with chip_smoke._moe_harness(train, smoke) as held:
        out = train.main(run_argv)
    return out["losses"], held["flips"]


def test_smoke_flags_leave_the_trainers():
    run_argv, smoke = chip_smoke._smoke_flags(
        ["--seed", "0", "--smoke-moe-dispatch", "grouped", "--smoke-guard-moe",
         "--smoke-record-picks", "a.pt", "--smoke-force-picks", "b.pt",
         "--smoke-wait-for", "c", "--device", "cpu"])
    assert run_argv == ["--seed", "0", "--device", "cpu"]
    assert smoke == {"guard_moe": True, "dispatch": "grouped", "wait_for": "c",
                     "record_picks": "a.pt", "force_picks": "b.pt"}


def test_forced_picks_route_the_first_forward(tmp_path):
    picks = str(tmp_path / "picks.pt")
    ref, flips = run(argv(tmp_path, "ref") + ["--smoke-record-picks", picks])
    assert flips == []
    recorded = torch.load(picks)
    assert len(recorded) == LAYERS and recorded[0].shape == (2, 32, 2)
    same, flips = run(argv(tmp_path, "same") + ["--smoke-force-picks", picks])
    assert flips == [0] * LAYERS and same == ref
    own, _ = run(argv(tmp_path, "own", seed=1))
    forced, flips = run(argv(tmp_path, "forced", seed=1) + ["--smoke-force-picks", picks])
    assert len(flips) == LAYERS and sum(flips) > 0
    assert forced[0] != own[0]
