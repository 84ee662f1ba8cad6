"""The port's time-aware stop held to the JAX package's ``preempt.py``: the
same estimates and stop decisions on the same inputs, markers each package
reads from the other, and the trainer's stop at a deadline, a notice file
and SIGTERM, each with a ``_final`` checkpoint and ``REQUEUE``."""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch

from pyrecover_tpu import preempt as jax_preempt
from pyrecover_tpu_torch import preempt
from pyrecover_tpu_torch import train as train_mod
from pyrecover_tpu_torch.checkpoint import registry
from pyrecover_tpu_torch.config import get_args
from pyrecover_tpu_torch.train import train


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_decaying_estimator_matches_jax():
    rng = np.random.default_rng(3)
    series = np.concatenate([[40.0], rng.uniform(0.5, 2.0, 30), [9.0], rng.uniform(0.5, 1.0, 30)])
    for decay, window in ((0.9, 8), (0.5, 3)):
        port = preempt.DecayingMaxEstimator(1.0, decay=decay, window=window)
        ref = jax_preempt.DecayingMaxEstimator(1.0, decay=decay, window=window)
        assert port.value == ref.value
        for x in series:
            assert port.observe(x) == ref.observe(x)


@pytest.mark.parametrize("left", [5.0, 40.0, 60.0, 3600.0])
@pytest.mark.parametrize("interval", [1, 20])
def test_deadline_decisions_match_jax(left, interval):
    deadline = time.time() + left
    kw = dict(enabled=True, default_iter_time=1.0, default_ckpt_time=10.0,
              job_end_time=deadline, check_interval=interval)
    port, ref = preempt.PreemptionWatcher(**kw), jax_preempt.PreemptionWatcher(**kw)
    for w in (port, ref):
        w.observe_iter(1.5)
        w.observe_ckpt(4.0)
    # ckpt: the decayed prior, 10 * 0.9, still tops the 4.0 seen
    assert (port.max_iter_time, port.max_ckpt_time) == (ref.max_iter_time, ref.max_ckpt_time) == (1.5, 9.0)
    assert port.safety_buffer == ref.safety_buffer == 5 * 1.5 + 2 * 9.0
    for step in (interval - 1, interval):
        assert port.should_stop(step) == ref.should_stop(step)
    assert port.should_stop(interval) == (left < interval * 1.5 + 9.0 + 25.5)


def test_notice_file_and_signal_stop_any_step(tmp_path, monkeypatch):
    notice = tmp_path / "notice"
    monkeypatch.setenv(preempt.PREEMPT_NOTICE_ENV, str(notice))
    w = preempt.PreemptionWatcher(enabled=True, check_interval=50)
    assert not w.should_stop(1)
    notice.write_text("evicting")
    assert w.should_stop(2)  # not a check step: a notice stops all the same
    monkeypatch.delenv(preempt.PREEMPT_NOTICE_ENV)
    before = signal.getsignal(signal.SIGTERM)
    w2 = preempt.PreemptionWatcher(enabled=True).install_signal_handler()
    try:
        assert not w2.should_stop(1)
        os.kill(os.getpid(), signal.SIGUSR1)
        assert w2.should_stop(1)
    finally:
        w2.restore_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is before
    assert not preempt.PreemptionWatcher(enabled=False, job_end_time=0.0).should_stop()


def test_armed_second_signal_writes_marker_and_exits_75(tmp_path):
    exits = []
    w = preempt.PreemptionWatcher(enabled=True).install_signal_handler()
    w._exit_fn = exits.append
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)
        assert exits == []  # not armed: two signals only ask for the stop
        w.arm_escalation(tmp_path, 42)
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        w.restore_signal_handlers()
    assert exits == [75]
    assert preempt.read_requeue_marker(tmp_path)["step"] == 42
    assert jax_preempt.read_requeue_marker(tmp_path) == {
        **preempt.read_requeue_marker(tmp_path), "done": False}


def test_markers_cross_between_packages(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    preempt.write_requeue_marker(a, done=False, step=7)
    got = jax_preempt.read_requeue_marker(a)
    assert (got["done"], got["step"]) == (False, 7)
    jax_preempt.write_requeue_marker(b, done=True, step=9)
    got = preempt.read_requeue_marker(b)
    assert (got["done"], got["step"]) == (True, 9)
    preempt.write_requeue_marker(b, done=False)
    assert not (b / "DONE").exists() and jax_preempt.read_requeue_marker(b)["done"] is False
    for text, want in (("1700000000.5", 1700000000.5), ("{torn", None)):
        (a / "REQUEUE").write_text(text)
        assert preempt.read_requeue_marker(a) == jax_preempt.read_requeue_marker(a) == {
            "ts": want, "done": False}
    assert preempt.read_requeue_marker(tmp_path / "none") is None


# ---- the trainer's stops ---------------------------------------------------


def tiny(ckpt_dir, **kw):
    argv = ["--device", "cpu", "--batch-size", "2", "--sequence-length", "32",
            "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
            "--model-kv-heads", "2", "--vocab-size", "128", "--attention-impl", "flash",
            "--training-samples", "16", "--logging-frequency", "1",
            "--training-steps", "6", "--checkpoint-frequency", "0", "--verify-checkpoints",
            "--timeaware-checkpointing", "--checkpoint-dir", str(ckpt_dir)]
    return dataclasses.replace(get_args(argv), **kw)


def assert_stopped_at(out, exp, step):
    assert (out["end_step"], out["stopped_early"]) == (step, True)
    assert [p.name for p in registry.list_checkpoints(exp)] == [f"ckpt_{step}_final.ckpt"]
    assert (exp / "ckpt_{}_final.ckpt.sha256".format(step)).exists()
    marker = preempt.read_requeue_marker(exp)
    assert (marker["done"], marker["step"]) == (False, step)
    assert not (exp / "DONE").exists()


def test_deadline_stop_then_resume_to_done(tmp_path):
    exp = tmp_path / "default-exp"
    # a deadline already inside the buffer: stop at the first check step
    out = train(tiny(tmp_path, job_end_time=time.time() + 5.0, preempt_check_interval=2))
    assert_stopped_at(out, exp, 2)
    out = train(tiny(tmp_path, resume_from_checkpoint="latest", timeaware_checkpointing=False))
    assert (out["start_step"], out["end_step"], out["stopped_early"]) == (2, 6, False)
    assert preempt.read_requeue_marker(exp)["done"] is True
    assert not (exp / "REQUEUE").exists()


def test_notice_file_stop(tmp_path, monkeypatch):
    notice = tmp_path / "notice"
    monkeypatch.setenv(preempt.PREEMPT_NOTICE_ENV, str(notice))
    out = train(tiny(tmp_path), on_step=lambda s: s == 3 and notice.write_text("now"))
    assert_stopped_at(out, tmp_path / "default-exp", 3)


def test_sigterm_stop_restores_the_handler(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    out = train(tiny(tmp_path), on_step=lambda s: s == 4 and os.kill(os.getpid(), signal.SIGTERM))
    assert_stopped_at(out, tmp_path / "default-exp", 4)
    assert signal.getsignal(signal.SIGTERM) is before


def test_second_signal_during_a_save_escalates(tmp_path, monkeypatch):
    exits, fired = [], []
    monkeypatch.setattr(os, "_exit", exits.append)  # the watcher's exit function
    real_save = train_mod.save_ckpt_vanilla

    def save_under_fire(*args, **kwargs):
        if not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
            os.kill(os.getpid(), signal.SIGTERM)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(train_mod, "save_ckpt_vanilla", save_under_fire)
    out = train(tiny(tmp_path, checkpoint_frequency=2))
    assert exits == [75]
    # the escalation published REQUEUE at step 2; the swapped exit returned,
    # so the periodic save finished and the run stopped there with its final
    exp = tmp_path / "default-exp"
    assert (out["end_step"], out["stopped_early"]) == (2, True)
    assert [p.name for p in registry.list_checkpoints(exp)] == ["ckpt_2.ckpt", "ckpt_2_final.ckpt"]
    assert preempt.read_requeue_marker(exp)["step"] == 2


def test_watcher_learns_what_a_final_save_costs(tmp_path, monkeypatch):
    """A final save is synchronous, so the deadline's checkpoint estimate
    takes a background save's snapshot and write together (the JAX package
    learns only the snapshot's blocking time), and a synchronous save's
    blocking time."""
    seen = []
    real = preempt.PreemptionWatcher.observe_ckpt
    monkeypatch.setattr(preempt.PreemptionWatcher, "observe_ckpt",
                        lambda self, s: (seen.append(s), real(self, s)))
    out = train(tiny(tmp_path, checkpoint_frequency=2, timeaware_checkpointing=False))
    bg = out["saves"][:2]  # ckpt_2, ckpt_4 in the background; ckpt_6_final after
    assert [s["path"].rsplit("/", 1)[-1] for s in out["saves"]] == [
        "ckpt_2.ckpt", "ckpt_4.ckpt", "ckpt_6_final.ckpt"]
    assert seen == [s["blocking_s"] + s["write_s"] for s in bg]
    seen.clear()
    out = train(tiny(tmp_path / "sync", checkpoint_frequency=2, async_checkpoint=False))
    assert seen == [s["blocking_s"] for s in out["saves"][:2]]
