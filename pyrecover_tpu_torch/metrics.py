"""Throughput, MFU, the per-step loss CSV and the goodput ledger (the JAX
package's ``metrics.py``, single process).

Every logging interval reports tokens/s, TFLOP/s and MFU against the
card's own bf16 peak (``utils/perf.py``); the CSV is ``<exp_dir>/<exp>_loss_log.csv``.
`WallTimeTotals` is the JAX package's goodput accounting, emitted as the
``run_summary`` event on every exit of ``train.train``.
"""

import csv
import time
from pathlib import Path

from pyrecover_tpu_torch.models.presets import inactive_expert_param_count
from pyrecover_tpu_torch.utils.perf import get_num_flop_per_token


class LossCSVLogger:
    """Per-step ``(step, loss)`` CSV.

    ``resume_step`` (the checkpoint step resumed from, > 0) appends to an
    existing CSV instead of truncating it, so a stop and resume give one
    curve. Rows past the resume step are dropped first (the resumed run
    trains those steps again), and so are torn rows a kill left behind."""

    def __init__(self, exp_dir, experiment_name, enabled=True, resume_step=0):
        self._file = None
        self._writer = None
        self.path = None
        if enabled:
            exp_dir = Path(exp_dir)
            exp_dir.mkdir(parents=True, exist_ok=True)
            self.path = exp_dir / f"{experiment_name}_loss_log.csv"
            append = resume_step > 0 and self.path.exists() and self.path.stat().st_size > 0
            if append:
                with open(self.path, newline="") as f:
                    rows = list(csv.reader(f))
                kept = [rows[0] if rows else ["step", "loss"]]
                for r in rows[1:]:
                    try:
                        if len(r) >= 2 and int(r[0]) <= resume_step:
                            float(r[1])
                            kept.append(r)
                    except ValueError:
                        continue
                with open(self.path, "w", newline="") as f:
                    csv.writer(f).writerows(kept)
            self._file = open(self.path, "a" if append else "w", newline="")
            self._writer = csv.writer(self._file)
            if not append:
                self._writer.writerow(["step", "loss"])

    def log(self, step, loss):
        if self._writer is not None:
            self._writer.writerow([int(step), float(loss)])

    def flush(self):
        if self._file is not None:
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.flush()
            self._file.close()
            self._file = None


class ThroughputMeter:
    """Windowed tokens/s, TFLOP/s and MFU between logging points. The
    caller synchronizes the device before ``snapshot``/``log``. For an MoE
    model only the active experts' parameters count toward the FLOPs."""

    def __init__(self, model_config, num_params, seq_len, peak_flops):
        num_params -= inactive_expert_param_count(model_config)
        self.flop_per_token = get_num_flop_per_token(
            num_params, model_config.n_layers, model_config.n_heads,
            model_config.head_dim, seq_len,
        )
        self.peak_flops = peak_flops  # None: unknown device, no MFU
        self.seq_len = seq_len
        self.reset()

    def reset(self):
        self._t0 = time.monotonic()
        self._tokens = 0  # non-pad tokens trained on
        self._positions = 0  # token positions processed, pad included
        self._steps = 0

    def update(self, n_tokens, batch_size):
        self._tokens += int(n_tokens)
        self._positions += int(batch_size) * self.seq_len
        self._steps += 1

    def snapshot(self):
        dt = max(time.monotonic() - self._t0, 1e-9)
        flops = self.flop_per_token * self._positions / dt
        return {
            "tokens_per_sec": self._positions / dt,
            "tflops": flops / 1e12,
            "mfu_pct": None if self.peak_flops is None else 100.0 * flops / self.peak_flops,
            "training_tokens_pct": 100.0 * self._tokens / max(self._positions, 1),
            "seconds": dt,
            "steps": self._steps,
            "step_ms": 1e3 * dt / max(self._steps, 1),
        }


class WallTimeTotals:
    """Cumulative wall-time + goodput accounting, logged at exit and emitted
    as the ``run_summary`` telemetry event (reference train.py:381-398,
    extended).

    Buckets:
      * ``train_s`` — hot-loop wall time (includes in-loop ckpt/eval).
      * ``step_s`` — time actually spent stepping (interval sums between
        sync points, checkpoint and eval excluded).
      * ``ckpt_save_s`` / ``ckpt_load_s`` — blocking checkpoint seconds.
        ``ckpt_blocking_s`` is the same train-loop-stall charge under its
        honest name; ``ckpt_shadow_s`` counts the OVERLAPPED background
        save work (the background vanilla writer) —
        recovered goodput, visible but never charged to ``lost_s``.
      * ``eval_s`` — held-out evaluation wall time.
      * ``setup_s`` — pre-loop set-up (model init, the resume's bookkeeping);
        on a restarted run this is part of the restart tax.
      * ``replayed_steps`` / ``replayed_s`` — post-resume steps at or below
        the previous attempt's high-water mark: work done twice.
      * ``wall_s`` — whole ``train()`` call, entry to exit.

    Goodput = productive stepping (step_s − replayed_s) over total wall —
    the fraction of the run that moved training forward exactly once.
    """

    def __init__(self):
        self.train_s = 0.0
        self.step_s = 0.0
        self.ckpt_save_s = 0.0
        self.ckpt_blocking_s = 0.0
        self.ckpt_shadow_s = 0.0
        self.ckpt_load_s = 0.0
        self.eval_s = 0.0
        self.setup_s = 0.0
        self.wall_s = 0.0
        self.replayed_steps = 0
        self.replayed_s = 0.0

    def productive_s(self):
        return max(self.step_s - self.replayed_s, 0.0)

    def lost_s(self):
        """Resilience overhead: time that bought durability, not progress.
        Only the BLOCKING checkpoint seconds count — shadow (overlapped)
        save work ran while training stepped, so charging it would hide
        exactly the goodput an async engine recovers."""
        return (
            self.ckpt_save_s + self.ckpt_load_s + self.replayed_s + self.setup_s
        )

    def goodput_pct(self):
        total = self.wall_s or (self.train_s + self.ckpt_load_s + self.setup_s)
        if total <= 0:
            return 0.0
        return 100.0 * self.productive_s() / total

    def as_dict(self):
        return {
            "train_s": round(self.train_s, 3),
            "step_s": round(self.step_s, 3),
            "ckpt_save_s": round(self.ckpt_save_s, 3),
            "ckpt_blocking_s": round(self.ckpt_blocking_s, 3),
            "ckpt_shadow_s": round(self.ckpt_shadow_s, 3),
            "ckpt_load_s": round(self.ckpt_load_s, 3),
            "eval_s": round(self.eval_s, 3),
            "setup_s": round(self.setup_s, 3),
            "wall_s": round(self.wall_s, 3),
            "replayed_steps": int(self.replayed_steps),
            "replayed_s": round(self.replayed_s, 3),
            "productive_s": round(self.productive_s(), 3),
            "lost_s": round(self.lost_s(), 3),
            "goodput_pct": round(self.goodput_pct(), 2),
        }

    def summary(self):
        s = (
            f"total train {self.train_s:.1f}s | "
            f"ckpt save {self.ckpt_save_s:.1f}s | ckpt load {self.ckpt_load_s:.1f}s | "
            f"eval {self.eval_s:.1f}s"
        )
        if self.ckpt_shadow_s:
            s += f" | ckpt shadow {self.ckpt_shadow_s:.1f}s (overlapped)"
        if self.replayed_steps:
            s += (
                f" | replayed {self.replayed_steps} steps"
                f" ({self.replayed_s:.1f}s)"
            )
        if self.wall_s:
            s += f" | goodput {self.goodput_pct():.1f}%"
        return s
