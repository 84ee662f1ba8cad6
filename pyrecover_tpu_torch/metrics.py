"""Throughput, MFU and the per-step loss CSV (the JAX package's
``metrics.py``, single process).

Every logging interval reports tokens/s, TFLOP/s and MFU against the
card's own bf16 peak (``utils/perf.py``); the CSV is ``<exp_dir>/<exp>_loss_log.csv``.
"""

import csv
import time
from pathlib import Path

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
    caller synchronizes the device before ``snapshot``/``log``."""

    def __init__(self, model_config, num_params, seq_len, peak_flops):
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
