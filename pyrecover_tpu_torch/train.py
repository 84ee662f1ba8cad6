"""Single-process training loop with checkpoints, resume, the time-aware
stop, held-out evaluation, rematerialization and a profile window.

    python -m pyrecover_tpu_torch.train --model-dim 2048 --model-layers 20 \\
        --model-heads 16 --model-kv-heads 8 --vocab-size 32768 \\
        --sequence-length 2048 --batch-size 2 --attention-impl flash

Runs on the CUDA card unless ``--device cpu`` is given, and raises when
there is no card rather than falling back to the CPU. Trains the dense
Llama-style decoder on the deterministic synthetic dataset, or on a parquet
corpus (``--dataset``, tokenized with ``--tokenizer-name-or-path``, packed
several documents a row with ``--pack-sequences``), fed by the prefetching
``data.DataLoader``, and logs loss, tokens/s, step time, TFLOP/s and MFU
every ``--logging-frequency`` steps (and the per-step loss CSV with
``--log-loss-to-csv``). ``--eval-frequency`` evaluates the exact mean CE on
a held-out split (``--eval-dataset``, or synthetic data on ``seed + 1``)
outside the step timing; ``--remat`` / ``--remat-policy`` rematerialize the
blocks (``auto`` sizes the policy against the device's memory,
``utils/remat.py``); ``--profile`` traces the steps after
``--profile-step-start`` up to ``--profile-step-end`` with
``torch.profiler`` into ``--profile-dir``.

Checkpoints are the JAX package's vanilla ``PYRCKPT2`` files in
``<checkpoint-dir>/<experiment>/``, readable by either package: one every
``--checkpoint-frequency`` steps (written in the background unless
``--no-async-checkpoint``) and ``ckpt_<step>_final`` at the end. With
``--timeaware-checkpointing`` the run stops early, with a ``_final``
checkpoint, when the job's deadline comes near or a preemption notice
arrives (SIGTERM, SIGUSR1, ``$PYRECOVER_PREEMPT_FILE``), and leaves a
``REQUEUE`` marker (``DONE`` when it finished); ``launch/run_resilient.sh``
restarts it until ``DONE``. ``--resume-from-checkpoint latest`` continues
from the newest intact checkpoint exactly as if the run had never stopped;
a corrupt newest file is moved into ``.corrupt/`` and the one before it is
used. Telemetry, the sharded, zerostall and elastic checkpoint engines and
multi-device meshes are not ported.
"""

import contextlib
import dataclasses
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch.checkpoint.registry import checkpoint_path, list_checkpoints
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    load_ckpt_vanilla,
    precheck_ckpt_vanilla,
    save_ckpt_vanilla,
)
from pyrecover_tpu_torch.config import TrainConfig, get_args
from pyrecover_tpu_torch.data import DataLoader, StatefulSampler, SyntheticTextDataset
from pyrecover_tpu_torch.metrics import LossCSVLogger, ThroughputMeter
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.preempt import PreemptionWatcher, write_requeue_marker
from pyrecover_tpu_torch.resilience.quarantine import quarantine_checkpoint
from pyrecover_tpu_torch.train_state import (
    load_state_leaves,
    make_eval_step,
    make_train_step,
    rng_fold_in,
    rng_key,
    state_leaves,
)
from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.perf import get_num_params, gpu_peak_flops

log = logging.getLogger("pyrecover_tpu_torch")

# the exit path's bound on joining a background save: a wedged disk must not
# hang the unwind
_BG_JOIN_TIMEOUT_S = 600.0


def build_dataset(config):
    """``(dataset, pad token id, model config)``. With ``--dataset``: the
    parquet corpus, packed or right-padded, and the model config with the
    tokenizer's vocab size when it is larger than ``--vocab-size``; else
    the synthetic dataset and the configured model."""
    if config.dataset:
        from pyrecover_tpu_torch.data.parquet import ParquetTextDataset, load_tokenizer

        tokenizer = load_tokenizer(config.tokenizer_name_or_path)
        if config.pack_sequences:
            from pyrecover_tpu_torch.data.packed import PackedParquetTextDataset

            cls = PackedParquetTextDataset
        else:
            cls = ParquetTextDataset
        ds = cls(config.dataset, tokenizer, config.sequence_length,
                 training_samples=config.training_samples)
        vocab_size = max(len(tokenizer), config.model.vocab_size)
        return ds, ds.pad_token_id, dataclasses.replace(config.model, vocab_size=vocab_size)
    if config.pack_sequences:
        log.info("--pack-sequences has no effect with synthetic data (synthetic rows are "
                 "already dense); continuing unpacked")
    n = config.training_samples or max(
        config.batch_size * config.training_steps, config.batch_size
    )
    ds = SyntheticTextDataset(
        num_samples=n, seq_len=config.sequence_length,
        vocab_size=config.model.vocab_size, seed=config.seed,
    )
    return ds, 0, config.model


def build_model(config, device):
    """The model at its seeded initial weights, on ``device``."""
    generator = torch.Generator(device=device).manual_seed(config.seed)
    return Transformer(config.model, device=device, generator=generator)


def build_sampler(config, dataset_len):
    return StatefulSampler(
        dataset_len=dataset_len, global_batch_size=config.batch_size,
        seed=config.seed, num_samples=config.training_samples or None,
    )


def build_loader(config, dataset, pad_token_id, sampler, device, prefetch=2):
    """The prefetching loader the trainer takes its batches from (``prefetch``
    0: collated on the caller's thread)."""
    return DataLoader(dataset, sampler, pad_token_id, device=device, prefetch=prefetch,
                      num_workers=4, stall_timeout=config.loader_stall_timeout)


class _PadFilledView:
    """Dataset view of ``n_real`` corpus rows, length-padded to a whole
    number of batches with all-pad rows (zero loss contribution)."""

    def __init__(self, ds, n_real, n_total, pad_token_id, seq_len):
        self._ds = ds
        self._n_real = int(n_real)
        self._n_total = int(n_total)
        self._pad_row = np.full((int(seq_len) + 1,), pad_token_id, np.int32)

    def __len__(self):
        return self._n_total

    def __getitem__(self, idx):
        idx = int(idx)
        return self._ds[idx] if idx < self._n_real else self._pad_row


def build_eval_runner(config, model_config, pad_token_id, device):
    """Held-out evaluation (the JAX package's ``build_eval_runner``):
    returns ``run_eval(model) -> mean loss``, or None when
    ``--eval-frequency`` is 0.

    ``--eval-dataset`` names a parquet file, read at its natural length
    (no wraparound) with its tokenizer's pad id, the last batch filled
    with all-pad rows that add nothing to either sum; without it a
    synthetic split on ``seed + 1`` is the held-out data. The loss is
    exact: Σ CE / Σ valid tokens over ``--eval-samples`` samples, rounded
    up to whole batches of the training batch size. One prefetching loader
    over a sequential sampler serves every call (``run_eval.loader``, which
    the caller stops), so each call sees the same eval set and the next
    batch is collated while the device runs the current one."""
    if config.eval_frequency <= 0:
        return None
    batch = config.batch_size
    if config.eval_dataset:
        from pyrecover_tpu_torch.data.parquet import ParquetTextDataset, load_tokenizer

        tokenizer = load_tokenizer(config.tokenizer_name_or_path)
        corpus = ParquetTextDataset(config.eval_dataset, tokenizer, config.sequence_length,
                                    training_samples=0)
        pad_token_id = corpus.pad_token_id
        n_requested = min(config.eval_samples or len(corpus), len(corpus))
        n_batches = max((n_requested + batch - 1) // batch, 1)
        eval_ds = _PadFilledView(corpus, n_requested, n_batches * batch, pad_token_id,
                                 config.sequence_length)
    else:
        n_requested = config.eval_samples or 64
        n_batches = max((n_requested + batch - 1) // batch, 1)
        eval_ds = SyntheticTextDataset(
            num_samples=n_batches * batch, seq_len=config.sequence_length,
            vocab_size=model_config.vocab_size, seed=config.seed + 1,
        )
    sampler = StatefulSampler(dataset_len=len(eval_ds), global_batch_size=batch,
                              seed=config.seed + 1, shuffle=False)
    loader = DataLoader(eval_ds, sampler, pad_token_id, device=device, prefetch=2,
                        num_workers=2, stall_timeout=config.loader_stall_timeout)

    def run_eval(model):
        loader.start()  # idempotent; lazy, so no thread runs if eval never does
        eval_step = make_eval_step(model, config.loss_chunk_size)
        ce_sum = n_tok = None
        for _ in range(n_batches):
            _, b = next(loader)
            s, n = eval_step(b)
            # summed on the device: one sync per evaluation
            ce_sum = s if ce_sum is None else ce_sum + s
            n_tok = n if n_tok is None else n_tok + n
        return float(ce_sum) / max(int(n_tok), 1)

    run_eval.loader = loader
    run_eval.batches = n_batches
    return run_eval


class _ProfileWindow:
    """``--profile``: ``torch.profiler`` (CPU and, on the card, CUDA
    activity) from `start` to `stop`, its Chrome trace written under
    ``--profile-dir``; on the card the window is also bracketed by
    ``cudaProfilerStart``/``Stop`` (an nsys capture range) and each step is
    an NVTX range."""

    def __init__(self, config, cuda, step):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.cuda, self.first = cuda, step + 1
        self.dir = Path(config.profile_dir)
        self.path = None
        self._prof = profile(activities=activities)
        self._prof.start()
        if cuda:
            torch.cuda.profiler.start()

    @contextlib.contextmanager
    def step(self, n):
        if self.cuda:
            torch.cuda.nvtx.range_push(f"step {n}")
        try:
            with torch.profiler.record_function(f"step {n}"):
                yield
        finally:
            if self.cuda:
                torch.cuda.nvtx.range_pop()

    def stop(self, last):
        """End the window after step ``last``; returns the trace's path."""
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.profiler.stop()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"trace_steps_{self.first}-{last}.json"
        self._prof.export_chrome_trace(str(self.path))
        log.info("Profile of steps %d-%d written to %s", self.first, last, self.path)
        return self.path


def _resume(config, exp_dir, leaves):
    """Restore ``config.resume_from_checkpoint`` into ``leaves`` (the state's
    `state_leaves`). Returns the checkpoint's meta (None when ``latest``
    finds no checkpoint) and the seconds the integrity pre-checks took.

    ``latest`` walks the checkpoints newest to oldest: one that fails its
    integrity pre-check or its load is quarantined into ``.corrupt/`` and the
    walk falls back to the one before. A structure mismatch (the wrong
    model configuration) raises `CheckpointStructureError` and moves
    nothing, since every candidate would fail the same way. An explicitly
    named checkpoint raises on any failure. When every candidate fails the
    run refuses to start fresh: retention would then delete checkpoints
    that may still be recoverable."""
    target = config.resume_from_checkpoint
    explicit = target != "latest"
    precheck_s = 0.0
    if explicit:
        candidates = [Path(target)]
    else:
        candidates = list_checkpoints(exp_dir, engine="vanilla")[::-1]
        if not candidates:
            log.info("No checkpoint found in %s; starting fresh", exp_dir)
            return None, precheck_s
    for cand in candidates:
        if not explicit:
            t0 = time.monotonic()
            ok, why = precheck_ckpt_vanilla(cand, verify=config.verify_checkpoints,
                                            target=leaves)
            precheck_s += time.monotonic() - t0
            if not ok:
                log.warning("Checkpoint %s failed integrity pre-check (%s); falling back "
                            "to the previous one", cand, why)
                quarantine_checkpoint(cand, reason=why)
                continue
        try:
            # the pre-check already checksummed a `latest` candidate
            meta = load_ckpt_vanilla(cand, leaves,
                                     verify=config.verify_checkpoints and explicit)
        except Exception as e:
            if explicit or isinstance(e, CheckpointStructureError):
                raise
            log.warning("Checkpoint %s failed to restore (%s: %s); falling back to the "
                        "previous one", cand, type(e).__name__, e)
            quarantine_checkpoint(cand, reason=f"{type(e).__name__}: {e}")
            continue
        log.info("Resumed from %s", cand)
        return meta, precheck_s
    raise RuntimeError(
        f"every checkpoint in {exp_dir} failed to restore; refusing to start fresh "
        "over existing checkpoints — inspect them or move them aside"
    )


def train(config: TrainConfig, on_step=None):
    """Train up to ``config.training_steps`` steps, resuming first when
    ``config.resume_from_checkpoint`` says so. Returns a summary: this run's
    per-step losses; the steady-state step time, tokens/s, TFLOP/s, MFU
    (None off a known card) and peak device memory; ``start_step``,
    ``end_step``, ``stopped_early``; ``ckpt_load_s`` (the resume, pre-check
    included) and ``ckpt_precheck_s``, ``ckpt_save_s`` (what the saves blocked) and ``saves`` (each
    save's path, blocking seconds, bytes and write seconds);
    ``first_step_s``, from entry to the end of this run's first step;
    ``window_step_ms``, the step time of each logging window;
    ``evals`` (each evaluation's step, loss and seconds) and
    ``eval_batches``; ``remat`` (the policy run, and with ``auto`` its
    decision); ``profile_trace``; ``loader_stalls`` and ``loader_stall_s``
    (how often and how long the step waited on the loader).
    ``on_step(step)``, if given, is called at the end of every step (after
    the step's logging sync when it has one), e.g. to advance a profiler's
    schedule."""
    t_entry = time.monotonic()
    device = resolve_device(config.device)
    cuda = device.type == "cuda"
    ckpt_root = Path(config.checkpoint_dir)
    if ckpt_root.exists() and not ckpt_root.is_dir():
        raise NotADirectoryError(f"--checkpoint-dir {ckpt_root} exists and is not a directory")
    exp_dir = ckpt_root / config.experiment_name
    ds, pad_token_id, model_cfg = build_dataset(config)
    remat = {"policy": "none" if not model_cfg.remat else model_cfg.remat_policy,
             "decision": None}
    if model_cfg.remat_policy == "auto":
        from pyrecover_tpu_torch.utils.remat import resolve_remat_policy

        decision = resolve_remat_policy(
            model_cfg, batch_size=config.batch_size, seq_len=config.sequence_length,
            loss_chunk_size=config.loss_chunk_size, device=device,
        )
        model_cfg = dataclasses.replace(model_cfg, remat=decision.remat,
                                        remat_policy=decision.remat_policy)
        remat = {"policy": decision.policy, "decision": dataclasses.asdict(decision)}
        log.info("remat auto: policy %s on %s (modelled %.2f GiB vs budget %s; batch "
                 "suggestion %d)", decision.policy, decision.device_kind or "<unknown device>",
                 decision.table[decision.policy] / 2**30,
                 f"{decision.budget_bytes / 2**30:.2f} GiB" if decision.budget_bytes
                 else "unknown", decision.suggested_batch_size)
    config = dataclasses.replace(config, remat=model_cfg.remat, model=model_cfg)
    sampler = build_sampler(config, len(ds))
    model = build_model(config, device)
    optimizer, _ = build_optimizer(config, model.parameters())
    step_fn = make_train_step(
        model, optimizer, loss_chunk_size=config.loss_chunk_size,
        grad_accumulation_steps=config.grad_accumulation_steps,
    )
    n_params = get_num_params(model)
    log.info("Model: %.2fM params on %s | %s", n_params / 1e6, device, config.model)
    peak = gpu_peak_flops(torch.cuda.get_device_name(device)) if cuda else None
    meter = ThroughputMeter(
        config.model, get_num_params(model, exclude_embedding=True),
        config.sequence_length, peak,
    )

    rng = rng_key(config.seed)
    start_step, load_s, precheck_s = 0, 0.0, 0.0
    if config.resume_from_checkpoint:
        t0 = time.monotonic()
        leaves = state_leaves(model, optimizer, rng=rng)
        meta, precheck_s = _resume(config, exp_dir, leaves)
        if meta is not None:
            saved_step, _, rng = load_state_leaves(leaves, optimizer)
            start_step = int(meta.get("step", saved_step))
            sampler.seek(meta.get("sampler", {}).get("consumed", start_step))
        del leaves
        load_s = time.monotonic() - t0
        log.info("Resume took %.2f s; training from step %d", load_s, start_step + 1)
    loader = build_loader(config, ds, pad_token_id, sampler, device)
    run_eval = build_eval_runner(config, config.model, pad_token_id, device)
    csv_logger = LossCSVLogger(exp_dir, config.experiment_name,
                               enabled=config.log_loss_to_csv, resume_step=start_step)
    watcher = PreemptionWatcher(
        enabled=config.timeaware_checkpointing,
        default_iter_time=config.default_iter_time,
        default_ckpt_time=config.default_ckpt_time,
        job_end_time=config.job_end_time,
        check_interval=config.preempt_check_interval,
    )
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    losses, snaps, pending, evals = [], [], [], []
    saves, in_flight = [], []
    prof = None
    step, stopped_early, first_step_s = start_step, False, None
    # the watcher's iteration clock: wall time between sync points, per step
    sync_t0, sync_step = time.monotonic(), start_step

    def close_window(step):
        """Sync point: materialize the buffered per-step scalars and log."""
        for i, m in enumerate(pending):
            loss = m["loss"].item()
            losses.append(loss)
            csv_logger.log(step - len(pending) + i + 1, loss)
            meter.update(m["n_tokens"].item(), config.batch_size)
        if cuda:
            torch.cuda.synchronize(device)
        snap = meter.snapshot()
        snaps.append(snap)
        mfu = "n/a" if snap["mfu_pct"] is None else f"{snap['mfu_pct']:.2f}%"
        log.info(
            "step %d | loss %.4f | grad norm %.3f | %.0f tok/s | %.1f ms/step | "
            "%.1f%% training tokens | %.2f TFLOP/s | MFU %s",
            step, losses[-1], pending[-1]["grad_norm"].item(),
            snap["tokens_per_sec"], snap["step_ms"],
            snap["training_tokens_pct"], snap["tflops"], mfu,
        )
        csv_logger.flush()
        pending.clear()
        meter.reset()

    def join_in_flight(timeout=None):
        """Join the background save, if any. A final save is synchronous, so
        the watcher learns a background save's whole time, snapshot and
        write, as what a final save costs."""
        while in_flight:
            handle = in_flight.pop()
            handle.wait(timeout)
            watcher.observe_ckpt(handle.blocking_s + handle.write_s)

    def save(step, final=False):
        """Checkpoint the state after ``step``; returns its
        `VanillaSaveHandle`. The save's time is kept out of the throughput
        window and out of the watcher's iteration time."""
        nonlocal sync_t0
        if pending:
            close_window(step)
        path = checkpoint_path(config.checkpoint_dir, config.experiment_name, step,
                               final=final)
        bpe = sampler.batches_per_epoch
        epoch = step // bpe if bpe else 0
        # the batches the step consumed, not the prefetcher's live cursor
        sampler_meta = {"consumed": step, "replicas": 1, **sampler.state_dict_at(step)}
        # a second signal while this save runs writes the marker and exits
        watcher.arm_escalation(exp_dir, step)
        try:
            join_in_flight()  # one background write at a time
            handle = save_ckpt_vanilla(
                path, state_leaves(model, optimizer, step, epoch, rng), sampler_meta,
                verify=config.verify_checkpoints, max_keep=config.max_kept_checkpoints,
                extra_meta={"step": step, "epoch": epoch},
                background=config.async_checkpoint and not final,
            )
        finally:
            watcher.disarm_escalation()
        saves.append(handle)
        if not handle.done:
            in_flight.append(handle)
        log.info("Saved checkpoint %s (blocked %.2f s%s)", path.name, handle.blocking_s,
                 "" if handle.done else ", writing in the background")
        meter.reset()
        sync_t0 = time.monotonic()
        return handle

    def evaluate(step):
        """Held-out eval, outside the throughput window and the watcher's
        iteration clock."""
        nonlocal sync_t0, sync_step
        if pending:
            close_window(step)
        t0 = time.monotonic()
        loss = run_eval(model)
        evals.append({"step": step, "loss": loss, "seconds": time.monotonic() - t0})
        log.info("eval | step %d | loss %.4f | %.2f s", step, loss, evals[-1]["seconds"])
        meter.reset()
        sync_t0, sync_step = time.monotonic(), step

    watcher.install_signal_handler()
    meter.reset()  # the first window starts here, after any resume
    try:
        loader.start()
        while step < config.training_steps:
            if config.profile and prof is None and step == config.profile_step_start:
                prof = _ProfileWindow(config, cuda, step)
            _, batch = next(loader)
            with prof.step(step + 1) if prof and not prof.path else contextlib.nullcontext():
                pending.append(step_fn(batch))
            step += 1
            rng = rng_fold_in(rng, 1)  # the JAX step's key advance
            if first_step_s is None:
                if cuda:
                    torch.cuda.synchronize(device)
                first_step_s = time.monotonic() - t_entry
            want_log = step % config.logging_frequency == 0 or step == config.training_steps
            if want_log or watcher.is_check_step(step):
                if want_log:
                    close_window(step)
                elif cuda:
                    torch.cuda.synchronize(device)
                now = time.monotonic()
                watcher.observe_iter((now - sync_t0) / (step - sync_step))
                sync_t0, sync_step = now, step
            if on_step is not None:
                on_step(step)
            if prof is not None and not prof.path and step == config.profile_step_end:
                prof.stop(step)
            if run_eval is not None and step % config.eval_frequency == 0:
                evaluate(step)
            if (config.checkpoint_frequency > 0 and step % config.checkpoint_frequency == 0
                    and step < config.training_steps):
                handle = save(step)
                if handle.done:
                    watcher.observe_ckpt(handle.blocking_s)
            if in_flight and in_flight[0].done:
                join_in_flight()  # learn its cost now, and raise a write error now
            if watcher.should_stop(step):
                save(step, final=True)
                stopped_early = True
                break
        if not stopped_early and config.checkpoint_frequency > 0:
            save(step, final=True)  # `latest` is always the end state
    finally:
        unwinding = sys.exc_info()[0] is not None
        loader.stop()
        if run_eval is not None:
            run_eval.loader.stop()
        if prof is not None and not prof.path:
            prof.stop(step)
        csv_logger.close()
        watcher.restore_signal_handlers()
        try:
            join_in_flight(_BG_JOIN_TIMEOUT_S)
        except Exception:
            if not unwinding:
                raise
            log.warning("an in-flight background checkpoint save also failed during "
                        "the error unwind")
    write_requeue_marker(exp_dir, done=not stopped_early, step=step)
    log.info("%s after step %d", "Stopped early (deadline/preemption)" if stopped_early
             else "Finished", step)

    summary = {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "losses": losses,
        "start_step": start_step,
        "end_step": step,
        "stopped_early": stopped_early,
        "first_step_s": first_step_s,
        "ckpt_load_s": load_s,
        "ckpt_precheck_s": precheck_s,
        "ckpt_save_s": sum(h.blocking_s for h in saves),
        "saves": [{"path": str(h.path), "blocking_s": h.blocking_s, "bytes": h.bytes,
                   "write_s": h.write_s} for h in saves],
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "csv": str(csv_logger.path) if csv_logger.path else None,
        "evals": evals,
        "eval_batches": run_eval.batches if run_eval is not None else 0,
        "remat": remat,
        "profile_trace": str(prof.path) if prof is not None and prof.path else None,
        "loader_stalls": loader.stall_count,
        "loader_stall_s": loader.stall_s,
    }
    # steady state: every logging window after the first (which carries the
    # first step's one-time costs), or the first when it is the only one
    steady = snaps[1:] or snaps
    summary["window_step_ms"] = [s["step_ms"] for s in snaps]
    seconds = sum(s["seconds"] for s in steady)
    steps = sum(s["steps"] for s in steady)
    if steps:
        tokens_per_sec = sum(s["tokens_per_sec"] * s["seconds"] for s in steady) / seconds
        summary.update(
            step_ms=1e3 * seconds / steps,
            tokens_per_sec=tokens_per_sec,
            tflops=meter.flop_per_token * tokens_per_sec / 1e12,
            mfu_pct=None if peak is None else 100.0 * meter.flop_per_token * tokens_per_sec / peak,
        )
    else:  # resumed at the last step: nothing trained
        summary.update(step_ms=None, tokens_per_sec=None, tflops=None, mfu_pct=None)
    return summary


def main(argv=None, on_step=None):
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(message)s")
    return train(get_args(argv), on_step=on_step)


if __name__ == "__main__":
    main()
