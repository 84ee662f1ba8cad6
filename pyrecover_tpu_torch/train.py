"""Single-process training loop with checkpoints, resume and the time-aware
stop.

    python -m pyrecover_tpu_torch.train --model-dim 2048 --model-layers 20 \\
        --model-heads 16 --model-kv-heads 8 --vocab-size 32768 \\
        --sequence-length 2048 --batch-size 2 --attention-impl flash

Runs on the CUDA card unless ``--device cpu`` is given, and raises when
there is no card rather than falling back to the CPU. Trains the dense
Llama-style decoder on the deterministic synthetic dataset and logs loss,
tokens/s, step time, TFLOP/s and MFU every ``--logging-frequency`` steps
(and the per-step loss CSV with ``--log-loss-to-csv``).

Checkpoints are the JAX package's vanilla ``PYRCKPT2`` files in
``<checkpoint-dir>/<experiment>/``, readable by either package: one every
``--checkpoint-frequency`` steps (written in the background unless
``--no-async-checkpoint``) and ``ckpt_<step>_final`` at the end. With
``--timeaware-checkpointing`` the run stops early, with a ``_final``
checkpoint, when the job's deadline comes near or a preemption notice
arrives (SIGTERM, SIGUSR1, ``$PYRECOVER_PREEMPT_FILE``), and leaves a
``REQUEUE`` marker (``DONE`` when it finished). ``--resume-from-checkpoint
latest`` continues from the newest intact checkpoint exactly as if the run
had never stopped; a corrupt newest file is moved into ``.corrupt/`` and the
one before it is used. Telemetry, the sharded, zerostall and elastic
checkpoint engines and multi-device meshes are not ported.
"""

import logging
import sys
import time
from pathlib import Path

import torch

from pyrecover_tpu_torch.checkpoint.registry import checkpoint_path, list_checkpoints
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    load_ckpt_vanilla,
    precheck_ckpt_vanilla,
    save_ckpt_vanilla,
)
from pyrecover_tpu_torch.config import TrainConfig, get_args
from pyrecover_tpu_torch.data import StatefulSampler, SyntheticTextDataset, collate_clm
from pyrecover_tpu_torch.metrics import LossCSVLogger, ThroughputMeter
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.preempt import PreemptionWatcher, write_requeue_marker
from pyrecover_tpu_torch.resilience.quarantine import quarantine_checkpoint
from pyrecover_tpu_torch.train_state import (
    load_state_leaves,
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
    """The synthetic dataset and its pad token id."""
    n = config.training_samples or max(
        config.batch_size * config.training_steps, config.batch_size
    )
    ds = SyntheticTextDataset(
        num_samples=n, seq_len=config.sequence_length,
        vocab_size=config.model.vocab_size, seed=config.seed,
    )
    return ds, 0


def build_model(config, device):
    """The model at its seeded initial weights, on ``device``."""
    generator = torch.Generator(device=device).manual_seed(config.seed)
    return Transformer(config.model, device=device, generator=generator)


def build_sampler(config, dataset_len):
    return StatefulSampler(
        dataset_len=dataset_len, global_batch_size=config.batch_size,
        seed=config.seed, num_samples=config.training_samples or None,
    )


def batches(config, device, sampler=None):
    """The training batches, in the order the trainer takes them: collated
    from the synthetic dataset by ``sampler`` (a fresh seeded one by
    default) and moved to ``device``."""
    ds, pad_token_id = build_dataset(config)
    if sampler is None:
        sampler = build_sampler(config, len(ds))
    while True:
        yield to_device(
            collate_clm([ds[i] for i in sampler.next_batch()], pad_token_id), device
        )


def to_device(batch, device):
    """Collated numpy batch -> tensors on ``device`` (token ids as int64)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["inputs"] = out["inputs"].long()
    out["labels"] = out["labels"].long()
    return out


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
    ``first_step_s``, from entry to the end of this run's first step.
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
    ds, _ = build_dataset(config)
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
    data = batches(config, device, sampler)
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

    losses, snaps, pending = [], [], []
    saves, in_flight = [], []
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
        sampler_meta = {"consumed": step, "replicas": 1, **sampler.state_dict()}
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

    watcher.install_signal_handler()
    meter.reset()  # the first window starts here, after any resume
    try:
        while step < config.training_steps:
            pending.append(step_fn(next(data)))
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
    }
    # steady state: every logging window after the first (which carries the
    # first step's one-time costs), or the first when it is the only one
    steady = snaps[1:] or snaps
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
