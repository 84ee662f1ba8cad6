"""Single-process training loop.

    python -m pyrecover_tpu_torch.train --model-dim 2048 --model-layers 20 \\
        --model-heads 16 --model-kv-heads 8 --vocab-size 32768 \\
        --sequence-length 2048 --batch-size 2 --attention-impl flash

Runs on the CUDA card unless ``--device cpu`` is given, and raises when
there is no card rather than falling back to the CPU. Trains the dense
Llama-style decoder on the deterministic synthetic dataset and logs loss,
tokens/s, step time, TFLOP/s and MFU every ``--logging-frequency`` steps
(and the per-step loss CSV with ``--log-loss-to-csv``). Checkpointing,
resume, preemption handling, telemetry and multi-device meshes are not
ported yet.
"""

import logging
from pathlib import Path

import torch

from pyrecover_tpu_torch.config import TrainConfig, get_args
from pyrecover_tpu_torch.data import StatefulSampler, SyntheticTextDataset, collate_clm
from pyrecover_tpu_torch.metrics import LossCSVLogger, ThroughputMeter
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.train_state import make_train_step
from pyrecover_tpu_torch.utils.perf import get_num_params, gpu_peak_flops

log = logging.getLogger("pyrecover_tpu_torch")


def resolve_device(name):
    """``cuda`` -> the current card, raising when there is none; ``cpu``."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the trainer runs on the card; pass --device cpu "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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


def batches(config, device):
    """The training batches, in the order the trainer takes them: collated
    from the synthetic dataset by the seeded sampler and moved to
    ``device``."""
    ds, pad_token_id = build_dataset(config)
    sampler = StatefulSampler(
        dataset_len=len(ds), global_batch_size=config.batch_size,
        seed=config.seed, num_samples=config.training_samples or None,
    )
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


def train(config: TrainConfig, on_step=None):
    """Train for ``config.training_steps`` steps. Returns a summary: the
    per-step losses and the steady-state step time, tokens/s, TFLOP/s, MFU
    (None off a known card) and peak device memory. ``on_step(step)``, if
    given, is called at the end of every step (after the step's logging
    sync when it has one), e.g. to advance a profiler's schedule."""
    device = resolve_device(config.device)
    cuda = device.type == "cuda"
    data = batches(config, device)
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
    exp_dir = Path(config.checkpoint_dir) / config.experiment_name
    csv_logger = LossCSVLogger(exp_dir, config.experiment_name,
                               enabled=config.log_loss_to_csv)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    losses, snaps, pending = [], [], []

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

    try:
        for step in range(1, config.training_steps + 1):
            pending.append(step_fn(next(data)))
            if step % config.logging_frequency == 0 or step == config.training_steps:
                close_window(step)
            if on_step is not None:
                on_step(step)
    finally:
        csv_logger.close()

    # steady state: every logging window after the first (which carries the
    # first step's one-time costs), or the first when it is the only one
    steady = snaps[1:] or snaps
    seconds = sum(s["seconds"] for s in steady)
    steps = sum(s["steps"] for s in steady)
    tokens_per_sec = sum(s["tokens_per_sec"] * s["seconds"] for s in steady) / seconds
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "losses": losses,
        "step_ms": 1e3 * seconds / steps,
        "tokens_per_sec": tokens_per_sec,
        "tflops": meter.flop_per_token * tokens_per_sec / 1e12,
        "mfu_pct": None if peak is None else 100.0 * meter.flop_per_token * tokens_per_sec / peak,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "csv": str(csv_logger.path) if csv_logger.path else None,
    }


def main(argv=None, on_step=None):
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(message)s")
    return train(get_args(argv), on_step=on_step)


if __name__ == "__main__":
    main()
