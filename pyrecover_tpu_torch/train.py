"""Training loop with checkpoints, resume, the time-aware stop, held-out
evaluation, rematerialization and a profile window, on one process or one
process per card of a data-parallel group.

    python -m pyrecover_tpu_torch.train --model-dim 2048 --model-layers 20 \\
        --model-heads 16 --model-kv-heads 8 --vocab-size 32768 \\
        --sequence-length 2048 --batch-size 2 --attention-impl flash

    torchrun --nproc-per-node 2 -m pyrecover_tpu_torch.train --distributed --dp 2 ...

With ``--distributed`` (or a ``torchrun``/SLURM environment naming more than
one process) the run joins a process group (``parallel/mesh.py``): NCCL on
the card with gloo beside it, gloo on the CPU, or ``--dist-backend``. Each
rank takes ``cuda:LOCAL_RANK``, collates its rows of every global batch and
runs the step under ``DistributedDataParallel`` with the loss over the
global batch's labels (``train_state.py``), or, with ``--grad-allreduce
bf16|int8``, through the quantized gradient wire with its error-feedback
residual; ``--optimizer-sharding zero1`` keeps 1/dp of the moments on each
rank (the ``grad_quantize`` and ``grad_bucket`` events record the set-up). Host 0 decides the resume's
candidate and the time-aware stop and broadcasts them; host 0 writes the
vanilla checkpoint, the markers, the loss CSV and the telemetry JSONL;
every rank writes its share of a sharded checkpoint
(``--checkpoint-engine sharded``, ``checkpoint/sharded.py``). A checkpoint
saved at another ``--dp`` resumes with the sampler rescaled
(``sampler_rescaled``). The process group is destroyed on every exit.

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
used.

``--telemetry`` writes the JAX package's JSONL event stream (``run_start``,
per-step ``step_time``, ``train_sync`` and ``throughput`` at the loop's
existing sync points, the checkpoint lifecycle, ``resume``, ``eval``, and
``run_summary`` with the goodput ledger on every exit); the flight recorder
is always installed and dumps a postmortem bundle on an unhandled
exception; ``--hang-watchdog-timeout`` starts the run-health watchdog after
the first step; ``--transfer-guard`` holds each step's dispatch to CUDA's
sync-debug mode; ``$PYRECOVER_FAULT_PLAN`` fires seeded faults at the
seams (``resilience/faults.py``). No instrumentation adds a device sync.

``--checkpoint-engine zerostall`` saves through the zero-stall engine: the
loop blocks only while the state is copied on the card, the copy reaches
pinned host memory on a side stream and a thread writes it into a
content-addressed chunk store; a ``latest`` resume in the same process
restores from its in-RAM emergency tier. ``--elastic-resume`` gates a
resume onto another topology with the elastic preflight, and
``--checkpoint-frequency auto`` lets the autopilot choose the save interval.
The fsdp, tensor, sequence, pipeline and expert axes are not ported.
"""

import contextlib
import dataclasses
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint import elastic, zerostall
from pyrecover_tpu_torch.checkpoint.elastic import TopologyMismatchError
from pyrecover_tpu_torch.checkpoint.registry import (
    checkpoint_path,
    engine_of,
    list_checkpoints,
    parse_step,
)
from pyrecover_tpu_torch.checkpoint.sharded import ShardedCheckpointer, precheck_ckpt_sharded
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    VanillaSaveHandle,
    load_ckpt_vanilla,
    precheck_ckpt_vanilla,
    save_ckpt_vanilla,
)
from pyrecover_tpu_torch.checkpoint.zerostall import (
    emergency,
    load_ckpt_zerostall,
    precheck_ckpt_zerostall,
    save_ckpt_zerostall,
)
from pyrecover_tpu_torch.config import TrainConfig, get_args
from pyrecover_tpu_torch.data import DataLoader, StatefulSampler, SyntheticTextDataset
from pyrecover_tpu_torch.metrics import LossCSVLogger, ThroughputMeter, WallTimeTotals
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.ops import flash_attention
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.parallel import mesh
from pyrecover_tpu_torch.parallel.mesh import (
    broadcast_host0_obj,
    broadcast_host0_scalar,
    initialize_distributed,
    sync_global_devices,
)
from pyrecover_tpu_torch.preempt import (
    PreemptionWatcher,
    read_requeue_marker,
    write_requeue_marker,
)
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.quarantine import quarantine_checkpoint
from pyrecover_tpu_torch.telemetry import detectors
from pyrecover_tpu_torch.train_state import (
    fit_residual,
    load_state_leaves,
    make_eval_step,
    make_train_step,
    restore_whole,
    rng_fold_in,
    rng_key,
    state_leaves,
    whole_leaves,
)
from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.logging import process_index
from pyrecover_tpu_torch.utils.perf import get_num_params, peak_flops_or_warn

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
    batch is collated while the device runs the current one. Under data
    parallelism each rank evaluates its rows of every batch and the two
    sums are all-reduced once per evaluation."""
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
        if mesh.world_size() > 1:
            sums = torch.stack([ce_sum.double(), n_tok.double()])
            torch.distributed.all_reduce(sums)
            ce_sum, n_tok = sums[0], sums[1]
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


# Every rank reads the checkpoint that host 0 chose and broadcast, so the
# meta it returns is the same everywhere.
# distcheck: congruent -- host 0's broadcast candidate, read by every rank
def _resume(config, exp_dir, leaves, sharded_ckptr, target_topology, device):  # jaxlint: sync-point
    """Restore ``config.resume_from_checkpoint`` into ``leaves`` (the state's
    `state_leaves`). Returns ``(meta, source, precheck seconds, plan)``:
    the checkpoint's meta (None when ``latest`` finds nothing), its path (or
    ``<emergency-ram>``) and, when the elastic gate resharded it, the plan.

    ``latest`` with the zerostall engine first asks the in-RAM emergency
    tier (``pyrecover_tpu/train.py:356-415``): host 0 checks that its record
    is at least as new as the newest manifest, on the live topology and
    digest-intact, and broadcasts the verdict; a rejected record is an
    ``emergency_restore_rejected`` event and the disk walk follows. The walk
    goes over every engine's checkpoints newest to oldest (``:419-640``):
    host 0 runs the elastic gate (``checkpoint/elastic.py``) and the
    integrity pre-check on each candidate and broadcasts one verdict, so
    every rank walks the same list and reads the same checkpoint:

      1 ok; 5 ok, resharded onto this topology (a ``reshard`` span and an
      ``elastic_resume`` event with the plan's accounting); 0 corrupt: it is
      quarantined into ``.corrupt/`` and the walk falls back; 3 the elastic
      preflight rejected it (``elastic_preflight_failed``): the walk falls
      back and the checkpoint, intact, stays; 2 a structure mismatch (the
      wrong model configuration) raises `CheckpointStructureError`; 4 another
      topology under ``--elastic-resume off`` raises `TopologyMismatchError`
      after a ``topology_mismatch`` event.

    In one process a load that fails is also quarantined
    (``ckpt_restore_fallback``) and the walk falls back. An explicitly named
    checkpoint raises on any failure, and so does a failed load across ranks
    (a rank cannot fall back alone). When every candidate fails the run
    refuses to start fresh: retention would then delete checkpoints that may
    still be recoverable."""
    target = config.resume_from_checkpoint
    explicit = target != "latest"
    host0 = process_index() == 0
    precheck_s = 0.0
    zerostall = config.checkpoint_engine == "zerostall"
    if explicit:
        candidates = [str(Path(target))]
    else:
        # host 0's listing is every rank's: the verdicts below are positional
        candidates = broadcast_host0_obj(
            [str(p) for p in list_checkpoints(exp_dir)[::-1]] if host0 else None)
        if zerostall:
            meta = _resume_from_ram(exp_dir, leaves, candidates, target_topology)
            if meta is not None:
                return meta, EMERGENCY_SOURCE, precheck_s, None
        if not candidates:
            log.info("No checkpoint found in %s; starting fresh", exp_dir)
            return None, None, precheck_s, None
    rejected = []
    for cand in map(Path, candidates):
        verdict = {"verdict": 1, "reason": "", "engine": None, "residual": None}
        plan = None
        fitted = leaves
        if host0:
            verdict["engine"] = engine_of(cand)
            # the int8 residual across a --grad-allreduce flip
            verdict["residual"] = elastic.saved_residual_shape(cand)
            fitted = fit_residual(leaves, verdict["residual"])
            t0 = time.monotonic()
            try:
                gate, reason, plan = elastic.resume_gate(
                    config.elastic_resume, cand, fitted, target_topology, device=device)
                verdict.update(verdict=_GATE_VERDICTS[gate], reason=reason)
                if verdict["verdict"] in (1, 5) and not explicit:
                    ok, why = _PRECHECKS[verdict["engine"]](
                        cand, verify=config.verify_checkpoints, target=fitted)
                    if not ok:
                        verdict.update(verdict=0, reason=why)
            # faultcheck: disable-next=recovery-swallow -- folded into host 0's
            # verdict, broadcast and re-raised on every rank just below
            except CheckpointStructureError as e:
                verdict.update(verdict=2, reason=str(e))
            precheck_s += time.monotonic() - t0
        verdict = broadcast_host0_obj(verdict)
        fitted = fit_residual(leaves, verdict["residual"])
        why = verdict["reason"]
        if verdict["verdict"] == 2:
            raise CheckpointStructureError(why)
        if verdict["verdict"] == 4:
            telemetry.emit("topology_mismatch", path=str(cand), reason=why,
                           elastic_resume=config.elastic_resume)
            raise TopologyMismatchError(path=cand, message=why)
        if verdict["verdict"] == 3:
            telemetry.emit("elastic_preflight_failed", path=str(cand), reason=why)
            if explicit:
                raise TopologyMismatchError(path=cand, detail=why)
            log.warning("Checkpoint %s cannot be resharded onto this topology (%s); falling "
                        "back to the previous one", cand, why)
            rejected.append(cand)  # intact: it fits again when the capacity returns
            continue
        if verdict["verdict"] == 0:
            log.warning("Checkpoint %s failed integrity pre-check (%s); falling back "
                        "to the previous one", cand, why)
            telemetry.emit("ckpt_precheck_failed", path=str(cand), reason=why)
            if host0:
                quarantine_checkpoint(cand, reason=why)
            continue
        # host 0's pre-check and quarantine are done before any rank reads
        sync_global_devices("resume_read")
        resharded = verdict["verdict"] == 5
        try:
            with (telemetry.span("reshard", path=str(cand), metric="reshard_s") if resharded
                  else contextlib.nullcontext()):
                meta = _load(verdict["engine"], cand, fitted, sharded_ckptr,
                             verify=config.verify_checkpoints and (explicit or not host0))
        except Exception as e:
            if explicit or isinstance(e, CheckpointStructureError) or mesh.world_size() > 1:
                raise
            log.warning("Checkpoint %s failed to restore (%s: %s); falling back to the "
                        "previous one", cand, type(e).__name__, e)
            telemetry.emit("ckpt_restore_fallback", path=str(cand),
                           reason=f"{type(e).__name__}: {e}")
            quarantine_checkpoint(cand, reason=f"{type(e).__name__}: {e}")
            continue
        log.info("Resumed from %s", cand)
        return meta, cand, precheck_s, plan if resharded else None
    detail = ""
    if rejected:
        detail = (f" ({len(rejected)} rejected by the elastic preflight for this topology: "
                  f"{', '.join(p.name for p in rejected[:4])} — they are intact and will "
                  "restore when matching capacity returns)")
    raise RuntimeError(
        f"every checkpoint in {exp_dir} failed to restore{detail}; refusing to start fresh "
        "over existing checkpoints — inspect them or move them aside"
    )


EMERGENCY_SOURCE = "<emergency-ram>"

# the elastic gate's verdict codes (the JAX package's)
_GATE_VERDICTS = {elastic.GATE_OK: 1, elastic.GATE_ELASTIC: 5, elastic.GATE_INFEASIBLE: 3,
                  elastic.GATE_MISMATCH: 4}


_PRECHECKS = {"vanilla": precheck_ckpt_vanilla, "sharded": precheck_ckpt_sharded,
              "zerostall": precheck_ckpt_zerostall}


def _load(engine, cand, leaves, sharded_ckptr, verify):
    """Read the checkpoint ``cand`` of ``engine`` into ``leaves``; returns
    its meta. Host 0's pre-check already checked a `latest` candidate's
    bytes; ``verify`` asks the others (and an explicit one) to check theirs.
    The sharded engine reads a rank's slice of a sharded leaf as it is; the
    others read the whole leaf and keep the rank's slice."""
    if engine == "sharded":
        return sharded_ckptr.restore(cand, leaves, verify=verify)
    if engine == "zerostall":  # every chunk read is verified
        return restore_whole(leaves, lambda whole: load_ckpt_zerostall(cand, whole))
    return restore_whole(leaves, lambda whole: load_ckpt_vanilla(cand, whole, verify=verify))


def _stalled_s(handle):
    """What a save stalled the train loop: its blocking window and, for a
    zerostall save, its wait for the save before (back-pressure)."""
    return handle.blocking_s + getattr(handle, "backpressure_s", 0.0)


# distcheck: congruent -- host 0's broadcast verdicts, followed by every rank
def _resume_from_ram(exp_dir, leaves, candidates, target_topology):  # jaxlint: sync-point
    """The emergency tier's turn in a zerostall ``latest`` resume: host 0's
    gate (a record at least as new as the newest manifest, on this topology,
    its digests intact), broadcast; then the restore into ``leaves`` on every
    rank. Returns the record's manifest, or None to walk the disk."""
    host0 = process_index() == 0
    use_ram = 0
    if host0:
        newest = parse_step(candidates[0]) if candidates else -1
        record = emergency.usable(exp_dir, target_topology, min_step=max(newest, 0))
        if record is not None:
            ok, reason = emergency.verify(record)
            if ok:
                use_ram = 1
            else:
                telemetry.emit("emergency_restore_rejected", reason=reason,
                               step=record["step"])
                log.warning("in-RAM emergency record rejected (%s); using the disk tier",
                            reason)
    if int(broadcast_host0_scalar(use_ram)) != 1:
        return None
    try:
        # host 0's gate verified the record's digests just now; a peer
        # checks the copy it received
        _, doc = restore_whole(leaves, lambda whole: emergency.restore(
            exp_dir, whole, verified=host0))
    except Exception as e:
        telemetry.emit("emergency_restore_rejected", reason=f"{type(e).__name__}: {e}",
                       step=-1)
        if mesh.world_size() > 1:
            raise  # every rank took the RAM path: none can fall back alone
        log.warning("emergency-tier restore failed (%s: %s); falling back to the disk tier",
                    type(e).__name__, e)
        return None
    return doc


def _elastic_accounting(plan, meta, cand, start_step):  # obscheck: once
    """After a resharded resume: the ``elastic_resume`` event with the plan's
    accounting and, when the replica count changed, ``sampler_rescaled``
    (its split proven by the plan's round trip; the global cursor, so the
    sample order, is kept: ``pyrecover_tpu/train.py:585-629``)."""
    from pyrecover_tpu_torch.data.sampler import rescale_sampler_state

    telemetry.emit("elastic_resume", path=str(cand), step=start_step,
                   saved_topology=plan.saved_topology, target_topology=plan.target_topology,
                   resharded_leaves=plan.resharded_leaves, plan_bytes_moved=plan.bytes_moved)
    sampler_meta = meta.get("sampler", {})
    saved = int(sampler_meta.get("replicas", 0) or 0)
    live = int(plan.sampler.get("target_replicas", 1))
    if saved and saved != live:
        rescale_sampler_state({k: v for k, v in sampler_meta.items()
                               if k not in ("consumed", "replicas")}, live)
        consumed = int(sampler_meta.get("consumed", start_step))
        log.info("Sampler rescaled from %d to %d replicas at %d consumed batches", saved,
                 live, consumed)
        telemetry.emit("sampler_rescaled", saved_replicas=saved, target_replicas=live,
                       consumed=consumed)


def _grad_sync_events(config, model, dp, step_fn):  # obscheck: once
    """The JAX trainer's records of the gradient sync, once a run
    (``pyrecover_tpu/train.py:1099-1166``): ``grad_bucket`` when
    ``--grad-bucket-mb`` is set (JAX's layout over the leaves; at fp32 the
    port's buckets are DDP's), ``grad_quantize`` when the wire is quantized
    or the moments are sharded (the modelled bytes a leg moves). Returns
    the summary's ``grad_sync`` record."""
    from pyrecover_tpu_torch.parallel.collectives import (
        param_leaf_order,
        resolve_bucket_layout,
        wire_bytes_per_element,
    )
    from pyrecover_tpu_torch.train_state import param_leaves

    leaves = param_leaves(model)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    grad_elems = sum(sizes)
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bpe = wire_bytes_per_element(config.grad_allreduce, config.grad_quant_block,
                                 elem_bytes=grad_bytes / max(grad_elems, 1))
    out = {"mode": config.grad_allreduce, "optimizer_sharding": config.optimizer_sharding,
           "data_replicas": dp, "grad_bytes_fp32": grad_bytes,
           "wire_bytes_per_leg": int(grad_elems * bpe), "buckets": 0}
    if config.grad_bucket_mb > 0:
        layout = resolve_bucket_layout(sizes, config.grad_bucket_mb, dp,
                                       config.grad_quant_block, order=param_leaf_order(model))
        bucket_bytes = [b.nbytes_f32 for b in layout] if layout else []
        out["buckets"] = len(bucket_bytes)
        telemetry.emit("grad_bucket", bucket_mb=float(config.grad_bucket_mb),
                       mode=config.grad_allreduce, buckets=len(bucket_bytes),
                       degenerate=layout is None, bucket_bytes_f32=bucket_bytes,
                       max_bucket_bytes=max(bucket_bytes, default=0),
                       min_bucket_bytes=min(bucket_bytes, default=0))
    if config.grad_allreduce != "fp32" or config.optimizer_sharding != "none":
        telemetry.emit("grad_quantize", mode=config.grad_allreduce,
                       optimizer_sharding=config.optimizer_sharding,
                       block=int(config.grad_quant_block), data_replicas=dp,
                       error_feedback=config.grad_allreduce == "int8",
                       grad_bytes_fp32=grad_bytes, wire_bytes_per_leg=out["wire_bytes_per_leg"])
    return out


def train(config: TrainConfig, on_step=None):
    """Train up to ``config.training_steps`` steps, resuming first when
    ``config.resume_from_checkpoint`` says so. Returns a summary: this run's
    per-step losses (CE), MoE aux losses (0 for a dense model) and
    ``grad_norms`` (of the synced, unclipped gradient); the steady-state step time, tokens/s, TFLOP/s, MFU
    (None off a known card) and peak device memory; ``start_step``,
    ``end_step``, ``stopped_early``; ``ckpt_load_s`` (the resume, pre-check
    included) and ``ckpt_precheck_s``, ``ckpt_save_s`` (what the saves stalled the loop, back-pressure
    included) and ``saves`` (each
    save's path, blocking seconds, bytes and write seconds);
    ``first_step_s``, from entry to the end of this run's first step;
    ``resumed_from`` (the checkpoint, ``<emergency-ram>`` or None) and
    ``shadow_steps`` (the steps that ran while a background save wrote);
    a zerostall save's entry also carries its ``report``;
    ``window_step_ms``, the step time of each logging window;
    ``evals`` (each evaluation's step, loss and seconds) and
    ``eval_batches``; ``remat`` (the policy run, and with ``auto`` its
    decision); ``profile_trace``; ``loader_stalls`` and ``loader_stall_s``
    (how often and how long the step waited on the loader); ``goodput``
    (`WallTimeTotals.as_dict`, the ``run_summary`` numbers) and
    ``telemetry_path`` (None without ``--telemetry``).
    ``on_step(step)``, if given, is called at the end of every step (after
    the step's logging sync when it has one), e.g. to advance a profiler's
    schedule.

    A thin shell around ``_train_impl`` that first joins the process group
    the environment names (``--distributed`` makes a missing or failed
    rendezvous fatal, ``pyrecover_tpu/train.py:667-669``), and then emits the
    ``run_summary`` event (goodput accounting) and tears down the run's
    telemetry sinks, its flight recorder and the process group it joined
    on EVERY exit: finished, stopped early, or raising. A raising run first
    dumps a postmortem bundle, here and not only in ``sys.excepthook``, so
    a caller that catches the error cannot swallow it."""
    joined = not mesh.is_distributed() and initialize_distributed(
        required=config.distributed, backend=config.dist_backend, device_type=config.device,
    ) is not None
    # host 0 logs the run; the other ranks only their warnings
    level = log.level
    if process_index() != 0:
        log.setLevel(max(level, logging.WARNING))
    try:
        return _train_outer(config, on_step)
    finally:
        log.setLevel(level)
        if joined:
            mesh.destroy_distributed()


def _flash_launches_since(start):
    """``{"flash_launches": ...}``, the flash kernels' launches since
    ``start`` (a `flash_attention.launch_counts`), for ``run_summary``; {}
    when none launched (always on the CPU, where the plain version runs)."""
    now = flash_attention.launch_counts()
    diff = {k: now[k] - start[k] for k in now}
    return {"flash_launches": diff} if any(diff.values()) else {}


def _train_outer(config, on_step):
    totals = WallTimeTotals()
    t_entry = time.monotonic()
    owned_sinks = []
    status = {"status": "error", "step": 0}
    launches0 = flash_attention.launch_counts()
    try:
        summary = _train_impl(config, totals, t_entry, owned_sinks, status, on_step)
        summary["goodput"] = totals.as_dict()
        return summary
    finally:
        totals.wall_s = time.monotonic() - t_entry
        exc = sys.exc_info()
        if exc[0] is not None and not issubclass(exc[0], (KeyboardInterrupt, SystemExit)):
            telemetry.flight.dump("unhandled_exception", exc=exc)
        # the final percentile snapshot first: the run_summary reader gets
        # goodput and the step-time / checkpoint-phase distributions together
        telemetry.metrics.flush(reason="run_end")
        telemetry.emit(
            "run_summary", status=status["status"], step=status["step"],
            **totals.as_dict(),
            # peak device memory against the card's (empty on the CPU)
            **detectors.hbm_run_summary(),
            **_flash_launches_since(launches0),
        )
        exporter = status.pop("exporter", None)
        if exporter is not None:
            try:
                exporter.stop()
            except TimeoutError as e:
                # teardown must not mask the run's own exit path; a wedged
                # exporter thread is a daemon and dies with the process
                log.warning("metrics exporter did not stop cleanly: %s", e)
        for sink in owned_sinks:
            telemetry.remove_sink(sink)
        telemetry.flight.uninstall()


def _train_impl(config, totals, t_entry, owned_sinks, status, on_step):
    ckpt_root = Path(config.checkpoint_dir)
    if ckpt_root.exists() and not ckpt_root.is_dir():
        raise NotADirectoryError(f"--checkpoint-dir {ckpt_root} exists and is not a directory")
    exp_dir = ckpt_root / config.experiment_name

    # ---- the flight recorder, before anything else, --telemetry or not ----
    # the in-memory ring and the black-box dump hooks: unhandled exceptions,
    # fatal signals, the SIGTERM escalation and the hang watchdog each
    # write a postmortem bundle under <exp_dir>/.postmortem/
    detectors.reset_hbm()
    telemetry.flight.install(exp_dir, config=dataclasses.asdict(config))

    # ---- sinks, and the previous attempt's high-water mark -----------------
    # prior_step: the highest step the previous attempt completed, from the
    # requeue/done marker and the telemetry JSONL (flushed per event, so it
    # survives a hard kill); steps resumed at or below it are replayed work
    prior_step = None
    telemetry_path = None
    resume_requested = bool(config.resume_from_checkpoint)
    if config.telemetry:
        telemetry_path = (Path(config.telemetry_path) if config.telemetry_path
                          else exp_dir / f"{config.experiment_name}_telemetry.jsonl")
    if resume_requested:
        marker = read_requeue_marker(exp_dir)
        if marker and marker.get("step") is not None:
            prior_step = int(marker["step"])
        if telemetry_path is not None:
            recorded = telemetry.last_recorded_step(telemetry_path)
            if recorded is not None:
                prior_step = max(prior_step or 0, recorded)
    if telemetry_path is not None:
        # one stream per experiment across resumes; a fresh run truncates
        owned_sinks.append(telemetry.add_sink(
            telemetry.JsonlSink(telemetry_path, append=resume_requested)))
    if config.telemetry_stdout:
        owned_sinks.append(telemetry.add_sink(telemetry.LogSink()))
    # the live-metrics endpoint ($PYRECOVER_METRICS_PORT): started after the
    # sinks so exporter_started lands in the stream, stopped (bounded join)
    # on the unwind. Its thread reads only the host-side registry.
    from pyrecover_tpu_torch.telemetry.exporter import maybe_start_from_env

    status["exporter"] = maybe_start_from_env()

    # cuda:LOCAL_RANK under a process group (initialize_distributed set it)
    device = resolve_device(config.device)
    cuda = device.type == "cuda"
    world = mesh.world_size()
    dp = mesh.MeshConfig(data=config.dp).resolve(world)
    host0 = process_index() == 0
    ds, pad_token_id, model_cfg = build_dataset(config)
    remat = {"policy": "none" if not model_cfg.remat else model_cfg.remat_policy,
             "decision": None}
    if model_cfg.remat_policy == "auto":
        from pyrecover_tpu_torch.utils.remat import resolve_remat_policy

        # this rank's rows of the global batch
        decision = resolve_remat_policy(
            model_cfg, batch_size=config.batch_size // dp, seq_len=config.sequence_length,
            loss_chunk_size=config.loss_chunk_size, device=device, data=dp,
            optimizer_sharding=config.optimizer_sharding,
            grad_allreduce=config.grad_allreduce, quant_block=config.grad_quant_block,
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
    optimizer, _ = build_optimizer(config, model.parameters(), model=model)
    # under a process group the fp32 step wraps the model in DDP; the
    # checkpoint leaves below are built from the model itself
    step_fn = make_train_step(
        model, optimizer, loss_chunk_size=config.loss_chunk_size,
        grad_accumulation_steps=config.grad_accumulation_steps,
        grad_bucket_mb=config.grad_bucket_mb, grad_allreduce=config.grad_allreduce,
        grad_quant_block=config.grad_quant_block,
    )
    residual = getattr(step_fn, "residual", None)  # the int8 error-feedback row
    if world > 1:
        if config.grad_allreduce != "fp32":
            how = (f"a {config.grad_allreduce} two-leg all-reduce "
                   + (f"a bucket ({len(step_fn.layout)} buckets)" if step_fn.layout
                      else "of the whole flat gradient"))
        elif config.grad_bucket_mb > 0:
            how = (f"DDP's buckets, {config.grad_bucket_mb:g} MiB each, all-reduced during "
                   "the backward")
        else:
            how = "one all-reduce after the backward"
        log.info("Gradient sync over %d replicas: %s; optimizer sharding %s", dp, how,
                 config.optimizer_sharding)
    engine = config.checkpoint_engine
    sharded = engine == "sharded"
    # every rank makes DCP's group here, at the same point; it also reads a
    # sharded checkpoint in a `latest` walk of a vanilla run
    sharded_ckptr = ShardedCheckpointer(use_async=config.async_checkpoint)
    n_params = get_num_params(model)
    device_kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    log.info("Model: %.2fM params on %s (rank %d of %d, %s) | %s", n_params / 1e6, device,
             process_index(), world, config.dist_backend if world > 1 else "one process",
             config.model)
    # obscheck: disable-next=hot-path-emit -- once per run, before the loop
    telemetry.emit(
        "run_start", devices=world, device_kind=device_kind, processes=world,
        mesh={"data": dp} if world > 1 else {},
        params_m=round(n_params / 1e6, 3), batch_size=config.batch_size,
        sequence_length=config.sequence_length,
        grad_accum_steps=config.grad_accumulation_steps,
        training_steps=config.training_steps, resume=resume_requested,
    )
    # loud platform_fallback when a card was expected and the run is on CPU
    detectors.check_expected_accelerator(device)
    grad_sync = _grad_sync_events(config, model, dp, step_fn)

    rng = rng_key(config.seed)
    start_step, load_s, precheck_s, resumed_from = 0, 0.0, 0.0, None
    if config.resume_from_checkpoint:
        t0 = time.monotonic()
        with telemetry.span("resume", metric="resume_s"):
            leaves = state_leaves(model, optimizer, rng=rng, residual=residual)
            meta, cand, precheck_s, plan = _resume(config, exp_dir, leaves, sharded_ckptr,
                                                   mesh.topology(dp), device)
            if meta is not None:
                saved_step, _, rng = load_state_leaves(leaves, optimizer)
                start_step = int(meta.get("step", saved_step))
                if plan is not None:
                    _elastic_accounting(plan, meta, cand, start_step)
                sampler.seek(meta.get("sampler", {}).get("consumed", start_step))
                totals.ckpt_load_s += time.monotonic() - t0
                resumed_from = str(cand)
                telemetry.emit("resume", path=resumed_from, step=start_step,
                               seconds=round(totals.ckpt_load_s, 4))
            del leaves
        load_s = time.monotonic() - t0
        log.info("Resume took %.2f s; training from step %d", load_s, start_step + 1)
    if start_step > 0 and prior_step is not None and prior_step > start_step:
        telemetry.emit("resume_replay", start_step=start_step, prior_step=prior_step,
                       replayed_steps=prior_step - start_step)
    else:
        prior_step = None  # nothing to replay
    # --checkpoint-frequency auto: the autopilot folds the prior attempts'
    # deaths from the telemetry stream into its sidecar and takes the first
    # decision; each decision is host 0's, broadcast (it gates the save
    # every rank takes part in)
    autopilot = next_save = None
    if config.checkpoint_auto:
        from pyrecover_tpu_torch.resilience.autopilot import CheckpointAutopilot

        autopilot = CheckpointAutopilot(
            exp_dir, engine=engine, static_interval=config.checkpoint_frequency,
            floor=config.ckpt_auto_floor, ceiling=config.ckpt_auto_ceiling,
            mtti_prior_s=config.ckpt_auto_mtti_prior_s, window=config.ckpt_auto_window,
            default_cost_s=config.default_ckpt_time, default_iter_s=config.default_iter_time,
        )
        next_save = start_step + autopilot.bootstrap(telemetry_path, step=start_step)
    loader = build_loader(config, ds, pad_token_id, sampler, device)
    run_eval = build_eval_runner(config, config.model, pad_token_id, device)
    # the loss CSV is host 0's (every rank logs the same global loss)
    csv_logger = LossCSVLogger(exp_dir, config.experiment_name,
                               enabled=config.log_loss_to_csv and host0, resume_step=start_step)
    watcher = PreemptionWatcher(
        enabled=config.timeaware_checkpointing,
        default_iter_time=config.default_iter_time,
        default_ckpt_time=config.default_ckpt_time,
        job_end_time=config.job_end_time,
        check_interval=config.preempt_check_interval,
    )
    if remat["decision"] is not None:
        d = remat["decision"]
        telemetry.emit(
            "remat_autosize", policy=d["policy"], fits=d["fits"],
            device_kind=d["device_kind"], budget_bytes=d["budget_bytes"],
            table_bytes=d["table"], batch_size=d["batch_size"],
            suggested_batch_size=d["suggested_batch_size"],
            suggested_total_bytes=d["suggested_total_bytes"],
        )
    # a signature drift of the step's batch is a re-specialization (a dynamo
    # recompile under torch.compile): one `recompile` event each
    step_fn = detectors.RecompileWatch(step_fn, name="train_step")
    peak = peak_flops_or_warn(device_kind)
    meter = ThroughputMeter(
        config.model, get_num_params(model, exclude_embedding=True),
        config.sequence_length, peak,
    )
    # the run-health watchdog: made now, STARTED after this run's first
    # completed step, which carries the nvcc build and the first launches
    hang_watchdog = (telemetry.watchdog.Watchdog(config.hang_watchdog_timeout)
                     if config.hang_watchdog_timeout > 0 else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    losses, moe_aux, grad_norms, snaps, pending, evals = [], [], [], [], [], []
    saves, in_flight = [], []
    shadow_steps = []  # steps that ran while a background save was writing
    prof = prof_span = None
    step, stopped_early, first_step_s = start_step, False, None
    # per-step (step, iter_t0, t_data, t_dispatch) stamps awaiting a sync
    # point: the step_time events and retroactive spans are written from it
    step_times = []
    interval_t0, steps_since_sync = time.monotonic(), 0

    def close_interval(now):  # jaxlint: sync-point
        """Charge the wall time since the last boundary to stepping (the
        goodput ledger: productive vs replayed) and write the buffered
        per-step telemetry: host-side work, no device sync. Called at sync
        points and before eval and saves, so their time never counts as
        stepping. Returns ``(interval seconds, steps in it)``."""
        nonlocal interval_t0, steps_since_sync
        dt, n = now - interval_t0, steps_since_sync
        if n > 0:
            totals.step_s += dt
            if prior_step is not None:
                replayed = min(prior_step, step) - (step - n)
                if replayed > 0:
                    totals.replayed_steps += replayed
                    totals.replayed_s += dt * replayed / n
        for s_, t0_, td_, tp_ in step_times:
            telemetry.emit("step_time", step=s_, data_wait_s=round(td_ - t0_, 6),
                           dispatch_s=round(tp_ - td_, 6))
            # retroactive spans from the buffered stamps: the loop never pays
            # the span I/O, the trace still shows data wait vs dispatch
            sid = telemetry.record_span("step", t0_, tp_, step=s_)
            telemetry.record_span("data_wait", t0_, td_, step=s_, parent=sid,
                                  metric="step_data_wait_s")
            telemetry.record_span("dispatch", td_, tp_, step=s_, parent=sid,
                                  metric="step_dispatch_s")
        step_times.clear()
        interval_t0, steps_since_sync = now, 0
        return dt, n

    def sync_point(step, want_log):  # jaxlint: sync-point
        """The deliberate sync: materialize the buffered per-step scalars,
        then account the interval and write its telemetry. Logs a window
        when ``want_log``."""
        t_sync0 = time.monotonic()
        for i, m in enumerate(pending):
            loss = m["loss"].item()
            losses.append(loss)
            moe_aux.append(m["moe_aux"].item())
            grad_norms.append(m["grad_norm"].item())
            csv_logger.log(step - len(pending) + i + 1, loss)
            meter.update(m["n_tokens"].item(), config.batch_size)
        if cuda:
            torch.cuda.synchronize(device)
        sync_s = time.monotonic() - t_sync0
        csv_logger.flush()
        snap = None
        if want_log:
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
            meter.reset()
        pending.clear()
        dt, n = close_interval(time.monotonic())
        if n:
            watcher.observe_iter(dt / n)
            if autopilot is not None:
                autopilot.observe_iter(dt / n, n=n, step=step)
        telemetry.record_span("loss_sync", t_sync0, t_sync0 + sync_s, step=step)
        if n:
            telemetry.metrics.histogram("step_iter_s").observe(dt / n, n=n)
        # device-memory gauges, flushed with the metrics_snapshot below; the
        # peak goes into run_summary
        detectors.sample_hbm(device)
        telemetry.metrics.maybe_flush(interval_s=config.metrics_flush_interval_s)
        telemetry.emit(
            "train_sync", step=step, loss=round(losses[-1], 6), steps=n,
            interval_s=round(dt, 6), iter_s=round(dt / max(n, 1), 6),
            sync_s=round(sync_s, 6), grad_accum_steps=config.grad_accumulation_steps,
        )
        # the live plane: the throughput event's numbers as gauges the
        # exporter serves between flushes (dict writes: no sync, no I/O)
        telemetry.metrics.gauge("train_step").set(step)
        if snap is not None:
            for key, gauge_name in (("tokens_per_sec", "train_tokens_per_sec"),
                                    ("mfu_pct", "train_mfu_pct"), ("tflops", "train_tflops")):
                v = snap.get(key)
                if isinstance(v, (int, float)):
                    telemetry.metrics.gauge(gauge_name).set(round(v, 4))
            telemetry.emit("throughput", step=step, **{
                k: round(v, 4) if isinstance(v, float) else v for k, v in snap.items()
            })

    def join_in_flight(timeout=None):
        """Join the background save, if any, with a ``ckpt_bg_join`` event. A
        final save is synchronous, so the watcher learns a background save's
        whole time, blocking and shadow, as what a final save costs."""
        while in_flight:
            handle = in_flight.pop()
            t0 = time.monotonic()
            try:
                handle.wait(timeout)
            finally:
                telemetry.emit(
                    "ckpt_bg_join", engine=engine, waited_s=round(time.monotonic() - t0, 4),
                    completed=bool(handle.done), ok=handle.error is None,
                    bounded=timeout is not None,
                )
                # background seconds the loop did not pay: recovered goodput
                totals.ckpt_shadow_s += handle.shadow_s
            # the whole save, blocking and writer: what a synchronous final
            # save will cost the time-aware stop
            watcher.observe_ckpt(handle.blocking_s + handle.write_s)

    def save(step, final=False):  # jaxlint: sync-point
        """Checkpoint the state after ``step``; returns its handle (a
        `VanillaSaveHandle`, `ShardedSaveHandle` or `ZerostallSaveHandle`).
        Host 0 writes a vanilla file or a zerostall snapshot (every rank
        holds the whole state; the others get a finished empty handle);
        every rank writes its share of a sharded one. A zerostall save first
        waits out the one in flight (``ckpt_backpressure``), apart from its
        blocking window. A final save ends at a barrier, so no rank leaves
        before the checkpoint is published. The caller closes the interval
        first, so the save's time stays out of stepping, the throughput
        window and the watcher's iteration time."""
        if pending:
            sync_point(step, want_log=True)
        path = checkpoint_path(config.checkpoint_dir, config.experiment_name, step,
                               final=final, engine=engine)
        bpe = sampler.batches_per_epoch
        epoch = step // bpe if bpe else 0
        # the batches the step consumed, not the prefetcher's live cursor
        sampler_meta = {"consumed": step, "replicas": dp, **sampler.state_dict_at(step)}
        extra_meta = {"step": step, "epoch": epoch, "topology": mesh.topology(dp)}
        background = config.async_checkpoint and not final
        # a second signal while this save runs writes the marker and exits
        watcher.arm_escalation(exp_dir, step)
        save_span = telemetry.spans.begin("ckpt_save", step=int(step), final=bool(final),
                                          engine=engine)
        try:
            # the wait for the save in flight: a zerostall save's is its
            # back-pressure (an event and the handle's backpressure_s)
            waited = zerostall.backpressure(exp_dir, path) if engine == "zerostall" else 0.0
            join_in_flight()  # one background write at a time
            leaves = state_leaves(model, optimizer, step, epoch, rng, residual=residual)
            if not sharded and any(leaf.shard is not None for leaf in leaves):
                # ZeRO-1 moments, the residual's rows: every rank sends its
                # slice, host 0 writes the whole leaves
                leaves = whole_leaves(leaves)
            if engine == "zerostall":
                handle = save_ckpt_zerostall(
                    path, leaves, sampler_meta, max_keep=config.max_kept_checkpoints,
                    extra_meta=extra_meta, background=background)
                handle.backpressure_s += waited
            elif sharded:
                handle = sharded_ckptr.save(
                    path, leaves, sampler_meta, max_keep=config.max_kept_checkpoints,
                    extra_meta=extra_meta, background=background)
            elif host0:
                handle = save_ckpt_vanilla(
                    path, leaves, sampler_meta, verify=config.verify_checkpoints,
                    max_keep=config.max_kept_checkpoints, extra_meta=extra_meta,
                    background=background,
                )
            else:
                handle = VanillaSaveHandle(path)
            del leaves
            if final:
                sync_global_devices("ckpt_final")
        except BaseException as e:
            save_span.end(ok=False, error=f"{type(e).__name__}: {e}")
            raise
        finally:
            watcher.disarm_escalation()
        save_span.end()
        saves.append(handle)
        if not handle.done:
            in_flight.append(handle)
        # the loop's stall under its honest name (a zerostall save's wait for
        # the one before included); the histogram feeds the
        # metrics_snapshot percentiles
        stalled = _stalled_s(handle)
        totals.ckpt_save_s += stalled
        totals.ckpt_blocking_s += stalled
        telemetry.metrics.histogram("ckpt_blocking_s").observe(stalled)
        log.info("Saved checkpoint %s (blocked %.2f s%s)", path.name, handle.blocking_s,
                 "" if handle.done else ", writing in the background")
        telemetry.emit("ckpt_saved", step=int(step), path=path.name, final=bool(final),
                       engine=engine, blocking_s=round(handle.blocking_s, 4))
        meter.reset()
        return handle

    def evaluate(step):  # jaxlint: sync-point
        """Held-out eval, outside stepping, the throughput window and the
        watcher's iteration clock."""
        nonlocal interval_t0
        if pending:
            sync_point(step, want_log=True)
        close_interval(time.monotonic())
        t0 = time.monotonic()
        with telemetry.span("eval", step=step, metric="eval_s"):
            loss = run_eval(model)
        seconds = time.monotonic() - t0
        totals.eval_s += seconds
        evals.append({"step": step, "loss": loss, "seconds": seconds})
        log.info("eval | step %d | loss %.4f | %.2f s", step, loss, seconds)
        telemetry.emit("eval", step=step, loss=round(loss, 6), seconds=round(seconds, 4))
        meter.reset()
        interval_t0 = time.monotonic()

    watcher.install_signal_handler()
    train_t0 = time.monotonic()
    # pre-loop set-up (model init, the resume's bookkeeping): part of the
    # restart tax; the checkpoint load is its own bucket
    totals.setup_s = max(train_t0 - t_entry - totals.ckpt_load_s, 0.0)
    meter.reset()  # the first window starts here, after any resume
    interval_t0 = time.monotonic()
    try:
        loader.start()
        while step < config.training_steps:
            if config.profile and prof is None and step == config.profile_step_start:
                # a span over the whole window, so the JSONL and the
                # profile correlate on one timeline
                prof_span = telemetry.spans.begin("profile", dir=str(config.profile_dir),
                                                  start_step=step)
                prof = _ProfileWindow(config, cuda, step)
            # fault seam: `sigterm_at_step N` delivers its signal as step N
            # begins, so the final checkpoint lands exactly at N
            faults.check("train_step", step=step + 1)
            iter_t0 = time.monotonic()
            _, batch = next(loader)
            t_data = time.monotonic()
            # --transfer-guard holds the dispatch of every step after the
            # first (which carries the build and the allocator's warm-up)
            guard = (detectors.transfer_watch(step=step + 1, device=device,
                                              warn=config.transfer_guard == "log")
                     if config.transfer_guard != "off" and first_step_s is not None
                     else contextlib.nullcontext())
            with prof.step(step + 1) if prof and not prof.path else contextlib.nullcontext():
                with guard:
                    pending.append(step_fn(batch))
            t_dispatch = time.monotonic()
            step += 1
            steps_since_sync += 1
            rng = rng_fold_in(rng, 1)  # the JAX step's key advance
            if hang_watchdog is not None:
                hang_watchdog.beat("train_loop")
            if telemetry.enabled():
                # host stamps only: dispatch_s is the enqueue cost, not
                # device time (that is the sync interval's average)
                step_times.append((step, iter_t0, t_data, t_dispatch))
            if first_step_s is None:
                if cuda:
                    torch.cuda.synchronize(device)
                first_step_s = time.monotonic() - t_entry
            if hang_watchdog is not None and not hang_watchdog.started:
                hang_watchdog.start()  # the first step is done: the build is over
            want_log = step % config.logging_frequency == 0 or step == config.training_steps
            if want_log or watcher.is_check_step(step):
                sync_point(step, want_log)
            if on_step is not None:
                on_step(step)
            if prof is not None and not prof.path and step == config.profile_step_end:
                prof.stop(step)
                prof_span.end()
            if run_eval is not None and step % config.eval_frequency == 0:
                evaluate(step)
            if in_flight and not in_flight[0].done:
                shadow_steps.append(step)  # this step ran beside a save's writer
            # with the autopilot the interval is re-decided after every save
            # from the measured blocking cost and the failure model
            if autopilot is not None:
                due = step >= next_save
            else:
                due = config.checkpoint_frequency > 0 and step % config.checkpoint_frequency == 0
            if due and step < config.training_steps:
                close_interval(time.monotonic())
                handle = save(step)
                if handle.done:
                    watcher.observe_ckpt(handle.blocking_s)
                if autopilot is not None:
                    # the steady cost: a run's first zerostall save also
                    # pins the buffer sets (alloc_s), once per process
                    autopilot.observe_save(handle.blocking_s - getattr(handle, "alloc_s", 0.0))
                    next_save = step + autopilot.decide(step, source="post_save")
                interval_t0 = time.monotonic()
            if in_flight and in_flight[0].done:
                join_in_flight()  # learn its cost now, and raise a write error now
            if watcher.should_stop(step):
                close_interval(time.monotonic())
                save(step, final=True)
                stopped_early = True
                break
        close_interval(time.monotonic())  # the tail since the last sync
        totals.train_s = time.monotonic() - train_t0
        # `latest` is always the end state; the autopilot never disables saves
        if not stopped_early and (config.checkpoint_frequency > 0 or autopilot is not None):
            save(step, final=True)
    finally:
        status["step"] = step  # a crashed run still reports how far it got
        unwinding = sys.exc_info()[0] is not None
        if hang_watchdog is not None:
            hang_watchdog.stop()
        detectors.sample_hbm(device)  # the final peak sample for run_summary
        loader.stop()
        if run_eval is not None:
            run_eval.loader.stop()
        if prof is not None and not prof.path:
            prof.stop(step)
            prof_span.end()
        csv_logger.close()
        watcher.restore_signal_handlers()
        try:
            join_in_flight(_BG_JOIN_TIMEOUT_S)
        except Exception:
            if not unwinding:
                raise
            log.warning("an in-flight background checkpoint save also failed during "
                        "the error unwind")
        finally:
            # the zerostall buffer sets (the one the emergency record holds
            # stays with the record)
            zerostall.release(exp_dir)
    write_requeue_marker(exp_dir, done=not stopped_early, step=step)
    status["status"] = "stopped_early" if stopped_early else "finished"
    totals.wall_s = time.monotonic() - t_entry
    log.info("%s after step %d | %s", "Stopped early (deadline/preemption)" if stopped_early
             else "Finished", step, totals.summary())

    summary = {
        "device": device_kind,
        "losses": losses,
        "moe_aux": moe_aux,
        "grad_norms": grad_norms,
        "start_step": start_step,
        "end_step": step,
        "stopped_early": stopped_early,
        "first_step_s": first_step_s,
        "ckpt_load_s": load_s,
        "ckpt_precheck_s": precheck_s,
        "ckpt_save_s": sum(_stalled_s(h) for h in saves),
        "saves": [{"path": str(h.path), "blocking_s": h.blocking_s, "bytes": h.bytes,
                   "write_s": h.write_s, **getattr(h, "report", {})} for h in saves],
        "shadow_steps": shadow_steps,
        "resumed_from": resumed_from,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "csv": str(csv_logger.path) if csv_logger.path else None,
        "evals": evals,
        "eval_batches": run_eval.batches if run_eval is not None else 0,
        "remat": remat,
        "profile_trace": str(prof.path) if prof is not None and prof.path else None,
        "loader_stalls": loader.stall_count,
        "loader_stall_s": loader.stall_s,
        "telemetry_path": str(telemetry_path) if telemetry_path is not None else None,
        "grad_sync": {**grad_sync, "residual_absmax": (
            float(residual.row.abs().max()) if residual is not None else None)},
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
