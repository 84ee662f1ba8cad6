"""Configuration: the ``TrainConfig`` fields this port uses, and its CLI.

Flags are spelled as in ``pyrecover_tpu.config.build_parser``, with its
defaults, so a JAX launch line's model, data, optimizer, remat, eval,
profile, checkpoint, time-aware and telemetry flags carry over. ``--device`` is the
port's own: entry points run on ``cuda`` unless it says ``cpu``.
``--fused-optimizer`` and ``--compile`` are accepted for parity and change
nothing. ``--moe-experts`` > 0 (with ``--moe-top-k``,
``--moe-capacity-factor`` and ``--moe-aux-weight``, JAX's defaults) makes
every FFN a Mixture-of-Experts layer (``models/moe.py``). Data parallelism:
``--distributed`` (a rendezvous is required),
``--dp`` (the data axis, one process per card), ``--grad-bucket-mb`` (DDP's
buckets at fp32, 0 syncs once after the backward; with a quantized wire,
the JAX step's bucket layout, one collective a bucket), ``--grad-allreduce
bf16|int8`` (the quantized gradient wire, with error feedback at int8, and
``--grad-quant-block`` elements a scale), ``--optimizer-sharding zero1``
(each rank holds and updates 1/dp of the AdamW moments), and
``--dist-backend``, the port's own setting: ``cuda:nccl,cpu:gloo`` on the
card and ``gloo`` on the CPU unless it is given (``gloo`` on the card runs
two ranks on one card, which NCCL refuses). ``--checkpoint-engine sharded``
(or ``--use-torch-distributed-ckpt``/``--sharded-checkpoint``) writes through
``torch.distributed.checkpoint``; ``--checkpoint-engine zerostall`` through
the zero-stall engine (``checkpoint/zerostall/``). ``--elastic-resume``
gates a resume onto another topology (``checkpoint/elastic.py``), and
``--checkpoint-frequency auto`` hands the save interval to the autopilot
(``resilience/autopilot.py``; ``--ckpt-auto-floor``, ``-ceiling``,
``-mtti-prior``, ``-window``). The model axes: ``--fsdp`` (ZeRO-3: each
rank holds 1/fsdp of every parameter, gradient and moment the rules split,
and its own rows of the batch), ``--tp`` (Megatron's column/row split of
attention and the FFN, the vocab projection over its columns) and ``--ep``
(each rank holds ``E / ep`` of every MoE block's experts; expert peers hold
the same rows, and a dense model is replicated over them, as in JAX), with
``--dp`` x ``--fsdp`` x ``--tp`` x ``--ep`` processes; they compose with
zero1 and raise, with JAX's wording, beside the quantized wire or buckets.
``--sp`` splits every row's columns over the sequence axis, attended
through ring attention (``--attention-impl ring``, which ``auto`` picks at
``--sp`` above 1, as JAX's); ``--pp`` splits the layers over pipeline
stages, run by ``--pp-schedule`` gpipe or 1f1b with ``--pp-microbatches``
(0: the stage count) and ``--pp-virtual-stages`` (interleaved 1F1B).
Both refuse the quantized wire and buckets, and 1F1B refuses gradient
accumulation, with JAX's words. The axes compose as JAX's do: an MoE model
over the sequence axis (routed by whole rows) or the pipeline (einsum
dispatch inside a stage), and the pipeline beside fsdp, tensor, expert,
sequence and ZeRO-1, each stage's blocks sharded over its own groups.
"""

import argparse
import dataclasses
from typing import Optional

from pyrecover_tpu_torch.models.llama import ModelConfig

_DTYPE_NAMES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32", "fp64": "float64"}


@dataclasses.dataclass
class TrainConfig:
    # -- data ----------------------------------------------------------------
    dataset: str = ""  # path to parquet with a 'text' column; "" -> synthetic
    tokenizer_name_or_path: str = "unsloth/Mistral-Nemo-Base-2407-bnb-4bit"
    # pack several documents per row (segment-masked attention) instead of
    # right-padding each one
    pack_sequences: bool = False
    # seconds without a batch before the loader raises LoaderStallError; 0 off
    loader_stall_timeout: float = 0.0
    sequence_length: int = 2048
    batch_size: int = 1  # global batch size
    training_samples: int = 0  # 0 -> batch_size * training_steps synthetic rows
    # -- optimization --------------------------------------------------------
    learning_rate: float = 1e-5
    lr_warmup_steps: int = 10
    lr_schedule: str = "constant"  # "constant" | "cosine"
    lr_min_ratio: float = 0.1
    grad_accumulation_steps: int = 1
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_max_norm: float = 1.0
    grad_clipping: bool = True
    loss_chunk_size: int = 0
    # -- data parallelism (pyrecover_tpu_torch/parallel) -----------------------
    distributed: bool = False  # require a rendezvous (hard-fail without one)
    dp: int = -1  # data axis; -1 = every process of the group
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    # bucket cap in MiB (DDP's at fp32, the JAX layout on a quantized wire);
    # 0 = one sync after the backward
    grad_bucket_mb: float = 0.0
    grad_allreduce: str = "fp32"  # fp32 | bf16 | int8 (the gradient wire format)
    grad_quant_block: int = 256  # int8 block size (one f32 scale per block)
    # pipeline flags, inert at --pp 1: microbatches (0 = the stage count),
    # the schedule (None = the model's) and interleaved 1F1B chunks
    pp_microbatches: int = 0
    pp_schedule: Optional[str] = None
    pp_virtual_stages: Optional[int] = None
    optimizer_sharding: str = "none"  # none | zero1 (1/dp of the moments on each rank)
    # the process group's backend; "" -> cuda:nccl,cpu:gloo on the card, gloo
    # on the CPU (the port's own setting: set only when asked)
    dist_backend: str = ""
    training_steps: int = 1000
    seed: int = 42
    # -- model ---------------------------------------------------------------
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    model_dtype: str = "bf16"  # compute dtype
    param_dtype: str = "fp32"  # master weights
    use_flash_attention: bool = False
    attention_impl: str = "auto"  # auto | sdpa | flash | ring
    remat: bool = False  # recompute blocks in the backward (model.remat_policy says how)
    # -- run -----------------------------------------------------------------
    device: str = "cuda"
    checkpoint_dir: str = "checkpoints/"  # <dir>/<experiment>/: checkpoints, markers, loss CSV
    experiment_name: str = "default-exp"
    logging_frequency: int = 5
    log_loss_to_csv: bool = False
    # -- telemetry (pyrecover_tpu_torch/telemetry) ----------------------------
    telemetry: bool = False  # the JSONL event stream (goodput, checkpoints, ...)
    telemetry_path: str = ""  # "" -> <ckpt_dir>/<exp>/<exp>_telemetry.jsonl
    telemetry_stdout: bool = False  # mirror events into the host-0 log
    metrics_flush_interval_s: float = 30.0  # between metrics_snapshot events
    # seconds of no progress (train loop, loader, checkpoint writer) before
    # hang_detected and a postmortem bundle (never a kill); 0 disables
    hang_watchdog_timeout: float = 0.0
    # synchronizing CUDA calls in the step's dispatch: off | log (warn) |
    # disallow (implicit_transfer event + ImplicitTransferError)
    transfer_guard: str = "off"
    # -- checkpointing -------------------------------------------------------
    checkpoint_frequency: int = 10  # save every k steps; < 1 disables
    # --checkpoint-frequency auto: the autopilot adapts the interval online
    # (Young-Daly from the measured save cost and the interruption history),
    # within [ckpt_auto_floor, ckpt_auto_ceiling]; checkpoint_frequency is
    # then the static baseline of its counterfactual
    checkpoint_auto: bool = False
    ckpt_auto_floor: int = 1
    ckpt_auto_ceiling: int = 500
    ckpt_auto_mtti_prior_s: float = 3600.0  # MTTI assumed while none was observed
    ckpt_auto_window: int = 8  # interruptions in the windowed MTTI estimate
    max_kept_checkpoints: int = 3
    resume_from_checkpoint: Optional[str] = None  # a path, or "latest"
    verify_checkpoints: bool = False
    async_checkpoint: bool = True  # periodic saves write in the background
    checkpoint_engine: str = "vanilla"  # vanilla | sharded | zerostall
    # a checkpoint saved on another topology: auto reshards it after the
    # elastic preflight, on runs the preflight on every candidate, off raises
    # TopologyMismatchError
    elastic_resume: str = "auto"
    # -- evaluation ----------------------------------------------------------
    eval_frequency: int = 0  # every k steps; 0 disables
    eval_samples: int = 64  # held-out samples per evaluation
    eval_dataset: str = ""  # parquet path; "" -> held-out synthetic split
    # -- profile window ------------------------------------------------------
    profile: bool = False
    profile_step_start: int = 10
    profile_step_end: int = 12
    profile_dir: str = "profiles/"
    # -- time-aware stop -----------------------------------------------------
    timeaware_checkpointing: bool = False
    default_iter_time: float = 1.0
    default_ckpt_time: float = 10.0
    job_end_time: Optional[float] = None  # unix seconds; else $JOB_END_TIME / SLURM_JOB_END_TIME
    preempt_check_interval: int = 5

    def __post_init__(self):
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda or cpu, got {self.device!r}")
        if self.transfer_guard not in ("off", "log", "disallow"):
            raise ValueError(
                f"--transfer-guard must be off, log or disallow, got {self.transfer_guard!r}")
        if self.checkpoint_engine not in ("vanilla", "sharded", "zerostall"):
            raise ValueError(f"unknown checkpoint engine {self.checkpoint_engine!r}")
        from pyrecover_tpu_torch.parallel.mesh import MeshConfig, default_backend

        MeshConfig(data=self.dp, fsdp=self.fsdp, tensor=self.tp, sequence=self.sp,
                   pipeline=self.pp, expert=self.ep)
        if self.optimizer_sharding not in ("none", "zero1"):
            raise ValueError(f"unknown --optimizer-sharding {self.optimizer_sharding!r} "
                             "(expected none or zero1)")
        if self.grad_allreduce not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown --grad-allreduce {self.grad_allreduce!r} "
                             "(expected fp32, bf16 or int8)")
        if self.grad_quant_block <= 0:
            raise ValueError(
                f"--grad-quant-block must be positive, got {self.grad_quant_block}")
        if self.pp_schedule not in (None, "gpipe", "1f1b"):
            raise ValueError(f"--pp-schedule {self.pp_schedule!r}: expected gpipe or 1f1b")
        if self.pp_virtual_stages is not None:
            if self.pp_virtual_stages < 1:
                raise ValueError(
                    f"--pp-virtual-stages must be >= 1, got {self.pp_virtual_stages}")
            if self.pp_virtual_stages > 1 and self.pp_schedule != "1f1b":
                raise ValueError("--pp-virtual-stages > 1 requires --pp-schedule 1f1b (the "
                                 "interleaved schedule is a 1F1B variant)")
        if self.grad_bucket_mb < 0:
            raise ValueError(f"--grad-bucket-mb must be >= 0, got {self.grad_bucket_mb}")
        if self.grad_allreduce != "fp32" or self.grad_bucket_mb > 0:
            # the JAX package's rules: the explicit sync does not nest in a
            # pipeline schedule's or the ring's own manual region, and it
            # syncs pure data-parallel replicas only
            lean = (f"--grad-allreduce {self.grad_allreduce}" if self.grad_allreduce != "fp32"
                    else "--grad-bucket-mb")
            if self.pp_schedule == "1f1b" or self.pp > 1:
                raise ValueError(f"{lean} does not compose with pipeline parallelism (the "
                                 "pipeline schedule runs its own manual region); drop it with "
                                 "--pp")
            if self.sp > 1:
                raise ValueError(f"{lean} does not compose with sequence parallelism (ring "
                                 "attention runs its own manual region); drop it with --sp")
            if self.fsdp > 1 or self.tp > 1 or self.ep > 1:
                raise ValueError(f"{lean} supports pure data-parallel replicas (+zero1) only; "
                                 "fsdp/tensor/expert axes already shard their own collectives "
                                 "— drop it with them")
        if self.elastic_resume not in ("auto", "on", "off"):
            raise ValueError(f"unknown --elastic-resume {self.elastic_resume!r}")
        if self.ckpt_auto_floor < 1:
            raise ValueError(f"--ckpt-auto-floor must be >= 1, got {self.ckpt_auto_floor}")
        if self.ckpt_auto_ceiling < self.ckpt_auto_floor:
            raise ValueError(f"--ckpt-auto-ceiling {self.ckpt_auto_ceiling} must be >= "
                             f"--ckpt-auto-floor {self.ckpt_auto_floor}")
        if self.ckpt_auto_mtti_prior_s <= 0:
            raise ValueError(
                f"--ckpt-auto-mtti-prior must be > 0, got {self.ckpt_auto_mtti_prior_s}")
        if self.ckpt_auto_window < 1:
            raise ValueError(f"--ckpt-auto-window must be >= 1, got {self.ckpt_auto_window}")
        if not self.dist_backend:
            self.dist_backend = default_backend(self.device)
        if self.attention_impl == "auto":
            if self.sp > 1:
                attn = "ring"
            elif self.use_flash_attention:
                attn = "flash"
            else:
                attn = self.model.attention_impl
        else:
            attn = self.attention_impl
        self._check_sp_pp(attn)
        if self.ep > 1 and self.model.n_experts > 0 and self.model.n_experts % self.ep:
            raise ValueError(f"--ep {self.ep} needs n_experts % ep == 0 (got E="
                             f"{self.model.n_experts}): each rank holds E / ep experts")
        if self.tp > 1:
            if self.model.n_heads % self.tp or self.model.n_kv_heads % self.tp:
                raise ValueError(
                    f"--tp {self.tp} must divide --model-heads {self.model.n_heads} and "
                    f"--model-kv-heads {self.model.n_kv_heads}: the heads split whole")
        self.model = dataclasses.replace(
            self.model,
            max_seq_len=self.sequence_length,
            compute_dtype=_DTYPE_NAMES.get(self.model_dtype, self.model_dtype),
            param_dtype=_DTYPE_NAMES.get(self.param_dtype, self.param_dtype),
            attention_impl=attn,
            remat=self.remat or self.model.remat,
            pp_microbatches=self.pp_microbatches or self.model.pp_microbatches,
            pp_schedule=(self.pp_schedule if self.pp_schedule is not None
                         else self.model.pp_schedule),
            pp_virtual_stages=(self.pp_virtual_stages if self.pp_virtual_stages is not None
                               else self.model.pp_virtual_stages),
        )

    def _check_sp_pp(self, attn):
        """The sequence axis attends over the whole row through the ring
        (JAX's ``--attention-impl ring``, which ``auto`` picks at sp > 1).
        JAX's other refusals over these axes stand where they are raised:
        the lean wire's (above) and 1F1B's with grad accumulation
        (``train_state.make_train_step``)."""
        if self.sp > 1 and attn != "ring":
            raise ValueError(f"--sp {self.sp} attends over the whole row through ring "
                             f"attention: --attention-impl must be ring or auto, got {attn}")


def _checkpoint_frequency_arg(value):
    """An int (every k steps; < 1 disables), or ``auto`` (the autopilot)."""
    return value if value == "auto" else int(value)


def build_parser():
    p = argparse.ArgumentParser(description="pyrecover_tpu_torch trainer")
    d = TrainConfig()
    # data
    p.add_argument("--dataset", type=str, default=d.dataset,
                   help="Parquet file (or glob, or directory of *.parquet) with a 'text' "
                        "column. Empty: deterministic synthetic data.")
    p.add_argument("--tokenizer-name-or-path", type=str, default=d.tokenizer_name_or_path,
                   help="Hugging Face tokenizer (a local directory works offline). Its vocab "
                        "size raises --vocab-size when larger.")
    p.add_argument("--pack-sequences", action="store_true",
                   help="Pack multiple documents per row (segment-masked "
                        "attention) instead of right-padding each one; "
                        "training-tokens %% becomes ~100.")
    p.add_argument("--loader-stall-timeout", type=float, default=d.loader_stall_timeout,
                   help="Seconds without a batch before the data loader raises "
                        "LoaderStallError instead of hanging the step loop. 0 disables "
                        "the watchdog.")
    p.add_argument("--sequence-length", type=int, default=d.sequence_length)
    p.add_argument("--batch-size", type=int, default=d.batch_size,
                   help="Global batch size.")
    p.add_argument("--training-samples", type=int, default=d.training_samples)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--lr-warmup-steps", type=int, default=d.lr_warmup_steps)
    p.add_argument("--lr-schedule", type=str, default=d.lr_schedule,
                   choices=["constant", "cosine"])
    p.add_argument("--lr-min-ratio", type=float, default=d.lr_min_ratio)
    p.add_argument("--grad-accumulation-steps", type=int,
                   default=d.grad_accumulation_steps)
    p.add_argument("--weight-decay", type=float, default=d.weight_decay)
    p.add_argument("--grad-max-norm", type=float, default=d.grad_max_norm)
    p.add_argument("--no-grad-clipping", action="store_true")
    p.add_argument("--loss-chunk-size", type=int, default=0,
                   help=">0: compute the CE loss in sequence chunks of this size.")
    p.add_argument("--training-steps", type=int, default=d.training_steps)
    p.add_argument("--seed", type=int, default=d.seed)
    # data parallelism
    p.add_argument("--distributed", action="store_true",
                   help="Require a rendezvous (torchrun's or SLURM's environment); hard-fail "
                        "if it is absent or fails (reference dist_utils.py:64-65).")
    p.add_argument("--dp", type=int, default=d.dp,
                   help="Data-parallel replicas, one process per card; -1 = all processes.")
    p.add_argument("--fsdp", type=int, default=d.fsdp,
                   help="ZeRO-3 ranks: each holds 1/fsdp of every parameter, gradient and "
                        "moment the rules split, gathered a block at a time, and its own "
                        "rows of the batch.")
    p.add_argument("--tp", type=int, default=d.tp,
                   help="Tensor-parallel ranks: Megatron's column/row split of attention "
                        "(whole heads) and the FFN, the vocab projection over its columns.")
    p.add_argument("--ep", type=int, default=d.ep,
                   help="Expert-parallel ranks: each holds E/ep of every MoE block's experts "
                        "and the same rows as its expert peers.")
    for flag, name, what in (
            ("--sp", "sp", "Sequence axis: every row's columns split over this many "
                           "processes, attended through ring attention."),
            ("--pp", "pp", "Pipeline axis: the layers split over this many stages.")):
        p.add_argument(flag, type=int, default=getattr(d, name), help=what)
    p.add_argument("--pp-microbatches", type=int, default=d.pp_microbatches,
                   help="Pipeline microbatch count; 0 = number of stages. Inert at --pp 1.")
    p.add_argument("--pp-schedule", type=str, default=d.pp_schedule, choices=["gpipe", "1f1b"],
                   help="Pipeline training schedule. Inert at --pp 1.")
    p.add_argument("--pp-virtual-stages", type=int, default=d.pp_virtual_stages,
                   help="Interleaved 1F1B: virtual layer chunks per stage (> 1 requires "
                        "--pp-schedule 1f1b). Inert at --pp 1.")
    p.add_argument("--grad-bucket-mb", type=float, default=d.grad_bucket_mb,
                   help="Gradient buckets of this many MiB: DDP's at fp32, all-reduced as "
                        "the backward finishes them; at bf16/int8 the JAX step's layout, one "
                        "quantized collective a bucket. 0 = one sync after the backward.")
    p.add_argument("--grad-allreduce", type=str, default=d.grad_allreduce,
                   choices=["fp32", "bf16", "int8"],
                   help="Gradient wire format: fp32 (DDP), or a two-leg quantized all-reduce "
                        "in bf16 or block-scaled int8 with error feedback.")
    p.add_argument("--grad-quant-block", type=int, default=d.grad_quant_block,
                   help="int8 quantization block size: one f32 scale per this many gradient "
                        "elements. Inert at --grad-allreduce fp32.")
    p.add_argument("--optimizer-sharding", type=str, default=d.optimizer_sharding,
                   choices=["none", "zero1"],
                   help="zero1: each rank holds and updates 1/dp of the AdamW moments.")
    # default "" (not d.dist_backend, which post_init resolved for the card)
    p.add_argument("--dist-backend", type=str, default="",
                   help="torch.distributed backend; default cuda:nccl,cpu:gloo on the card, "
                        "gloo on the CPU. gloo on the card runs several ranks on one card.")
    p.add_argument("--fused-optimizer", action="store_true",
                   help="Accepted for parity with the JAX trainer; does nothing in the "
                        "port (its AdamW is optax's arithmetic, unfused).")
    p.add_argument("--compile", action="store_true",
                   help="Accepted for parity with the JAX trainer; does nothing in the "
                        "port (the step runs eagerly; no torch.compile).")
    p.add_argument("--model-dtype", type=str, default=d.model_dtype)
    p.add_argument("--param-dtype", type=str, default=d.param_dtype)
    p.add_argument("--model-dim", type=int, default=d.model.dim)
    p.add_argument("--model-layers", type=int, default=d.model.n_layers)
    p.add_argument("--model-heads", type=int, default=d.model.n_heads)
    p.add_argument("--model-kv-heads", type=int, default=d.model.n_kv_heads)
    p.add_argument("--vocab-size", type=int, default=d.model.vocab_size,
                   help="Used with synthetic data; with a tokenizer, its vocab size wins "
                        "when larger.")
    p.add_argument("--moe-experts", type=int, default=d.model.n_experts,
                   help="MoE experts per FFN; 0 = dense (reference).")
    p.add_argument("--moe-top-k", type=int, default=d.model.moe_top_k)
    p.add_argument("--moe-capacity-factor", type=float, default=d.model.moe_capacity_factor)
    p.add_argument("--moe-aux-weight", type=float, default=d.model.moe_aux_weight,
                   help="Load-balance aux loss scale.")
    p.add_argument("--use_flash_attention", "--use-flash-attention",
                   dest="use_flash_attention", action="store_true")
    p.add_argument("--attention-impl", type=str, default=d.attention_impl,
                   choices=["auto", "sdpa", "flash", "ring"],
                   help="auto: ring at --sp above 1, else flash if --use_flash_attention, "
                        "else sdpa.")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize transformer blocks (trade FLOPs for device memory).")
    p.add_argument("--remat-policy", type=str, default=d.model.remat_policy,
                   choices=["full", "save-attn", "auto"],
                   help="With --remat: recompute each whole block in the backward "
                        "(the flash forward runs twice), or keep each block's attention "
                        "output and flash residuals and recompute only the projections, "
                        "norms and FFN. 'auto' sizes the policy (none/save-attn/full) "
                        "against the device memory model at startup (utils/remat.py; "
                        "overrides --remat).")
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or, for tests, the CPU.")
    p.add_argument("--checkpoint-dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--experiment_name", "--experiment-name", dest="experiment_name",
                   type=str, default=d.experiment_name)
    p.add_argument("--logging-frequency", type=int, default=d.logging_frequency)
    p.add_argument("--log-loss-to-csv", action="store_true")
    p.add_argument("--telemetry", action="store_true",
                   help="Emit a structured JSONL event stream (step timing, checkpoint "
                        "lifecycle, preemption, goodput summary); the JAX package's "
                        "tools/summarize_telemetry.py reads it.")
    p.add_argument("--telemetry-path", type=str, default=d.telemetry_path,
                   help="Telemetry JSONL path; default "
                        "<checkpoint-dir>/<experiment>/<experiment>_telemetry.jsonl.")
    p.add_argument("--telemetry-stdout", action="store_true",
                   help="Also mirror telemetry events into the host-0 log.")
    p.add_argument("--metrics-flush-interval", type=float, dest="metrics_flush_interval_s",
                   default=d.metrics_flush_interval_s,
                   help="Seconds between metrics_snapshot telemetry events.")
    p.add_argument("--hang-watchdog-timeout", type=float, dest="hang_watchdog_timeout",
                   default=d.hang_watchdog_timeout,
                   help="Seconds of no progress (train loop, loader, checkpoint writer) "
                        "before the run-health watchdog emits hang_detected and writes a "
                        "postmortem bundle (never kills the run). 0 disables.")
    p.add_argument("--transfer-guard", type=str, default=d.transfer_guard,
                   choices=["off", "log", "disallow"],
                   help="Synchronizing CUDA calls in the step's dispatch: log (a warning "
                        "each) or disallow (implicit_transfer event + typed error).")
    # checkpointing
    p.add_argument("--checkpoint-frequency", type=_checkpoint_frequency_arg,
                   default=d.checkpoint_frequency,
                   help="Save every k steps (< 1 disables), or 'auto': the autopilot "
                        "adapts the interval online to the Young-Daly optimum of the "
                        "measured save blocking cost and the interruption rate in the "
                        "failure-history sidecar (within --ckpt-auto-floor/-ceiling; each "
                        "decision a ckpt_policy event).")
    p.add_argument("--ckpt-auto-floor", type=int, default=d.ckpt_auto_floor,
                   help="autopilot: the least save interval in steps.")
    p.add_argument("--ckpt-auto-ceiling", type=int, default=d.ckpt_auto_ceiling,
                   help="autopilot: the largest save interval in steps (also the cadence "
                        "while no interruption has been observed).")
    p.add_argument("--ckpt-auto-mtti-prior", type=float, dest="ckpt_auto_mtti_prior_s",
                   default=d.ckpt_auto_mtti_prior_s,
                   help="autopilot: the MTTI (seconds) assumed while no interruption has "
                        "been observed.")
    p.add_argument("--ckpt-auto-window", type=int, default=d.ckpt_auto_window,
                   help="autopilot: recent interruptions in the windowed MTTI estimate.")
    p.add_argument("--resume-from-checkpoint", type=str, default=None,
                   help="A checkpoint path, or 'latest'.")
    p.add_argument("--verify-checkpoints", action="store_true")
    p.add_argument("--max-kept-checkpoints", type=int, default=d.max_kept_checkpoints)
    p.add_argument("--use-torch-distributed-ckpt", "--sharded-checkpoint",
                   dest="sharded_checkpoint", action="store_true",
                   help="Sharded checkpoints on torch.distributed.checkpoint.")
    p.add_argument("--checkpoint-engine", type=str, default=None,
                   choices=["vanilla", "sharded", "zerostall"],
                   help="vanilla (one PYRCKPT2 file, written by host 0), sharded "
                        "(torch.distributed.checkpoint) or zerostall (the snapshot moved to "
                        "pinned host buffers on a side stream, a content-addressed chunk "
                        "store, the in-RAM emergency tier). Default: sharded with "
                        "--sharded-checkpoint, else vanilla.")
    p.add_argument("--no-async-checkpoint", action="store_true")
    p.add_argument("--elastic-resume", type=str, default=d.elastic_resume,
                   choices=["auto", "on", "off"],
                   help="A checkpoint saved on another topology (--dp): auto reshards it "
                        "after the elastic preflight (SC11 infeasible, SC05 over the card's "
                        "memory) with the sampler rescaled; on runs the preflight on every "
                        "candidate; off raises TopologyMismatchError.")
    # evaluation
    p.add_argument("--eval-frequency", type=int, default=d.eval_frequency,
                   help="Evaluate on a held-out split every k steps (0 = off).")
    p.add_argument("--eval-samples", type=int, default=d.eval_samples)
    p.add_argument("--eval-dataset", type=str, default=d.eval_dataset,
                   help="Parquet file for eval; default holds out a "
                        "synthetic split (different seed from training).")
    # profile window
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler over the steps after step --profile-step-start "
                        "up to step --profile-step-end (trace under --profile-dir), "
                        "bracketed on the card by cudaProfilerStart/Stop (an nsys "
                        "capture range) with an NVTX range per step.")
    p.add_argument("--profile-step-start", type=int, default=d.profile_step_start)
    p.add_argument("--profile-step-end", type=int, default=d.profile_step_end)
    p.add_argument("--profile-dir", type=str, default=d.profile_dir)
    # time-aware stop
    p.add_argument("--timeaware-checkpointing", action="store_true")
    p.add_argument("--default-iter-time", type=float, default=d.default_iter_time)
    p.add_argument("--default-ckpt-time", type=float, default=d.default_ckpt_time)
    p.add_argument("--job-end-time", type=float, default=None,
                   help="Unix seconds; default from $JOB_END_TIME or $SLURM_JOB_END_TIME.")
    p.add_argument("--preempt-check-interval", type=int, default=d.preempt_check_interval,
                   help="Check the deadline every k-th step instead of every step.")
    return p


def get_args(argv=None):
    """Parse CLI args into a TrainConfig."""
    ns = build_parser().parse_args(argv)
    auto = ns.checkpoint_frequency == "auto"
    model = ModelConfig(
        dim=ns.model_dim, n_layers=ns.model_layers, n_heads=ns.model_heads,
        n_kv_heads=ns.model_kv_heads, vocab_size=ns.vocab_size,
        n_experts=ns.moe_experts, moe_top_k=ns.moe_top_k,
        moe_capacity_factor=ns.moe_capacity_factor, moe_aux_weight=ns.moe_aux_weight,
        remat_policy=ns.remat_policy,
    )
    return TrainConfig(
        dataset=ns.dataset,
        tokenizer_name_or_path=ns.tokenizer_name_or_path,
        pack_sequences=ns.pack_sequences,
        loader_stall_timeout=ns.loader_stall_timeout,
        sequence_length=ns.sequence_length,
        batch_size=ns.batch_size,
        training_samples=ns.training_samples,
        learning_rate=ns.learning_rate,
        lr_warmup_steps=ns.lr_warmup_steps,
        lr_schedule=ns.lr_schedule,
        lr_min_ratio=ns.lr_min_ratio,
        grad_accumulation_steps=ns.grad_accumulation_steps,
        weight_decay=ns.weight_decay,
        grad_max_norm=ns.grad_max_norm,
        grad_clipping=not ns.no_grad_clipping,
        loss_chunk_size=ns.loss_chunk_size,
        distributed=ns.distributed,
        dp=ns.dp, fsdp=ns.fsdp, tp=ns.tp, sp=ns.sp, pp=ns.pp, ep=ns.ep,
        grad_bucket_mb=ns.grad_bucket_mb,
        grad_allreduce=ns.grad_allreduce,
        grad_quant_block=ns.grad_quant_block,
        pp_microbatches=ns.pp_microbatches,
        pp_schedule=ns.pp_schedule,
        pp_virtual_stages=ns.pp_virtual_stages,
        optimizer_sharding=ns.optimizer_sharding,
        dist_backend=ns.dist_backend,
        elastic_resume=ns.elastic_resume,
        training_steps=ns.training_steps,
        seed=ns.seed,
        model=model,
        model_dtype=ns.model_dtype,
        param_dtype=ns.param_dtype,
        use_flash_attention=ns.use_flash_attention,
        attention_impl=ns.attention_impl,
        remat=ns.remat,
        device=ns.device,
        checkpoint_dir=ns.checkpoint_dir,
        experiment_name=ns.experiment_name,
        logging_frequency=ns.logging_frequency,
        log_loss_to_csv=ns.log_loss_to_csv,
        telemetry=ns.telemetry,
        telemetry_path=ns.telemetry_path,
        telemetry_stdout=ns.telemetry_stdout,
        metrics_flush_interval_s=ns.metrics_flush_interval_s,
        hang_watchdog_timeout=ns.hang_watchdog_timeout,
        transfer_guard=ns.transfer_guard,
        # auto keeps the numeric default as the static baseline
        checkpoint_frequency=TrainConfig.checkpoint_frequency if auto
        else ns.checkpoint_frequency,
        checkpoint_auto=auto,
        ckpt_auto_floor=ns.ckpt_auto_floor,
        ckpt_auto_ceiling=ns.ckpt_auto_ceiling,
        ckpt_auto_mtti_prior_s=ns.ckpt_auto_mtti_prior_s,
        ckpt_auto_window=ns.ckpt_auto_window,
        max_kept_checkpoints=ns.max_kept_checkpoints,
        resume_from_checkpoint=ns.resume_from_checkpoint,
        verify_checkpoints=ns.verify_checkpoints,
        async_checkpoint=not ns.no_async_checkpoint,
        checkpoint_engine=ns.checkpoint_engine
        or ("sharded" if ns.sharded_checkpoint else "vanilla"),
        eval_frequency=ns.eval_frequency,
        eval_samples=ns.eval_samples,
        eval_dataset=ns.eval_dataset,
        profile=ns.profile,
        profile_step_start=ns.profile_step_start,
        profile_step_end=ns.profile_step_end,
        profile_dir=ns.profile_dir,
        timeaware_checkpointing=ns.timeaware_checkpointing,
        default_iter_time=ns.default_iter_time,
        default_ckpt_time=ns.default_ckpt_time,
        job_end_time=ns.job_end_time,
        preempt_check_interval=ns.preempt_check_interval,
    )
