"""Drive the PyTorch/H100 port once on the card and check it.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also device time by kernel
    python3 chip_smoke.py --trainer ARGS...   # one trainer run (the checkpoint
                                              # phase's subprocess)
    python3 chip_smoke.py --trainer-phase     # the trainer phase alone (item 6,
                                              # run as a subprocess)
    python3 chip_smoke.py --emergency-child ARGS...  # phase E's process (item 12)
    python3 chip_smoke.py --fleet-phase       # the fleet phase alone (item 15;
                                              # no kernel build, ~100 s)
    python3 chip_smoke.py --dp-cards 4        # only the dp phase across 4 cards
                                              # (item 11; not part of the whole check)
    python3 chip_smoke.py --time-phases DIR PHASE...  # only the named phase
                                              # functions of DIR's chip_smoke.py (a
                                              # checkout: this one, or its parent's
                                              # to compare in one call), timed

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the flash-attention kernels from ``pyrecover_tpu_torch/csrc``
   with nvcc and, beside them, the host checkpoint-I/O library from
   ``pyrecover_tpu_torch/native`` with g++; fails if either does not load.
3. Kernel phase: runs the forward, dq and dk/dv kernels against their plain
   PyTorch versions on the same inputs, at the llama-1b training shape, at
   llama-8b's attention (GQA group 4), and at smaller ragged / segmented /
   multi-batch / s != sk / non-causal / fp32 shapes that reach both the
   tensor-core (bf16, d 64 and 128) and the FMA instances at their tile
   edges, at head dims 80 and 96 (zero-padded by the wrapper to the d 128
   instance, held at the true d), 160 (zero-padded to d 256) and 256 (the
   FMA d 256 instance, Gemma's head dim), and times each kernel, its plain
   version and ``F.scaled_dot_product_attention`` at the training shape and
   the d 256 instance at b 1, s 2048, hq 8, hkv 2 (bf16 and fp32, with its
   ptxas registers and spill, under ``instances`` on the ``kernels`` line),
   and d 320 and 512 (the head-dim-chunked instances, d 320 zero-padded to
   384) at the same shape, each a row of its own on the ``kernels`` line
   with the SDPA backend that runs there and, as every row, the SDPA
   backward's time and autograd node. Times are the card's (`cuda_time_ms`).
   A row's ``route`` is ``cuda``; the instance the dispatch ran is under
   ``instance``, and its ``launches`` are the train line's, counted by the
   wrapper (the chunked rows by the chunked counters). Each output is held
   element by element and by its relative norm, and each error is printed
   beside its limit.
4. Train phase: ``pyrecover_tpu_torch.train.main`` trains llama-1b at full
   width with flash attention on synthetic data, fed by its prefetching
   ``DataLoader``, for a few steps; every loss
   must be finite, each kernel must have launched once per layer per step,
   and every forward, dq and dk/dv launch must have gone to a tensor-core
   instance. It runs with ``--telemetry`` and the hang watchdog: its JSONL
   must hold ``run_start``, one ``step_time`` a step and a last
   ``run_summary`` with ``goodput_pct`` and ``hbm_peak_pct``, and no
   ``hang_detected``. Then the same line with telemetry off and on again,
   and two profiled steps of each, give the step time and device idle share
   with telemetry on and off (``telemetry_cost`` line); and three steps after the
   first under ``--transfer-guard disallow`` must raise no
   ``implicit_transfer`` (``transfer_guard`` line).
5. Attention check in the model: from the trainer's initial weights and
   first batch, flash against ``sdpa``. With bf16 compute the step-1
   losses must agree, and flash's must equal the trainer's first loss;
   layer 0's and the last layer's real q, k, v (after RoPE) and incoming
   dout are captured, and the forward, dq and dk/dv kernels are held to
   their plain versions on them. With fp32 compute the losses and every layer's
   wq/wk/wv/wo gradient must agree.
6. Trainer phase, in its own process under deterministic algorithms, at
   llama-1b's full width and depth: 6 steps each without remat, with
   ``--remat-policy save-attn`` and with ``full`` from the same seed and
   data (losses against the run without remat, expected bit-equal; peak
   memory and step time; flash forward launches = layers x steps, twice
   that under ``full``, dq and dk/dv layers x steps) and ``auto``'s
   decision on this card; packed rows (documents of 64-1536 tokens ending
   in EOS, a pad tail in ``PAD_SEGMENT`` on the last row) through the
   ``DataLoader``: flash against sdpa inside the model and the three
   kernels against their plain versions on real activations, with the
   segment ids, then 3 timed steps; the eval loss with flash against sdpa
   on the same weights; a 4-step trainer run with ``--eval-frequency 2``
   and the profile window over step 3, whose trace must name the three
   kernels. Prints one ``trainer`` line.
7. Checkpoint phase: three trainer processes at llama-1b's full width and
   ``CKPT_LAYERS`` deep (cut from 20 in PR 8) with flash attention, deterministic algorithms, verified
   checkpoints and one checkpoint kept. A trains 4 steps straight. B1 runs
   with a deadline already inside the time-aware stop's buffer and must stop
   early with ``ckpt_<k>_final.ckpt`` and ``REQUEUE``; B2 resumes from
   ``latest`` and must finish at step 4 with ``DONE``. B2's final checkpoint
   must equal A's byte for byte (their sidecar digests), its loss CSV must
   hold one row per step, equal to A's, every flash launch in B2 must go
   to a tensor-core instance, and both sidecars must be ``xxh64tree:``
   (the native library's, hashed in the write pass). Prints the
   checkpoint's bytes, each save's blocking seconds and write rate, the
   resume's pre-check and load seconds, and how much of the loaded file
   was in the page cache. The three runs write telemetry: each stream is
   whole (as the train line's), each ``ckpt_commit``'s bytes are the file's
   size, B1 has ``preempt_stop`` and B2 ``resume``, and the port's doctor
   says healthy / preemption / healthy for A / B1 / B2. A's final file, its
   leaves' content addresses and loss CSV are kept for the zerostall phase.
   Beside the three runs, three chains run the chaos soak's z1, bk and bkf
   groups (``resilience/chaos.py``, cycles 16-24: two ranks over gloo on
   the card, the soak's own tiny model, deterministic algorithms, the flash
   kernels): zero1 stopped and resumed at ``none`` bit-exact against its
   golden; int8 with buckets resumed without them, bit-exact to the flip
   and within tolerance after; fp32 buckets resumed at another cap,
   bit-exact. Their flash launches go to the FMA instances (head dim 16;
   wgmma runs bf16 at d 64 and 128); each group's rank-0 launches are read from its
   runs' ``run_summary`` events and must be more than 0. Prints one
   ``chaos`` line (each cycle's rc and seconds, the verdicts, the
   launches).
8. Serving phase, at llama-1b's full width and depth, on the final
   checkpoint of a 4-step trainer run (``serving_checkpoint``: B2's weights,
   which it read before PR 8):
   ``load_serving_params`` restores its ``.params`` (seconds, bytes, the
   ``xxh64tree:`` sidecar checked through the native hash); a 1,024-token prompt through the paged prefill (chunks of 256)
   against the training forward (sdpa), at bf16 and fp32 compute, by
   relative norm; at fp32 compute every request of a seeded workload served
   by the engine equals ``generate_tokens`` token for token, a divergence
   excused only where lockstep's top two logits lie within a stated gap;
   the int8 KV pool against the native one under the JAX package's policy
   (teacher-forced argmax match, logits relative to the native pool's
   largest, free-running match), held at the fp32 compute the policy's test
   runs, the bf16 figures printed beside; then a timed bf16 run of 16
   requests arriving at 50 req/s through the engine (8 slots) against the
   lockstep baseline over the first ``LOCKSTEP_REQUESTS`` of them (serial
   decoding runs at one rate whatever the request): tokens/s, TTFT/TPOT/e2e percentiles, decode-step ms
   at 8 live slots (with paged attention's share and the device's busy time
   under ``torch.profiler``) and prefill-chunk ms, pool bytes and resident
   sequences, peak memory. Every engine run must end with its pool drained.
   The restore must leave a ``serving_restore`` span and ``weights_loaded``,
   and the timed run 16 ``request_done`` events with their ``req_*`` spans.
   Prints one ``serving`` line.
9. Drill phase: trainer subprocesses at llama-1b's width, depth cut to 2
   layers, under ``$PYRECOVER_FAULT_PLAN``, the five independent chains
   below at once (PR 8) and the OOM drill after them: a straight run (the yardstick);
   ``kill9_during_save`` in the first save (rc -9, doctor ``crash`` in
   ``ckpt_write``, nothing published) and its ``latest`` resume, whose final
   checkpoint must equal the yardstick's; ``corrupt_ckpt_bytes`` on the
   newest save and its resume (pre-check failed, quarantined, resumed from
   the one before; the same final digest); ``transient_io_error`` on writes,
   then on the resume's reads (retried, healthy); a ``loader_stall`` past
   the watchdog's window (``hang`` in ``loader_wait``, a bundle); and the
   full-depth model at a batch the card cannot hold (``OutOfMemoryError``
   in the bundle, ``oom``); and the zerostall engine killed (``kill9_during_save``
   at ``ckpt_chunk_write``) in its second save, the doctor ``crash`` in
   ``ckpt_chunk_write``, only the first manifest published, and its
   ``latest`` resume ending with Z-A's state. Prints one ``drills`` line,
   then the ``telemetry`` line and each phase's seconds.
10. dp phase (before the drills), trainer subprocesses at llama-1b's width,
   ``DP_LAYERS`` deep, global batch ``DP_BATCH``, synthetic data through the
   ``DataLoader``, 4 steps: R0 one process; R1 ``--distributed --dp 1`` on
   NCCL, a group of one, whose loss CSV must equal R0's bit for bit; A2 two
   ranks on the one card (``--dist-backend gloo``, each with LOCAL_RANK 0),
   the sharded engine with an asynchronous save at step 2, step 1's loss
   within ``DP_STEP1_RTOL`` of R0's, the rest within ``DP_LOSS_RTOL``, one
   loss CSV and JSONL, host 0's; B1 stopped at step 2 by a deadline only
   host 0 sees (both ranks stop there, one REQUEUE) and B2 its ``latest``
   resume, whose final ``.params`` digests must equal A2's; C one process
   resuming A2's step-2 sharded checkpoint with ``--elastic-resume on``
   (``elastic_resume`` 2 -> 1 devices with the plan's bytes,
   ``sampler_rescaled`` 2 -> 1, steps 3-4 within the limit of A2's); A2's
   final sharded checkpoint served (``load_serving_params``) equal, digest
   for digest, to the vanilla reader of the same state; V2 dp2 with the vanilla engine (one
   file a save, host 0's, the JAX TrainState's paths) and V1 its step-2 file
   resumed at dp 1, as C. Then the gradient wire and ZeRO-1 on A2's data
   and weights, two ranks over gloo, ``WIRE_STEPS`` steps, the five runs
   in one process pair: Q8 the int8 wire, Q8B int8 over JAX's bucket
   layout (``WIRE_BUCKET_MB``, 6 buckets), B16 the bf16 wire, Z1 zero1 at
   fp32 and Z1Q zero1 with int8. Q8, Q8B and B16 within
   ``WIRE_LOSS_RTOL`` of A2, and their step-1 gradient norm (of the synced
   gradient, so of the wire's sum) within ``WIRE_NORM_RTOL`` of A2's; Z1's losses and step-2 ``.params`` digests
   equal A2's and Z1Q's equal Q8's, bit for bit; Q8's residual nonzero on
   both ranks, its ``grad_quantize`` wire bytes below the gradient's; Z1's
   peak below A2's by ``Z1_PEAK_SHARE`` of one rank's moment bytes. Every
   rank's flash launches must be layers x steps on the tensor-core
   instances. R0 -> R1 (one at a time: ten processes do not fit the card),
   the wire runs and the A2 -> C, B1 -> B2 and V2 -> V1 chains run at
   once, so their seconds overlap; the checks read
   their results after. Prints one ``dp`` line: each run's ranks, backend,
   losses, median step ms, saves (blocking seconds by engine for the same
   state), load seconds, the wire's bytes and errors, and the checks.
11. ``--dp-cards N`` (N >= 2 cards; run alone, not by the whole check):
   the dp phase as users run it, one rank a card. M0 is one process on card
   0; every other run is ``torch.distributed.run --standalone
   --nproc-per-node N`` starting N trainer ranks, each on ``cuda:LOCAL_RANK``
   over the default ``cuda:nccl,cpu:gloo``. NA: the sharded engine with an
   asynchronous save at step 2 and one gradient all-reduce after the
   backward (``--grad-bucket-mb 0``), held to M0 as A2 is; NK: DDP's
   overlapped 25 MiB buckets and the vanilla engine (host 0's save at 2),
   within ``DP_LOSS_RTOL`` of NA; NB1 stopped at step 2 by a deadline only
   host 0 sees and NB2 its ``latest`` resume, whose final ``.params``
   digests must equal NA's; NQ the int8 wire over NCCL, within
   ``WIRE_LOSS_RTOL`` of NA; NZ zero1, bit-equal to NA. Prints one
   ``dp_cards`` line.

12. Zerostall phase (after the checkpoint phase), trainer
   subprocesses at llama-1b's width under deterministic algorithms with
   ``--checkpoint-engine zerostall``: Z-A (4 steps, a save every step),
   alone on the card, then at once Z-B1 (stopped by a deadline) and Z-B2
   (its ``latest`` resume from disk), both at the vanilla B runs' interval,
   E and P, all at the checkpoint phase's depth, and Z-F. Z-B2's final manifest must equal Z-A's,
   chunk digest for chunk digest, and both vanilla A's leaves (their content
   addresses); the loss CSVs equal A's; REQUEUE then DONE; the doctor says
   healthy / preemption / healthy; every snapshot went through pinned
   buffers; and a steady-state save (after the first, which pins the two
   buffer sets) must block less than vanilla A's background save. Z-A's
   manifest served on the card equals vanilla A's file, digest for digest.
   E: one process trains 2 steps, the disk tier (chunks and manifests) is
   deleted, and ``train.train`` again resumes from the in-RAM emergency
   tier and ends equal to Z-A; after each call the process keeps pinned at
   most the one buffer set the emergency record holds. P: ``--checkpoint-frequency auto`` (ceiling
   2, 6 steps): the ``ckpt_policy`` records, saves where they said, every
   interval within [floor, ceiling], the cost learned = the blocking
   measured less the first save's pinning. Z-F: llama-1b's width at
   ``ZF_LAYERS`` of its 20 layers (a 7.6 GB state; the depth cut to make
   room for the fleet phase, named in the line's ``reduced``), 3 steps, a
   save at 2. Prints one ``zerostall`` line: each save's blocking (the first, with
   its pinning, apart), back-pressure, shadow, chunks written and reused,
   pinned bytes, peak memory, Z-A's step ms beside a shadow write against
   vanilla A's with no writer, Z-B2's disk load against E's RAM restore, and
   Z-F.

13. MoE phase (after the transfer guard; PR 10): moe-4x1b
   (``models/presets.py``) at full width and depth, every FFN 4 top-2
   experts dispatched by ``auto`` (``grouped``). M-T: ``train.main``, seq
   1024, batch 4, bf16 compute, fp32 masters, flash, synthetic data through
   the ``DataLoader``, ``MOE_STEPS`` steps: finite losses and aux, flash
   launches = layers x steps on the tensor-core instances (the ``kernels``
   line's ``launches_moe``), the median step ms of steps 2-5, tokens/s,
   active-parameter MFU and peak memory, and two profiled steps (device busy
   time by kernel group, idle share); then 3 steps after the first under
   ``--transfer-guard disallow``, none of which may fire. M-R (trainer
   subprocesses under deterministic algorithms, at ``MOE_R_LAYERS`` layers,
   beside M-A): a straight ``MOE_R_STEPS``-step run, and a run stopped at
   step 2 and resumed from ``latest``: loss CSVs equal, final checkpoints'
   ``xxh64tree:`` digests equal, save and load seconds. M-A: flash against
   sdpa in the MoE model on the first batch, as item 5. M-B: one layer at
   moe-4x1b's width (B 4, S 1024, D 2048, E 4, top-2, F 7168, C 640),
   ``grouped``, ``scatter`` and ``einsum`` in bf16, each output and gradient
   held to the others and to an fp32 run (``MOE_BF16_VS_FP32``,
   ``MOE_BACKENDS_REL``), each forward + backward timed. M-S: M-R's final
   checkpoint served at fp32 compute: the paged prefill against the training
   forward at the no-drop capacity, the engine against ``generate_tokens``
   token for token over 8 requests. Prints ``moe_train``,
   ``moe_transfer_guard``, ``moe_attention_check``, ``moe_resume``,
   ``moe_backends`` and ``moe_serve`` lines. The kernel phase holds K1-K3
   at the MoE shape too (b 4, s 1024, hq 16, hkv 8, d 128), timed under each
   row's ``moe_shape``.

14. Hotswap phase (after the MoE phase): the live plane and the
   zero-downtime hot-swap at llama-1b's width, ``HS_LAYERS`` deep. Live leg: a
   trainer child (``chip_smoke.py --trainer``, ``train.main``: flash, bf16 compute,
   fp32 masters, a zerostall save every ``HS_EVERY`` of ``HS_STEPS`` steps,
   telemetry on, ``PYRECOVER_METRICS_PORT=0``; its port read from its
   ``exporter_started`` event) beside an fp32 ``ServingEngine`` in this
   process, restored from the trainer's first manifest, whose ``HotSwapper``
   follows the experiment directory while open-loop load (``HS_LOAD``, each
   request a trace) runs until the trainer has ended and its last manifest
   is served; a ``FleetAggregator`` polls both exporters every
   ``HS_SCRAPE_S``. Checks: the trainer exits 0 with every flash launch on
   the tensor-core instances (``HS_LAYERS`` x ``HS_STEPS`` each); at least 2
   swaps land, none
   rejected; the requests submitted at each flip equal lockstep decoding of
   that manifest's cold restore (a near-tie excused as in item 8); a probe
   after the last swap equals a cold restore of the final manifest token for
   token; the mid-run poll sees both targets live with the trainer's
   ``step_iter_s`` and the engine's ``e2e_s``, and so does the poll after the
   drain (a target that exited keeps its last totals, flagged stale);
   ``traceview`` over the trainer's stream and ``traceassembly
   --expect-complete`` over the engine's exit 0. Perturbation leg: the served
   weights saved again with only ``output`` and ``final_norm`` moved; the
   incremental fetch moves exactly the chunk plan's bytes and the probe equals
   a cold restore. Then the live leg's requests again on an engine with no
   swapper (its p99s beside the live ones). Every pool must drain. Prints
   one ``hotswap`` line: each swap's seconds, bytes fetched and reused and
   GB/s, the p99s, the polls' milliseconds. The chaos leg
   (``hotswap_chaos_drill`` at ``HS_CHAOS_LAYERS``, fp32: a server SIGKILLed
   at its first ``swap_fetch``, the pin kept, nothing leaked or quarantined,
   the old manifest served bit for bit, the rewatch completing the swap)
   runs as a chain of the drill phase, beside its other drills, and prints
   one ``hotswap_chaos`` line. The
   ``telemetry_cost`` line gains ``exporter_on``: the train line's steps with
   the exporter scraped every ``EXPORTER_SCRAPE_S``, each step holding a
   scrape (checked) and each held to the spread of the two telemetry-on
   runs without it (reported); the MoE phase gains one fp32 guarded step
   (``moe_transfer_guard_fp32``), and M-S times its no-drop fp32 prefill and
   serving with ``grouped`` and with ``scatter`` (``fp32_backends_ms``).

15. Fleet phase (two chains of the drill phase, beside its other drills): the
   serving fleet, two replica processes on the one card (``python -m
   pyrecover_tpu_torch.serving.fleet.replica --device cuda``), each an fp32
   engine at llama-1b's width, ``FLEET_LAYERS`` deep, behind the router,
   each drill through ``python -m pyrecover_tpu_torch.serving.fleet.drill``
   in a process of its own. The chaos leg: a baseline fleet under 2 s of
   open-loop load at 25 req/s (the multi-target split equal to the single
   stream, exact accounting, every replica's probe equal to a cold
   restore's, the aggregator seeing both live, zero capacity shedding
   loudly); then replica 1 SIGKILLed at its ``replica_kill`` seam after 3
   completed requests while the router's first redrive hits an injected
   transient error (rc -9, ``submitted == done + shed``, at least one
   redrive, every result equal to the baseline's, the kill-window p99 within
   ``P99_FACTOR`` x the baseline's + ``P99_SLACK_S``, the respawn ready and
   serving the probe, every request one rooted trace with no orphan and the
   redriven one's gap in ``redrive_gap``); then a replica with nothing to
   serve quarantined after exactly 3 spawns. The canary leg: three releases;
   the divergent one fails the canary's token gate and rolls back with the
   old manifest pinned and both replicas on it, the healthy one passes and
   waves. On the card a result decoded in another batch may differ in fp32's
   last bits: a divergence is excused only at a near-tie of lockstep decoding
   of a cold restore of the same manifest (top-two gap within 1e-3, item 8's
   rule) and counted. Prints one ``fleet`` line: each replica's
   spawn-to-ready seconds and the respawn's, the baseline and kill-window
   p99 and the gate, the requests submitted, done, shed and redriven, the
   quarantine spawns, the canary verdicts with each swap's seconds and
   bytes, each replica's allocator peak (from its ``status`` reply), the
   near-ties excused, each leg's seconds and the depth cut.

Prints one ``{"kernels": [...]}`` JSON line and, last, one
``{"ok": true, "device": {...}}`` line. Any failed check exits non-zero
before that line.
"""

import argparse
import contextlib
import csv
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# kernel vs plain version, (atol, rtol, rel_norm): every element must hold
# |a - b| <= atol + rtol * |b|, and the whole output ||a - b|| / ||b|| <=
# rel_norm. Both sides take the same inputs and compute in fp32, so they
# differ only in summation order and, for bf16 outputs, in which way a value
# near a rounding midpoint rounds: one bf16 ulp, at most 2**-7 of the value.
# Measured on an H100 80GB HBM3 at 700 W: bf16 worst 0.499 (the one-ulp flips)
# but for 0.832 in dk/dv's dv at the llama-1b shape, relative norm up to
# 1.7e-4; fp32 worst 0.29, relative norm up to 8.3e-7;
# lse worst 0.026 at (1e-5, 1e-5), relative norm up to 4.0e-8.
BF16_TOL = (1e-5, 2**-6, 5e-4)
FP32_TOL = (1e-5, 1e-4, 4e-6)
LSE_TOL = (1e-6, 1e-6, 2e-7)  # lse is fp32 whatever the inputs

# Inside the model, flash vs sdpa from the trainer's initial weights and
# first batch. With bf16 compute 20 layers of rounding carry any small
# difference far: the layers' wq/wk gradients differ by up to 3.1e-2 on an
# H100 80GB HBM3 at 700 W, so bf16 gradients are printed but only the loss
# is held. The gradients are held with fp32 compute, where only summation order
# differs: every layer's wq/wk/wv/wo gradient by relative norm (measured up
# to 7.8e-6), and the loss (8.8e-8 apart).
BF16_LOSS_RTOL = 1e-3
FP32_LOSS_RTOL = 5e-7
FP32_GRAD_REL_NORM = 4e-5
# the rebuilt model's bf16 flash loss vs the trainer's first loss (same
# weights, same batch, same kernels)
SAME_LOSS_RTOL = 1e-5

# the training run: llama-1b at full width and depth. If the time limit
# ever forces a cut, cut LAYERS (depth) first and say so in the output.
LAYERS, STEPS, BATCH = 20, 5, 2

# telemetry: the hang watchdog's window on the train line (~20 steps of
# ~250 ms) and on the checkpoint runs, where one fsync of a ~15 GB file is a
# legitimate silence of many seconds; the facts the `telemetry` line prints
TRAIN_WATCHDOG_S, CKPT_WATCHDOG_S = 5.0, 60.0
TELEMETRY = {}

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12   # non-tensor fp32 peak
H100_BYTES_PER_S = 3.35e12

# the trainer phase: steps of each remat run; packed rows (one batch, so
# every batch holds the last row and its pad tail) cut from documents of
# 64-1536 tokens ending in EOS; the eval and profile run's steps and where
# its trace goes; the flash kernels' names the trace must hold
# (6: the steady window then spans 5 steps, so one slow step, which earlier
# runs show now and then, does not decide the comparison of the policies'
# step times)
REMAT_STEPS = 6
# a rematerialized run's losses against the run without remat: expected
# bit-equal (the recompute reruns deterministic kernels on the same
# inputs); any difference is printed beside this limit
REMAT_LOSS_RTOL = 1e-6
PACKED_ROWS, PACKED_DOC_LENS, PACKED_TAIL, PACKED_EOS = BATCH, (64, 1536), 300, 2
PACKED_STEPS, EVAL_STEPS, EVAL_EVERY, EVAL_SAMPLES = 3, 4, 2, 8
PROFILE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "profile"
FLASH_KERNEL_NAMES = ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel")

# the checkpoint phase: steps per run, periodic save interval, its depth,
# and where the runs write (two checkpoints must fit at once). PR 8 cut the
# depth from 20 layers (15.2 GB files, 235 s for the phase) to CKPT_LAYERS,
# to make room for the dp phase: the checks and the width are unchanged.
# The serving phase keeps the model it served before: full depth after
# CKPT_STEPS steps (the weights of the old B2), from a trainer run of its
# own. Its int8-KV policy does not hold on models near their random start:
# the free-running match was 0.6132 at 4 layers after 4 steps and 0.2058
# (logits 2.09 % apart) at 20 layers after 1 step, against 0.80 (H100 80GB
# HBM3, 700 W; PERF.md §6, PR 8).
CKPT_STEPS, CKPT_EVERY, CKPT_LAYERS = 4, 3, 2
SERVE_CKPT_STEPS = CKPT_STEPS
# the last figures measured with sha256 sidecars (PERF.md §2; H100 80GB HBM3,
# 700 W), printed beside this run's
SHA256_SIDECAR_FIGURES = {"precheck_s": 20.37, "final_save_s": [36.40, 37.79], "load_s": 36.05,
                  "serving_restore_s": 21.13}
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ckpt"
# the zerostall phase: Z-A/Z-B1/Z-B2 are the checkpoint phase's runs
# with the zerostall engine, Z-A with a save every step (the first save pins
# the buffer sets, the next two are the steady state the engine is for); Z-F is
# llama-1b's width at ZF_LAYERS (a 7.6 GB state; the depth cut from 20, the
# phase's longest run, to make room for the fleet phase in the script's time
# limit), ZF_STEPS steps with a save at ZF_EVERY; P is the autopilot on the
# 2-layer model, ceiling P_CEILING.
# The facts the later phases hold against (A's file and digests, Z-A's final
# manifest) are kept in ZS_REF.
ZS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "zs"
ZS_EVERY, ZF_LAYERS, ZF_STEPS, ZF_EVERY, P_STEPS, P_CEILING = 1, 10, 3, 2, 6, 2
ZS_REF = {}
# what a process may keep pinned beyond the emergency record's buffer set
# once `train` has returned: the loader's last batches, a few KiB each
PINNED_SLACK = 64 << 20
# the drill phase: llama-1b's width at 2 layers (a ~3 GB checkpoint), 4
# steps with a save every 2; the loader stall outlasts its watchdog window;
# the OOM drill's batch (llama-1b, 20 layers, seq 2048: ~4 GB of activations
# a row against the card's 80 GB)
DRILL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "drills"
DRILL_LAYERS, DRILL_STEPS, DRILL_WATCHDOG_S = 2, 4, 60.0
STALL_S, STALL_WINDOW_S, OOM_BATCH = 12.0, 4.0, 32
# the dp phase (PR 8): llama-1b's width at DP_LAYERS layers (a ~3 GB state),
# global batch DP_BATCH, DP_STEPS steps; where its runs write. Step 1 of the
# dp2 run sees R0's weights and rows: its loss is held to R0's at
# DP_STEP1_RTOL. Later steps follow two ranks' summed gradients, which
# differ from one process's in rounding only: DP_LOSS_RTOL
DP_LAYERS, DP_BATCH, DP_STEPS = 2, 4, 4
DP_STEP1_RTOL, DP_LOSS_RTOL = 1e-6, 1e-4
# the dp phase's gradient-wire and ZeRO-1 runs (item 10): int8 within
# WIRE_LOSS_RTOL of A2 over the steps (JAX test_int8_tracks_fp32_short), a
# bucket cap that cuts llama-1b's 2-layer leaves into 6 buckets, and the
# share of one rank's moment bytes zero1 must take off its peak
WIRE_LOSS_RTOL, WIRE_BUCKET_MB, Z1_PEAK_SHARE = 2e-3, 128, 1 / 3
# their steps: cut from DP_STEPS to keep the phase's time (A2's step-2
# checkpoint carries the digests Z1 is held to). Step 2's loss sees the wire
# only through AdamW's first update, which is near sign(g) whatever the
# gradient's scale, so step 1's gradient norm (taken after the sync: the
# wire's sum itself) is held to A2's too (measured on the CPU at the tests'
# tiny model: int8 3e-5, bf16 6e-5; a wrong scale or a missing rank's share
# moves it by tens of percent)
WIRE_STEPS, WIRE_NORM_RTOL = 2, 1e-3
# the soak's groups run on the card beside the checkpoint phase (item 7)
CHAOS_GROUPS = ("z1", "bk", "bkf")
CHAOS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "chaos"
DP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dp"
# the serving phase (llama-1b at full width, bf16 compute unless it says fp32)
SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK, SERVE_BUDGET = 8, 16, 256, 512
TF_PROMPT = 1024  # teacher-forced prompt, prefilled in chunks of SERVE_CHUNK
# the timed workload: requests, prompt and output length ranges, arrivals/s
TIMED = dict(n_requests=16, prompt_lens=(16, 1024), new_tokens=(16, 128), arrival_rate=50.0)
# the lockstep baseline's share of them: one request after another decodes at
# one rate, so a few give its tokens/s (all 16 took ~76 s on a slow host)
LOCKSTEP_REQUESTS = 4
# the fp32 greedy-equality and int8 workloads (manually pumped, so the
# batches are the same in every run)
EQUAL = dict(n_requests=8, prompt_lens=(16, 512), new_tokens=(16, 64), arrival_rate=50.0)
# paged prefill vs the training forward, logits by relative norm. Measured on
# an H100 80GB HBM3 at 700 W: bf16 9.9e-3-1.07e-2 (the two paths round the
# probabilities at different places through 20 layers), fp32 2.2e-6-2.8e-6
TF_REL_NORM = {"bfloat16": 5e-2, "float32": 1e-5}
# an fp32 engine token may differ from lockstep's only where lockstep's top
# two logits are closer than this (summation order moves fp32 logits by
# ~1e-5)
GREEDY_GAP = 1e-3
# the JAX package's int8-KV policy (tests/test_serving.py)
INT8_TF_MATCH, INT8_LOGIT_REL, INT8_FREE_MATCH = 0.90, 0.02, 0.80
# read beside the profiled steps: a card held below its clocks runs every
# kernel longer
CLOCKS = "clocks.sm,power.draw,temperature.gpu"
# the MoE phase (PR 10): moe-4x1b at full width and depth, seq 1024, batch 4,
# MOE_STEPS steps (M-T) and MOE_GUARD_STEPS under the transfer guard; M-R at
# MOE_R_LAYERS layers (a ~6.1 GB state), MOE_R_STEPS steps, stopped at 2;
# where its runs write. M-B's limits, by relative norm: each bf16 backend's
# output and gradients against an fp32 run of the same inputs (the weights
# and intermediates round to bf16 there; measured 5.1e-3-6.2e-3 on an H100
# 80GB HBM3 at 700 W), and the bf16 backends against grouped (the same
# roundings, summed in another order: scatter 0 for y, dh and drouter and
# 3.2e-5 for the experts' gradients, einsum up to 2.8e-3)
MOE_LAYERS, MOE_STEPS, MOE_GUARD_STEPS, MOE_BATCH, MOE_SEQ = 8, 6, 3, 4, 1024
MOE_R_LAYERS, MOE_R_STEPS = 2, 4
MOE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "moe"
MOE_BF16_VS_FP32, MOE_BACKENDS_REL = 2e-2, 1e-2
# the hotswap phase: a trainer child at llama-1b's width, HS_LAYERS
# deep (cut from 20 to stay inside the script's time limit), HS_STEPS steps
# with a zerostall save every HS_EVERY, beside an fp32 engine in this process
# that follows its manifests; open-loop load at HS_LOAD for as long as the
# trainer runs (at most HS_LOAD_MAX_S), the fleet aggregator polled every
# HS_SCRAPE_S; the chaos drill at HS_CHAOS_LAYERS. Each flip is probed with
# HS_FLIP_PROBE and held to lockstep decoding of that manifest's cold restore.
HS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "hotswap"
HS_LAYERS, HS_STEPS, HS_EVERY, HS_CHAOS_LAYERS = 4, 8, 2, 2
HS_LOAD = dict(prompt_lens=(16, 256), new_tokens=(16, 64), arrival_rate=4.0)
HS_LOAD_MAX_S, HS_SCRAPE_S = 240.0, 0.5
# the exporter-on leg of `telemetry_cost`: often enough that every step holds a scrape
EXPORTER_SCRAPE_S = 0.1
HS_FLIP_PROBE = dict(n=4, prompt_len=64, new_tokens=16)
# the fleet phase (item 15): two replica processes on the card at llama-1b's
# width, FLEET_LAYERS deep (cut from 20 to stay inside the script's time
# limit), fp32 compute; each drill runs in a process of its own (its
# telemetry bus and fault plan are process-wide), beside the drill phase's
# chains, within FLEET_TIMEOUT_S
FLEET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "fleet"
FLEET_LAYERS, FLEET_TIMEOUT_S = 2, 600
# one bytecode cache for this process and every process it starts, inside
# the checkout (build/, which git ignores): an interpreter started with
# bytecode writes off (PYTHONDONTWRITEBYTECODE) would otherwise compile torch
# from its sources in each of the script's processes
PYC_DIR = Path(__file__).resolve().parent / "build" / "pyc"


def fail(msg):
    """Stop the script: the reason on standard output, where the phase's
    lines are, and on standard error, whose tail a caller that keeps only
    that stream still shows."""
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say_failed(line):
    """A failed check's line, on both streams (see :func:`fail`)."""
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)


def card_line(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def ptxas_summary(log):
    """One line per kernel instance from ``nvcc -Xptxas -v`` output: its name,
    dtype and head dim, registers and spill bytes."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?((?:fwd|dq|dkv)(?:_wgmma|_chunked)?_kernel)I"
                      r"(\w*?)(?:Li(\d+))?EE", line)
        if m:
            dtype = "fp32" if m.group(2) == "f" else "bf16"
            # the chunked instances take any d above 256 in chunks of 128
            d = m.group(3) or ">256"
            name, spill = f"{m.group(1)}<{dtype}, {d}>", ""
        elif name and "spill stores" in line:
            spill = ", " + ", ".join(p.strip() for p in line.split(",")[1:])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            lines.append(f"{name}: {m.group(1)} registers{spill}")
            name = None
    return lines


def ptxas_spill(log):
    """``{"<kernel><dtype, d>": {"registers": n, "spill_stores": b,
    "spill_loads": b}}`` from ``nvcc -Xptxas -v`` output (None where the
    library was not built in this process)."""
    out = {}
    for line in ptxas_summary(log):
        name, rest = line.split(": ", 1)
        stores = re.search(r"(\d+) bytes spill stores", rest)
        loads = re.search(r"(\d+) bytes spill loads", rest)
        out[name] = {"registers": int(re.match(r"(\d+)", rest).group(1)),
                     "spill_stores": int(stores.group(1)) if stores else 0,
                     "spill_loads": int(loads.group(1)) if loads else 0}
    return out


TIMING_LEAD_CYCLES = 10**8


def cuda_time_ms(fn, iters, warmup=2):
    """Mean device milliseconds of ``fn`` over ``iters`` calls, after
    ``warmup`` calls. A sleep kernel of ``TIMING_LEAD_CYCLES`` clocks
    (about 50 ms on an H100) is queued ahead of the start event, so the
    host has queued every call before the card reaches them: the span
    between the events is the card's own time, not the pace of a host that
    launches slower than the card runs (autograd's backward of SDPA does).
    When the card reached the start event before the host was done, the
    lead is doubled and the timing taken again."""
    import torch

    for _ in range(warmup):
        fn()
    lead_cycles = TIMING_LEAD_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_behind = start.query()
        torch.cuda.synchronize()
        if not host_behind:
            break
        lead_cycles *= 2
    return start.elapsed_time(end) / iters


def make_case(b, s, sk, hq, hkv, d, dtype, n_segments, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    dout = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    seg = None
    if n_segments > 1:
        cuts = torch.linspace(0, s, n_segments + 1, device="cuda")[1:-1].long()
        pos = torch.arange(s, device="cuda")
        seg = (pos[None, :] >= cuts[:, None]).sum(0).to(torch.int32)
        seg = seg[None, :].expand(b, s).contiguous()
    return q, k, v, seg, dout


def valid_pairs(b, s, causal, seg):
    """Score positions the mask keeps, summed over the batch rows."""
    import torch

    pos = torch.arange(s, device="cuda")
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal:
        mask = pos[:, None] >= pos[None, :]
    if seg is None:
        return b * int(mask.sum().item())
    same = seg[:, :, None] == seg[:, None, :]
    return int((mask[None] & same).sum().item())


def compare(got, ref, tol):
    """``got`` against ``ref`` under ``tol = (atol, rtol, rel_norm)``.
    Returns (max abs err, worst err / (atol + rtol |ref|), relative norm
    err); the check holds when the last two are within 1 and rel_norm."""
    atol, rtol, _ = tol
    a, b = got.double(), ref.double()
    diff = (a - b).abs()
    worst = (diff / (atol + rtol * b.abs())).max().item()
    return diff.max().item(), worst, rel_norm_err(a, b)


def rel_norm_err(got, ref):
    """||got - ref|| / ||ref||, in fp64."""
    ref = ref.double()
    return ((got.double() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def check_outputs(label, pairs, failures):
    """Compare each (name, got, ref, tol), print one line each with the
    limits beside the errors, and note every miss in ``failures``. Returns
    the max abs err over the pairs."""
    err_max = 0.0
    for name, got, ref, tol in pairs:
        err, worst, rel = compare(got, ref, tol)
        ok = math.isfinite(err) and worst <= 1.0 and rel <= tol[2]
        print(f"  {label} {name}: max abs err {err:.3e}; worst err/(atol {tol[0]:.0e} + "
              f"rtol {tol[1]:.2e}*|ref|) = {worst:.3f} (limit 1); rel norm err "
              f"{rel:.3e} (limit {tol[2]:.0e}){'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(f"{label} {name}")
        err_max = max(err_max, err)
    return err_max


def sdpa_backend(q, k, v, causal):
    """The backend ``F.scaled_dot_product_attention`` runs for these inputs:
    the first, in PyTorch's priority order, that accepts them."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        order = [SDPBackend(i) for i in torch._C._get_sdp_priority_order()]
    except (AttributeError, TypeError, ValueError):
        order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    for backend in order:
        if backend in (SDPBackend.ERROR, SDPBackend.OVERRIDEABLE):
            continue
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
            return backend.name
        except RuntimeError:
            continue
    return None


def kernel_case(fa, label, b, s, sk, hq, hkv, d, dtype, n_segments, causal, timed, failures):
    import torch
    import torch.nn.functional as F

    q, k, v, seg, dout = make_case(b, s, sk, hq, hkv, d, dtype, n_segments, seed=s + d)
    scale = 1.0 / math.sqrt(d)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    routes = ", ".join(f"{key} {fa.kernel_route(key, dtype, d)}" for key in ("fwd", "dq", "dkv"))
    dp = fa.padded_head_dim(d)
    print(f"kernel case {label}: b{b} s{s} sk{sk} hq{hq} hkv{hkv} d{d} {dtype} "
          f"segments={n_segments} causal={causal}; route {routes}"
          f"{f' (zero-padded to the d {dp} instance)' if dp != d else ''}", flush=True)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, seg, causal, scale)
    out_k, lse_k = fa.flash_fwd(q, k, v, seg, causal, scale)
    torch.cuda.synchronize()
    e_fwd = check_outputs(label, [("out", out_k, out_r, tol), ("lse", lse_k, lse_r, LSE_TOL)],
                          failures)
    bwd = (q, k, v, seg, out_r, lse_r, dout, causal, scale)
    dq_r = fa.flash_bwd_dq_reference(*bwd)
    dq_k = fa.flash_bwd_dq(*bwd)
    torch.cuda.synchronize()
    e_dq = check_outputs(label, [("dq", dq_k, dq_r, tol)], failures)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(*bwd)
    dk_k, dv_k = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    e_dkv = check_outputs(label, [("dk", dk_k, dk_r, tol), ("dv", dv_k, dv_r, tol)], failures)
    errs = {"fwd": e_fwd, "dq": e_dq, "dkv": e_dkv}
    if not timed:
        return None

    del dq_r, dk_r, dv_r, out_k, lse_k, dq_k, dk_k, dv_k
    torch.cuda.empty_cache()
    ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_fwd(q, k, v, seg, causal, scale), 10),
        "dq": cuda_time_ms(lambda: fa.flash_bwd_dq(*bwd), 10),
        "dkv": cuda_time_ms(lambda: fa.flash_bwd_dkv(*bwd), 10),
    }
    plain_ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_fwd_reference(q, k, v, seg, causal, scale), 3, 1),
        "dq": cuda_time_ms(lambda: fa.flash_bwd_dq_reference(*bwd), 3, 1),
        "dkv": cuda_time_ms(lambda: fa.flash_bwd_dkv_reference(*bwd), 3, 1),
    }
    # the one PyTorch call computing the forward: SDPA on (b, h, s, d)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
    # SDPA's backward (dq, dk, dv together): a yardstick for K2 + K3
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg), dot, retain_graph=True), 10)
    # the autograd node names the backend whose backward ran
    lib_bwd_op = o.grad_fn.name()
    print(json.dumps({"library_backward_ms": lib_bwd, "library_backward_op": lib_bwd_op,
                      "note": "F.scaled_dot_product_attention backward, dq+dk+dv"}))
    library_backend = sdpa_backend(qt, kt, vt, causal)

    pairs = valid_pairs(b, s, causal, seg) * hq
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    work = {
        "fwd": (4 * d * pairs, nbytes(q, k, v, seg, out_r, lse_r)),
        "dq": (6 * d * pairs, nbytes(q, k, v, seg, out_r, lse_r, dout, q)),
        "dkv": (8 * d * pairs, nbytes(q, k, v, seg, out_r, lse_r, dout, k, v)),
    }
    rows = []
    meta = {
        "fwd": ("flash_fwd", "pyrecover_tpu/ops/flash_attention.py:107", lib_fwd),
        "dq": ("flash_bwd_dq", "pyrecover_tpu/ops/flash_attention.py:238", None),
        "dkv": ("flash_bwd_dkv", "pyrecover_tpu/ops/flash_attention.py:301", None),
    }
    for key, (name, replaces, lib_ms) in meta.items():
        flops, moved = work[key]
        t_ops, t_bytes = flops / peak * 1e3, moved / H100_BYTES_PER_S * 1e3
        route = fa.kernel_route(key, dtype, d)
        rows.append({
            "name": name, "route": "cuda", "instance": route, "head_dim": d,
            "dtype": "bf16" if dtype == torch.bfloat16 else "fp32",
            "source": "pyrecover_tpu_torch/csrc/" + (
                "flash_attention_sm90.cuh" if route == "cuda-wgmma" else "flash_attention.cu"),
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[key], "ms": ms[key], "plain_ms": plain_ms[key],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library_backend": library_backend,
            "library_backward_ms": lib_bwd, "library_backward_op": lib_bwd_op,
        })
        print(f"  {name} ({route}): {ms[key]:.3f} ms, plain {plain_ms[key]:.3f} ms, "
              f"library {lib_ms} ms, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({rows[-1]['bound_by']})", flush=True)
    return rows


def kernel_phase(fa):
    import torch

    bf16, fp32, f = torch.bfloat16, torch.float32, []
    # the path's shape: llama-1b attention, bf16, s 2048, GQA 16/8, d 128
    rows = kernel_case(fa, "llama-1b", 2, 2048, 2048, 16, 8, 128, bf16, 1, True, True, f)
    # the MoE line's shape (moe-4x1b): b 4, s 1024, GQA 16/8, d 128, bf16
    moe_rows = kernel_case(fa, "moe-4x1b", MOE_BATCH, MOE_SEQ, MOE_SEQ, 16, 8, 128, bf16, 1,
                           True, True, f)
    for row, mrow in zip(rows, moe_rows):
        row["moe_shape"] = {k: mrow[k] for k in (
            "instance", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_backward_ms")}
    # llama-8b's attention: GQA 32/8 (group 4), d 128, s 2048
    kernel_case(fa, "llama-8b", 1, 2048, 2048, 32, 8, 128, bf16, 1, True, False, f)
    # twice the sequence: dk/dv sum 8192 q rows a kv row and dq 64 kv tiles
    # a q row, where a drifting accumulation would show first
    kernel_case(fa, "llama-8b-s4096", 1, 4096, 4096, 32, 8, 128, bf16, 1, True, False, f)
    # ragged, segmented, d 64, GQA group 4
    kernel_case(fa, "ragged-seg-d64", 2, 1000, 1000, 8, 2, 64, bf16, 3, True, False, f)
    # three batch rows, ragged and segmented at d 128: a TMA map that read
    # across batch rows would show here
    kernel_case(fa, "b3-ragged-seg-d128", 3, 1000, 1000, 4, 2, 128, bf16, 3, True, False, f)
    # one row past a tile, and one short of four
    kernel_case(fa, "bf16-d64-s129", 1, 129, 129, 4, 2, 64, bf16, 1, True, False, f)
    kernel_case(fa, "bf16-d64-s255", 2, 255, 255, 4, 4, 64, bf16, 1, True, False, f)
    kernel_case(fa, "bf16-d128-full", 2, 300, 300, 4, 2, 128, bf16, 1, False, False, f)
    # bf16 at d 32 stays on the FMA instances, as fp32 does
    kernel_case(fa, "bf16-d32", 1, 150, 150, 4, 2, 32, bf16, 2, True, False, f)
    # fp32, every other head dim, causal and full
    kernel_case(fa, "fp32-d16", 1, 77, 77, 4, 2, 16, fp32, 2, True, False, f)
    kernel_case(fa, "fp32-d32-full", 2, 130, 130, 4, 4, 32, fp32, 1, False, False, f)
    kernel_case(fa, "fp32-d128", 1, 200, 200, 4, 1, 128, fp32, 1, True, False, f)
    # q and kv of different lengths (start-aligned causality)
    kernel_case(fa, "fp32-d64-s<sk", 1, 100, 170, 4, 2, 64, fp32, 1, True, False, f)
    kernel_case(fa, "bf16-d128-s>sk", 1, 170, 100, 4, 2, 128, bf16, 1, True, False, f)
    kernel_case(fa, "bf16-d128-s<sk", 1, 100, 170, 4, 2, 128, bf16, 1, True, False, f)
    kernel_case(fa, "bf16-d64-s>sk", 2, 200, 77, 4, 2, 64, bf16, 1, True, False, f)
    kernel_case(fa, "bf16-d64-s<sk", 2, 77, 200, 4, 2, 64, bf16, 1, True, False, f)
    # head dims with no instance of their own: the wrapper zero-pads q, k, v
    # and dout to d 128 (d 160 to d 256), launches, and slices; held at the
    # true d. d 256 (Gemma's) runs its own FMA instance.
    for d in (80, 96, 160, 256):
        for name, dtype in (("bf16", bf16), ("fp32", fp32)):
            kernel_case(fa, f"{name}-d{d}-ragged-seg", 1, 1000, 1000, 8, 2, d, dtype, 3, True,
                        False, f)
    kernel_case(fa, "bf16-d256-full", 1, 300, 300, 4, 2, 256, bf16, 1, False, False, f)
    # the d 256 instance timed (b 1, s 2048, hq 8, hkv 2) beside its bound,
    # its plain version and SDPA, at bf16 and fp32
    instances = {}
    for name, dtype in (("bf16", bf16), ("fp32", fp32)):
        d256 = kernel_case(fa, f"{name}-d256-timed", 1, 2048, 2048, 8, 2, 256, dtype, 1, True,
                           True, f)
        for key, row in zip(("fwd", "dq", "dkv"), d256):
            if row["instance"] != "cuda-fma":
                f.append(f"d256 {name} {key} on {row['instance']}, not cuda-fma")
            instances.setdefault(key, {})[f"d256_{name}"] = {
                k: row[k] for k in ("instance", "source", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
    spill = ptxas_spill(fa.BUILD_LOG)
    for key, row in zip(("fwd", "dq", "dkv"), rows):
        row["instances"] = instances[key]
        for name in ("bf16", "fp32"):
            row["instances"][f"d256_{name}"]["ptxas"] = spill.get(f"{key}_kernel<{name}, 256>")
    # head dims above 256 (PR 8): the chunked instances, d 320 zero-padded
    # to 384 and d 512 as it is, timed at b 1, s 2048, hq 8, hkv 2, causal;
    # one row each, the fp32 figures under "instances". Their launches are
    # the chunked counts of the train line's run (`main`).
    chunked = []
    for d in (320, 512):
        kernel_case(fa, f"bf16-d{d}-ragged-seg", 1, 1000, 1000, 8, 2, d, bf16, 3, True, False, f)
        timed = {name: kernel_case(fa, f"{name}-d{d}-timed", 1, 2048, 2048, 8, 2, d, dtype, 1,
                                   True, True, f)
                 for name, dtype in (("bf16", bf16), ("fp32", fp32))}
        for key, row, row32 in zip(("fwd", "dq", "dkv"), timed["bf16"], timed["fp32"]):
            for r in (row, row32):
                if r["instance"] != "cuda-fma-chunked":
                    f.append(f"d{d} {key} on {r['instance']}, not cuda-fma-chunked")
            row["ptxas"] = spill.get(f"{key}_chunked_kernel<bf16, >256>")
            row["instances"] = {"fp32": {k: row32[k] for k in (
                "instance", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
            row["instances"]["fp32"]["ptxas"] = spill.get(f"{key}_chunked_kernel<fp32, >256>")
            chunked.append(row)
    if f:
        fail("kernels disagree with their plain versions: " + ", ".join(f))
    return rows, chunked


def train_argv():
    """The trainer's flags for llama-1b at full width on the card."""
    return [
        "--model-dim", "2048", "--model-layers", str(LAYERS),
        "--model-heads", "16", "--model-kv-heads", "8", "--vocab-size", "32768",
        "--sequence-length", "2048", "--batch-size", str(BATCH),
        # a fixed dataset size, so every run draws the same first batches
        "--training-samples", str(BATCH * STEPS),
        "--lr-warmup-steps", "2", "--learning-rate", "3e-4",
        "--logging-frequency", "1", "--seed", "0", "--device", "cuda",
        "--checkpoint-dir", "build/chip_smoke",
        # no saves: the train phase times steps
        "--checkpoint-frequency", "0",
    ]


def run_segment(path):
    """The last run segment (from the newest ``run_start``) of a telemetry
    JSONL, read with the port's tolerant reader."""
    from pyrecover_tpu_torch.telemetry import read_events

    events = read_events(path)
    starts = [i for i, e in enumerate(events) if e["event"] == "run_start"]
    return events[starts[-1]:] if starts else []


def check_stream(label, events, first_step, last_step, final_ckpt=None):
    """The facts every instrumented run's stream must show: ``run_start``
    first, one ``step_time`` a step, and a last ``run_summary`` carrying
    ``goodput_pct`` and ``hbm_peak_pct``; each ``ckpt_commit``'s bytes are
    the final file's size (every save of one run holds the same state).
    Returns ``(facts, problems)``."""
    names = [e["event"] for e in events]
    steps = [e["step"] for e in events if e["event"] == "step_time"]
    summary = events[-1] if events and names[-1] == "run_summary" else {}
    commits = [e["bytes"] for e in events if e["event"] == "ckpt_commit"]
    size = final_ckpt.stat().st_size if final_ckpt is not None and final_ckpt.exists() else None
    problems = []
    if not names or names[0] != "run_start":
        problems.append("no run_start first")
    if steps != list(range(first_step + 1, last_step + 1)):
        problems.append(f"step_time steps {steps}")
    if "goodput_pct" not in summary or "hbm_peak_pct" not in summary:
        problems.append("no run_summary with goodput_pct and hbm_peak_pct last")
    if final_ckpt is not None and (not commits or any(b != size for b in commits)):
        problems.append(f"ckpt_commit bytes {commits} != file size {size}")
    facts = {
        "events": len(events), "step_time": len(steps), "status": summary.get("status"),
        "goodput_pct": summary.get("goodput_pct"), "hbm_peak_pct": summary.get("hbm_peak_pct"),
        "ckpt_commit_bytes": commits, "file_bytes": size,
    }
    for p in problems:
        print(f"  telemetry {label}: {p}  FAIL", flush=True)
    return facts, problems


def profiled_busy(train, extra, argv=None):
    """Device busy ms a step (union of kernel intervals) over two steady
    flash training steps of ``train.main`` (llama-1b, or the 4-step ``argv``)
    under ``torch.profiler`` (steps 1-2 are skipped), by kernel name, and the
    card's clocks after each step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    captured, clocks = [], []

    def on_step(step):
        prof.step()
        clocks.append(card_line(CLOCKS))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=2),
                 on_trace_ready=lambda p: captured.append(p.events())) as prof:
        train.main((argv or train_argv() + ["--attention-impl", "flash", "--training-steps", "4"])
                   + list(extra), on_step=on_step)
    if not captured:
        fail("the profiler's window did not close")
    busy, by_name = device_busy_ms(captured[0])
    return busy / 2, {name: ms / 2 for name, ms in by_name.items()}, clocks


def train_phase(fa):
    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.telemetry import read_events

    layers, steps = LAYERS, STEPS
    if layers < 20:
        print(f"chip_smoke: depth cut to {layers} of llama-1b's 20 layers", flush=True)
    fa.reset_launch_counts()
    flash = train.main(train_argv() + [
        "--attention-impl", "flash", "--training-steps", str(steps), "--experiment-name", "train",
        "--telemetry", "--hang-watchdog-timeout", str(TRAIN_WATCHDOG_S)])
    counts = fa.launch_counts()
    # the chunked instances' own counts (d > 256): the path's d 128 launches none
    counts.update({f"{k}_chunked": n for k, n in fa.chunked_launch_counts().items()})
    gc.collect()
    torch.cuda.empty_cache()
    losses = flash["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"flash losses {losses}")
    want = {k: layers * steps for k in ("fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")}
    if counts != {**want, "fwd_chunked": 0, "dq_chunked": 0, "dkv_chunked": 0}:
        fail(f"launch counts {counts}, want {layers * steps} each (layers x steps), every "
             f"forward, dq and dk/dv launch on a tensor-core instance, none chunked")
    print(json.dumps({
        "train": {
            "layers": layers, "steps": steps, "batch_size": BATCH, "losses": losses,
            "step_ms": flash["step_ms"], "tokens_per_sec": flash["tokens_per_sec"],
            "mfu_pct": flash["mfu_pct"], "peak_mem_gib": flash["peak_mem_gib"],
            "launches": counts,
            # batches through the prefetching DataLoader: how often and how
            # long a step found its queue empty
            "loader": {"stalls": flash["loader_stalls"], "stall_s": flash["loader_stall_s"]},
            "goodput": flash["goodput"],
        }
    }), flush=True)
    facts, problems = check_stream("train", run_segment(flash["telemetry_path"]), 0, steps)
    hangs = [e for e in read_events(flash["telemetry_path"]) if e["event"] == "hang_detected"]
    if hangs:
        problems.append(f"{len(hangs)} hang_detected in a healthy run")
    TELEMETRY["train"] = {**facts, "hang_watchdog_s": TRAIN_WATCHDOG_S}
    if problems:
        fail("train line telemetry: " + "; ".join(problems))
    return counts, flash


def telemetry_cost_phase(flash):
    """Steps 2-5 of the train line with telemetry off, then on again (the
    watchdog armed), beside the train line's own (on, the process's first
    training run), and each one's device idle share: 1 - busy / step ms,
    busy from two profiled steps of a run with the same flags. No device
    sync is added by telemetry, so the runs should agree within the
    run-to-run spread, which the two runs with it on show."""
    import torch

    from pyrecover_tpu_torch import train

    base = train_argv() + ["--attention-impl", "flash", "--training-steps", str(STEPS)]
    on_flags = ["--telemetry", "--hang-watchdog-timeout", str(TRAIN_WATCHDOG_S)]
    runs = {"on": flash}
    for label, flags in (("off", []), ("on_again", on_flags)):
        runs[label] = train.main(base + flags + ["--experiment-name", f"train-{label}"])
        gc.collect()
        torch.cuda.empty_cache()
    runs["exporter_on"], scrapes = exporter_run(train, base + on_flags + [
        "--experiment-name", "train-exporter"])
    gc.collect()
    torch.cuda.empty_cache()
    busy = {}
    for label, flags in (("on", on_flags), ("off", [])):
        busy[label], _, _ = profiled_busy(train, flags + ["--experiment-name", f"prof-{label}"])
        gc.collect()
        torch.cuda.empty_cache()
    cost = {}
    for label, out in runs.items():
        b = busy["off" if label == "off" else "on"]
        cost[label] = {"step_ms": out["step_ms"], "window_step_ms": out["window_step_ms"],
                       "median_step_ms": float(np.median(out["window_step_ms"][1:])),
                       "busy_ms": b, "idle_pct": 100.0 * max(out["step_ms"] - b, 0.0)
                       / out["step_ms"]}
    # each scraped step against the spread of steps 2-5 over the two runs
    # that differ from it only by the exporter (a median would hide one slow
    # step)
    spread = [ms for label in ("on", "on_again") for ms in runs[label]["window_step_ms"][1:]]
    scraped = [ms for ms, n in zip(runs["exporter_on"]["window_step_ms"][1:], scrapes["per_step"])
               if n]
    cost["exporter_on"].update(scrapes=scrapes, scraped_step_ms=scraped,
                               spread_ms=[min(spread), max(spread)],
                               within_spread=bool(scraped) and max(scraped) <= max(spread))
    print(json.dumps({"telemetry_cost": cost}), flush=True)
    TELEMETRY["cost"] = cost
    if not scrapes["n"] or not scrapes["step_iter_s_seen"] or 0 in scrapes["per_step"]:
        fail(f"the trainer's exporter was not scraped in every step with its step times: "
             f"{scrapes}")


def exporter_run(train, argv):
    """``train.main(argv)`` with ``$PYRECOVER_METRICS_PORT=0``: the port is
    read from the run's ``exporter_started`` event and a thread scrapes
    ``/snapshot.json`` every ``EXPORTER_SCRAPE_S`` seconds while the run
    trains.
    Returns the summary and the scrapes: their count and milliseconds, and
    for each step after the first (a ``train_sync`` to the next) the
    scrapes that overlapped it."""
    import threading

    from pyrecover_tpu_torch import telemetry
    from pyrecover_tpu_torch.telemetry.aggregate import scrape

    mem = telemetry.add_sink(telemetry.MemorySink())
    stop, spans, seen = threading.Event(), [], []

    def scraper():
        port = None
        while not stop.is_set():
            started = [e for e in mem.events if e["event"] == "exporter_started"]
            if started and port is None:
                port = started[0]["port"]
            if port is not None:
                t = time.time()
                try:
                    snap = scrape(f"127.0.0.1:{port}", timeout_s=2.0)
                except OSError:  # the run's unwind stopped the exporter
                    break
                spans.append((t, time.time()))
                seen.append("step_iter_s" in snap["hists"])
            stop.wait(EXPORTER_SCRAPE_S)

    thread = threading.Thread(target=scraper, name="exporter-scraper")
    os.environ["PYRECOVER_METRICS_PORT"] = "0"
    thread.start()
    try:
        out = train.main(argv)
    finally:
        os.environ.pop("PYRECOVER_METRICS_PORT", None)
        stop.set()
        thread.join(timeout=30)
        telemetry.remove_sink(mem)
    syncs = {e["step"]: e["ts"] for e in mem.events if e["event"] == "train_sync"}
    per_step = [sum(1 for t0, t1 in spans if t0 < syncs[k] and t1 > syncs[k - 1])
                for k in range(2, out["end_step"] + 1)]
    times = [1e3 * (t1 - t0) for t0, t1 in spans]
    return out, {"n": len(spans), "every_s": EXPORTER_SCRAPE_S, "step_iter_s_seen": any(seen),
                 "median_ms": float(np.median(times)) if times else None,
                 "max_ms": max(times) if times else None, "per_step": per_step}


def transfer_guard_phase():
    """Three steps of the train line after the first with each dispatch held
    to CUDA's sync-debug mode (``--transfer-guard disallow``): a
    synchronizing call in the step raises `ImplicitTransferError` after an
    ``implicit_transfer`` event. None may fire."""
    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.telemetry import detectors, read_events

    from pyrecover_tpu_torch.config import get_args

    argv = train_argv() + ["--attention-impl", "flash", "--training-steps", "4",
                           "--experiment-name", "guard", "--telemetry",
                           "--transfer-guard", "disallow"]
    path = Path(get_args(argv).checkpoint_dir) / "guard" / "guard_telemetry.jsonl"
    error = None
    try:
        train.main(argv)
    except detectors.ImplicitTransferError as e:
        error = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    found = [e for e in read_events(path) if e["event"] == "implicit_transfer"]
    TELEMETRY["transfer_guard"] = {"guarded_steps": 3, "implicit_transfer": len(found),
                                   "events": found, "error": error}
    print(json.dumps({"transfer_guard": TELEMETRY["transfer_guard"]}), flush=True)
    if found or error:
        fail(f"implicit transfers in the step's dispatch: {found or error}")


def first_batch(config, device):
    """The trainer's first batch: its dataset and sampler through its
    ``DataLoader`` (collated on this thread)."""
    from pyrecover_tpu_torch import train

    ds, pad_token_id, _ = train.build_dataset(config)
    loader = train.build_loader(config, ds, pad_token_id, train.build_sampler(config, len(ds)),
                                device, prefetch=0)
    return next(loader)[1]


def attention_check(fa, first_loss, batch=None, label="train"):
    """flash against sdpa inside the model, from the trainer's initial
    weights and first batch (``train.build_model``, `first_batch`), or the
    given ``batch`` (packed rows carry segment ids, which reach the kernels).
    With bf16 compute (the path's): the step-1 losses, and the flash loss
    against the trainer's own first loss (when ``first_loss`` is given); the
    gradients are printed; and the
    forward, dq and dk/dv kernels against their plain versions on the real
    q, k, v and dout of layer 0 and of the last layer
    (``real_activation_check``).
    With fp32 compute: the losses and every layer's wq/wk/wv/wo gradient,
    which the forward, dq and dk/dv kernels all feed. Each flash run must
    launch each kernel once per layer, the bf16 one on the tensor-core
    instances."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import forward_hidden_with_aux
    from pyrecover_tpu_torch.train_state import chunked_ce

    config = get_args(train_argv() + ["--attention-impl", "flash"])
    device = train.resolve_device(config.device)
    model = train.build_model(config, device)
    if batch is None:
        batch = first_batch(config, device)
    layers = config.model.n_layers
    names = ("wq", "wk", "wv", "wo")
    loss, grads, captured = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("flash", "sdpa"):
            model.config = dataclasses.replace(
                config.model, compute_dtype=dtype, attention_impl=impl)
            model.zero_grad(set_to_none=True)
            fa.reset_launch_counts()
            real = fa.flash_attention
            if (dtype, impl) == ("bfloat16", "flash"):
                fa.flash_attention = capturing(real, (0, layers - 1), captured)
            try:
                hidden, _ = forward_hidden_with_aux(model, batch["inputs"], batch.get("segments"))
                ce, _ = chunked_ce(model, hidden, batch["labels"], config.loss_chunk_size)
                ce.backward()
            finally:
                fa.flash_attention = real
            n = layers if impl == "flash" else 0
            tc = n if dtype == "bfloat16" else 0
            want = {"fwd": n, "dq": n, "dkv": n,
                    "fwd_wgmma": tc, "dq_wgmma": tc, "dkv_wgmma": tc}
            if fa.launch_counts() != want:
                fail(f"{dtype} {impl} launched {fa.launch_counts()}, want {want}")
            loss[f"{dtype} {impl}"] = ce.item()
            grads[dtype, impl] = [[getattr(layer, n).grad.clone() for n in names]
                                  for layer in model.layers]
            del hidden, ce
    by_layer, worst = {}, {}
    for dtype in ("bfloat16", "float32"):
        by_layer[dtype] = [[rel_norm_err(f, s) for f, s in zip(fl, sl)]
                           for fl, sl in zip(grads[dtype, "flash"], grads[dtype, "sdpa"])]
        worst[dtype] = {n: max(e[i] for e in by_layer[dtype]) for i, n in enumerate(names)}
    print(json.dumps({"attention_check": {
        "batch": label, "segments": "segments" in batch,
        "loss": loss, "trainer_first_loss": first_loss,
        "grad_rel_norm_err_max_over_layers": worst, "float32_limit": FP32_GRAD_REL_NORM,
        "grad_rel_norm_err_by_layer": by_layer,
    }}), flush=True)
    worst = worst["float32"]
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    real_activation_check(fa, captured)
    checks = [
        ("bfloat16 flash", "bfloat16 sdpa", loss["bfloat16 sdpa"], BF16_LOSS_RTOL),
        ("float32 flash", "float32 sdpa", loss["float32 sdpa"], FP32_LOSS_RTOL),
    ]
    if first_loss is not None:
        checks.append(("bfloat16 flash", "trainer's first loss", first_loss, SAME_LOSS_RTOL))
    for run, what, other, rtol in checks:
        if not abs(loss[run] - other) <= rtol * abs(other):
            fail(f"{run} loss {loss[run]} vs {what} {other} (rtol {rtol})")
    bad = {n: e for n, e in worst.items() if not e <= FP32_GRAD_REL_NORM}
    if bad:
        fail(f"fp32 flash vs sdpa attention gradients beyond {FP32_GRAD_REL_NORM}: {bad}")


def capturing(flash_attention, layers, captured):
    """``flash_attention`` that also keeps, for the calls numbered in
    ``layers`` (one call per layer, in order), the q, k, v it was given (after
    RoPE), its keyword arguments and the gradient that reaches its output."""
    calls = []

    def wrapped(q, k, v, **kw):
        i = len(calls)
        calls.append(i)
        out = flash_attention(q, k, v, **kw)
        if i in layers:
            rec = captured[i] = {"qkv": [x.detach().clone() for x in (q, k, v)], "kw": kw}
            out.register_hook(lambda g: rec.__setitem__("dout", g.detach().clone()))
        return out

    return wrapped


def real_activation_check(fa, captured):
    """The forward, dq and dk/dv kernels against their plain versions on the
    captured activations of the model's first and last layers, under the
    kernel phase's bf16 and lse limits. Real activations give peakier
    softmax rows than ``randn`` inputs."""
    import torch

    failures = []
    for layer, rec in sorted(captured.items()):
        q, k, v = (x.contiguous() for x in rec["qkv"])
        seg = rec["kw"].get("segment_ids")
        seg = None if seg is None else seg.to(torch.int32).contiguous()
        causal = rec["kw"].get("causal", True)
        scale = rec["kw"].get("scale") or 1.0 / math.sqrt(q.shape[-1])
        dout = rec["dout"].contiguous()
        label = f"layer {layer} ({q.dtype}, {tuple(q.shape)}{', segments' if seg is not None else ''})"
        routes = ", ".join(f"{key} {fa.kernel_route(key, q.dtype, q.shape[-1])}"
                           for key in ("fwd", "dq", "dkv"))
        print(f"real activations, {label}: route {routes}", flush=True)
        out_r, lse_r = fa.flash_fwd_reference(q, k, v, seg, causal, scale)
        out_k, lse_k = fa.flash_fwd(q, k, v, seg, causal, scale)
        bwd = (q, k, v, seg, out_r, lse_r, dout, causal, scale)
        dq_r = fa.flash_bwd_dq_reference(*bwd)
        dq_k = fa.flash_bwd_dq(*bwd)
        dk_r, dv_r = fa.flash_bwd_dkv_reference(*bwd)
        dk_k, dv_k = fa.flash_bwd_dkv(*bwd)
        torch.cuda.synchronize()
        check_outputs(label, [("out", out_k, out_r, BF16_TOL), ("lse", lse_k, lse_r, LSE_TOL),
                              ("dq", dq_k, dq_r, BF16_TOL), ("dk", dk_k, dk_r, BF16_TOL),
                              ("dv", dv_k, dv_r, BF16_TOL)], failures)
    if len(captured) != 2 or failures:
        fail(f"real-activation kernel check: captured layers {sorted(captured)}, "
             f"failures {failures}")


class PackedRows:
    """Packed training rows as ``PackedParquetTextDataset.__getitem__``
    returns them: ``(tokens, segment_ids)``, each ``(seq_len + 1,)`` int32,
    cut in order from one seeded stream of documents of
    ``PACKED_DOC_LENS`` tokens (random ids, the last one ``PACKED_EOS``),
    segments numbered from 0 within each row. The stream stops
    ``PACKED_TAIL`` tokens short of the last row's end, which is pad (0) in
    segment ``PAD_SEGMENT``."""

    def __init__(self, n_rows, seq_len, vocab_size, seed):
        rng = np.random.default_rng(seed)
        self.n_rows, self.width = n_rows, seq_len + 1
        total = n_rows * self.width - PACKED_TAIL
        lens = []
        while sum(lens) < total:
            lens.append(int(rng.integers(PACKED_DOC_LENS[0], PACKED_DOC_LENS[1] + 1)))
        lens[-1] -= sum(lens) - total
        self.cum = np.concatenate([[0], np.cumsum(lens)])
        self.stream = rng.integers(PACKED_EOS + 1, vocab_size, total).astype(np.int32)
        self.stream[self.cum[1:] - 1] = PACKED_EOS

    def __len__(self):
        return self.n_rows

    def __getitem__(self, idx):
        from pyrecover_tpu_torch.data import PAD_SEGMENT

        start = (int(idx) % self.n_rows) * self.width
        take = min(start + self.width, len(self.stream)) - start
        tokens = np.zeros(self.width, np.int32)
        segs = np.full(self.width, PAD_SEGMENT, np.int32)
        tokens[:take] = self.stream[start:start + take]
        docs = np.searchsorted(self.cum, np.arange(start, start + take), side="right") - 1
        segs[:take] = docs - docs[0]
        return tokens, segs


def trainer_phase():
    """The trainer's slice at llama-1b's full width (module docstring, item
    6), in its own process under deterministic algorithms: remat policies,
    packed rows through the loader, eval and the profile window. Prints
    one ``trainer`` line; any failed check exits non-zero. The device is
    the one `train_argv` names."""
    import dataclasses

    import torch

    torch.use_deterministic_algorithms(True)
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.data import PAD_SEGMENT, DataLoader, StatefulSampler
    from pyrecover_tpu_torch.ops import flash_attention as fa
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import make_train_step
    from pyrecover_tpu_torch.utils.remat import resolve_remat_policy

    config = get_args(train_argv() + ["--attention-impl", "flash"])
    device = train.resolve_device(config.device)
    card, layers = card_line(), config.model.n_layers
    print(f"trainer phase on {card}", flush=True)
    failures, report = [], {"card": card, "layers": layers, "batch_size": BATCH}

    def check(what, ok, detail):
        print(f"  {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    def want_counts(fwd, bwd):
        return {"fwd": fwd, "dq": bwd, "dkv": bwd,
                "fwd_wgmma": fwd, "dq_wgmma": bwd, "dkv_wgmma": bwd}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # -- remat: the same seed and data at each policy ------------------------
    runs = {}
    argv = train_argv() + ["--attention-impl", "flash", "--training-steps", str(REMAT_STEPS),
                           "--training-samples", str(BATCH * REMAT_STEPS)]
    for policy in ("none", "save-attn", "full"):
        fa.reset_launch_counts()
        out = train.main(argv + ([] if policy == "none" else ["--remat", "--remat-policy", policy]))
        n = layers * REMAT_STEPS
        runs[policy] = {"losses": out["losses"], "step_ms": out["step_ms"],
                        "window_step_ms": out["window_step_ms"],
                        "peak_mem_gib": out["peak_mem_gib"], "launches": fa.launch_counts()}
        release()
        want = want_counts(2 * n if policy == "full" else n, n)
        check(f"remat {policy}: launches", runs[policy]["launches"] == want,
              f"{runs[policy]['launches']} (want {want}); peak {out['peak_mem_gib']} GiB, "
              f"{out['step_ms']} ms a step")
    for policy in ("save-attn", "full"):
        pairs = list(zip(runs[policy]["losses"], runs["none"]["losses"]))
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        runs[policy]["bit_equal_to_none"] = all(a == b for a, b in pairs)
        runs[policy]["loss_rel_diff_to_none"] = rel
        check(f"remat {policy}: losses against none", len(pairs) == REMAT_STEPS
              and rel <= REMAT_LOSS_RTOL,
              f"bit-equal {runs[policy]['bit_equal_to_none']}, max rel diff {rel:.3e} "
              f"(limit {REMAT_LOSS_RTOL:.0e})")
    auto = resolve_remat_policy(config.model, batch_size=BATCH, seq_len=config.sequence_length,
                                loss_chunk_size=config.loss_chunk_size, device=device)
    runs["auto"] = {"policy": auto.policy, "fits": auto.fits, "device_kind": auto.device_kind,
                    "budget_gib": auto.budget_bytes / 2**30 if auto.budget_bytes else None,
                    "table_gib": {k: v / 2**30 for k, v in auto.table.items()},
                    "suggested_batch_size": auto.suggested_batch_size}
    print(f"  remat auto: {runs['auto']}", flush=True)
    report["remat"] = runs

    # -- packed rows through the DataLoader ----------------------------------
    ds = PackedRows(PACKED_ROWS, config.sequence_length, config.model.vocab_size, seed=0)
    loader = DataLoader(ds, StatefulSampler(len(ds), BATCH, seed=0), 0, device=device,
                        prefetch=2, num_workers=2)
    try:
        _, batch = next(loader)
        docs = [int(ds[i][1].max()) + 1 for i in range(len(ds))]
        tail = int((ds[len(ds) - 1][1] == PAD_SEGMENT).sum())
        check("packed rows", "segments" in batch and tail == PACKED_TAIL
              and int((batch["segments"] == PAD_SEGMENT).sum()) == PACKED_TAIL - 1,
              f"documents a row {docs}, pad tail {tail} positions on the last row")
        attention_check(fa, None, batch=batch, label="packed")
        release()
        model = train.build_model(config, device)
        optimizer, _ = build_optimizer(config, model.parameters())
        step_fn = make_train_step(model, optimizer, loss_chunk_size=config.loss_chunk_size)
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(PACKED_STEPS):
            _, b = next(loader)
            sync()
            t0 = time.monotonic()
            losses.append(step_fn(b)["loss"].item())
            step_ms.append((time.monotonic() - t0) * 1e3)
    finally:
        loader.stop()
    counts = fa.launch_counts()
    del model, optimizer, step_fn
    release()
    check("packed steps", all(math.isfinite(x) for x in losses)
          and counts == want_counts(layers * PACKED_STEPS, layers * PACKED_STEPS),
          f"losses {losses}, step ms {step_ms}, launches {counts}")
    report["packed"] = {"documents_a_row": docs, "pad_tail": tail, "losses": losses,
                        "step_ms": step_ms, "launches": counts}

    # -- eval: flash against sdpa on the same weights ------------------------
    eval_cfg = get_args(train_argv() + ["--attention-impl", "flash", "--eval-frequency",
                                        str(EVAL_EVERY), "--eval-samples", str(EVAL_SAMPLES)])
    model = train.build_model(eval_cfg, device)
    run_eval = train.build_eval_runner(eval_cfg, eval_cfg.model, 0, device)
    ev, ev_ms = {}, {}
    try:
        for impl in ("flash", "sdpa", "flash"):  # the second flash call is timed warm
            model.config = dataclasses.replace(eval_cfg.model, attention_impl=impl)
            sync()
            t0 = time.monotonic()
            ev[impl] = run_eval(model)
            ev_ms[impl] = (time.monotonic() - t0) * 1e3 / run_eval.batches
    finally:
        run_eval.loader.stop()
    del model
    release()
    check("eval: flash against sdpa", abs(ev["flash"] - ev["sdpa"]) <= BF16_LOSS_RTOL * ev["sdpa"],
          f"{ev['flash']:.6f} vs {ev['sdpa']:.6f} (rtol {BF16_LOSS_RTOL}) over "
          f"{run_eval.batches} batches; {ev_ms['flash']:.1f} ms a batch (sdpa "
          f"{ev_ms['sdpa']:.1f})")

    # -- the trainer with eval and the profile window ------------------------
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    fa.reset_launch_counts()
    out = train.main(train_argv() + [
        "--attention-impl", "flash", "--training-steps", str(EVAL_STEPS),
        "--training-samples", str(BATCH * EVAL_STEPS), "--eval-frequency", str(EVAL_EVERY),
        "--eval-samples", str(EVAL_SAMPLES), "--profile", "--profile-step-start", "2",
        "--profile-step-end", "3", "--profile-dir", str(PROFILE_DIR)])
    release()
    evals = out["evals"]
    check("trainer eval", [e["step"] for e in evals] == list(range(EVAL_EVERY, EVAL_STEPS + 1,
                                                                     EVAL_EVERY))
          and all(math.isfinite(e["loss"]) for e in evals),
          f"{[(e['step'], e['loss'], e['seconds']) for e in evals]}, "
          f"{out['eval_batches']} batches each")
    trace = Path(out["profile_trace"] or PROFILE_DIR / "missing")
    text = trace.read_text() if trace.exists() else ""
    found = [name for name in FLASH_KERNEL_NAMES if name in text]
    check("profile trace", found == list(FLASH_KERNEL_NAMES),
          f"{trace.name if trace.exists() else 'no trace'} ({len(text)} bytes) names {found}")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    report["eval"] = {"same_weights": ev, "ms_per_batch": ev_ms, "trainer_evals": evals,
                      "trainer_eval_ms_per_batch": [1e3 * e["seconds"] / out["eval_batches"]
                                                    for e in evals],
                      "trainer_step_ms": out["step_ms"], "launches": fa.launch_counts()}
    report["profile"] = {"trace": trace.name, "bytes": len(text), "kernels": found}
    print(json.dumps({"trainer": report}), flush=True)
    if failures:
        fail("trainer phase: " + "; ".join(failures))


def run_trainer_phase():
    """`trainer_phase` in a subprocess (``chip_smoke.py --trainer-phase``),
    with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts there; its
    output is echoed."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trainer-phase"],
                          cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                          text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
        fail(f"trainer phase exited {proc.returncode}")
    print(f"trainer phase took {time.monotonic() - t0:.1f} s", flush=True)


def page_cache_share(path):
    """The share of ``path``'s pages in the page cache (``mincore``), or None
    where it cannot be read."""
    import ctypes
    import mmap

    size = os.path.getsize(path)
    if not size:
        return None
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    pages = (size + mmap.PAGESIZE - 1) // mmap.PAGESIZE
    with open(path, "rb") as f:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, f.fileno(), 0)
        if addr is None or addr == ctypes.c_void_p(-1).value:
            return None
        try:
            vec = (ctypes.c_ubyte * pages)()
            if libc.mincore(addr, size, vec) != 0:
                return None
            return float((np.frombuffer(vec, np.uint8) & 1).mean())
        finally:
            libc.munmap(addr, size)


def state_bytes(layers):
    """Bytes of a llama-1b checkpoint's tensors at ``layers`` layers: fp32
    parameters, mu and nu (counted on the meta device, nothing allocated)."""
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer

    config = get_args(train_argv() + ["--model-layers", str(layers)]).model
    return 12 * sum(p.numel() for p in Transformer(config, device="meta").parameters())


def trainer_child(argv):
    """One trainer run, as the checkpoint phase starts it in a subprocess:
    ``train.main(argv)`` under deterministic algorithms (the parent sets
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts), then its summary and
    the flash launch counts as one JSON line. ``argv`` split by ``--then``
    is several runs, one after the other in this process, each with its
    summary line: the process group (when the first run names one) is
    joined once for all of them, so the runs pay one process start, and
    each summary carries ``params_digests``: the sharded engine's digests of
    the run's final ``.params`` leaves, taken in memory (no checkpoint)."""
    import torch

    rank = os.environ.get("RANK", "0")
    # a started-by-torchrun rank's own variables (`run_torchrun`)
    os.environ.update(json.loads(os.environ.get("CHIP_SMOKE_RANK_ENV", "{}")).get(rank, {}))
    torch.use_deterministic_algorithms(True)
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.ops import flash_attention as fa
    from pyrecover_tpu_torch.parallel import mesh

    runs = [[]]
    for arg in argv:
        if arg == "--then":
            runs.append([])
        else:
            runs[-1].append(arg)
    models = []
    if len(runs) > 1:
        from pyrecover_tpu_torch.checkpoint.sharded import _leaf_digest
        from pyrecover_tpu_torch.train_state import param_leaves

        config = get_args(runs[0])
        mesh.initialize_distributed(required=config.distributed, backend=config.dist_backend,
                                    device_type=config.device)
        build = train.build_model
        train.build_model = lambda *a: models.append(build(*a)) or models[-1]
    for run in runs:
        fa.reset_launch_counts()
        out = train.main(run)
        out["launches"] = fa.launch_counts()
        if models:
            out["params_digests"] = {leaf.path: _leaf_digest(leaf.parts)
                                     for leaf in param_leaves(models.pop())}
        print("trainer summary: " + json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if len(runs) > 1:
        mesh.destroy_distributed()
    if os.environ.get("CHIP_SMOKE_SUMMARY_DIR"):
        path = Path(os.environ["CHIP_SMOKE_SUMMARY_DIR"]) / f"rank{rank}.json"
        path.write_text(json.dumps(out))


def emergency_child(argv):
    """Phase E's process: ``train.train`` for the first ``--training-steps``
    of ``argv`` (its final save lands in the emergency tier), then the disk
    tier deleted (``<exp>/chunks`` and every manifest), then ``train.train``
    again to ``CKPT_STEPS`` with ``--resume-from-checkpoint latest``: the
    second call must resume from RAM. Prints the second call's summary, the
    first's under ``first``."""
    import torch

    torch.use_deterministic_algorithms(True)
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args

    def pinned():  # the caching host allocator's pinned bytes, cached blocks included
        return torch.cuda.host_memory_stats().get("allocated_bytes.current")

    config = get_args(argv)
    exp = Path(config.checkpoint_dir) / config.experiment_name
    first = train.main(argv)
    first["host_pinned_bytes"] = pinned()
    for p in exp.glob("*.zs.json"):
        p.unlink()
    shutil.rmtree(exp / "chunks")
    second = train.main(argv + ["--training-steps", str(CKPT_STEPS),
                                "--resume-from-checkpoint", "latest"])
    second["host_pinned_bytes"] = pinned()
    second["first"] = {k: first[k] for k in ("end_step", "saves", "peak_mem_gib",
                                             "host_pinned_bytes")}
    print("trainer summary: " + json.dumps(second), flush=True)


def start_trainer(label, argv, timeout=400, plan=None, mode="--trainer"):
    """Run `trainer_child` (or, with ``mode`` ``--emergency-child``,
    `emergency_child`) in a subprocess, under the fault plan ``plan`` when
    given (``$PYRECOVER_FAULT_PLAN``). Returns the process, its summary
    (None when it did not finish) and its wall seconds. Its log lines about
    checkpoints are echoed."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    env.pop("PYRECOVER_FAULT_PLAN", None)
    if plan is not None:
        env["PYRECOVER_FAULT_PLAN"] = json.dumps(plan)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), mode, *argv],
                          cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.monotonic() - t0
    keep = ("checkpoint", "Resume", "Stopping", "Finished", "Stopped", "step ", "Quarantined",
            "retry", "Error", "emergency", "ckpt_backpressure", "elastic")
    for line in proc.stderr.splitlines():
        if any(k in line for k in keep):
            print(f"  [{label}] {line[24:] if line[:2] == '20' else line}", flush=True)
    summary = [line for line in proc.stdout.splitlines() if line.startswith("trainer summary: ")]
    summary = json.loads(summary[0][len("trainer summary: "):]) if summary else None
    return proc, summary, wall


def run_trainer(label, argv, timeout=400, mode="--trainer"):
    """`start_trainer`, failing the script unless the run finished; returns
    its summary and wall seconds."""
    proc, summary, wall = start_trainer(label, argv, timeout, mode=mode)
    if proc.returncode != 0 or summary is None:
        print(proc.stderr[-6000:], flush=True)
        fail(f"trainer run {label} exited {proc.returncode}")
    return summary, wall


def loss_rows(exp):
    with open(exp / f"{exp.name}_loss_log.csv", newline="") as f:
        return list(csv.reader(f))


def file_leaf_chunks(path, chunk_bytes):
    """``[(leaf path, chunk digests)]`` of a ``PYRCKPT2`` file's leaves: the
    content addresses a zerostall save of the same state gives them."""
    from pyrecover_tpu_torch.checkpoint.vanilla import _frame_spans, _read_header
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import leaf_chunk_digests

    out = []
    with open(path, "rb") as f:
        meta, off = _read_header(f)
        for i, _, start, n in _frame_spans(f, meta, off, os.fstat(f.fileno()).st_size):
            f.seek(start)
            out.append((meta["paths"][i], leaf_chunk_digests(
                np.frombuffer(f.read(n), np.uint8), chunk_bytes)))
    return out


def manifest_chunks(path):
    """``[(leaf path, chunk digests)]`` of a zerostall manifest."""
    doc = json.loads(Path(path).read_text())
    return [(e["path"], e["chunks"]) for e in doc["leaves"]]


def served_digests(path, config):
    """``load_serving_params`` of ``path`` on `train_argv`'s device: each served
    parameter's BLAKE2b-128 digest over its bytes (matrices in the compute
    dtype, as served), in order, and the restore's info."""
    import hashlib

    import torch

    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.serving import load_serving_params

    device = get_args(train_argv()).device
    model, info = load_serving_params(path, config, device=device)
    digests = [(name, hashlib.blake2b(p.detach().contiguous().reshape(-1).view(torch.uint8)
                                      .cpu().numpy(), digest_size=16).hexdigest())
               for name, p in model.named_parameters()]
    del model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return digests, info


def checkpoint_phase():
    """Train, stop at a deadline, resume, and hold the resumed run's final
    checkpoint to a straight run's, byte for byte (see the module
    docstring, item 7). Returns B2's final checkpoint and the depth (the
    caller removes ``CKPT_DIR`` after the serving phase)."""
    from pyrecover_tpu_torch.preempt import read_requeue_marker

    card = card_line()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    free = shutil.disk_usage(CKPT_DIR).free
    layers = CKPT_LAYERS
    while layers > 1 and 3.1 * state_bytes(layers) > free:  # cut depth, never width
        layers -= 1
    print(f"checkpoint phase on {card}: {free / 1e9:.1f} GB free under {CKPT_DIR.parent}, "
          f"{state_bytes(layers) / 1e9:.2f} GB a checkpoint", flush=True)
    print(f"chip_smoke: checkpoint phase at {layers} of llama-1b's {LAYERS} layers (full "
          f"width){'' if layers == CKPT_LAYERS else ': the disk cannot hold three'}", flush=True)

    from pyrecover_tpu_torch.telemetry import doctor

    def argv(name, *extra):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(layers),
            "--training-steps", str(CKPT_STEPS), "--checkpoint-dir", str(CKPT_DIR),
            "--experiment-name", name, "--checkpoint-frequency", str(CKPT_EVERY),
            "--max-kept-checkpoints", "1", "--verify-checkpoints", "--log-loss-to-csv",
            "--telemetry", "--hang-watchdog-timeout", str(CKPT_WATCHDOG_S), *extra,
        ]

    telemetry_problems, verdicts, streams = [], {}, {}

    def read_run(label, exp, first, last, final_ckpt, want_class):
        """This run's stream checks and the doctor's verdict on the
        experiment directory as the run left it."""
        segment = run_segment(exp / f"{exp.name}_telemetry.jsonl")
        facts, problems = check_stream(label, segment, first, last, final_ckpt)
        report = doctor.diagnose(exp)
        verdicts[label] = report["classification"]
        if report["classification"] != want_class:
            problems.append(f"doctor says {report['classification']} ({report['detail']}), "
                            f"want {want_class}")
        facts["doctor"] = report["classification"]
        streams[label] = facts
        telemetry_problems.extend(f"{label}: {p}" for p in problems)
        return segment

    final = f"ckpt_{CKPT_STEPS}_final.ckpt"
    a, a_wall = run_trainer("A", argv("a"))
    exp_a = CKPT_DIR / "a"
    if (a["end_step"], a["stopped_early"]) != (CKPT_STEPS, False) or not (exp_a / "DONE").exists():
        fail(f"run A ended at step {a['end_step']}, stopped early {a['stopped_early']}")
    digest = (exp_a / (final + ".sha256")).read_text()
    rows_a = loss_rows(exp_a)
    read_run("A", exp_a, 0, CKPT_STEPS, exp_a / final, "healthy")
    # A's end state stays for the zerostall phase: its leaves' content
    # addresses, its loss CSV, its background save's blocking window, and
    # the file, which the serving check reads
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import chunk_bytes_default

    kept = CKPT_DIR / "a_final.ckpt"
    os.replace(exp_a / final, kept)
    ZS_REF.update(layers=layers, a_file=kept, rows_a=rows_a, a_summary=a,
                  a_chunks=file_leaf_chunks(kept, chunk_bytes_default()),
                  vanilla_bg_blocking_s=[sv["blocking_s"] for sv in a["saves"][:-1]])
    shutil.rmtree(exp_a)

    b1, b1_wall = run_trainer("B1", argv("b", "--timeaware-checkpointing", "--job-end-time",
                                         str(time.time() + 1.0), "--preempt-check-interval", "2"))
    exp_b = CKPT_DIR / "b"
    k = b1["end_step"]
    marker = read_requeue_marker(exp_b) or {}
    if not (b1["stopped_early"] and 0 < k < CKPT_STEPS and (exp_b / f"ckpt_{k}_final.ckpt").exists()
            and (exp_b / "REQUEUE").exists() and marker.get("step") == k):
        fail(f"run B1 did not stop early with ckpt_<k>_final and REQUEUE: end step {k}, "
             f"marker {marker}, files {sorted(p.name for p in exp_b.iterdir())}")

    seg_b1 = read_run("B1", exp_b, 0, k, exp_b / f"ckpt_{k}_final.ckpt", "preemption")
    if "preempt_stop" not in [e["event"] for e in seg_b1]:
        telemetry_problems.append("B1: no preempt_stop")

    # what B2's pre-check and load will read: just written by B1, so it may
    # still be in the page cache
    cached_b1 = page_cache_share(exp_b / f"ckpt_{k}_final.ckpt")
    b2, b2_wall = run_trainer("B2", argv("b", "--resume-from-checkpoint", "latest"))
    seg_b2 = read_run("B2", exp_b, k, CKPT_STEPS, exp_b / final, "healthy")
    if not [e for e in seg_b2 if e["event"] == "resume" and e["step"] == k]:
        telemetry_problems.append(f"B2: no resume event at step {k}")
    want = {key: layers * (CKPT_STEPS - k) for key in
            ("fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")}
    rows_b = loss_rows(exp_b)
    checks = {
        "B2 resumed at B1's stop": b2["start_step"] == k,
        f"B2 ended at step {CKPT_STEPS} with DONE": b2["end_step"] == CKPT_STEPS
        and not b2["stopped_early"] and (exp_b / "DONE").exists()
        and not (exp_b / "REQUEUE").exists(),
        "B2's final checkpoint equals A's (sidecar digests)":
            (exp_b / (final + ".sha256")).read_text() == digest,
        "loss CSV: one row per step, equal to A's":
            [r[0] for r in rows_b] == ["step"] + [str(i) for i in range(1, CKPT_STEPS + 1)]
            and rows_b == rows_a,
        "every flash launch in B2 on a tensor-core instance": b2["launches"] == want,
        "sidecars are xxh64tree (the native I/O library loaded)":
            digest.startswith("xxh64tree:")
            and (exp_b / (final + ".sha256")).read_text().startswith("xxh64tree:"),
        "telemetry: every stream whole, doctor healthy / preemption / healthy":
            not telemetry_problems,
    }
    TELEMETRY["checkpoint"] = {**streams, "hang_watchdog_s": CKPT_WATCHDOG_S,
                               "problems": telemetry_problems}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    nbytes = (exp_b / final).stat().st_size
    saves = [{"run": run, "file": Path(sv["path"]).name, "blocking_s": sv["blocking_s"],
              "write_s": sv["write_s"], "write_gb_per_s": sv["bytes"] / sv["write_s"] / 1e9}
             for run, summary in (("A", a), ("B1", b1), ("B2", b2)) for sv in summary["saves"]]
    print(json.dumps({"checkpoint": {
        "card": card, "layers": layers, "bytes": nbytes, "digest": digest,
        "stop_step": k, "saves": saves,
        "load_s": b2["ckpt_load_s"], "precheck_s": b2["ckpt_precheck_s"],
        "page_cache_share_of_loaded_file": cached_b1,
        "with_sha256_sidecars": SHA256_SIDECAR_FIGURES,
        "resume_to_first_step_s": b2["first_step_s"],
        "process_wall_s": {"A": a_wall, "B1": b1_wall, "B2": b2_wall},
        "step_ms": {"A": a["step_ms"], "B2": b2["step_ms"]},
        "launches": {"A": a["launches"], "B1": b1["launches"], "B2": b2["launches"]},
        "goodput": {"A": a["goodput"], "B1": b1["goodput"], "B2": b2["goodput"]},
    }}), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        fail("checkpoint phase: " + "; ".join(bad))
    return exp_b / final, layers


def zerostall_phase():
    """The zerostall engine on the card (module docstring, item 12): Z-A,
    Z-B1 and Z-B2 at the checkpoint phase's depth, E (a restore from RAM with
    the disk tier deleted), P (the autopilot), serving from Z-A's manifest,
    and Z-F at ``ZF_LAYERS``. Returns the ``zerostall`` line."""
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.preempt import read_requeue_marker
    from pyrecover_tpu_torch.telemetry import doctor, read_events

    card = card_line()
    shutil.rmtree(ZS_DIR, ignore_errors=True)
    ZS_DIR.mkdir(parents=True)
    layers = ZS_REF["layers"]
    final = f"ckpt_{CKPT_STEPS}_final.zs.json"
    checks, verdicts, runs = {}, {}, {}

    def argv(name, *extra, depth=layers, steps=CKPT_STEPS, every=ZS_EVERY):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(depth),
            "--training-steps", str(steps), "--checkpoint-dir", str(ZS_DIR),
            "--experiment-name", name, "--checkpoint-frequency", str(every),
            "--max-kept-checkpoints", "1", "--checkpoint-engine", "zerostall",
            "--log-loss-to-csv", "--telemetry", "--hang-watchdog-timeout", str(CKPT_WATCHDOG_S),
            *extra]

    def go(label, args, want_class, mode="--trainer", timeout=400):
        summary, wall = run_trainer(label, args, timeout=timeout, mode=mode)
        exp = ZS_DIR / args[args.index("--experiment-name") + 1]
        verdicts[label] = doctor.diagnose(exp)["classification"]
        if verdicts[label] != want_class:
            checks[f"{label}: doctor says {want_class}"] = False
        runs[label] = {"summary": summary, "wall_s": wall, "exp": exp}
        return summary, exp

    def saves(label):
        return [{"file": Path(sv["path"]).name, **{k: sv.get(k) for k in (
            "blocking_s", "alloc_s", "backpressure_s", "snapshot_s", "shadow_s", "bytes",
            "pinned_bytes")}, "reuse": sv.get("reuse")} for sv in runs[label]["summary"]["saves"]]

    # -- Z-A: the straight run ----------------------------------------------
    za, exp_za = go("Z-A", argv("za"), "healthy")
    za_chunks = manifest_chunks(exp_za / final)
    ZS_REF["za_chunks"] = za_chunks
    checks["Z-A ends at 4 with DONE"] = (za["end_step"] == CKPT_STEPS and not za["stopped_early"]
                                         and (exp_za / "DONE").exists())
    checks["Z-A's final state = vanilla A's, leaf by leaf (content addresses)"] = (
        za_chunks == ZS_REF["a_chunks"])
    checks["Z-A loss CSV: one row a step, equal to vanilla A's"] = (
        loss_rows(exp_za) == ZS_REF["rows_a"])
    checks["every Z-A save moved its snapshot through pinned buffers"] = all(
        sv["pinned_bytes"] > 0 for sv in za["saves"])
    # serving from Z-A's manifest against the vanilla reader of A's file
    config = get_args(train_argv() + ["--model-layers", str(layers)]).model
    served_v, info_v = served_digests(ZS_REF["a_file"], config)
    served_z, info_z = served_digests(exp_za / final, config)
    checks["serving: Z-A's manifest = vanilla A's file, digest for digest"] = (
        served_z == served_v and info_z["engine"] == "zerostall")
    ZS_REF["a_file"].unlink()
    first, steady = za["saves"][0], za["saves"][1:-1]
    # the engine's purpose: a steady-state save blocks less than the vanilla
    # background save of the same state in this run
    checks["a steady-state zerostall save blocks less than the vanilla background save"] = (
        bool(steady) and max(sv["blocking_s"] for sv in steady) < min(
            ZS_REF["vanilla_bg_blocking_s"]))

    res = {}

    def zb_chain():
        """Z-B1, stopped by a deadline, and Z-B2, its `latest` resume from
        disk (the vanilla B runs' save interval)."""
        b1, exp_zb = go("Z-B1", argv("zb", "--timeaware-checkpointing", "--job-end-time",
                                     str(time.time() + 1.0), "--preempt-check-interval", "2",
                                     every=CKPT_EVERY), "preemption")
        k = b1["end_step"]
        marker = read_requeue_marker(exp_zb) or {}
        checks["Z-B1 stops early with ckpt_<k>_final and REQUEUE"] = (
            b1["stopped_early"] and 0 < k < CKPT_STEPS
            and (exp_zb / f"ckpt_{k}_final.zs.json").exists() and marker.get("step") == k)
        b2, _ = go("Z-B2", argv("zb", "--resume-from-checkpoint", "latest", every=CKPT_EVERY),
                   "healthy")
        checks["Z-B2 resumes from Z-B1's manifest and ends with DONE"] = (
            b2["start_step"] == k
            and str(b2["resumed_from"]).endswith(f"ckpt_{k}_final.zs.json")
            and b2["end_step"] == CKPT_STEPS and (exp_zb / "DONE").exists()
            and not (exp_zb / "REQUEUE").exists())
        checks["Z-B2's final state = Z-A's (chunk digests)"] = (
            manifest_chunks(exp_zb / final) == za_chunks)
        checks["Z-B2 loss CSV = Z-A's"] = loss_rows(exp_zb) == loss_rows(exp_za)
        res["b2"] = b2

    def emergency_run():
        """E: 2 steps, the disk tier deleted, the `latest` resume from RAM."""
        e, exp_e = go("E", argv("e", "--training-steps", "2", every=2), "healthy",
                      mode="--emergency-child")
        e_events = [ev for ev in read_events(exp_e / "e_telemetry.jsonl")
                    if ev["event"] in ("emergency_restore", "resume")]
        checks["E resumes from RAM at step 2 and ends equal to Z-A"] = (
            e["resumed_from"] == "<emergency-ram>" and e["start_step"] == 2
            and [ev["step"] for ev in e_events if ev["event"] == "emergency_restore"] == [2]
            and manifest_chunks(exp_e / final) == za_chunks)
        one_set = e["saves"][0]["pinned_bytes"] // 2
        checks["E: after each train call the process keeps pinned only the emergency "
               "record's buffer set"] = all(
            pinned is not None and pinned <= one_set + PINNED_SLACK
            for pinned in (e["first"]["host_pinned_bytes"], e["host_pinned_bytes"]))
        res["e"] = e

    def autopilot_run():
        """P: the autopilot over 6 steps, ceiling P_CEILING."""
        p_sum, exp_p = go("P", argv("p", "--ckpt-auto-ceiling", str(P_CEILING), steps=P_STEPS,
                                    every="auto"), "healthy")
        p_events = read_events(exp_p / "p_telemetry.jsonl")
        recs = [ev for ev in p_events if ev["event"] == "ckpt_policy"]
        periodic = [ev["step"] for ev in p_events
                    if ev["event"] == "ckpt_saved" and not ev["final"]]
        want, nxt = [], recs[0]["interval_steps"] if recs else None
        for r in recs[1:]:
            want.append(nxt)
            nxt = r["step"] + r["interval_steps"]
        first_p = next((sv for sv in p_sum["saves"]
                        if not sv["path"].endswith("_final.zs.json")), None)
        checks["P: ckpt_policy records, saves where they said, every interval in "
               "[floor, ceiling]"] = (
            bool(recs) and recs[0]["source"] == "bootstrap" and periodic == want
            and [r["step"] for r in recs[1:]] == periodic
            and all(r["floor"] <= r["interval_steps"] <= r["ceiling"] == P_CEILING
                    for r in recs))
        checks["P: the cost it learned is the zerostall blocking it measured, less the "
               "first save's pinning"] = (
            first_p is not None and len(recs) > 1 and first_p["alloc_s"] > 0
            and recs[1]["cost_s"] == round(first_p["blocking_s"] - first_p["alloc_s"], 6))
        res["recs"] = recs

    # -- Z-F: the deep state, beside the 2-layer chains -------------------------
    free = shutil.disk_usage(ZS_DIR).free - 3 * 2.1 * state_bytes(layers)
    depth = ZF_LAYERS
    while depth > 1 and 2.1 * state_bytes(depth) > free:  # cut depth, never width
        depth -= 1

    def full_depth_run():
        """Z-F: ZF_STEPS steps at ``depth`` with a save at ZF_EVERY."""
        zf, exp_zf = go("Z-F", argv("zf", depth=depth, steps=ZF_STEPS, every=ZF_EVERY),
                        "healthy", timeout=900)
        checks["Z-F ends with DONE"] = zf["end_step"] == ZF_STEPS and (exp_zf / "DONE").exists()
        shutil.rmtree(exp_zf, ignore_errors=True)
        res["zf"] = zf

    # four independent chains at once (their own directories; the card holds
    # three 2-layer runs and the deep one): their times overlap, E's RAM
    # restore and Z-B2's disk load under the same load
    chains_s = run_chains("zerostall", (full_depth_run, zb_chain, emergency_run,
                                        autopilot_run))
    checks["doctor: healthy / preemption / healthy"] = [
        verdicts["Z-A"], verdicts["Z-B1"], verdicts["Z-B2"]] == [
        "healthy", "preemption", "healthy"]
    b2, e, recs, zf = res["b2"], res["e"], res["recs"], res["zf"]
    for name in ("za", "zb", "e", "p"):
        shutil.rmtree(ZS_DIR / name, ignore_errors=True)

    def step_ms(sm):
        """``{step: ms}`` of a run's steps after its first (which carries the
        start-up), and the steps that ran beside a save's writer."""
        ms = {i: v for i, v in enumerate(sm["window_step_ms"], start=sm["start_step"] + 1)
              if i > sm["start_step"] + 1}
        return ms, set(sm["shadow_steps"])

    # steps beside a zerostall shadow (Z-A: every step after the first)
    # against vanilla A's steps with no writer running, both alone on the card
    za_ms, za_beside = step_ms(za)
    a_ms, a_beside = step_ms(ZS_REF["a_summary"])
    beside = [v for i, v in za_ms.items() if i in za_beside]
    alone = [v for i, v in a_ms.items() if i not in a_beside]
    step_line = {"beside_shadow_ms_Z-A": beside, "alone_ms_vanilla_A": alone,
                 "median_beside_ms": float(np.median(beside)) if beside else None,
                 "median_alone_ms": float(np.median(alone)) if alone else None}

    zf_saves = saves("Z-F")
    out = {"zerostall": {
        "card": card, "layers": layers, "state_gb": state_bytes(layers) / 1e9,
        "saves": {label: saves(label) for label in ("Z-A", "Z-B1", "Z-B2", "P")},
        "first_save_blocking_s": first["blocking_s"], "first_save_alloc_s": first["alloc_s"],
        "steady_blocking_s": [sv["blocking_s"] for sv in steady],
        "vanilla_background_blocking_s": ZS_REF["vanilla_bg_blocking_s"],
        "backpressure_s": [sv["backpressure_s"] for sv in za["saves"]],
        "shadow_s": [sv["shadow_s"] for sv in za["saves"]],
        "chunks": [sv["reuse"] for sv in za["saves"]],
        "pinned_bytes": first["pinned_bytes"],
        "peak_mem_gib": {label: runs[label]["summary"]["peak_mem_gib"] for label in runs},
        "step_ms": step_line, "concurrent_chains_s": chains_s,
        "disk_load_s_Z-B2": b2["ckpt_load_s"], "precheck_s_Z-B2": b2["ckpt_precheck_s"],
        "ram_restore_s_E": e["ckpt_load_s"],
        "host_pinned_after_each_train_E": [e["first"]["host_pinned_bytes"],
                                           e["host_pinned_bytes"]],
        "serving": {"vanilla_s": info_v["seconds"], "zerostall_s": info_z["seconds"]},
        "policy": [{k: r[k] for k in ("step", "source", "interval_steps", "cost_s", "mtti_s",
                                      "reason")} for r in recs],
        "Z-F": {"layers": depth, "steps": ZF_STEPS, "state_gb": state_bytes(depth) / 1e9,
                "reduced": f"depth cut to {depth} of {LAYERS} layers (full width) to make room "
                           "for the fleet phase",
                "step2_save": zf_saves[0], "final_save": zf_saves[-1],
                "peak_mem_gib": zf["peak_mem_gib"], "step_ms": zf["window_step_ms"],
                "shadow_steps": zf["shadow_steps"]},
        "wall_s": {label: runs[label]["wall_s"] for label in runs},
        "doctor": verdicts, "checks": checks,
    }}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)
    shutil.rmtree(ZS_DIR, ignore_errors=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        fail("zerostall phase: " + "; ".join(bad))
    return out


@contextlib.contextmanager
def low_water(what, path, every_s=1.0):
    """While the block runs, sample once every ``every_s`` the free disk under
    ``path``, the host's ``MemAvailable`` and the card's free memory (all
    processes'); yields a dict that holds the least of each, in GB, once the
    block has ended, and prints it on both streams then, also when the block
    fails."""
    import threading

    import torch

    low = {"disk_free_gb": math.inf, "host_mem_available_gb": math.inf,
           "card_free_gb": math.inf}
    stop = threading.Event()

    def sample():
        while True:
            meminfo = Path("/proc/meminfo").read_text().split("MemAvailable:")[1]
            now = {"disk_free_gb": shutil.disk_usage(path).free / 1e9,
                   "host_mem_available_gb": int(meminfo.split()[0]) * 1024 / 1e9,
                   "card_free_gb": torch.cuda.mem_get_info()[0] / 1e9}
            for k, v in now.items():
                low[k] = min(low[k], round(v, 3))
            if stop.wait(every_s):
                return

    sampler = threading.Thread(target=sample, name="low-water", daemon=True)
    sampler.start()
    try:
        yield low
    finally:
        stop.set()
        sampler.join()
        print(f"chip_smoke: {what} low water: {json.dumps(low)}", flush=True)
        print(f"chip_smoke: {what} low water: {json.dumps(low)}", file=sys.stderr, flush=True)


def run_chains(what, fns):
    """Run the independent chains ``fns`` at once, a thread each (the runs
    of one chain stay in order); fails the script, naming the ``what``
    phase, if any chain raised. Returns the seconds they took together."""
    import threading

    errors = []

    def chain(fn):
        try:
            fn()
        except BaseException as e:  # surfaced below
            errors.append(f"{fn.__name__}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=chain, args=(fn,), name=f"{what}-{fn.__name__}")
               for fn in fns]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"{what} phase: " + "; ".join(errors))
    return time.monotonic() - t0


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_group(label, argv, world=None, rank_env=None, timeout=600):
    """Start ``world`` trainer children (`trainer_child`) at once, ranks of
    one process group with their ``torchrun`` variables (``LOCAL_RANK`` 0
    for every rank: they share the one card), or one child outside any
    group when ``world`` is None; ``rank_env(rank)`` adds variables. Fails
    the script unless every child finished; returns each child's summary
    (rank order; for ``argv`` of several runs split by ``--then``, the list
    of its runs' summaries) and the group's wall seconds."""
    n_runs = argv.count("--then") + 1
    n = world or 1
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                         "JOB_END_TIME", "SLURM_JOB_END_TIME", "PYRECOVER_FAULT_PLAN")}
    base["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    procs = []
    t0 = time.monotonic()
    for rank in range(n):
        env = dict(base)
        if world is not None:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.update((rank_env or (lambda _: {}))(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--trainer", *argv],
            cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    summaries, failed = [], []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            lines = [json.loads(x[len("trainer summary: "):]) for x in out.splitlines()
                     if x.startswith("trainer summary: ")]
            if proc.returncode != 0 or len(lines) != n_runs:
                failed.append(f"rank {rank} exited {proc.returncode}: {err[-3000:]}")
                summaries.append(None)
            else:
                summaries.append(lines[0] if n_runs == 1 else lines)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.monotonic() - t0
    if failed:
        fail(f"dp run {label}: " + " | ".join(failed))
    return summaries, wall


def serve_sharded(ckpt, args):
    """Serve the sharded checkpoint ``ckpt`` on the card and hold it to the
    vanilla reader of the same state: the state read into host leaves (DCP,
    one process), written as a ``PYRCKPT2`` file beside it and served. Both
    restores' parameters must hash the same."""
    from pyrecover_tpu_torch.checkpoint.sharded import load_ckpt_sharded
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.train_state import state_leaves

    config = get_args(args)
    model = Transformer(config.model, device="meta").to_empty(device="cpu")
    optimizer, _ = build_optimizer(config, model.parameters())
    leaves = state_leaves(model, optimizer)
    load_ckpt_sharded(ckpt, leaves)
    vanilla = ckpt.parent / "served_state.ckpt"
    save_ckpt_vanilla(vanilla, leaves)
    del leaves, optimizer, model
    gc.collect()
    want, info_v = served_digests(vanilla, config.model)
    got, info_s = served_digests(ckpt, config.model)
    vanilla.unlink()
    return {"equal": got == want and info_s["engine"] == "sharded",
            "seconds": {"sharded": info_s["seconds"], "vanilla": info_v["seconds"]},
            "checksum": info_s["checksum"], "plan_bytes_moved": info_s["plan_bytes_moved"]}


def dp_phase():
    """Data parallelism on the card, in trainer subprocesses at llama-1b's
    width and DP_LAYERS deep (see the module docstring, item 10). Returns
    the ``dp`` line."""
    from pyrecover_tpu_torch.checkpoint.sharded import read_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import read_ckpt_meta
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.preempt import read_requeue_marker
    from pyrecover_tpu_torch.telemetry import read_events
    from pyrecover_tpu_torch.train_state import state_leaves

    card = card_line()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)

    def argv(name, *extra):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(DP_LAYERS),
            "--batch-size", str(DP_BATCH), "--training-samples", str(DP_BATCH * DP_STEPS),
            "--training-steps", str(DP_STEPS), "--checkpoint-dir", str(DP_DIR),
            "--experiment-name", name, "--log-loss-to-csv", "--telemetry", *extra]

    dist2 = ["--distributed", "--dp", "2", "--dist-backend", "gloo"]
    runs, checks, problems = {}, {}, []

    def go(label, args, world=None, rank_env=None):
        summaries, wall = run_group(label, args, world, rank_env)
        runs[label] = {"summaries": summaries, "wall_s": wall}
        want = DP_LAYERS * (summaries[0]["end_step"] - summaries[0]["start_step"])
        for rank, sm in enumerate(summaries):
            if sm["launches"] != {k: want for k in sm["launches"]}:
                problems.append(f"{label} rank {rank}: launches {sm['launches']}, want {want} "
                                "each, all on the tensor-core instances")
        print(f"  dp run {label}: {world or 1} process(es), {wall:.1f} s, losses "
              f"{summaries[0]['losses']}", flush=True)
        return summaries

    def csv_losses(name):
        return {int(r[0]): float(r[1]) for r in loss_rows(DP_DIR / name)[1:]}

    def rel(a, b):
        return abs(a - b) / abs(b)

    exp_b, exp_v = DP_DIR / "b", DP_DIR / "v2"
    res = {}

    def r0_run():
        """R0: one process, no group."""
        go("R0", argv("r0", "--checkpoint-frequency", "0"))

    def r1_run():
        """R1: a group of one on NCCL (the default backend), env rendezvous."""
        go("R1", argv("r1", "--checkpoint-frequency", "0", "--distributed", "--dp", "1"),
           world=1)

    def a_chain():
        """A2: two ranks on the one card over gloo, sharded engine, async
        save at 2; then C, one process resuming A2's step-2 sharded
        checkpoint through the elastic preflight; then A2's final
        checkpoint served."""
        res["a2"] = go("A2", argv("a2", *dist2, "--checkpoint-engine", "sharded",
                                  "--checkpoint-frequency", "2"), world=2)
        go("C", argv("c", "--checkpoint-frequency", "0", "--resume-from-checkpoint",
                     str(DP_DIR / "a2" / "ckpt_2"), "--elastic-resume", "on"))
        res["serving"] = serve_sharded(DP_DIR / "a2" / f"ckpt_{DP_STEPS}_final", argv("x"))

    def b_chain():
        """B1: A2's setup, host 0 alone sees a past deadline; B2 its resume."""
        res["b1"] = go("B1", argv("b", *dist2, "--checkpoint-engine", "sharded",
                                  "--checkpoint-frequency", str(DP_STEPS),
                                  "--timeaware-checkpointing", "--preempt-check-interval", "2"),
                       world=2,
                       rank_env=lambda r: {"JOB_END_TIME": str(time.time() - 60)} if r == 0
                       else {})
        res["b_marker"] = read_requeue_marker(exp_b) or {}
        res["b_after_b1"] = ((exp_b / "REQUEUE").exists(), (exp_b / "DONE").exists())
        res["b2"] = go("B2", argv("b", *dist2, "--checkpoint-engine", "sharded",
                                  "--checkpoint-frequency", str(DP_STEPS),
                                  "--resume-from-checkpoint", "latest"), world=2)

    def v_chain():
        """V2 -> V1: dp2 with the vanilla engine (host 0 writes), resumed at dp1."""
        res["v2"] = go("V2", argv("v2", *dist2, "--checkpoint-frequency", "2",
                                  "--training-steps", "3"), world=2)
        res["v_files"] = sorted(p.name for p in exp_v.iterdir() if p.name.startswith("ckpt_"))
        go("V1", argv("v1", "--checkpoint-frequency", "0", "--resume-from-checkpoint",
                      str(exp_v / "ckpt_2.ckpt")))

    wire_runs = {
        "Q8": ("--grad-allreduce", "int8"),
        "Q8B": ("--grad-allreduce", "int8", "--grad-bucket-mb", str(WIRE_BUCKET_MB)),
        "B16": ("--grad-allreduce", "bf16"),
        "Z1": ("--optimizer-sharding", "zero1"),
        "Z1Q": ("--optimizer-sharding", "zero1", "--grad-allreduce", "int8"),
    }

    def r_chain():
        """R0, then R1: one process at a time, so the card holds nine of the
        phase's processes at once, not ten (ten went out of memory)."""
        r0_run()
        r1_run()

    def wire_chain():
        """Q8, Q8B, B16, Z1, Z1Q: A2's two ranks, data and weights,
        WIRE_STEPS steps, one run after another in one process pair (one
        start for the five; each run's final ``.params`` digests taken in
        memory, no checkpoint written)."""
        joined = []
        for label, extra in wire_runs.items():
            joined += (["--then"] if joined else []) + argv(
                label.lower(), *dist2, *extra, "--training-steps", str(WIRE_STEPS))
        summaries, wall = run_group("wire", joined, world=2)
        for i, label in enumerate(wire_runs):
            per_rank = [sm[i] for sm in summaries]
            runs[label] = {"summaries": per_rank, "wall_s": wall}
            want = DP_LAYERS * WIRE_STEPS
            for rank, sm in enumerate(per_rank):
                if sm["launches"] != {k: want for k in sm["launches"]}:
                    problems.append(f"{label} rank {rank}: launches {sm['launches']}, want "
                                    f"{want} each, all on the tensor-core instances")
            print(f"  dp run {label}: 2 processes (one pair for the five runs, {wall:.1f} s), "
                  f"losses {per_rank[0]['losses']}", flush=True)

    # five independent chains at once (their own experiment directories; the
    # card holds their nine processes): their seconds overlap
    chains_s = run_chains("dp", (r_chain, wire_chain, a_chain, b_chain, v_chain))

    r0_rows, r1_rows = loss_rows(DP_DIR / "r0"), loss_rows(DP_DIR / "r1")
    r0, r1 = csv_losses("r0"), csv_losses("r1")
    checks["R1 (NCCL, world 1) loss CSV = R0's, bit for bit"] = r1_rows == r0_rows
    r1_err = max(rel(r1[s], r0[s]) for s in r0)

    a2 = res["a2"]
    a = csv_losses("a2")
    step1_err = rel(a[1], r0[1])
    later_err = max(rel(a[s], r0[s]) for s in range(2, DP_STEPS + 1))
    checks[f"A2 step 1 loss within {DP_STEP1_RTOL:g} of R0's"] = step1_err <= DP_STEP1_RTOL
    checks[f"A2 steps 2-{DP_STEPS} within {DP_LOSS_RTOL:g} of R0's"] = later_err <= DP_LOSS_RTOL
    checks["A2: one loss CSV, one row a step (host 0's)"] = (
        sorted(a) == list(range(1, DP_STEPS + 1))
        and [p.name for p in (DP_DIR / "a2").glob("*.csv")] == ["a2_loss_log.csv"])
    a2_events = read_events(DP_DIR / "a2" / "a2_telemetry.jsonl")
    checks["A2: the JSONL is host 0's"] = {e["host"] for e in a2_events} == {0}
    checks["A2: both ranks end at step 4, sharded saves at 2 and 4"] = (
        all(sm["end_step"] == DP_STEPS for sm in a2)
        and sorted(p.name for p in (DP_DIR / "a2").glob("ckpt_*")) == ["ckpt_2", "ckpt_4_final"])

    b1, b2, marker = res["b1"], res["b2"], res["b_marker"]
    checks["B1: both ranks stop early on the same step (2)"] = (
        [(sm["end_step"], sm["stopped_early"]) for sm in b1] == [(2, True), (2, True)])
    checks["B1: one REQUEUE marker, at step 2"] = (
        res["b_after_b1"] == (True, False) and marker.get("step") == 2)
    digests_a = read_meta(DP_DIR / "a2" / f"ckpt_{DP_STEPS}_final")["leaf_digests"]
    digests_b = read_meta(exp_b / f"ckpt_{DP_STEPS}_final")["leaf_digests"]
    checks["B2 resumed at 2 and its final .params digests equal A2's"] = (
        all(sm["start_step"] == 2 for sm in b2) and digests_a == digests_b
        and (exp_b / "DONE").exists())

    def rescaled(name):
        return [e for e in read_events(DP_DIR / name / f"{name}_telemetry.jsonl")
                if e["event"] == "sampler_rescaled"]

    c = csv_losses("c")
    c_err = max(rel(c[s], a[s]) for s in (3, 4))
    checks["C: sampler_rescaled 2 -> 1 at 2 consumed"] = [
        (e["saved_replicas"], e["target_replicas"], e["consumed"]) for e in rescaled("c")
    ] == [(2, 1, 2)]
    checks[f"C: steps 3-4 within {DP_LOSS_RTOL:g} of A2's"] = (
        sorted(c) == [3, 4] and c_err <= DP_LOSS_RTOL)
    c_elastic = [e for e in read_events(DP_DIR / "c" / "c_telemetry.jsonl")
                 if e["event"] == "elastic_resume"]
    checks["C (--elastic-resume on): elastic_resume with the plan's accounting, 2 -> 1 devices"] = (
        [(e["saved_topology"]["devices"], e["target_topology"]["devices"], e["step"])
         for e in c_elastic] == [(2, 1, 2)]
        # every byte of the state moves onto the new placement (the tensors,
        # and the counters and key on top)
        and 0 <= c_elastic[0]["plan_bytes_moved"] - state_bytes(DP_LAYERS) < 1024
        and c_elastic[0]["resharded_leaves"] == 0)
    serving = res["serving"]
    checks["serving: A2's sharded checkpoint = the vanilla reader of its state, digest for "
           "digest"] = serving.pop("equal")

    v2 = res["v2"]
    config = get_args(argv("x"))
    model = Transformer(config.model, device="meta")
    optimizer, _ = build_optimizer(config, model.parameters())
    want_paths = [leaf.path for leaf in state_leaves(model, optimizer)]
    vmeta = read_ckpt_meta(exp_v / "ckpt_2.ckpt")
    checks["V2: one file a save, written by host 0 (rank 1 wrote nothing)"] = (
        res["v_files"] == ["ckpt_2.ckpt", "ckpt_3_final.ckpt"]
        and v2[0]["saves"][0]["bytes"] is not None
        and all(sv["bytes"] is None for sv in v2[1]["saves"]))
    checks["V2: manifest paths are the JAX TrainState's (no module.)"] = (
        vmeta["paths"] == want_paths and not [p for p in vmeta["paths"] if "module" in p]
        and vmeta["sampler"]["replicas"] == 2)
    v = csv_losses("v1")
    v_err = max(rel(v[s], a[s]) for s in (3, 4))
    checks["V1: sampler_rescaled 2 -> 1 at 2 consumed"] = [
        (e["saved_replicas"], e["target_replicas"], e["consumed"]) for e in rescaled("v1")
    ] == [(2, 1, 2)]
    checks[f"V1: steps 3-4 within {DP_LOSS_RTOL:g} of A2's"] = (
        sorted(v) == [3, 4] and v_err <= DP_LOSS_RTOL)
    # the gradient wire and ZeRO-1, against A2 (fp32, DDP, the same data)
    def losses_of(label):
        return runs[label]["summaries"][0]["losses"]

    def digests_of(label):
        return runs[label]["summaries"][0]["params_digests"]

    a2_losses = losses_of("A2")[:WIRE_STEPS]
    wire_err = {label: max(rel(x, y) for x, y in zip(losses_of(label), a2_losses))
                for label in ("Q8", "Q8B", "B16")}
    for label, err in wire_err.items():
        checks[f"{label}: losses within {WIRE_LOSS_RTOL:g} of A2's over its {WIRE_STEPS} "
               "steps"] = len(losses_of(label)) == WIRE_STEPS and err <= WIRE_LOSS_RTOL
    a2_norms = runs["A2"]["summaries"][0]["grad_norms"][:WIRE_STEPS]
    norm_err = {label: [rel(x, y) for x, y in zip(
        runs[label]["summaries"][0]["grad_norms"], a2_norms)] for label in wire_err}
    for label, errs in norm_err.items():
        checks[f"{label}: step 1's gradient norm (the synced sum) within {WIRE_NORM_RTOL:g} "
               "of A2's"] = len(errs) == WIRE_STEPS and errs[0] <= WIRE_NORM_RTOL
    checks[f"Z1 (zero1, fp32): losses and step-{WIRE_STEPS} .params digests equal A2's bit "
           "for bit"] = (
        losses_of("Z1") == a2_losses
        and digests_of("Z1") == read_meta(DP_DIR / "a2" / f"ckpt_{WIRE_STEPS}")["leaf_digests"])
    checks["Z1Q (zero1 + int8): losses and final .params digests equal Q8's bit for bit"] = (
        losses_of("Z1Q") == losses_of("Q8") and digests_of("Z1Q") == digests_of("Q8"))
    sync = {label: [sm["grad_sync"] for sm in runs[label]["summaries"]] for label in wire_runs}
    checks["Q8: every rank's error-feedback residual is nonzero after the run"] = all(
        (g["residual_absmax"] or 0) > 0 for g in sync["Q8"])
    quant_events = [e for e in read_events(DP_DIR / "q8" / "q8_telemetry.jsonl")
                    if e["event"] == "grad_quantize"]
    checks["Q8: one grad_quantize event, wire_bytes_per_leg below grad_bytes_fp32"] = (
        len(quant_events) == 1
        and 0 < quant_events[0]["wire_bytes_per_leg"] < quant_events[0]["grad_bytes_fp32"])
    checks["Q8B: at least 4 buckets"] = sync["Q8B"][0]["buckets"] >= 4
    n_params = state_bytes(DP_LAYERS) // 12
    moment_gib = 8 * n_params / 2**30  # one rank's mu and nu, fp32
    z1_saving = [a_["peak_mem_gib"] - z_["peak_mem_gib"]
                 for a_, z_ in zip(a2, runs["Z1"]["summaries"])
                 if a_["peak_mem_gib"] is not None and z_["peak_mem_gib"] is not None]
    checks[f"Z1: each rank's peak at least {Z1_PEAK_SHARE:.3g} of its moment bytes below A2's"] = (
        len(z1_saving) == 2 and min(z1_saving) >= Z1_PEAK_SHARE * moment_gib)
    checks["every rank launched the flash kernels layers x steps, on tensor cores"] = not problems

    def line(label):
        sm = runs[label]["summaries"]
        return {
            "ranks": len(sm),
            "backend": {"R0": None, "R1": "cuda:nccl,cpu:gloo", "C": None, "V1": None}.get(
                label, "gloo"),
            "losses": sm[0]["losses"],
            "median_step_ms_2_4": (float(np.median(sm[0]["window_step_ms"][1:]))
                                   if len(sm[0]["window_step_ms"]) > 1 else None),
            "saves": [[{"file": Path(sv["path"]).name, "blocking_s": sv["blocking_s"],
                        "bytes": sv["bytes"], "write_s": sv["write_s"]}
                       for sv in s_["saves"]] for s_ in sm],
            "load_s": sm[0]["ckpt_load_s"], "precheck_s": sm[0]["ckpt_precheck_s"],
            "peak_mem_gib": [s_["peak_mem_gib"] for s_ in sm],
            "wall_s": runs[label]["wall_s"],
        }

    state_gb = state_bytes(DP_LAYERS) / 1e9
    out = {"dp": {
        "card": card, "layers": DP_LAYERS, "batch_size": DP_BATCH, "steps": DP_STEPS,
        "state_gb": state_gb,
        "runs": {label: line(label) for label in runs},
        "save_blocking_s": {
            "sharded_async_A2_step2": [sm["saves"][0]["blocking_s"] for sm in a2],
            "vanilla_background_V2_step2": v2[0]["saves"][0]["blocking_s"],
        },
        "errors": {"R1_vs_R0": r1_err, "A2_step1_vs_R0": step1_err,
                   "A2_steps2_4_vs_R0": later_err, "C_vs_A2": c_err, "V1_vs_A2": v_err},
        "limits": {"step1_rtol": DP_STEP1_RTOL, "loss_rtol": DP_LOSS_RTOL},
        "digest_A2_B2": digests_a == digests_b,
        "wire": {
            "route": "gloo, CUDA tensors passed as they lie (gloo stages them through the "
                     "host itself)",
            "bucket_mb": WIRE_BUCKET_MB, "errors_vs_A2": wire_err,
            "limit_rtol": WIRE_LOSS_RTOL, "grad_norm_errors_vs_A2": norm_err,
            "grad_norm_limit_rtol_step1": WIRE_NORM_RTOL,
            "grad_sync": {label: sync[label][0] for label in wire_runs},
            "Z1_peak_saving_gib": z1_saving, "moment_gib_per_rank": moment_gib,
        },
        "elastic_resume_C": c_elastic,
        "serving_A2": serving, "concurrent_chains_s": chains_s,
        "checks": checks,
    }}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    shutil.rmtree(DP_DIR, ignore_errors=True)
    if bad or problems:
        fail("dp phase: " + "; ".join(bad + problems))
    return out



def run_torchrun(label, argv, nproc, rank_env=None, timeout=600):
    """Start ``nproc`` trainer ranks (`trainer_child`) with
    ``torch.distributed.run --standalone``, which sets each rank's torchrun
    variables (``LOCAL_RANK`` 0..nproc-1: one card each); ``rank_env``
    maps a rank to variables of its own. Fails the script unless the group
    finished; returns each rank's summary (rank order) and the wall
    seconds."""
    sums = DP_DIR / f"summaries_{label}"
    shutil.rmtree(sums, ignore_errors=True)
    sums.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "JOB_END_TIME", "SLURM_JOB_END_TIME", "PYRECOVER_FAULT_PLAN")}
    env.update(CUBLAS_WORKSPACE_CONFIG=":4096:8", CHIP_SMOKE_SUMMARY_DIR=str(sums),
               CHIP_SMOKE_RANK_ENV=json.dumps(
                   {str(r): (rank_env or (lambda _: {}))(r) for r in range(nproc)}))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(Path(__file__).resolve()), "--trainer", *argv],
        cwd=Path(__file__).resolve().parent, env=env, capture_output=True, text=True,
        timeout=timeout)
    wall = time.monotonic() - t0
    paths = [sums / f"rank{r}.json" for r in range(nproc)]
    if proc.returncode != 0 or not all(p.exists() for p in paths):
        fail(f"dp run {label} (torchrun, {nproc} ranks) exited {proc.returncode}: "
             f"{proc.stderr[-4000:]}")
    return [json.loads(p.read_text()) for p in paths], wall


def dp_cards_phase(n):
    """The dp phase across ``n`` cards, one rank a card over NCCL (see the
    module docstring, item 11). Returns the ``dp_cards`` line."""
    from pyrecover_tpu_torch.checkpoint.sharded import read_meta
    from pyrecover_tpu_torch.preempt import read_requeue_marker

    card = card_line()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)

    def argv(name, *extra):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(DP_LAYERS),
            "--batch-size", str(DP_BATCH), "--training-samples", str(DP_BATCH * DP_STEPS),
            "--training-steps", str(DP_STEPS), "--checkpoint-dir", str(DP_DIR),
            "--experiment-name", name, "--log-loss-to-csv", "--telemetry", *extra]

    dist = ["--distributed", "--dp", str(n)]
    runs, checks = {}, {}

    def go(label, args, rank_env=None):
        summaries, wall = run_torchrun(label, args, n, rank_env)
        runs[label] = {"summaries": summaries, "wall_s": wall}
        want = DP_LAYERS * (summaries[0]["end_step"] - summaries[0]["start_step"])
        checks[f"{label}: every rank launched the flash kernels layers x steps, on tensor "
               "cores"] = all(sm["launches"] == {k: want for k in sm["launches"]}
                              for sm in summaries)
        print(f"  dp run {label}: {n} ranks on {n} cards, {wall:.1f} s, losses "
              f"{summaries[0]['losses']}", flush=True)
        return summaries

    def csv_losses(name):
        return {int(r[0]): float(r[1]) for r in loss_rows(DP_DIR / name)[1:]}

    def rel(a, b):
        return abs(a - b) / abs(b)

    m0, m0_wall = run_group("M0", argv("m0", "--checkpoint-frequency", "0"))
    runs["M0"] = {"summaries": m0, "wall_s": m0_wall}
    m = csv_losses("m0")
    na = go("NA", argv("na", *dist, "--checkpoint-engine", "sharded",
                       "--checkpoint-frequency", "2", "--grad-bucket-mb", "0"))
    a = csv_losses("na")
    step1_err = rel(a[1], m[1])
    later_err = max(rel(a[s_], m[s_]) for s_ in range(2, DP_STEPS + 1))
    checks[f"NA step 1 loss within {DP_STEP1_RTOL:g} of M0's"] = step1_err <= DP_STEP1_RTOL
    checks[f"NA steps 2-{DP_STEPS} within {DP_LOSS_RTOL:g} of M0's"] = later_err <= DP_LOSS_RTOL
    checks["NA: one loss CSV, one row a step (host 0's)"] = (
        sorted(a) == list(range(1, DP_STEPS + 1))
        and [p.name for p in (DP_DIR / "na").glob("*.csv")] == ["na_loss_log.csv"])
    checks["NA: every rank ends at step 4, sharded saves at 2 and 4"] = (
        all(sm["end_step"] == DP_STEPS for sm in na)
        and sorted(p.name for p in (DP_DIR / "na").glob("ckpt_*")) == ["ckpt_2", "ckpt_4_final"])
    nk = go("NK", argv("nk", *dist, "--checkpoint-frequency", "2", "--grad-bucket-mb", "25"))
    k = csv_losses("nk")
    k_err = max(rel(k[s_], a[s_]) for s_ in a)
    checks[f"NK (DDP buckets of 25 MiB) within {DP_LOSS_RTOL:g} of NA"] = (
        sorted(k) == sorted(a) and k_err <= DP_LOSS_RTOL)
    checks["NK: one vanilla file a save, written by host 0"] = (
        sorted(p.name for p in (DP_DIR / "nk").iterdir() if p.name.startswith("ckpt_"))
        == ["ckpt_2.ckpt", f"ckpt_{DP_STEPS}_final.ckpt"]
        and nk[0]["saves"][0]["bytes"] is not None
        and all(sv["bytes"] is None for sm in nk[1:] for sv in sm["saves"]))
    # the gradient wire and ZeRO-1 across cards, over NCCL: NQ the int8 wire
    # (its all_to_all and all-gather card to card), NZ zero1 at fp32
    nq = go("NQ", argv("nq", *dist, "--grad-allreduce", "int8"))
    q_err = max(rel(x, y) for x, y in zip(nq[0]["losses"], na[0]["losses"]))
    checks[f"NQ (int8 wire over NCCL) within {WIRE_LOSS_RTOL:g} of NA"] = (
        len(nq[0]["losses"]) == DP_STEPS and q_err <= WIRE_LOSS_RTOL
        and all((sm["grad_sync"]["residual_absmax"] or 0) > 0 for sm in nq))
    go("NZ", argv("nz", *dist, "--checkpoint-engine", "sharded", "--checkpoint-frequency", "2",
                  "--grad-bucket-mb", "0", "--optimizer-sharding", "zero1"))
    checks["NZ (zero1) bit-equal to NA: losses and final .params digests"] = (
        csv_losses("nz") == a
        and read_meta(DP_DIR / "nz" / f"ckpt_{DP_STEPS}_final")["leaf_digests"]
        == read_meta(DP_DIR / "na" / f"ckpt_{DP_STEPS}_final")["leaf_digests"])
    nb1 = go("NB1", argv("b", *dist, "--checkpoint-engine", "sharded",
                         "--checkpoint-frequency", str(DP_STEPS), "--timeaware-checkpointing",
                         "--preempt-check-interval", "2"),
             rank_env=lambda r: {"JOB_END_TIME": str(time.time() - 60)} if r == 0 else {})
    exp_b = DP_DIR / "b"
    marker = read_requeue_marker(exp_b) or {}
    checks["NB1: every rank stops early on the same step (2)"] = (
        [(sm["end_step"], sm["stopped_early"]) for sm in nb1] == [(2, True)] * n)
    checks["NB1: one REQUEUE marker, at step 2"] = (
        (exp_b / "REQUEUE").exists() and marker.get("step") == 2
        and not (exp_b / "DONE").exists())
    nb2 = go("NB2", argv("b", *dist, "--checkpoint-engine", "sharded",
                         "--checkpoint-frequency", str(DP_STEPS), "--resume-from-checkpoint",
                         "latest"))
    digests_a = read_meta(DP_DIR / "na" / f"ckpt_{DP_STEPS}_final")["leaf_digests"]
    digests_b = read_meta(exp_b / f"ckpt_{DP_STEPS}_final")["leaf_digests"]
    checks["NB2 resumed at 2 and its final .params digests equal NA's"] = (
        all(sm["start_step"] == 2 for sm in nb2) and digests_a == digests_b
        and (exp_b / "DONE").exists())

    def line(label):
        sm = runs[label]["summaries"]
        return {
            "ranks": len(sm), "cards": 1 if label == "M0" else n,
            "backend": None if label == "M0" else "cuda:nccl,cpu:gloo",
            "losses": sm[0]["losses"],
            "median_step_ms_2_4": (float(np.median(sm[0]["window_step_ms"][1:]))
                                   if len(sm[0]["window_step_ms"]) > 1 else None),
            "saves": [[{"file": Path(sv["path"]).name, "blocking_s": sv["blocking_s"],
                        "bytes": sv["bytes"], "write_s": sv["write_s"]}
                       for sv in s_["saves"]] for s_ in sm],
            "load_s": sm[0]["ckpt_load_s"], "peak_mem_gib": [s_["peak_mem_gib"] for s_ in sm],
            "wall_s": runs[label]["wall_s"], "grad_sync": sm[0].get("grad_sync"),
        }

    out = {"dp_cards": {
        "card": card, "cards": n, "layers": DP_LAYERS, "batch_size": DP_BATCH,
        "steps": DP_STEPS, "state_gb": state_bytes(DP_LAYERS) / 1e9,
        "runs": {label: line(label) for label in runs},
        "errors": {"NA_step1_vs_M0": step1_err, "NA_steps2_4_vs_M0": later_err,
                   "NK_vs_NA": k_err, "NQ_vs_NA": q_err},
        "NK_bit_equal_NA": k == a,
        "limits": {"step1_rtol": DP_STEP1_RTOL, "loss_rtol": DP_LOSS_RTOL},
        "checks": checks,
    }}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    shutil.rmtree(DP_DIR, ignore_errors=True)
    if bad:
        fail("dp_cards phase: " + "; ".join(bad))
    return out


def drill_phase():
    """Seeded faults through the trainer at llama-1b's width, in subprocesses
    (see the module docstring, item 9). Returns the drills' line."""
    from pyrecover_tpu_torch.checkpoint.registry import list_checkpoints
    from pyrecover_tpu_torch.telemetry import doctor, read_events

    shutil.rmtree(DRILL_DIR, ignore_errors=True)
    DRILL_DIR.mkdir(parents=True)
    print(f"chip_smoke: drill phase depth cut to {DRILL_LAYERS} of llama-1b's {LAYERS} layers "
          "(full width) to keep saves short; the OOM drill runs the full depth", flush=True)
    final = f"ckpt_{DRILL_STEPS}_final.ckpt"
    runs, failures, digests = [], [], {}

    def argv(name, *extra, steps=DRILL_STEPS):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(DRILL_LAYERS),
            "--training-steps", str(steps), "--checkpoint-dir", str(DRILL_DIR),
            "--experiment-name", name, "--checkpoint-frequency", "2",
            "--max-kept-checkpoints", "2", "--verify-checkpoints", "--telemetry",
            "--hang-watchdog-timeout", str(DRILL_WATCHDOG_S), *extra]

    def drill(label, name, args, plan=None, want_rc=0, want=("healthy", None), timeout=400):
        proc, summary, wall = start_trainer(label, args, timeout=timeout, plan=plan)
        exp = DRILL_DIR / name
        report = doctor.diagnose(exp)
        segment = run_segment(exp / f"{name}_telemetry.jsonl")
        sites = sorted({e["site"] for e in segment if e["event"] == "fault_injected"})
        ok = proc.returncode == want_rc and (report["classification"], report["phase"]) == want
        runs.append({"drill": label, "rc": proc.returncode, "classification":
                     report["classification"], "phase": report["phase"], "seconds": wall,
                     "sites": sites, "detail": report["detail"][:160]})
        print(f"  drill {label}: rc {proc.returncode} (want {want_rc}), doctor "
              f"{report['classification']}/{report['phase']} (want {want[0]}/{want[1]}), "
              f"{wall:.1f} s, sites {sites}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            say_failed(f"  drill {label} FAILED; its standard error ends:\n{proc.stderr[-4000:]}")
            failures.append(label)
        return exp, segment, summary

    def final_digest(label, exp):
        side = exp / (final + ".sha256")
        digests[label] = side.read_text() if side.exists() else None
        return digests[label]

    def straight():  # 1: the yardstick
        drill("straight", "straight", argv("straight"))
        final_digest("straight", DRILL_DIR / "straight")

    def kill9():
        # 2: SIGKILL in the first save's write (synchronous saves, so the
        # main thread dies inside it), then the `latest` resume
        kill = {"seed": 0, "faults": [{"type": "kill9_during_save", "save_index": 1,
                                       "after_bytes": 2**20}]}
        exp, _, _ = drill("kill9_during_save", "kill9", argv("kill9", "--no-async-checkpoint"),
                          plan=kill, want_rc=-9, want=("crash", "ckpt_write"))
        published = [p.name for p in list_checkpoints(exp)]
        if published:
            failures.append(f"kill9: torn checkpoint published: {published}")
        drill("kill9 resume", "kill9", argv("kill9", "--resume-from-checkpoint", "latest"))
        final_digest("kill9 resume", exp)

    def corrupt():
        # 3: the newest save's bytes flipped after its commit, then the
        # resume quarantines it and falls back to the one before
        plan = {"seed": 0, "faults": [{"type": "corrupt_ckpt_bytes", "save_index": 2,
                                       "count": 64}]}
        exp, _, _ = drill("corrupt_ckpt_bytes", "corrupt", argv("corrupt"), plan=plan)
        _, seg, _ = drill("corrupt resume", "corrupt",
                          argv("corrupt", "--resume-from-checkpoint", "latest"))
        order = [e["event"] for e in seg if e["event"] in (
            "ckpt_precheck_failed", "ckpt_quarantined", "ckpt_restore_fallback", "resume")]
        resumed = [e["step"] for e in seg if e["event"] == "resume"]
        if order[:3] != ["ckpt_precheck_failed", "ckpt_quarantined", "resume"] or resumed != [2]:
            failures.append(f"corrupt: recovery events {order}, resumed at {resumed}")
        final_digest("corrupt resume", exp)

    retries = {}

    def transient():
        # 4: transient EIO on writes, then on the resume's reads: retried
        for label, op, extra in (("transient write", "write", []),
                                 ("transient read", "read",
                                  ["--resume-from-checkpoint", "latest"])):
            plan = {"seed": 0, "faults": [{"type": "transient_io_error", "op": op,
                                           "fail_count": 2}]}
            _, seg, _ = drill(label, "transient", argv(
                "transient", *extra, steps=DRILL_STEPS + 2 if extra else DRILL_STEPS), plan=plan)
            retries[op] = [e["op"] for e in seg if e["event"] == "ckpt_io_retry"]
            if retries[op] != [op, op]:
                failures.append(f"transient {op}: ckpt_io_retry ops {retries[op]}")

    def zerostall_kill():
        # 6: the zerostall engine killed in the chunk store mid-write of its
        # second save (the final one), then the `latest` resume from the
        # first manifest, which must end with Z-A's state
        kill = {"seed": 0, "faults": [{"type": "kill9_during_save", "site": "ckpt_chunk_write",
                                       "save_index": 2, "after_bytes": 2**20}]}
        zs = ("--checkpoint-engine", "zerostall")
        exp, _, _ = drill("zerostall kill9_during_save", "zskill", argv("zskill", *zs),
                          plan=kill, want_rc=-9, want=("crash", "ckpt_chunk_write"))
        published = [p.name for p in list_checkpoints(exp)]
        if published != ["ckpt_2.zs.json"]:
            failures.append(f"zerostall kill9: published {published}, want ckpt_2.zs.json only")
        _, _, resumed = drill("zerostall kill9 resume", "zskill",
                              argv("zskill", *zs, "--resume-from-checkpoint", "latest"))
        if resumed is None or not str(resumed["resumed_from"]).endswith("ckpt_2.zs.json"):
            failures.append("zerostall kill9: the resume did not start from ckpt_2.zs.json")
        digests["zerostall kill9 resume"] = manifest_chunks(exp / final.replace(
            ".ckpt", ".zs.json")) == ZS_REF["za_chunks"]
        if not digests["zerostall kill9 resume"]:
            failures.append("zerostall kill9 resume: the final state differs from Z-A's")

    def stall():
        # 5: the loader stalls past the watchdog's window
        plan = {"seed": 0, "faults": [{"type": "loader_stall", "seconds": STALL_S,
                                       "batch": 8}]}
        exp, seg, _ = drill("loader_stall", "stall", argv(
            "stall", "--checkpoint-frequency", "0", "--hang-watchdog-timeout",
            str(STALL_WINDOW_S), steps=12), plan=plan, want=("hang", "loader_wait"))
        if not [e for e in seg if e["event"] == "hang_detected"] or not list(
                (exp / ".postmortem").glob("*hang_detected")):
            failures.append("loader_stall: no hang_detected event or bundle")

    hotswap_chaos, fleet = {}, {}

    def hotswap_chaos_leg():
        # 7: the hotswap phase's chaos leg: a serving process SIGKILLed at its
        # first swap_fetch (item 14), run here beside the other drills
        hotswap_chaos.update(hotswap_chaos_phase())

    # drills 1-7 and the fleet's two drills (item 15, each in its own
    # process) are independent chains, each in its own experiment directory:
    # they run at once (to make room for the dp phase), so their seconds
    # overlap; each chain's runs stay in order
    with low_water("drill chains", DRILL_DIR) as low:
        chains_s = run_chains("drill", (straight, kill9, corrupt, transient, stall,
                                        zerostall_kill, hotswap_chaos_leg,
                                        *fleet_chains(fleet)))
    want = digests["straight"]
    for label in ("kill9 resume", "corrupt resume"):
        if digests[label] != want:
            failures.append(f"{label}: the final checkpoint differs from the straight run's")
    for name in ("straight", "kill9", "corrupt", "transient", "zskill"):
        shutil.rmtree(DRILL_DIR / name, ignore_errors=True)

    # 6: llama-1b at full depth and a batch the card cannot hold
    exp, seg, _ = drill("oom", "oom", train_argv() + [
        "--attention-impl", "flash", "--batch-size", str(OOM_BATCH), "--training-steps", "1",
        "--training-samples", str(OOM_BATCH), "--checkpoint-dir", str(DRILL_DIR),
        "--experiment-name", "oom", "--telemetry"], want_rc=1, want=("oom", None))
    bundles = [json.loads((b / "MANIFEST.json").read_text()) for b in
               sorted((exp / ".postmortem").glob("*unhandled_exception"))]
    if not bundles or bundles[-1]["exception"]["type"] != "OutOfMemoryError":
        failures.append(f"oom: bundle exception {[b.get('exception', {}).get('type') for b in bundles]}")
    oom_summary = next((e for e in seg if e["event"] == "run_summary"), {})

    fired = sorted({site for r in runs for site in r["sites"]})
    line = {"layers": DRILL_LAYERS, "width": "llama-1b (dim 2048, GQA 16/8, hd 128, vocab 32768, "
            "seq 2048, batch 2)", "reduced": f"depth cut to {DRILL_LAYERS} of {LAYERS} layers "
            "to keep saves short (the OOM drill: full depth, batch " f"{OOM_BATCH})",
            "runs": runs, "concurrent_chains_s": chains_s, "chains_low_water": low,
            "sites_fired": fired,
            "final_digests": digests, "hotswap_chaos_s": hotswap_chaos.get("seconds"),
            "fleet_s": {leg: fleet[leg]["seconds"] for leg in fleet},
            "io_retry_ops": retries, "oom_run_summary": {k: oom_summary.get(k) for k in (
                "status", "hbm_peak_pct", "goodput_pct")}}
    print(json.dumps({"drills": line}), flush=True)
    fleet_line(fleet)
    TELEMETRY["drills"] = {r["drill"]: r["classification"] for r in runs}
    shutil.rmtree(DRILL_DIR, ignore_errors=True)
    if failures:
        fail("drill phase: " + "; ".join(failures))


def chaos_chain(reports, group):
    """A group of the chaos soak (``resilience/chaos.py``) on the card, as a
    chain for `run_chains`: its trainer processes, two ranks over gloo, at
    the soak's model; its report into ``reports``."""
    from pyrecover_tpu_torch.resilience.chaos import run_soak

    def run():
        t0 = time.monotonic()
        reports[group] = run_soak("smoke", seed=0, workdir=CHAOS_DIR / group, device="cuda",
                                  groups=(group,))
        reports[group]["seconds"] = time.monotonic() - t0

    run.__name__ = f"chaos_{group}"
    return run


def checkpoint_and_chaos_phase():
    """The checkpoint phase, with the chaos soak's z1, bk and bkf groups
    (item 7) as chains beside it: the soak's small processes take the card
    and the host where the checkpoint phase leaves them room (beside the
    drills they slowed the fleet's replicas past their drill). Prints the
    ``chaos`` line; fails on any violation."""
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    reports, failures = {}, []
    run_chains("checkpoint", (checkpoint_phase,
                              *(chaos_chain(reports, g) for g in CHAOS_GROUPS)))
    chaos_line(reports, failures)
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    if failures:
        fail("chaos groups: " + "; ".join(failures))


def chaos_line(reports, failures):
    """Print the ``chaos`` line of the soak's groups the drill phase ran on
    the card (each cycle's rc and seconds, the verdicts) and add each
    violation to ``failures``."""
    from pyrecover_tpu_torch.resilience.chaos import PRESETS, print_report
    from pyrecover_tpu_torch.telemetry import read_events

    groups = {}
    for group, rep_ in reports.items():
        print_report(rep_)
        verdicts = {k: rep_[k] for k in ("zero1", "bucket") if k in rep_}
        # host 0's stream of each run: the rank-0 process's launches (a run
        # ended by SIGKILL writes no run_summary)
        launches = {}
        for path in sorted((CHAOS_DIR / group).rglob("*_telemetry.jsonl")):
            for e in read_events(path):
                if e["event"] == "run_summary":
                    for k, n in e.get("flash_launches", {}).items():
                        launches[k] = launches.get(k, 0) + n
        groups[group] = {"cycles": [{k: c[k] for k in ("name", "rc", "seconds", "ok")}
                                    for c in rep_["cycles"]],
                         "seconds": rep_["seconds"], "verdicts": verdicts,
                         "flash_launches_rank0": launches,
                         "violations": rep_["violations"]}
        for v in rep_["violations"]:
            say_failed(f"  chaos {group}: VIOLATION: {v}")
            failures.append(f"chaos {group}: {v}")
        if not all(launches.get(k, 0) > 0 for k in ("fwd", "dq", "dkv")):
            say_failed(f"  chaos {group}: flash launches {launches}, want each kernel's > 0")
            failures.append(f"chaos {group}: flash launches {launches}")
    print(json.dumps({"chaos": {
        "preset": "smoke", "seed": 0, "device": "cuda", "ranks": 2,
        "model": "the soak's own (dim 64, 2 layers, 4/2 heads, vocab 128), "
                 f"{PRESETS['smoke']['training_steps']} steps",
        "flash_instances": "head dim 16: the FMA instances (wgmma runs bf16 at d 64 and 128)",
        "groups": groups}}), flush=True)


def cast_serving_model(model, config):
    """``model``'s weights as a serving model of ``config``: each matrix in
    its compute dtype, cast once, as ``load_serving_params`` stores them."""
    import torch

    from pyrecover_tpu_torch.serving.restore import serving_model

    out = serving_model(config, model.tok_embed.device)
    with torch.no_grad():
        for dst, src in zip(out.parameters(), model.parameters(), strict=True):
            dst.copy_(src)
    return out


def paged_prefill(model, tokens, kv_mode="native"):
    """fp32 logits of ``tokens`` (a list) through the paged prefill, in
    chunks of ``SERVE_CHUNK`` against a fresh pool."""
    import torch

    from pyrecover_tpu_torch.serving import BlockPool, blocks_for, paged_forward
    from pyrecover_tpu_torch.serving.kvpool import make_block_table

    n = len(tokens)
    pool = BlockPool(model.config, blocks_for(n, SERVE_BLOCK) + 1, SERVE_BLOCK, kv_mode=kv_mode,
                     device=model.tok_embed.device)
    table = make_block_table(pool.table_width(model.config.max_seq_len),
                             pool.alloc(0, blocks_for(n, SERVE_BLOCK)))[None]
    padded = tokens + [0] * (-n % SERVE_CHUNK)
    logits = torch.cat([
        paged_forward(model, pool.arrays, [padded[s0:s0 + SERVE_CHUNK]], [s0], table,
                      block_size=SERVE_BLOCK, kv_mode=kv_mode)[0]
        for s0 in range(0, len(padded), SERVE_CHUNK)])
    pool.release(0)
    pool.check_drained()
    return logits[:n]


def serve_all(model, workload, kv_mode="native"):
    """Every request of ``workload`` through a manually pumped engine, all
    submitted at once (the same batches in every run); the pool must
    drain."""
    from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(model, ServingConfig(
        block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS, prefill_chunk=SERVE_CHUNK,
        prefill_token_budget=SERVE_BUDGET, kv_mode=kv_mode))
    rids = [engine.submit(r["prompt"], r["max_new_tokens"]) for r in workload]
    engine.run_until_drained()
    engine.pool.check_drained()
    return [engine.result(rid) for rid in rids]


def lockstep_gaps(model, got, want):
    """For each engine result in ``got`` that differs from its lockstep
    ``want``, lockstep's top-two logit gap at the first divergence (a
    near-tie in fp32 is where summation order may pick the other token)."""
    import torch

    from pyrecover_tpu_torch.models.decode import decode_forward, init_kv_cache

    device = model.tok_embed.device
    gaps = []
    for g, w in zip(got, want):
        if g == w:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        cache = init_kv_cache(model.config, 1, j, device=device)  # lockstep's logits there
        top2 = decode_forward(model, cache, torch.tensor([w[:j]], device=device), 0)[0, -1]
        top2 = top2.topk(2).values
        gaps.append((top2[0] - top2[1]).item())
    return gaps


def host_ms(fn, iters, sync):
    """Host wall time of one call of ``fn`` followed by ``sync()``, averaged
    over ``iters`` calls after one warm-up."""
    fn()
    sync()
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
    sync()
    return (time.monotonic() - t0) * 1e3 / iters


def serving_checkpoint():
    """The checkpoint the serving phase reads: one trainer run of llama-1b
    at full width and depth (``LAYERS``), ``SERVE_CKPT_STEPS`` steps and one
    verified save, at the end. Returns its path and step."""
    summary, wall = run_trainer("S", train_argv() + [
        "--attention-impl", "flash", "--training-steps", str(SERVE_CKPT_STEPS),
        "--checkpoint-dir", str(CKPT_DIR), "--experiment-name", "serve",
        "--checkpoint-frequency", str(SERVE_CKPT_STEPS), "--verify-checkpoints"])
    path = CKPT_DIR / "serve" / f"ckpt_{SERVE_CKPT_STEPS}_final.ckpt"
    digest = Path(str(path) + ".sha256").read_text()
    print(f"serving checkpoint: {path.name}, {path.stat().st_size} bytes, {digest}, final save "
          f"{summary['saves'][-1]['blocking_s']:.2f} s, run {wall:.1f} s", flush=True)
    return path, SERVE_CKPT_STEPS


def serving_phase(ckpt, config, device="cuda", step=None):
    """Serve the model of ``config`` (llama-1b) from the trainer's checkpoint
    ``ckpt`` of ``step`` (see the module docstring, item 8).
    ``device="cpu"`` rehearses the phase at a small size; its times mean
    nothing."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch.models.decode import generate_tokens
    from pyrecover_tpu_torch.models.llama import forward
    from pyrecover_tpu_torch.serving import (
        BlockPool,
        ServingConfig,
        ServingEngine,
        blocks_for,
        load_serving_params,
        lockstep_baseline,
        paged_attention,
        paged_forward,
        resident_sequences,
        run_loadgen,
        sample_workload,
    )
    from pyrecover_tpu_torch.serving.kvpool import make_block_table
    from pyrecover_tpu_torch.telemetry import metrics

    t_phase = time.monotonic()
    cuda = device == "cuda"
    card = card_line() if cuda else "cpu"
    layers = config.n_layers
    print(f"serving phase on {card}: {ckpt.name}", flush=True)
    if layers < LAYERS:
        print(f"chip_smoke: serving phase depth cut to {layers} of llama-1b's {LAYERS} layers",
              flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()
    failures = []

    def check(what, ok, detail):
        print(f"  {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    # restore once at fp32 compute (fp32 matrices); the bf16 serving model is
    # its matrices cast once, as a bf16 restore stores them
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg32, cfg16 = (dataclasses.replace(config, compute_dtype=dt, attention_impl="sdpa")
                    for dt in ("float32", "bfloat16"))
    from pyrecover_tpu_torch import telemetry

    restore_sink = telemetry.add_sink(telemetry.MemorySink())
    model32, info = load_serving_params(ckpt, cfg32, device=device)
    telemetry.remove_sink(restore_sink)
    check("restore", info["checksum"] == "xxh64tree" and info["leaves"] == 12
          and info["step"] == (CKPT_STEPS if step is None else step),
          f"{info['seconds']:.2f} s (with sha256 sidecars: "
          f"{SHA256_SIDECAR_FIGURES['serving_restore_s']} s), "
          f"{info['bytes']} bytes of .params of "
          f"{ckpt.stat().st_size} in the file, {info['leaves']} leaves, step {info['step']}, "
          f"sidecar {info['checksum']} verified before decoding")
    model16 = cast_serving_model(model32, cfg16)
    vocab = cfg16.vocab_size
    rng = np.random.default_rng(0)

    # teacher-forced: paged prefill vs the training forward (sdpa)
    prompt = rng.integers(0, vocab, (TF_PROMPT,)).tolist()
    tf_err, paged = {}, {}
    for dtype, model in (("bfloat16", model16), ("float32", model32)):
        paged[dtype] = paged_prefill(model, prompt)
        with torch.inference_mode():
            ref = forward(model, torch.tensor([prompt], device=device))[0]
        tf_err[dtype] = rel_norm_err(paged[dtype], ref)
        check(f"teacher-forced logits, {dtype}", tf_err[dtype] <= TF_REL_NORM[dtype],
              f"paged prefill vs training forward over {TF_PROMPT} positions: rel norm err "
              f"{tf_err[dtype]:.3e} (limit {TF_REL_NORM[dtype]:.0e}); argmax agrees at "
              f"{(paged[dtype].argmax(-1) == ref.argmax(-1)).float().mean().item():.4f}")
        del ref

    # fp32 greedy: the engine against lockstep generate_tokens, every request
    equal_work = sample_workload(vocab_size=vocab, max_model_len=cfg32.max_seq_len, seed=1,
                                 **EQUAL)
    got = serve_all(model32, equal_work)
    want = [generate_tokens(model32, r["prompt"], r["max_new_tokens"]) for r in equal_work]
    gaps = lockstep_gaps(model32, got, want)
    excused = sum(gap <= GREEDY_GAP for gap in gaps)
    n_new = sum(r["max_new_tokens"] for r in equal_work)
    check("fp32 greedy, engine vs generate_tokens", excused == len(gaps),
          f"{len(equal_work) - len(gaps)} of {len(equal_work)} requests ({n_new} new tokens) "
          f"equal token for token; {len(gaps)} diverge, {excused} excused (lockstep top-two "
          f"gap {gaps} <= {GREEDY_GAP})")

    # int8 KV against the native pool under the JAX package's policy, at the
    # fp32 compute its policy test runs (bf16 compute moves the logits as much
    # as the quantiser does: the two bf16 paths above differ by ~1e-2 in
    # norm); the bf16 figures are printed beside
    int8 = {}
    for dtype, model in (("float32", model32), ("bfloat16", model16)):
        paged8 = paged_prefill(model, prompt, kv_mode="int8")
        int8[dtype] = {
            "teacher_forced_match": (paged8.argmax(-1) == paged[dtype].argmax(-1))
            .float().mean().item(),
            "logit_rel": ((paged8 - paged[dtype]).abs().max() / paged[dtype].abs().max()).item(),
        }
        del paged8
    free8 = serve_all(model32, equal_work, kv_mode="int8")
    int8["float32"]["free_running_match"] = sum(
        a == b for r, x, y in zip(equal_work, free8, got)
        for a, b in zip(x[len(r["prompt"]):], y[len(r["prompt"]):])) / n_new
    f32 = int8["float32"]
    check("int8 KV, teacher-forced greedy match (fp32)",
          f32["teacher_forced_match"] >= INT8_TF_MATCH,
          f"{f32['teacher_forced_match']:.4f} over {TF_PROMPT} positions (limit >= "
          f"{INT8_TF_MATCH}; bf16: {int8['bfloat16']['teacher_forced_match']:.4f})")
    check("int8 KV, logits (fp32)", f32["logit_rel"] <= INT8_LOGIT_REL,
          f"max |int8 - native| / max |native| = {f32['logit_rel']:.4e} (limit {INT8_LOGIT_REL}; "
          f"bf16: {int8['bfloat16']['logit_rel']:.4e})")
    check("int8 KV, free-running match (fp32)", f32["free_running_match"] >= INT8_FREE_MATCH,
          f"{f32['free_running_match']:.4f} of {n_new} new tokens equal the native pool's "
          f"(limit >= {INT8_FREE_MATCH})")
    del model32, paged
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the timed bf16 run: the engine under arrivals against lockstep
    timed_work = sample_workload(vocab_size=vocab, max_model_len=cfg16.max_seq_len, seed=2,
                                 **TIMED)
    serve_all(model16, timed_work[:2])  # warm-up: cuBLAS handles and first launches
    engine = ServingEngine(model16, ServingConfig(
        block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS, prefill_chunk=SERVE_CHUNK,
        prefill_token_budget=SERVE_BUDGET))
    metrics.reset()
    timed_sink = telemetry.add_sink(telemetry.MemorySink())
    _, report = run_loadgen(engine, timed_work)
    telemetry.remove_sink(timed_sink)
    engine.pool.check_drained()
    # the stream the timed run and the restore wrote
    done = [e for e in timed_sink.events if e["event"] == "request_done"]
    admitted = [e for e in timed_sink.events if e["event"] == "request_admitted"]
    restore_spans = [e["event"] for e in restore_sink.events
                     if e.get("name") == "serving_restore"]
    loaded = [e for e in restore_sink.events if e["event"] == "weights_loaded"]
    req_spans = sorted({e["name"] for e in timed_sink.events if e["event"] == "span"})
    TELEMETRY["serving"] = {
        "request_done": len(done), "request_admitted": len(admitted),
        "kv_backpressure": sum(e["event"] == "kv_backpressure" for e in timed_sink.events),
        "request_spans": req_spans, "serving_restore_span": restore_spans,
        "weights_loaded_s": loaded[0]["seconds"] if loaded else None,
    }
    check("telemetry: 16 request_done, a serving_restore span, weights_loaded",
          len(done) == TIMED["n_requests"] and len(admitted) == TIMED["n_requests"]
          and restore_spans == ["span_begin", "span_end"] and len(loaded) == 1
          and req_spans == ["req_decode", "req_prefill", "req_queue"],
          json.dumps(TELEMETRY["serving"]))
    _, lock = lockstep_baseline(model16, timed_work[:LOCKSTEP_REQUESTS],
                                max_len=cfg16.max_seq_len)
    print(f"  timed run: {report['requests']} requests, {report['new_tokens']} new tokens; "
          "every engine pool drained", flush=True)

    # decode-step ms with every slot live, and prefill-chunk ms
    pool = engine.pool
    width = pool.table_width(engine.max_model_len)
    pos = [len(r["prompt"]) for r in timed_work[:SERVE_SLOTS]]
    tables = np.stack([make_block_table(width, pool.alloc(i, blocks_for(p + 1, SERVE_BLOCK)))
                       for i, p in enumerate(pos)])
    toks = np.ones((SERVE_SLOTS, 1), np.int64)
    step_ms = host_ms(lambda: paged_forward(model16, pool.arrays, toks, pos, tables,
                                            block_size=SERVE_BLOCK), 20, sync)
    # paged attention's share of that step: its 20 calls alone, same inputs
    n_blocks = min((max(pos) + SERVE_BLOCK) // SERVE_BLOCK, width)
    q = torch.randn(SERVE_SLOTS, 1, cfg16.n_heads, cfg16.head_dim, device=device,
                    dtype=torch.bfloat16)
    layer_pools = [{n: a[i] for n, a in pool.arrays.items()} for i in range(layers)]
    tables_t = torch.as_tensor(tables, device=device).long()
    qpos = torch.as_tensor(pos, device=device)[:, None]
    with torch.inference_mode():
        attn_ms = host_ms(lambda: [paged_attention(
            q, lp, tables_t, qpos, cfg16.head_dim**-0.5, SERVE_BLOCK, "native", n_blocks)
            for lp in layer_pools], 20, sync)
    # the device's busy time within decode steps (union of kernel intervals)
    step_device = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                paged_forward(model16, pool.arrays, toks, pos, tables, block_size=SERVE_BLOCK)
            sync()
        busy, by_name = device_busy_ms(prof.events())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        step_device = {"busy_ms_per_step": busy / 5,
                       "idle_pct": 100.0 * max(0.0, 1 - busy / 5 / step_ms),
                       "top_kernels_ms_per_step": [[n[:80], ms / 5] for n, ms in top]}
    chunk = np.ones((1, SERVE_CHUNK), np.int64)
    deep = max(0, (max(pos) // SERVE_CHUNK) * SERVE_CHUNK)
    chunk_ms = {f"pos {p0}": host_ms(lambda p0=p0: paged_forward(
        model16, pool.arrays, chunk, [p0], tables[:1], block_size=SERVE_BLOCK), 10, sync)
        for p0 in sorted({0, deep})}
    for i in range(SERVE_SLOTS):
        pool.release(i)
    pool.check_drained()
    nbytes = pool.pool_bytes()
    out = {
        "card": card, "layers": layers, "restore": info,
        "teacher_forced_rel_norm_err": tf_err, "teacher_forced_limit": TF_REL_NORM,
        "fp32_greedy": {"requests": len(equal_work), "new_tokens": n_new,
                        "diverged": len(gaps), "excused": excused, "top2_gaps": gaps,
                        "gap_limit": GREEDY_GAP},
        "int8": int8,
        "timed": {
            "workload": TIMED, "slots": SERVE_SLOTS, "block_size": SERVE_BLOCK,
            "prefill_chunk": SERVE_CHUNK, "prefill_token_budget": SERVE_BUDGET,
            "engine_tokens_per_sec": report["tokens_per_sec"], "engine_wall_s": report["wall_s"],
            "lockstep_tokens_per_sec": lock["tokens_per_sec"], "lockstep_wall_s": lock["wall_s"],
            "lockstep_requests": lock["requests"],
            "speedup": report["tokens_per_sec"] / lock["tokens_per_sec"],
            "ttft_s": report["ttft_s"], "tpot_s": report["tpot_s"], "e2e_s": report["e2e_s"],
            "backpressure_events": report["backpressure_events"],
        },
        "decode_step_ms_8_slots": {"ms": step_ms, "positions": pos,
                                   "paged_attention_ms": attn_ms, "device": step_device},
        "prefill_chunk_ms": chunk_ms,
        "pool_bytes": nbytes,
        "resident_sequences_2048": {
            mode: resident_sequences(nbytes, cfg16, SERVE_BLOCK, mode, cfg16.max_seq_len)
            for mode in ("native", "int8")},
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        "phase_s": time.monotonic() - t_phase,
    }
    print(json.dumps({"serving": out}), flush=True)
    del model16, engine, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if failures:
        fail("serving phase: " + "; ".join(failures))


# ======================= the MoE phase (item 13) =======================


def moe_argv(layers=MOE_LAYERS, steps=MOE_STEPS, device="cuda"):
    """The trainer's flags for moe-4x1b (``models/presets.py``) at full width
    on the card: dim 2048, GQA 16/8, 4 top-2 experts of ffn 7168, vocab
    32768, seq 1024, batch 4, bf16 compute, fp32 masters, flash, synthetic
    data through the ``DataLoader``, no saves."""
    return [
        "--model-dim", "2048", "--model-layers", str(layers), "--model-heads", "16",
        "--model-kv-heads", "8", "--vocab-size", "32768", "--moe-experts", "4",
        "--moe-top-k", "2", "--sequence-length", str(MOE_SEQ), "--batch-size", str(MOE_BATCH),
        "--training-samples", str(MOE_BATCH * steps), "--training-steps", str(steps),
        "--lr-warmup-steps", "2", "--learning-rate", "3e-4", "--logging-frequency", "1",
        "--seed", "0", "--device", device, "--attention-impl", "flash", "--checkpoint-dir", str(MOE_DIR),
        "--checkpoint-frequency", "0",
    ]


def moe_train(fa):
    """M-T: moe-4x1b at full width and depth, ``MOE_STEPS`` steps through
    ``train.main``, every flash launch counted; two steady steps of a 4-step
    run under ``torch.profiler`` (the device's busy time by kernel group and
    its idle share); then ``MOE_GUARD_STEPS`` steps after the first under
    ``--transfer-guard disallow``. Returns the launch counts and the line."""
    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models import presets
    from pyrecover_tpu_torch.models.moe import dispatch_backend
    from pyrecover_tpu_torch.telemetry import detectors, read_events
    from pyrecover_tpu_torch.utils.perf import get_num_flop_per_token

    cfg = get_args(moe_argv()).model
    preset = presets.moe_4x1b(max_seq_len=MOE_SEQ)
    shape = ("dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "ffn_hidden_dim",
             "n_experts", "moe_top_k", "moe_capacity_factor", "moe_aux_weight")
    if any(getattr(cfg, k) != getattr(preset, k) for k in shape):
        fail(f"the MoE line's model is not moe-4x1b: {cfg}")
    fa.reset_launch_counts()
    out = train.main(moe_argv() + ["--experiment-name", "moe-train"])
    counts = fa.launch_counts()
    counts.update({f"{k}_chunked": n for k, n in fa.chunked_launch_counts().items()})
    gc.collect()
    torch.cuda.empty_cache()
    losses, aux = out["losses"], out["moe_aux"]
    n = MOE_LAYERS * MOE_STEPS
    want = {k: n for k in ("fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")}
    want.update(fwd_chunked=0, dq_chunked=0, dkv_chunked=0)
    step_ms = float(np.median(out["window_step_ms"][1:5]))
    tokens_per_s = MOE_BATCH * MOE_SEQ / (step_ms / 1e3)
    active = presets.analytic_active_param_count(cfg, exclude_embedding=True)
    flop_per_token = get_num_flop_per_token(active, cfg.n_layers, cfg.n_heads, cfg.head_dim,
                                            MOE_SEQ)
    line = {
        "model": "moe-4x1b", "layers": MOE_LAYERS, "steps": MOE_STEPS, "batch": MOE_BATCH,
        "seq": MOE_SEQ, "dispatch": dispatch_backend(cfg),
        "params": presets.analytic_param_count(cfg),
        "active_params": presets.analytic_active_param_count(cfg),
        "losses": losses, "moe_aux": aux, "window_step_ms": out["window_step_ms"],
        "median_step_ms_2_5": step_ms, "tokens_per_sec": tokens_per_s,
        "active_tflop_per_step": flop_per_token * MOE_BATCH * MOE_SEQ / 1e12,
        "active_mfu_pct": 100.0 * flop_per_token * tokens_per_s / H100_BF16_FLOPS,
        "trainer_mfu_pct": out["mfu_pct"], "peak_mem_gib": out["peak_mem_gib"],
        "launches": counts,
    }
    problems = []
    if len(losses) != MOE_STEPS or not all(math.isfinite(x) for x in losses + aux):
        problems.append(f"losses {losses}, aux {aux}")
    if counts != want:
        problems.append(f"launch counts {counts}, want {want}: layers x steps, every launch "
                        "on a tensor-core instance, none chunked")
    if not problems:  # two steady steps under the profiler: device time by group
        busy, by_name, _ = profiled_busy(train, ["--experiment-name", "moe-prof"],
                                         moe_argv(steps=4))
        line["device"] = step_breakdown(step_ms, busy, by_name)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"moe_train": line}), flush=True)
    if problems:
        fail("MoE train line: " + "; ".join(problems))

    argv = moe_argv(steps=MOE_GUARD_STEPS + 1) + [
        "--experiment-name", "moe-guard", "--telemetry", "--transfer-guard", "disallow"]
    path = Path(get_args(argv).checkpoint_dir) / "moe-guard" / "moe-guard_telemetry.jsonl"
    error = None
    try:
        train.main(argv)
    except detectors.ImplicitTransferError as e:
        error = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    found = [e for e in read_events(path) if e["event"] == "implicit_transfer"]
    print(json.dumps({"moe_transfer_guard": {"guarded_steps": MOE_GUARD_STEPS,
                                             "implicit_transfer": len(found), "events": found,
                                             "error": error}}), flush=True)
    if found or error:
        fail(f"implicit transfers in the MoE step's dispatch: {found or error}")
    moe_fp32_guard()
    return counts, line


def moe_fp32_guard(device="cuda"):
    """One fp32 step of the MoE trainer (M-R's depth, the ``auto`` backend)
    after the first under ``--transfer-guard disallow``, which may not
    fire."""
    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models import moe
    from pyrecover_tpu_torch.telemetry import detectors, read_events

    argv = moe_argv(layers=MOE_R_LAYERS, steps=2, device=device) + [
        "--model-dtype", "fp32", "--experiment-name", "moe-guard-fp32", "--telemetry",
        "--transfer-guard", "disallow"]
    cfg = get_args(argv).model
    path = Path(get_args(argv).checkpoint_dir) / "moe-guard-fp32" / "moe-guard-fp32_telemetry.jsonl"
    error = None
    try:
        train.main(argv)
    except detectors.ImplicitTransferError as e:
        error = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    found = [e for e in read_events(path) if e["event"] == "implicit_transfer"]
    print(json.dumps({"moe_transfer_guard_fp32": {
        "layers": MOE_R_LAYERS, "guarded_steps": 1, "auto_backend": moe.dispatch_backend(cfg),
        "implicit_transfer": len(found), "events": found, "error": error}}), flush=True)
    if found or error:
        fail(f"implicit transfers in the fp32 MoE step's dispatch: {found or error}")


def moe_layer_inputs(cfg, device):
    """One MoE layer of ``cfg`` on ``device``, seeded: h (B, S, D) bf16, the
    router and experts (fp32) at the trainer's init scales, and the upstream
    gradient of y (bf16)."""
    import torch

    g = torch.Generator(device=device).manual_seed(5)
    D, E, F = cfg.dim, cfg.n_experts, cfg.expert_hidden_dim

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    resid = 0.02 / (2 * cfg.n_layers) ** 0.5
    h = randn(MOE_BATCH, MOE_SEQ, D).bfloat16()
    weights = [randn(D, E, std=0.02), randn(E, D, F, std=0.02), randn(E, D, F, std=0.02),
               randn(E, F, D, std=resid)]
    dy = randn(MOE_BATCH, MOE_SEQ, D).bfloat16()
    return h, weights, dy


def moe_backends(device="cuda"):
    """M-B: one MoE layer at moe-4x1b's width (B 4, S 1024, D 2048, E 4,
    top-2, F 7168, C 640). grouped, scatter and einsum in bf16: the output
    and the gradients of h, router and moe_w1/w3/w2 held to each other and
    to an fp32 grouped run of the same inputs (h upcast, fp32 weights);
    each backend's forward + backward timed on the card's clock. ``device``
    "cpu" rehearses the checks (no times)."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models import moe

    cfg = get_args(moe_argv(device=device)).model
    C = moe.moe_capacity(MOE_SEQ, cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
    h16, weights, dy = moe_layer_inputs(cfg, device)
    names = ("y", "dh", "drouter", "dmoe_w1", "dmoe_w3", "dmoe_w2")

    def run(backend, h):
        c = dataclasses.replace(cfg, moe_dispatch=backend)
        hh = h.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in weights]
        y, aux = moe.moe_ffn(hh, *ws, c)
        grads = torch.autograd.grad((y, aux), (hh, *ws),
                                    (dy.to(y.dtype), torch.ones_like(aux)))
        return [y.detach().float(), *(x.float() for x in grads)], aux.detach()

    _, eids, _, _, _, valid = moe._route(h16, weights[0], cfg.n_experts, cfg.moe_top_k, C)
    ref, ref_aux = run("grouped", h16.float())
    got, failures, errs = {}, [], {}
    for backend in moe.DISPATCH_BACKENDS:
        got[backend], aux = run(backend, h16)
        errs[backend] = {"vs_fp32": {}, "vs_grouped": {}}
        for i, name in enumerate(names):
            e32 = rel_norm_err(got[backend][i], ref[i])
            errs[backend]["vs_fp32"][name] = e32
            if not e32 <= MOE_BF16_VS_FP32:
                failures.append(f"{backend} {name} vs fp32 {e32:.3e}")
            if backend != "grouped":
                eg = rel_norm_err(got[backend][i], got["grouped"][i])
                errs[backend]["vs_grouped"][name] = eg
                if not eg <= MOE_BACKENDS_REL:
                    failures.append(f"{backend} {name} vs grouped {eg:.3e}")
        if not torch.allclose(aux, ref_aux, rtol=1e-5):
            failures.append(f"{backend} aux {aux.tolist()} vs fp32 {ref_aux.tolist()}")
    del got, ref
    torch.cuda.empty_cache()

    def step(backend):
        c = dataclasses.replace(cfg, moe_dispatch=backend)
        hh = h16.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in weights]

        def fn():
            y, aux = moe.moe_ffn(hh, *ws, c)
            torch.autograd.grad((y, aux), (hh, *ws), (dy, torch.ones_like(aux)))
        return fn

    ms = {b: cuda_time_ms(step(b), 5) if device == "cuda" else None
          for b in moe.DISPATCH_BACKENDS}
    line = {
        "shape": {"B": MOE_BATCH, "S": MOE_SEQ, "D": cfg.dim, "E": cfg.n_experts,
                  "K": cfg.moe_top_k, "F": cfg.expert_hidden_dim, "C": C},
        "auto_picks": moe.dispatch_backend(cfg),
        "dropped_pick_share": 1.0 - valid.float().mean().item(),
        "picks_per_expert": torch.bincount(eids.reshape(-1).cpu(),
                                           minlength=cfg.n_experts).tolist(),
        "fwd_bwd_ms": ms, "rel_norm_err": errs,
        "limits": {"bf16_vs_fp32": MOE_BF16_VS_FP32, "backends": MOE_BACKENDS_REL},
    }
    print(json.dumps({"moe_backends": line}), flush=True)
    if failures:
        fail("MoE backends disagree: " + ", ".join(failures))
    return line


def moe_attention_check(first_loss, device="cuda"):
    """M-A: from the trainer's initial moe-4x1b weights and first batch, the
    bf16 loss with flash against sdpa (``BF16_LOSS_RTOL``), and flash's
    against the train line's first loss (``SAME_LOSS_RTOL``)."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import forward_hidden_with_aux
    from pyrecover_tpu_torch.train_state import chunked_ce

    config = get_args(moe_argv(device=device))
    device = train.resolve_device(config.device)
    model = train.build_model(config, device)
    batch = first_batch(config, device)
    loss = {}
    with torch.no_grad():
        for impl in ("flash", "sdpa"):
            model.config = dataclasses.replace(config.model, attention_impl=impl)
            hidden, aux = forward_hidden_with_aux(model, batch["inputs"])
            loss[impl] = chunked_ce(model, hidden, batch["labels"], 0)[0].item()
            loss[f"{impl}_aux"] = aux.item()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(json.dumps({"moe_attention_check": {"loss": loss, "train_first_loss": first_loss,
                                              "limits": [BF16_LOSS_RTOL, SAME_LOSS_RTOL]}}),
          flush=True)
    if not abs(loss["flash"] - loss["sdpa"]) <= BF16_LOSS_RTOL * abs(loss["sdpa"]):
        fail(f"MoE bf16 flash loss {loss['flash']} vs sdpa {loss['sdpa']}")
    if not abs(loss["flash"] - first_loss) <= SAME_LOSS_RTOL * abs(first_loss):
        fail(f"MoE flash loss {loss['flash']} vs the train line's first {first_loss}")


def moe_resume(device="cuda"):
    """M-R: moe-4x1b at ``MOE_R_LAYERS`` layers under deterministic
    algorithms (trainer subprocesses): A trains ``MOE_R_STEPS`` steps straight,
    B1 stops at step 2 and B2 resumes from ``latest`` to the end. Loss CSVs
    equal row for row, the final checkpoints' ``xxh64tree:`` digests equal.
    Returns B2's final checkpoint and the line."""
    root = MOE_DIR / "resume"
    shutil.rmtree(root, ignore_errors=True)

    def argv(name, steps, *extra):
        return moe_argv(layers=MOE_R_LAYERS, steps=MOE_R_STEPS, device=device) + [
            "--training-steps", str(steps), "--checkpoint-dir", str(root),
            "--experiment-name", name, "--checkpoint-frequency", "2",
            "--max-kept-checkpoints", "1", "--verify-checkpoints", "--log-loss-to-csv", *extra]

    runs = {}

    def straight():
        runs["A"] = run_trainer("M-R A", argv("a", MOE_R_STEPS))

    def stopped_and_resumed():
        runs["B1"] = run_trainer("M-R B1", argv("b", 2))
        runs["B2"] = run_trainer("M-R B2", argv("b", MOE_R_STEPS, "--resume-from-checkpoint",
                                                "latest"))

    wall = run_chains("moe resume", [straight, stopped_and_resumed])
    (a, a_wall), (b1, _), (b2, b2_wall) = runs["A"], runs["B1"], runs["B2"]
    final = f"ckpt_{MOE_R_STEPS}_final.ckpt"
    digest_a = (root / "a" / (final + ".sha256")).read_text()
    digest_b = (root / "b" / (final + ".sha256")).read_text()
    rows_a, rows_b = loss_rows(root / "a"), loss_rows(root / "b")
    n = MOE_R_LAYERS * (MOE_R_STEPS - 2)
    checks = {
        "B2 resumed at step 2 and ended at the last step": (b1["end_step"], b2["start_step"],
                                                            b2["end_step"]) == (2, 2,
                                                                                MOE_R_STEPS),
        "loss CSVs equal row for row": rows_a == rows_b and len(rows_a) == MOE_R_STEPS + 1,
        "final checkpoints equal (xxh64tree sidecars)": digest_a == digest_b
        and digest_a.startswith("xxh64tree:"),
        "B2's flash launches on the tensor-core instances": b2["launches"] == {
            k: n for k in ("fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")},
    }
    for what, ok in checks.items():
        print(f"  M-R {what}: {'ok' if ok else 'FAIL'}", flush=True)
    line = {
        "layers": MOE_R_LAYERS, "bytes": (root / "b" / final).stat().st_size, "digest": digest_a,
        "saves": [{"run": r, "blocking_s": sv["blocking_s"], "write_s": sv["write_s"],
                   "bytes": sv["bytes"]} for r, s in (("A", a), ("B1", b1), ("B2", b2))
                  for sv in s["saves"]],
        "load_s": b2["ckpt_load_s"], "precheck_s": b2["ckpt_precheck_s"],
        "losses": {"A": a["losses"], "B": b1["losses"] + b2["losses"]},
        "wall_s": {"chains_at_once": wall, "A": a_wall, "B2": b2_wall},
    }
    print(json.dumps({"moe_resume": line}), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        fail("MoE resume: " + "; ".join(bad))
    return root / "b" / final, line


def moe_serve(ckpt, config, device="cuda"):
    """M-S: M-R's final checkpoint through ``load_serving_params`` at fp32
    compute: the paged prefill of a ``TF_PROMPT``-token prompt against the
    training forward at the no-drop capacity (``TF_REL_NORM``), and the
    engine (native KV) against ``generate_tokens``, token for token, over
    the ``EQUAL`` workload's 8 requests; then that prefill and those 8
    requests timed with ``grouped`` and with ``scatter``."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch.models import moe
    from pyrecover_tpu_torch.models.decode import generate_tokens, no_drop_config
    from pyrecover_tpu_torch.models.llama import forward
    from pyrecover_tpu_torch.serving import load_serving_params, sample_workload

    cfg = no_drop_config(dataclasses.replace(config, compute_dtype="float32",
                                             attention_impl="sdpa"))
    model, info = load_serving_params(ckpt, cfg, device=device)
    failures = []

    def check(what, ok, detail):
        print(f"  M-S {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    check("restore", info["checksum"] == "xxh64tree" and info["leaves"] == 13
          and info["step"] == MOE_R_STEPS,
          f"{info['seconds']:.2f} s, {info['bytes']} bytes of .params, {info['leaves']} leaves, "
          f"step {info['step']}, sidecar {info['checksum']}")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (TF_PROMPT,)).tolist()
    paged = paged_prefill(model, prompt)
    with torch.inference_mode():
        ref = forward(model, torch.tensor([prompt], device=device))[0]
    tf = rel_norm_err(paged, ref)
    check("teacher-forced logits, float32", tf <= TF_REL_NORM["float32"],
          f"paged prefill vs training forward (no-drop) over {TF_PROMPT} positions: rel norm "
          f"err {tf:.3e} (limit {TF_REL_NORM['float32']:.0e})")
    work = sample_workload(vocab_size=cfg.vocab_size, max_model_len=cfg.max_seq_len, seed=1,
                           **EQUAL)
    got = serve_all(model, work)
    want = [generate_tokens(model, r["prompt"], r["max_new_tokens"]) for r in work]
    gaps = lockstep_gaps(model, got, want)
    excused = sum(gap <= GREEDY_GAP for gap in gaps)
    n_new = sum(r["max_new_tokens"] for r in work)
    check("fp32 greedy, engine vs generate_tokens", excused == len(gaps),
          f"{len(work) - len(gaps)} of {len(work)} requests ({n_new} new tokens) equal token "
          f"for token; {len(gaps)} diverge, {excused} excused (gaps {gaps} <= {GREEDY_GAP})")
    # at the no-drop capacity (cf = E) scatter fills E·S·K slots a row where
    # grouped runs its S·K picks: both timed on the same prompt and requests
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    served_cfg, backends_ms = model.config, {}
    for backend in ("grouped", "scatter"):
        model.config = dataclasses.replace(served_cfg, moe_dispatch=backend)
        backends_ms[backend] = {
            "prefill_ms": host_ms(lambda: paged_prefill(model, prompt), 2, sync),
            "serve_ms": host_ms(lambda: serve_all(model, work), 1, sync)}
    model.config = served_cfg
    line = {"restore": info, "teacher_forced_rel_norm_err": tf,
            "fp32_greedy": {"requests": len(work), "new_tokens": n_new, "diverged": len(gaps),
                            "excused": excused, "top2_gaps": gaps},
            "auto_backend": moe.dispatch_backend(cfg), "fp32_backends_ms": backends_ms,
            "card": card_line() if device == "cuda" else "cpu"}
    print(json.dumps({"moe_serve": line}), flush=True)
    del model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if failures:
        fail("MoE serving: " + "; ".join(failures))
    return line


def moe_phase(fa):
    """The MoE slice on the card (module docstring, item 13): M-T, then M-R's
    trainer subprocesses beside M-A, then M-B alone (it is timed), then M-S
    on M-R's final checkpoint. Returns M-T's flash launch counts."""
    import threading

    from pyrecover_tpu_torch.config import get_args

    shutil.rmtree(MOE_DIR, ignore_errors=True)
    counts, train_line = moe_train(fa)
    resumed = {}

    def resume():
        try:
            resumed["out"] = moe_resume()
        except SystemExit:  # `fail` in this thread printed why; the phase fails below
            pass

    thread = threading.Thread(target=resume, name="moe-resume")
    thread.start()
    moe_attention_check(train_line["losses"][0])
    thread.join()
    if "out" not in resumed:
        fail("MoE resume (see above)")
    moe_backends()
    moe_serve(resumed["out"][0], get_args(moe_argv(layers=MOE_R_LAYERS)).model)
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    return counts


def hotswap_argv(device="cuda"):
    """The live leg's trainer: llama-1b's width, ``HS_LAYERS`` deep, flash,
    bf16 compute and fp32 masters, a zerostall save every ``HS_EVERY`` steps
    (every manifest kept: each version served is restored again for the
    checks), telemetry on."""
    return train_argv() + [
        "--model-layers", str(HS_LAYERS), "--training-steps", str(HS_STEPS),
        "--training-samples", str(BATCH * HS_STEPS), "--attention-impl", "flash",
        "--checkpoint-engine", "zerostall", "--checkpoint-frequency", str(HS_EVERY),
        "--max-kept-checkpoints", str(HS_STEPS), "--checkpoint-dir", str(HS_DIR),
        "--experiment-name", "live", "--telemetry", "--device", device]


def wait_for(what, fn, proc=None, timeout=300.0):
    """Poll ``fn()`` until it returns something true; fail on timeout or
    when ``proc`` exits first."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        if proc is not None and proc.poll() is not None:
            out = fn()
            if out:
                return out
            fail(f"{what}: the process exited {proc.returncode} first")
        time.sleep(0.05)
    fail(f"{what}: not within {timeout} s")


def hotswap_phase(device="cuda"):
    """The live plane and the hot-swap on the card (module docstring, item
    14): the live leg and the perturbation leg (the chaos leg runs in the
    drill phase). Every check prints ok/FAIL; the phase fails at its end if
    any failed."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch import telemetry
    from pyrecover_tpu_torch.checkpoint import zerostall
    from pyrecover_tpu_torch.checkpoint.registry import get_latest_checkpoint
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import read_manifest
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.decode import generate_tokens
    from pyrecover_tpu_torch.serving import (
        ServingConfig,
        ServingEngine,
        load_serving_params,
        open_loop_workload,
    )
    from pyrecover_tpu_torch.serving.hotswap import (
        HotSwapper,
        diff_manifest_chunks,
        drill,
    )
    from pyrecover_tpu_torch.serving.loadgen import live_scrape_digest
    from pyrecover_tpu_torch.serving.restore import serving_model
    from pyrecover_tpu_torch.telemetry import metrics, traceassembly, traceview, tracing
    from pyrecover_tpu_torch.telemetry.aggregate import FleetAggregator
    from pyrecover_tpu_torch.telemetry.exporter import MetricsExporter
    from pyrecover_tpu_torch.train_state import param_leaves

    t_phase = time.monotonic()
    shutil.rmtree(HS_DIR, ignore_errors=True)
    HS_DIR.mkdir(parents=True)
    cuda = device == "cuda"
    failures = []

    def check(what, ok, detail):
        print(f"  {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    argv = hotswap_argv(device)
    config = get_args(argv)
    exp = HS_DIR / "live"
    cfg32 = dataclasses.replace(config.model, compute_dtype="float32", attention_impl="sdpa")
    scfg = ServingConfig(block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS, prefill_chunk=SERVE_CHUNK,
                         prefill_token_budget=SERVE_BUDGET)
    if cfg32.n_layers < LAYERS:
        print(f"chip_smoke: hotswap phase depth cut to {cfg32.n_layers} of llama-1b's {LAYERS} "
              "layers", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the live leg: a trainer child beside the engine -------------------
    # `trainer_child` (as the checkpoint phase starts it) reports the run's
    # flash launch counts in its summary line
    log = open(HS_DIR / "trainer.log", "w")
    env = {**os.environ, "PYRECOVER_METRICS_PORT": "0", "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    env.pop("PYRECOVER_FAULT_PLAN", None)
    t_spawn = time.monotonic()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--trainer", *argv],
                            cwd=Path(__file__).resolve().parent, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    mem = telemetry.add_sink(telemetry.MemorySink())
    stream = HS_DIR / "engine_telemetry.jsonl"
    sink = telemetry.add_sink(telemetry.JsonlSink(stream))
    engine_exporter = swapper = engine = None
    try:
        trainer_stream = exp / "live_telemetry.jsonl"

        def exporter_port():
            started = [e for e in telemetry.read_events(trainer_stream)
                       if e["event"] == "exporter_started"] if trainer_stream.exists() else []
            return started[0]["port"] if started else None

        trainer_port = wait_for("the trainer's exporter_started", exporter_port, proc)
        first = wait_for("the trainer's first manifest", lambda: get_latest_checkpoint(exp), proc)
        host = {}
        model, info = load_serving_params(first, cfg32, device=device, host_bytes=host)
        engine = ServingEngine(model, scfg)
        engine.submit([1, 2, 3], 2)  # warm the engine before the window
        engine.run_until_drained()
        metrics.reset()
        engine_exporter = MetricsExporter(port=0).start()
        agg = FleetAggregator([f"127.0.0.1:{trainer_port}",
                               f"127.0.0.1:{engine_exporter.port}"], stale_after_s=5.0,
                              timeout_s=2.0)
        swapper = HotSwapper(engine, exp, cfg32, loaded_path=first, loaded_host=host,
                             poll_interval_s=0.2)
        first_step = swapper.loaded_step
        print(f"  live leg: trainer exporter :{trainer_port}, engine exporter "
              f":{engine_exporter.port}, serving {first.name} restored in "
              f"{info['seconds']:.2f} s ({info['bytes']} bytes)", flush=True)
        workload = open_loop_workload(HS_LOAD_MAX_S, vocab_size=cfg32.vocab_size,
                                      max_model_len=engine.max_model_len, seed=11, **HS_LOAD)
        rng = np.random.default_rng(12)
        flip_prompts = [rng.integers(0, cfg32.vocab_size, HS_FLIP_PROBE["prompt_len"]).tolist()
                        for _ in range(HS_FLIP_PROBE["n"])]
        swapper.start()
        engine.start()
        t0 = time.monotonic()
        served, flips, polls, mid, flip_mono = [], [], [], None, []
        version = engine.weights_step
        next_poll = t0
        # until the loop itself has seen the last flip land (the swapper's
        # step moves when a swap is staged, the engine's at the flip)
        while not (proc.poll() is not None and version >= HS_STEPS):
            now = time.monotonic() - t0
            if now > HS_LOAD_MAX_S:
                fail(f"hotswap live leg: the trainer and the last swap did not end in "
                     f"{HS_LOAD_MAX_S} s (trainer rc {proc.poll()}, loaded step "
                     f"{swapper.loaded_step}, rejected {swapper.rejected})")
            while len(served) < len(workload) and workload[len(served)]["arrival_s"] <= now:
                req = workload[len(served)]
                # the client stands in for a router: a trace per request
                ctx = tracing.mint(req["rid"])
                telemetry.emit("trace_root", rid=req["rid"], trace=ctx.trace, span=ctx.span,
                               verdict="accepted", mono=round(time.monotonic(), 6))
                with tracing.installed(ctx):
                    served.append((engine.submit(req["prompt"], req["max_new_tokens"]), ctx))
            if engine.weights_step != version:  # a flip landed: probe the new weights
                version = engine.weights_step
                flip_mono.append(time.monotonic())
                flips.append((version, [engine.submit(pr, HS_FLIP_PROBE["new_tokens"])
                                        for pr in flip_prompts]))
            if time.monotonic() >= next_poll:
                polls.append(agg.poll())
                next_poll += HS_SCRAPE_S
                if mid is None and swapper.loaded_step >= first_step + 2 * HS_EVERY:
                    mid = polls[-1]
            time.sleep(0.002)
        window_s = time.monotonic() - t0
        wait_for("the live leg's drain", lambda: engine.pending == 0, timeout=120.0)
        after = agg.poll()
        engine.stop()
        trainer_rc = proc.wait(timeout=60)
        engine.pool.check_drained()
        for rid, ctx in served:  # the root span each trace hangs under
            r = engine._done[rid]
            telemetry.record_span("req_root", r.t_submit, r.t_done, span_id=ctx.span,
                                  trace=ctx.trace, rid=rid, attempts=1, redrives=0)
        # each request's time per output token, split by whether a flip
        # landed while it decoded (the trainer shares the card with both)
        tpot = {True: [], False: []}
        for rid, _ in served:
            r = engine._done[rid]
            tpot[any(r.t_first_token < t < r.t_done for t in flip_mono)].append(
                (r.t_done - r.t_first_token) / max(r.n_new - 1, 1))
        live_report = {
            "requests": len(served), "window_s": window_s,
            "tpot_p99_s": metrics.histogram("tpot_s").percentile(0.99),
            "e2e_p99_s": metrics.histogram("e2e_s").percentile(0.99),
            "ttft_p99_s": metrics.histogram("ttft_s").percentile(0.99),
            "tpot_s_across_a_flip": {"n": len(tpot[True]), "max": max(tpot[True], default=None),
                                     "median": float(np.median(tpot[True])) if tpot[True]
                                     else None},
            "tpot_s_no_flip": {"n": len(tpot[False]),
                               "p99": float(np.percentile(tpot[False], 99)) if tpot[False]
                               else None,
                               "median": float(np.median(tpot[False])) if tpot[False]
                               else None}}
        summary = [ln for ln in (HS_DIR / "trainer.log").read_text().splitlines()
                   if ln.startswith("trainer summary: ")]
        launches = json.loads(summary[0][len("trainer summary: "):])["launches"] \
            if summary else None
        want_launches = {k: HS_LAYERS * HS_STEPS for k in (
            "fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")} if cuda else launches
        check("trainer", trainer_rc == 0 and launches is not None and launches == want_launches,
              f"rc {trainer_rc}, {time.monotonic() - t_spawn:.1f} s from spawn (log "
              f"{HS_DIR / 'trainer.log'}); flash launches {launches}, want {want_launches}: every "
              "forward, dq and dk/dv launch on the tensor-core instances")
        if trainer_rc != 0:
            print(Path(HS_DIR / "trainer.log").read_text()[-4000:], flush=True)
        done = [e for e in mem.events if e["event"] == "weights_swap_done"]
        begins = [e for e in mem.events if e["event"] == "weights_swap_begin"]
        fetches = [e for e in mem.events if e["event"] == "swap_fetch_bytes"]
        rejected = [e for e in mem.events if e["event"] == "weights_swap_rejected"]
        swaps = []
        for b, f, d in zip(begins, fetches, done):
            total = f["fetched_bytes"] + f["reused_bytes"]
            fetch_s = f["ts"] - b["ts"]
            swaps.append({"to_step": d["step"], "swap_s": d["swap_s"], "fetch_s": fetch_s,
                          "fetched_bytes": f["fetched_bytes"], "reused_bytes": f["reused_bytes"],
                          "fetch_gb_s": f["fetched_bytes"] / fetch_s / 1e9,
                          "verify_gb_s": total / fetch_s / 1e9, "in_flight": d["in_flight"]})
        check("swaps landed", len(done) >= 2 and not rejected and swapper.loaded_step == HS_STEPS,
              f"{len(done)} swaps in a {window_s:.1f} s window (steps "
              f"{[d['step'] for d in done]}), {len(rejected)} rejected, loaded step "
              f"{swapper.loaded_step}; {len(served)} requests served open-loop")

        # every flip's probes against lockstep decoding of that manifest
        restores = {}

        def cold(step):
            if step not in restores:
                path = next(p for p in (exp / f"ckpt_{step}_final.zs.json",
                                        exp / f"ckpt_{step}.zs.json") if p.exists())
                restores[step] = (path, load_serving_params(path, cfg32, device=device)[0])
            return restores[step]

        gaps, n_probes = [], 0
        for step, rids in flips:
            got = [engine.result(r) for r in rids]
            path, ref_model = cold(step)
            want = [generate_tokens(ref_model, pr, HS_FLIP_PROBE["new_tokens"])
                    for pr in flip_prompts]
            gaps += lockstep_gaps(ref_model, got, want)
            n_probes += len(rids)
            if step != HS_STEPS:
                del restores[step]
        check("no mixed weights", len(flips) == len(done)
              and all(gap <= GREEDY_GAP for gap in gaps),
              f"{n_probes} probes submitted at {len(flips)} flips equal lockstep decoding of "
              f"each manifest's cold restore token for token but {len(gaps)} (top-two gaps "
              f"{gaps} <= {GREEDY_GAP})")

        # the post-swap probe against a cold restore of the final manifest
        probe = drill.probe_workload(cfg32)
        live_tokens = drill.run_probe(engine, probe)
        engine.pool.check_drained()
        final_path, final_model = cold(HS_STEPS)
        cold_engine = ServingEngine(final_model, scfg)
        cold_tokens = drill.run_probe(cold_engine, probe)
        cold_engine.pool.check_drained()
        check("post-swap probe", live_tokens == cold_tokens,
              f"{len(probe)} requests after the last swap equal a cold restore of "
              f"{final_path.name} token for token: {live_tokens == cold_tokens}")

        digests = {}
        for label, fleet in (("mid", mid), ("after_drain", after)):
            digests[label] = {
                "ok": None if fleet is None else fleet["n_ok"],
                "stale": None if fleet is None else fleet["stale"],
                **({} if fleet is None else live_scrape_digest(fleet))}
        mid_ok = mid is not None and mid["n_ok"] == 2 and all(
            h in mid["hists"] for h in ("step_iter_s", "e2e_s"))
        after_ok = all(h in after["hists"] for h in ("step_iter_s", "e2e_s"))
        scrape_ms = [1e3 * e["seconds"] for e in mem.events if e["event"] == "metrics_scrape"]
        check("fleet scrapes", mid_ok and after_ok,
              f"mid-run both targets live with the trainer's step_iter_s "
              f"(n={digests['mid'].get('step_iter_count')}) and the engine's e2e_s "
              f"(n={digests['mid'].get('e2e_count')}); after the drain step_iter_s "
              f"n={digests['after_drain']['step_iter_count']}, e2e_s "
              f"n={digests['after_drain']['e2e_count']}, stale {after['stale']} (a target "
              f"that exited keeps its last totals); {len(scrape_ms)} polls, "
              f"{float(np.median(scrape_ms)):.2f} ms median")

        # ---- the perturbation leg: only output and final_norm move ---------
        moved = serving_model(cfg32, engine.device)
        with torch.no_grad():
            for dst, src in zip(moved.parameters(), engine.model.parameters(), strict=True):
                dst.copy_(src)
        drill.perturb(moved, HS_STEPS + 1)
        pert_path = exp / f"ckpt_{HS_STEPS + 1}.zs.json"
        engine.start()  # the flip lands on the serving loop, as in the live leg
        zerostall.save_ckpt_zerostall(pert_path, param_leaves(moved), background=False,
                                      extra_meta={"step": HS_STEPS + 1})
        zerostall.emergency.drop(exp)
        zerostall.release(exp)
        del moved
        wait_for("the perturbation swap", lambda: engine.weights_step == HS_STEPS + 1,
                 timeout=120.0)
        engine.stop()
        plan = diff_manifest_chunks(read_manifest(final_path), read_manifest(pert_path),
                                    prefix=".params")
        (b, f, d) = (next(e for e in reversed(mem.events) if e["event"] == name)
                     for name in ("weights_swap_begin", "swap_fetch_bytes", "weights_swap_done"))
        total = f["fetched_bytes"] + f["reused_bytes"]
        pert = {"to_step": d["step"], "swap_s": d["swap_s"], "fetch_s": f["ts"] - b["ts"],
                "fetched_bytes": f["fetched_bytes"], "reused_bytes": f["reused_bytes"],
                "reused_pct": 100.0 * f["reused_bytes"] / total,
                "output_bytes": next(r["nbytes"] for r in plan["leaves"]
                                     if r["path"] == ".params['output']"),
                "fetch_gb_s": f["fetched_bytes"] / (f["ts"] - b["ts"]) / 1e9}
        live_tokens = drill.run_probe(engine, probe)
        engine.pool.check_drained()
        pert_engine = ServingEngine(load_serving_params(pert_path, cfg32, device=device)[0], scfg)
        pert_tokens = drill.run_probe(pert_engine, probe)
        pert_engine.pool.check_drained()
        del pert_engine
        check("perturbation leg", f["fetched_bytes"] == plan["fetch_bytes"]
              and f["reused_bytes"] == plan["reused_bytes"] and f["incremental"]
              and d["step"] == HS_STEPS + 1 and plan["changed_leaves"] == 2
              and live_tokens == pert_tokens,
              f"fetched {f['fetched_bytes']} bytes ({100.0 - pert['reused_pct']:.1f} %), reused "
              f"{f['reused_bytes']} ({pert['reused_pct']:.1f} %) = the chunk plan; swap "
              f"{d['swap_s']:.3f} s; probe equals a cold restore of {pert_path.name}: "
              f"{live_tokens == pert_tokens}")
        swapper.stop()
        swapper = None

        # ---- the no-swap run of the same workload, on the last weights -----
        metrics.reset()
        base = ServingEngine(final_model, scfg)
        base.submit([1, 2, 3], 2)
        base.run_until_drained()
        metrics.reset()
        from pyrecover_tpu_torch.serving import run_loadgen

        run_loadgen(base, workload[:len(served)])
        base.pool.check_drained()
        noswap = {"tpot_p99_s": metrics.histogram("tpot_s").percentile(0.99),
                  "e2e_p99_s": metrics.histogram("e2e_s").percentile(0.99),
                  "ttft_p99_s": metrics.histogram("ttft_s").percentile(0.99)}
        del base, cold_engine, final_model, restores
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    finally:
        if swapper is not None:
            swapper.stop()
        if engine is not None and engine._loop_owner() is not None:
            engine.stop()
        if engine_exporter is not None:
            engine_exporter.stop()
        telemetry.remove_sink(mem)
        telemetry.remove_sink(sink)
        sink.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the streams: traceview over the trainer's, traceassembly over the engine's
    with contextlib.redirect_stdout(io.StringIO()):  # the reports are read from their JSON
        rc_view = traceview.main([str(trainer_stream), "--out",
                                  str(HS_DIR / "trainer_trace.json"), "--report-json",
                                  str(HS_DIR / "trainer_report.json")])
    report = json.loads((HS_DIR / "trainer_report.json").read_text())
    hosts = report["step_times"]["hosts"]
    check("traceview (trainer stream)", rc_view == 0 and hosts and hosts[0]["steps"] == HS_STEPS,
          f"exit {rc_view}, {hosts[0]['steps'] if hosts else 0} steps, phases "
          f"{sorted(report['ckpt_phases'])}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc_path = traceassembly.main([str(stream), "--expect-complete", "--json",
                                      str(HS_DIR / "engine_traces.json")])
    traces = json.loads((HS_DIR / "engine_traces.json").read_text())
    stalls = sum(1 for e in traces["per_trace"].values() if e.get("buckets", {}).get("swap_stall"))
    check("traceassembly (engine stream)", rc_path == 0
          and traces["traces"]["completed"] == len(served),
          f"exit {rc_path} under --expect-complete: {traces['traces']['completed']} of "
          f"{len(served)} requests assembled, {traces['traces']['orphan_spans']} orphans, "
          f"{stalls} with a swap_stall bucket")

    line = {
        "layers": cfg32.n_layers, "steps": HS_STEPS,
        "save_every": HS_EVERY, "serving_dtype": "float32",
        "params_bytes": sum(int(e["nbytes"]) for e in read_manifest(pert_path)["leaves"]),
        "swaps": swaps, "perturbation": pert, "live": live_report, "noswap": noswap,
        "scrapes": digests, "scrape_ms": {"median": float(np.median(scrape_ms)),
                                          "max": max(scrape_ms), "polls": len(scrape_ms)},
        "flip_probes": n_probes, "flip_gaps": gaps, "peak_mem_gib": peak_gib,
        "trainer_launches": launches,
        "phase_s": time.monotonic() - t_phase, "card": card_line() if cuda else "cpu",
    }
    print(json.dumps({"hotswap": line}), flush=True)
    if failures:
        fail("hotswap phase: " + ", ".join(failures))
    shutil.rmtree(HS_DIR, ignore_errors=True)
    return line


def hotswap_chaos_phase(device="cuda"):
    """The hotswap phase's chaos leg (module docstring, item 14):
    ``hotswap_chaos_drill`` at llama-1b's width, ``HS_CHAOS_LAYERS`` deep,
    fp32, on ``device``; it raises on a failed verdict. Prints one
    ``hotswap_chaos`` line and returns the report."""
    import dataclasses

    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.serving.hotswap import hotswap_chaos_drill

    cfg = dataclasses.replace(get_args(hotswap_argv(device)).model, n_layers=HS_CHAOS_LAYERS,
                              compute_dtype="float32", attention_impl="sdpa")
    t0 = time.monotonic()
    report = hotswap_chaos_drill(HS_DIR.parent / "hotswap_chaos", model_config=cfg,
                                 device=device, timeout_s=300.0)
    report.update(layers=HS_CHAOS_LAYERS, seconds=time.monotonic() - t0)
    print(json.dumps({"hotswap_chaos": report}), flush=True)
    shutil.rmtree(HS_DIR.parent / "hotswap_chaos", ignore_errors=True)
    return report


def fleet_config():
    """The fleet's replicas: llama-1b's width, ``FLEET_LAYERS`` deep, fp32."""
    import dataclasses

    from pyrecover_tpu_torch.config import get_args

    return dataclasses.replace(get_args(train_argv()).model, n_layers=FLEET_LAYERS,
                               compute_dtype="float32", attention_impl="sdpa")


def fleet_leg(drill):
    """One fleet drill (``chaos`` or ``canary``) through its entry point,
    ``python -m pyrecover_tpu_torch.serving.fleet.drill``, in a process of its
    own; fails the script unless it passed. Returns its report."""
    import dataclasses

    work = FLEET_DIR / drill
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work.parent / f"{drill}.json"
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.serving.fleet.drill", str(work),
           "--drill", drill, "--device", "cuda", "--json", str(out),
           "--model-config", json.dumps(dataclasses.asdict(fleet_config()))]
    env = {k: v for k, v in os.environ.items() if k != "PYRECOVER_FAULT_PLAN"}
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=FLEET_TIMEOUT_S)
    if proc.returncode != 0 or not out.exists():
        logs = sorted(work.rglob("replica_*.log"))
        tails = [f"{p.relative_to(work)}: {p.read_text()[-1500:]}" for p in logs[-3:]]
        say_failed("\n".join([proc.stdout[-2000:], proc.stderr[-6000:], *tails]))
        last = proc.stderr.strip().splitlines()[-1:] or ["no standard error"]
        fail(f"fleet {drill} drill exited {proc.returncode}: {last[0]}")
    report = json.loads(out.read_text())[drill]
    report["seconds"] = time.monotonic() - t0
    return report


def fleet_line(reports):
    """The fleet phase's line (module docstring, item 15) over the two legs'
    reports; fails the script on a verdict the drills report against."""
    chaos, canary = reports["chaos"], reports["canary"]
    acc = chaos["accounting"]
    failures = []

    def check(name, ok, detail):
        line = f"  fleet {name}: {'ok' if ok else 'FAIL'}: {detail}"
        if ok:
            print(line, flush=True)
        else:
            say_failed(line)
            failures.append(name)

    check("on the card", chaos["device"] == canary["device"] == "cuda",
          f"replicas served on {chaos['device']} and {canary['device']}")
    check("kill leg", chaos["killed_rc"] == -9 and chaos["redriven"] >= 1
          and acc["submitted"] == acc["done"] + acc["shed"] and not acc["shed"]
          and chaos["kill_p99_s"] <= chaos["p99_gate_s"],
          f"rc {chaos['killed_rc']}, {acc['submitted']} submitted = {acc['done']} done + "
          f"{acc['shed']} shed, {chaos['redriven']} redriven, kill-window p99 "
          f"{chaos['kill_p99_s']} s (gate {chaos['p99_gate_s']}, baseline "
          f"{chaos['baseline_p99_s']})")
    check("respawn and quarantine", chaos["respawns"] >= 1
          and "1.1" in chaos["spawn_to_ready_s"]["b"] and chaos["quarantine_spawns"] == 3,
          f"{chaos['respawns']} respawn(s), ready in "
          f"{chaos['spawn_to_ready_s']['b'].get('1.1', {}).get('ready_s')} s; the crash-looper "
          f"quarantined after {chaos['quarantine_spawns']} spawns")
    check("canary", canary["divergent_verdict"] == "fail"
          and canary["divergent_reason"] == "token_mismatch" and canary["pinned_after_rollback"]
          and canary["healthy_verdict"] == "pass" and canary["healthy_waved"] == 1,
          f"divergent {canary['divergent_verdict']} ({canary['divergent_reason']}), rolled back "
          f"{canary['rolled_back']} with {canary['pinned_after_rollback']} pinned; healthy "
          f"{canary['healthy_verdict']}, waved {canary['healthy_waved']}")
    near_ties = chaos["near_ties_excused"] + canary["near_ties_excused"]
    cfg = fleet_config()
    line = {
        "layers": FLEET_LAYERS, "replicas": chaos["replicas"], "serving_dtype": "float32",
        "width": f"llama-1b (dim {cfg.dim}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, hd "
                 f"{cfg.dim // cfg.n_heads}, ffn {cfg.ffn_hidden_dim}, vocab {cfg.vocab_size})",
        "reduced": f"depth cut to {FLEET_LAYERS} of {LAYERS} layers (full width) to stay inside "
                   "the script's time limit",
        "spawn_to_ready_s": {"chaos": chaos["spawn_to_ready_s"],
                             "canary": canary["spawn_to_ready_s"]},
        "respawn_to_ready_s": chaos["spawn_to_ready_s"]["b"]["1.1"]["ready_s"],
        "baseline_p99_s": chaos["baseline_p99_s"], "kill_p99_s": chaos["kill_p99_s"],
        "p99_gate_s": chaos["p99_gate_s"],
        "requests": {k: acc[k] for k in ("submitted", "done", "shed", "redriven")},
        "zero_capacity_shed": chaos["shed"], "killed_rc": chaos["killed_rc"],
        "quarantine_spawns": chaos["quarantine_spawns"],
        "traces": {k: chaos[k] for k in ("trace_completed", "trace_orphans",
                                         "trace_redrive_gap_s", "trace_dominant_tail_bucket")},
        "canary": {k: canary[k] for k in ("divergent_verdict", "divergent_reason",
                                          "healthy_verdict", "healthy_waved", "baseline_p99_s",
                                          "probe_p99_s", "p99_gate_s", "swaps")},
        "peak_mem_bytes": {"chaos": chaos["peak_mem_bytes"], "canary": canary["peak_mem_bytes"]},
        "near_ties_excused": near_ties,
        "near_tie_gaps": chaos["near_tie_gaps"] + canary["near_tie_gaps"],
        "gap_limit": 1e-3, "leg_s": {"chaos": chaos["seconds"], "canary": canary["seconds"]},
        "card": card_line(),
    }
    print(json.dumps({"fleet": line}), flush=True)
    if failures:
        fail("fleet phase: " + ", ".join(failures))
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    return line


def fleet_chains(reports):
    """The two fleet drills as chains for `run_chains`, each leaving its
    report in ``reports``."""
    def fleet_chaos_leg():  # the replica-loss drill
        reports["chaos"] = fleet_leg("chaos")

    def fleet_canary_leg():  # the canary-rollback drill
        reports["canary"] = fleet_leg("canary")

    return fleet_chaos_leg, fleet_canary_leg


def fleet_phase():
    """Both fleet drills at once, alone (the drill phase runs them as two of
    its chains); prints the ``fleet`` line."""
    reports = {}
    run_chains("fleet", fleet_chains(reports))
    return fleet_line(reports)


def device_busy_ms(events):
    """``(busy, by_name)`` over a profiler's events: the length of the union
    of the device's kernel intervals, and each kernel name's summed time, in
    ms. Fails when the trace holds no device time."""
    from torch.autograd import DeviceType

    by_name, spans = {}, []
    for e in events:
        # user annotations (e.g. the optimizer step's range) span kernels
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    if busy_us <= 0:
        fail("the profiler recorded no device time")
    return busy_us / 1e3, by_name


def step_breakdown(wall_ms, busy, by_name):
    """A profiled step's device time grouped into the flash kernels, matrix
    products (cuBLAS, and CUTLASS's grouped products) and the rest, the
    idle share against ``wall_ms`` (the unprofiled step) and the top
    kernels."""
    def group(name):
        if any(k in name for k in ("fwd_kernel", "dq_kernel", "dkv_kernel", "_wgmma_kernel")):
            return "flash_kernels"
        low = name.lower()
        if any(k in low for k in ("gemm", "sm90_", "cutlass", "nvjet", "xmma")):
            return "matmul"
        return "other"

    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"per_step_ms": {"wall": wall_ms, "device_busy": busy, **groups},
            "idle_pct": 100.0 * max(wall_ms - busy, 0.0) / wall_ms,
            "top_kernels_ms_per_step": [[n[:90], ms] for n, ms in top]}


# `time_phases`'s child, run in the checkout it times: that checkout's own
# set-up (as `main` makes it), its kernel build, then the named phases
TIME_PHASES_CHILD = """
import json, os, shutil, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke as c
sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(c.PYC_DIR)
import torch
from pyrecover_tpu_torch.checkpoint import native_io
from pyrecover_tpu_torch.ops import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t = time.monotonic()
fa.build_library()
if not native_io.available():
    c.fail("the native checkpoint-I/O library did not build or load (g++)")
out = {"build": time.monotonic() - t}
for name in sys.argv[1:]:
    t = time.monotonic()
    getattr(c, name)()
    out[name] = time.monotonic() - t
    print(f"phase {name} took {out[name]:.1f} s", flush=True)
    shutil.rmtree(c.CKPT_DIR, ignore_errors=True)  # the serving phases' input
print("phase_times_s " + json.dumps(out), flush=True)
"""


def time_phases(tree, *names):
    """Run only the phase functions ``names`` of the ``chip_smoke.py`` in
    the checkout ``tree``, in a child process there, after that checkout's
    set-up and kernel build; prints their seconds. Two checkouts timed in
    one call compare a change's phases with its parent's on one host (a
    whole check twice does not fit one call's disk writes)."""
    t0 = time.monotonic()
    rc = subprocess.run([sys.executable, "-c", TIME_PHASES_CHILD, *names], cwd=tree).returncode
    print(json.dumps({"time_phases": {"tree": str(tree), "phases": list(names), "rc": rc,
                                      "wall_s": time.monotonic() - t0}}), flush=True)
    if rc:
        fail(f"phases {list(names)} of {tree}: exit code {rc}")


def profile_phase(wall_ms):
    """Device time by kernel over two steady llama-1b flash training steps
    of ``train.main`` under ``torch.profiler`` (steps 1-2 are skipped),
    grouped into the flash kernels, matrix products and the rest, and the
    device's idle share: 1 - busy / ``wall_ms``, the unprofiled step time
    of the train phase."""
    import torch

    from pyrecover_tpu_torch import train

    busy, by_name, clocks = profiled_busy(train, [])
    print(json.dumps({"profile": {**step_breakdown(wall_ms, busy, by_name),
                                  "after_each_step": {CLOCKS: clocks}}}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sys.pycache_prefix = str(PYC_DIR)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYC_DIR)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    if argv[:1] == ["--trainer"]:
        trainer_child(argv[1:])
        return
    if argv[:1] == ["--emergency-child"]:
        emergency_child(argv[1:])
        return
    if argv == ["--trainer-phase"]:
        trainer_phase()
        return
    if argv == ["--fleet-phase"]:
        print(f"card: {card_line()}", flush=True)
        fleet_phase()
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two training steps by kernel")
    ap.add_argument("--dp-cards", type=int, default=0, metavar="N",
                    help="run only the dp phase across N cards, one rank a card over NCCL")
    ap.add_argument("--time-phases", nargs="+", metavar="ARG",
                    help="DIR PHASE...: time only these phase functions of DIR's "
                         "chip_smoke.py (a checkout), after its kernel build; no verdict line")
    args = ap.parse_args(argv)
    if args.time_phases:
        print(f"card: {card_line()}", flush=True)
        time_phases(*args.time_phases)
        return

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import threading

    from pyrecover_tpu_torch.checkpoint import native_io
    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.ops import flash_attention as fa

    card = card_line()
    print(f"card: {card}", flush=True)
    # the host I/O library (g++) builds beside the kernels (nvcc)
    t0 = time.monotonic()
    io_built = []
    io_thread = threading.Thread(target=lambda: io_built.append(
        (native_io.available(), time.monotonic() - t0)))
    io_thread.start()
    fa.build_library()
    print(f"kernels built in {time.monotonic() - t0:.1f} s", flush=True)
    io_thread.join()
    if not io_built or not io_built[0][0]:
        fail("the native checkpoint-I/O library did not build or load (g++)")
    print(f"native checkpoint I/O built in {io_built[0][1]:.1f} s", flush=True)
    for line in ptxas_summary(fa.BUILD_LOG):
        print(f"  ptxas: {line}")

    phases = {"build": time.monotonic() - t0}

    def timed(name, fn, *a):
        t = time.monotonic()
        out = fn(*a)
        phases[name] = time.monotonic() - t
        print(f"phase {name} took {phases[name]:.1f} s", flush=True)
        print(f"chip_smoke: phase {name} passed in {phases[name]:.1f} s", file=sys.stderr,
              flush=True)
        return out

    if args.dp_cards:
        if args.dp_cards < 2 or torch.cuda.device_count() < args.dp_cards:
            fail(f"--dp-cards {args.dp_cards} needs 2 or more cards, and this host has "
                 f"{torch.cuda.device_count()}")
        timed("dp_cards", dp_cards_phase, args.dp_cards)
        phases["total"] = time.monotonic() - t0
        print(json.dumps({"phases_s": phases}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return
    rows, chunked = timed("kernels", kernel_phase, fa)
    counts, flash = timed("train", train_phase, fa)
    timed("attention_check", attention_check, fa, flash["losses"][0])
    timed("telemetry_cost", telemetry_cost_phase, flash)
    timed("transfer_guard", transfer_guard_phase)
    moe_counts = timed("moe", moe_phase, fa)
    timed("hotswap", hotswap_phase)
    timed("trainer", run_trainer_phase)
    timed("checkpoint", checkpoint_and_chaos_phase)
    timed("zerostall", zerostall_phase)
    try:
        serve_ckpt, serve_step = timed("serving_checkpoint", serving_checkpoint)
        timed("serving", serving_phase, serve_ckpt, get_args(train_argv()).model, "cuda",
              serve_step)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    timed("dp", dp_phase)
    timed("drills", drill_phase)
    if args.profile:
        timed("profile", profile_phase, flash["step_ms"])
    print(json.dumps({"telemetry": TELEMETRY}), flush=True)
    phases["total"] = time.monotonic() - t0
    print(json.dumps({"phases_s": phases}), flush=True)
    for row, key in zip(rows, ("fwd", "dq", "dkv")):
        row["launches"] = counts[key]
        row["launches_moe"] = moe_counts[key]
    for row, key in zip(chunked, ("fwd", "dq", "dkv") * 2):
        row["launches"] = counts[f"{key}_chunked"]
        row["launches_moe"] = moe_counts[f"{key}_chunked"]
    print(card, flush=True)
    print(json.dumps({"kernels": rows + chunked}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
