"""Drive the PyTorch/H100 port once on the card and check it.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also device time by kernel
    python3 chip_smoke.py --trainer ARGS...   # one trainer run (the checkpoint
                                              # phase's subprocess)
    python3 chip_smoke.py --trainer-phase     # the trainer phase alone (item 6,
                                              # run as a subprocess)
    python3 chip_smoke.py --emergency-child ARGS...  # phase E's process (item 12)
    python3 chip_smoke.py --serving-mesh-rank JSON  # one rank of a serving
                                              # mesh's legs (item 18)
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
7. Checkpoint phase: three trainer runs at llama-1b's full width and
   ``CKPT_LAYERS`` deep (cut from 20 in PR 8) with flash attention, deterministic algorithms, verified
   checkpoints and one checkpoint kept. A trains 4 steps straight. B1, in
   A's process after it (one start for the two), runs
   with a deadline already inside the time-aware stop's buffer and must stop
   early with ``ckpt_<k>_final.ckpt`` and ``REQUEUE``; B2, a process of its
   own, resumes from ``latest`` and must finish at step 4 with ``DONE``. B2's final checkpoint
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
   launches). At the phase's end ``python -m
   pyrecover_tpu_torch.checkpoint.check_equality`` on A's and B2's finals
   starts beside the other chains and must exit 0 (the ``cli`` line).
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
   Prints one ``serving`` line. SMT (item 18) runs beside its int8 checks.
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
   for digest, to the vanilla reader of the same state (and FS2's, below); V2 dp2 with the vanilla engine (one
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
   peak below A2's by ``Z1_PEAK_SHARE`` of one rank's moment bytes. The
   model axes, two ranks on the card over gloo, A2's data and
   weights: FS2 (``--fsdp 2``, the sharded engine, saves at 2 and 4; first
   in the wire runs' process pair) within A2's limits of R0, its peak below
   A2's by ``FS_PEAK_SHARE`` of one rank's parameter, gradient and moment
   bytes; CF (in R1's process) FS2's step 2 resumed at dp 1 with the elastic
   preflight, steps 3-4 within ``DP_LOSS_RTOL`` of FS2's, ``elastic_resume``
   from fsdp 2 and ``sampler_rescaled`` 2 -> 1; FS2's final checkpoint (each
   rank's slices) served equal to the vanilla reader of its state; TP2
   (``--tp 2``, the vanilla engine, 2 steps and its save at 2, in V2's
   pair) within ``WIRE_LOSS_RTOL`` of R0 and its step-1 gradient norm
   within ``WIRE_NORM_RTOL``; TF (V2's pair) TP2's file resumed at ``--fsdp
   2``, steps 3-4 within ``DP_LOSS_RTOL`` of R0's, ``elastic_resume`` from
   tensor 2 and ``sampler_rescaled`` 1 -> 2. Every rank's flash launches
   must be layers x steps on the tensor-core instances (TP2's at the
   tensor-local shape, the ``kernels`` line's ``tp_shape``). R0 -> R1 (one at a time: ten processes do not fit the card),
   the wire runs and the A2 -> C, B1 -> B2 and V2 -> V1 chains run at
   once (V1 in R1's process), so their seconds overlap; the checks read
   their results after. The dp line's ``ep`` is the expert legs' line (
   `expert_phase_chains`), which run earlier, beside the checkpoint phase: an
   MoE pair does not fit the card beside the nine llama processes. At
   moe-4x1b's width (dim 2048, 4 top-2 experts of ffn 7168, GQA 16/8, vocab
   32768), ``DP_LAYERS`` deep, seq ``MOE_SEQ``, batch ``MOE_BATCH``: ME1,
   ME1F (fp32) and ER (E2's step 2 resumed at ep 1, ``elastic_resume`` from
   expert 2, held to ME1's steps 3-4) one process; E2 (``--ep 2``, grouped
   EP, the sharded engine, ``EP_SHORT_STEPS`` steps and one save, at their
   end) one pair, that checkpoint served equal to the vanilla reader's; EQ (``--ep 2``, fp32, every MoE dispatch call held to
   the transfer guard: gloo's CUDA collectives stage through the host and
   would trip it), MF (``--fsdp 2``) and MT (``--tp 2``, bf16, its first
   forward routed by ME1's picks, its own picks' flips counted) another. E2,
   MF and MT held to ME1, EQ to ME1F: step 1 within ``DP_STEP1_RTOL`` (MT's
   within ``EP_LOSS_RTOL``), later steps and the aux within
   ``EP_LOSS_RTOL``, step 1's gradient norm within ``WIRE_NORM_RTOL``; ER
   within ``EP_LOSS_RTOL`` of E2; each E2 rank
   holds 2 of the 4 experts of every ``moe_w*`` leaf, its peak below ME1's
   by ``EP_PEAK_SHARE`` of its expert parameters' 16 B; the fp32 legs' flash
   launches on the FMA instances, the rest on wgmma (the ``kernels`` line's
   ``launches_ep``: E2's rank 0, at the MoE shape). Prints one ``dp`` line: each run's ranks, backend,
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
   ``WIRE_LOSS_RTOL`` of NA; NZ zero1, bit-equal to NA. At 4 cards:
   NDF ``--dp 2 --fsdp 2`` held to M0 as NA is; NFT ``--fsdp 2 --tp 2``
   within ``DP_LOSS_RTOL`` of M0 and its step-1 gradient norm within
   ``WIRE_NORM_RTOL``; N8F llama-8b (``N8F_MODEL``) at full depth, ``--fsdp
   4``, seq 2048, one row a rank, ``full`` remat, 3 steps: finite losses and
   each card's peak under its 80 GB, where the whole fp32 state (16 B a
   parameter, ~128 GB) fits no card. Prints one ``dp_cards`` line. At 4
   cards the expert axis follows (`ep_cards_phase`, the ``ep_cards`` line;
   alone: ``--time-phases . ep_cards_phase``): NE ``--dp 2 --ep 2`` and NEF
   ``--fsdp 2 --ep 2`` held to ME0 (one process), NET ``--ep 2 --tp 2`` and
   NEQ ``--dp 2 --ep 2`` (the whole step under ``--transfer-guard
   disallow``: over NCCL nothing stages through the host) at fp32 held to
   ME0F, at the dp phase's expert limits; N8E moe-8x1b at full depth, ``--ep 4``, one row of seq 2048 a
   rank, ``full`` remat, 3 steps: finite, each card under 80 GB, its step
   ms and peak. Then the sequence and pipeline axes
   (`seqpipe_cards_phase`, the ``seqpipe_cards`` line; alone:
   ``--time-phases . seqpipe_cards_phase``): NS ``--sp 4`` at ``SP_SEQ``,
   llama-1b at full depth, one row, held to NS0 (one process) at the SP
   limits (NCCL's point to point moves the ring's chunks card to card);
   N8P llama-8b at full depth, ``--pp 4 --pp-schedule 1f1b``,
   ``N8P_MICRO`` microbatches of one row of 2048, ``full`` remat, 3 steps:
   finite, each card under 80 GB; and NETB ``--ep 2 --tp 2`` at bf16 with
   ME0's first-forward picks (as the one-card MT), held to ME0.

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
   ``ZF_LAYERS`` of its 20 layers (a 5.7 GB state; the depth cut to make
   room for the fleet phase and then for the sequence and pipeline legs,
   named in the line's ``reduced``), 3 steps, a save at 2. Prints one ``zerostall`` line: each save's blocking (the first, with
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
   row's ``moe_shape``, and at the dp phase's TP2 shape under
   ``tp_shape``, with TP2's rank-0 launches: b ``DP_BATCH`` (4; tensor
   peers attend over the same rows, and TP2's batch shards, data x fsdp,
   are 1), s 2048, hq 8, hkv 4, d 128, bf16.

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

16. Sequence and pipeline legs (two chains started at the zerostall phase's
   start and joined at its end: beside the checkpoint phase's chains they
   ran the card out of memory), at llama-1b's width, two ranks on the one
   card over gloo (the ring's k/v chunks and the stages' activations move by
   point-to-point sends staged through the host: gloo refuses a CUDA
   tensor in ``send``). One process pair runs PG2 (``--pp 2``, gpipe, M 2,
   ``PP_LAYERS`` deep, the sharded engine, 2 steps and one save), SP2
   (``--sp 2``, ring attention on K1-K3, ``SP_SEQ`` a row, ``SP_LAYERS``
   deep), SPK (SP2 on `PackedRows`, through ``--smoke-packed``: off the
   diagonal the keys carry their own segment ids), P1F (1f1b, M
   ``PP_MICRO``) and PI (interleaved, V 2); one process runs SP1 and SPK1
   (one process, flash), PP1, then PR1 (PG2's save resumed at pp 1 through
   the elastic preflight), then serves PG2's save. SP2 and SPK held to SP1
   and SPK1, the pipeline legs to PP1: step 1 within ``SP_STEP1_RTOL`` /
   ``PP_STEP1_RTOL``, later steps within ``SEQPIPE_LOSS_RTOL``, step 1's
   gradient norm within ``WIRE_NORM_RTOL``; PR1 within
   ``SEQPIPE_LOSS_RTOL`` of PP1's steps 3-4 with ``elastic_resume`` from
   pipeline 2; each stage holds its layers (at V 2 the interleaved chunks);
   PG2's save served equal to the vanilla reader's; every rank's flash
   launches exact and on the tensor-core instances: ring rank i (i + 1)
   blocks a layer in each pass, a stage its layers x microbatches. Prints
   one ``seqpipe`` line. The kernel phase holds K1-K3 at SP2's shape a rank
   with the keys' segment ids their own (``ring_seg_k_shape``: causal, and
   full with the row's merged out and lse in the backward, as the ring's
   off-diagonal block), and the ``kernels`` line carries ``launches_sp``
   and ``launches_pp``, every rank's. Run alone (``--time-phases .
   seqpipe_plant_phase``), `seqpipe_plant_phase` plants four known faults
   (``--smoke-plant``) and fails unless these limits catch each.
17. Composed legs (the axes beside each other). In the seqpipe pair, after
   its sequence and pipeline legs: PMI (moe-4x1b's width, ``--pp 2`` interleaved V 2, M
   ``PP_MICRO``, full remat, packed rows: an MoE model over the pipeline,
   einsum dispatch inside a stage) and SM2 (moe-4x1b's width, ``--sp 2``,
   one row of ``SM_SEQ``, capacity factor ``SM_CF``: each row routed whole
   across the sequence ranks); the one process runs their references PMI1
   and SM1 (`hold_to`, `hold_composed_moe`). Beside the trainer phase
   (`composed_chains`), one group of four ranks on the card runs PF
   (``--pp 2 --fsdp 2``, 1f1b: FSDP2's hooks a microbatch at a time), held
   to PP1 with the seqpipe legs. Their limits and launch counts are the
   seqpipe legs' (see ``SM_SEQ``'s comment). ``seqpipe_plant_phase`` adds
   SMC (SM2 with each sequence chunk routed as a row); ``--dp-cards 4``
   adds PT (``--pp 2 --tp 2``, interleaved) and PZ (``--pp 2 --dp 2``,
   zero1) against a PP1 of their own, and NPT and NPF (llama-1b at full
   depth, ``--pp 2`` beside tensor and fsdp over NCCL).
18. Serving meshes. SMT: two ranks (``--serving-mesh-rank``,
   started ahead of the serving checkpoint, `smt_ranks`) restore the
   serving phase's checkpoint onto a tensor 2 mesh over gloo on the one card
   at fp32 compute (``load_serving_params(mesh=)``: each rank its box) and
   serve the EQUAL workload through the engine's lockstep (rank 0 plans,
   the other follows), beside the serving phase's int8 checks. Its tokens
   must equal the one-card fp32 engine's (a divergence only at a near-tie,
   the fleet line's rule), the restore's ``plan_bytes_moved`` must be above
   0 and each rank's allocator peak at least a third of a rank's weight
   bytes below the one-card engine's (weights, pool, activations). Prints
   one ``serving_mesh`` line (restore s, decode-step ms at 8 slots, peaks).
   ``--time-phases . serving_cards_phase`` (four cards, not part of the
   whole check; NCCL, one rank a card): NST4 (tensor 4, fp32 and bf16),
   NSPT (pipeline 2 x tensor 2) and NSFT (fsdp 2 x tensor 2) on the serving
   checkpoint, NSE (moe-4x1b's width, ``NSE_LAYERS`` deep, seeded, expert 4,
   no-drop) and NSW (a hot swap at tensor 4 between two seeded zerostall
   manifests; the probe after the flip equals a cold restore, every rank
   flips at one step), each held to the one-card engine on card 0 (the
   paged prefill by relative norm, fp32 tokens under the near-tie rule; bf16
   tokens' divergences counted), then NPT and NPF again; one
   ``serving_cards`` line.

Prints one ``{"kernels": [...]}`` JSON line and, last, one
``{"ok": true, "device": {...}}`` line. Any failed check exits non-zero
before that line.
"""

import argparse
import contextlib
import csv
import dataclasses
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
# llama-1b's width at ZF_LAYERS (a 5.7 GB state; the depth cut from 20, the
# phase's longest run, to 10 to make room for the fleet phase in the
# script's time limit, then to 6 for the sequence and pipeline legs beside
# this phase), ZF_STEPS steps with a save at ZF_EVERY; P is the autopilot on
# the 2-layer model, ceiling P_CEILING.
# The facts the later phases hold against (A's file and digests, Z-A's final
# manifest) are kept in ZS_REF.
ZS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "zs"
ZS_EVERY, ZF_LAYERS, ZF_STEPS, ZF_EVERY, P_STEPS, P_CEILING = 1, 6, 3, 2, 6, 2
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
# the model axes in the dp phase (item 10): FS2's peak must sit below A2's
# by this share of one rank's parameter + gradient + moment bytes (fp32:
# 16 bytes a parameter; fsdp 2 holds half of each)
FS_PEAK_SHARE = 1 / 3
# the expert axis beside the checkpoint phase (item 10): moe-4x1b's width
# (moe_argv) at DP_LAYERS layers, seq MOE_SEQ, global batch MOE_BATCH,
# EP_STEPS steps (E2, EQ, MF and MT cut to EP_SHORT_STEPS). The bf16 legs are held
# to ME1 (one process), EQ (fp32) to ME1F (one process at fp32): step 1 within
# DP_STEP1_RTOL (MT's, whose attention sums over tensor at bf16, within
# EP_LOSS_RTOL); later steps, ER against ME1 and the aux loss within
# EP_LOSS_RTOL, set a few times above the CPU measurement at bf16 before the
# first card run (PERF.md section 6: up to 4.6e-4 by step 4, aux 3.9e-4);
# step 1's gradient norm within WIRE_NORM_RTOL (MT's first forward routed by
# ME1's picks, its own flips counted). E2's peak below ME1's by
# EP_PEAK_SHARE of one rank's expert parameters at 16 bytes each
EP_STEPS, EP_SHORT_STEPS = 4, 2
EP_LOSS_RTOL, EP_PEAK_SHARE = 2e-3, 1 / 3
# the expert legs that run at fp32 (their flash on the FMA instances), and
# each leg's flags in the checks' words
FP32_LEGS = ("EQ", "ME1F")
EP_LEG_FLAGS = {"E2": "--ep 2, grouped EP", "MF": "--fsdp 2", "EQ": "--ep 2, fp32",
                "MT": "--tp 2, ME1's picks in its first forward"}
# the sequence and pipeline legs (item 16, `seqpipe_phase_chains`): llama-1b's
# width, two ranks on the card over gloo. SP2 and SPK (packed rows) at
# --sp 2, SP_SEQ a row (SP_SEQ / 2 a rank), SP_LAYERS deep, batch SP_BATCH,
# SP_STEPS steps, held to SP1 and SPK1 (one process, flash); PG2, P1F and PI
# at --pp 2, PP_LAYERS deep (PI's V 2 x 2 stages needs 4), batch DP_BATCH,
# seq 2048, held to PP1 (one process, PP_STEPS steps): P1F and PI 3 steps,
# PG2 2, its one save there; PR1 resumes PG2's save at pp 1, held to PP1's
# steps 3-4.
# The limits were set from the CPU's bf16 drift (PERF.md section 6:
# `python tests/test_torch_sp_pp_resume.py drift`, up to 1.6e-5 at sp 2 and
# 3.0e-5 over the schedules by step 4, step-1 norm up to 1.0e-4) before the
# first card run, for a model 16 times as wide over 64 times the sequence,
# and are not widened after. The card's drift sits far below them; each
# fault `seqpipe_plant_phase` plants (RoPE offset dropped, ring diagonal
# only, interleaved chunks reversed) fails them.
SP_SEQ, SP_BATCH, SP_LAYERS, SP_STEPS = 8192, 1, 2, 2
PP_LAYERS, PP_STEPS, PP_MICRO = 4, 4, 4
SP_STEP1_RTOL, PP_STEP1_RTOL, SEQPIPE_LOSS_RTOL = 1e-3, 1e-4, 2e-3
# the composed legs (item 17, beside the others): moe-4x1b's width (the
# llama-1b width with 4 top-2 experts). PMI (--pp 2, interleaved V 2, M
# PP_MICRO, full remat, packed rows, COMPOSED_STEPS steps) held to PMI1 (one
# process, the same 4 layers, the einsum dispatch the stages run) at
# PP_STEP1_RTOL; SM2 (--sp 2, SM_LAYERS deep, one row of SM_SEQ, capacity
# factor SM_CF so capacity binds and the row's first-come order decides which
# picks drop, the scatter dispatch) held to SM1 (one process) at the SP
# limits; both with the later steps and the aux within EP_LOSS_RTOL and step
# 1's gradient norm within WIRE_NORM_RTOL (`hold_to`). PF (--pp 2 --fsdp 2,
# 1f1b, M 2: an fsdp rank holds 2 of PP1's 4 rows) as one group of four
# ranks on the card, and across four cards PT (--pp 2 --tp 2, interleaved V
# 2, M PP_MICRO) and PZ (--pp 2 --dp 2, zero1), COMPOSED_STEPS steps each,
# held to PP1 (`hold_seqpipe`). These
# limits are the legs' earlier ones; the CPU's bf16 drift (PERF.md section 6,
# `python tests/test_torch_compose_resume.py drift`) sits 4-29x below them
# before the first card run, and the moe-chunk-capacity plant (each sequence
# chunk routed as a row) misses SM2's norm and aux limits there.
SM_SEQ, SM_LAYERS, SM_CF, COMPOSED_STEPS = 4096, 2, "0.5", 2
SEQPIPE_MOE = ["--moe-experts", "4", "--moe-top-k", "2"]
SEQPIPE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "seqpipe"
# --dp-cards 4's expert-sharded run: moe-8x1b (models/presets.py) at full
# depth, ep 4: 2 of its 8 experts a card
N8E_MODEL = ["--model-dim", "2048", "--model-layers", "20", "--model-heads", "16",
             "--model-kv-heads", "8", "--vocab-size", "32768", "--moe-experts", "8",
             "--moe-top-k", "2"]
# --dp-cards 4's model-sharded run: llama-8b (models/presets.py) at full depth
N8F_MODEL = ["--model-dim", "4096", "--model-layers", "32", "--model-heads", "32",
             "--model-kv-heads", "8", "--vocab-size", "131072"]
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
# MOE_STEPS steps (M-T, the steps after the first under the transfer guard); M-R at
# MOE_R_LAYERS layers (a ~6.1 GB state), MOE_R_STEPS steps, stopped at 2;
# where its runs write. M-B's limits, by relative norm: each bf16 backend's
# output and gradients against an fp32 run of the same inputs (the weights
# and intermediates round to bf16 there; measured 5.1e-3-6.2e-3 on an H100
# 80GB HBM3 at 700 W), and the bf16 backends against grouped (the same
# roundings, summed in another order: scatter 0 for y, dh and drouter and
# 3.2e-5 for the experts' gradients, einsum up to 2.8e-3)
MOE_LAYERS, MOE_STEPS, MOE_BATCH, MOE_SEQ = 8, 6, 4, 1024
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


def ring_segments(b, s, causal):
    """Query and key segment ids of one ring block at chunk length ``s``:
    ``(seg_q, seg_k)``, (b, s) int32 each. Full (an earlier chunk's keys):
    a packed row of 2s cut by the ring, documents of 700-1500 tokens, the
    keys' ids those of the row's first half and the queries' of its second,
    so documents cross the boundary and the queries of the ones that start
    after it meet no key of theirs (their block lse is about ``NEG_INF``).
    Causal (the diagonal's mask with ids of their own): the queries' ids,
    documents starting at even positions, and the keys' the same but a new
    id at every odd position, so every query still meets a key."""
    import torch

    g = np.random.default_rng(s + b)
    rows_q, rows_k = [], []
    for _ in range(b):
        if causal:
            cuts = np.sort(g.choice(np.arange(2, s, 2), size=5, replace=False))
            seg = np.searchsorted(cuts, np.arange(s), side="right").astype(np.int32)
            key = seg.copy()
            key[1::2] = 1000
            rows_q.append(seg)
            rows_k.append(key)
        else:
            lens = g.integers(700, 1501, size=4 * s // 700 + 2)
            seg = np.searchsorted(np.cumsum(lens), np.arange(2 * s), side="right")
            rows_k.append(seg[:s].astype(np.int32))
            rows_q.append(seg[s:].astype(np.int32))
    return tuple(torch.from_numpy(np.stack(r)).cuda().contiguous() for r in (rows_q, rows_k))


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


def kernel_case(fa, label, b, s, sk, hq, hkv, d, dtype, n_segments, causal, timed, failures,
                ring=False):
    """One shape through K1-K3 against their plain versions (and, when
    ``timed``, the times and the ``kernels`` line's rows). ``ring``: the
    keys carry segment ids of their own (`ring_segments`), as a ring block's
    do."""
    import torch
    import torch.nn.functional as F

    q, k, v, seg, dout = make_case(b, s, sk, hq, hkv, d, dtype, n_segments, seed=s + d)
    seg_k = None
    if ring:
        seg, seg_k = ring_segments(b, s, causal)
    scale = 1.0 / math.sqrt(d)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    routes = ", ".join(f"{key} {fa.kernel_route(key, dtype, d)}" for key in ("fwd", "dq", "dkv"))
    dp = fa.padded_head_dim(d)
    print(f"kernel case {label}: b{b} s{s} sk{sk} hq{hq} hkv{hkv} d{d} {dtype} "
          f"segments={'ring (keys their own)' if ring else n_segments} causal={causal}; route "
          f"{routes}{f' (zero-padded to the d {dp} instance)' if dp != d else ''}", flush=True)
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, seg, causal, scale, seg_k)
    out_k, lse_k = fa.flash_fwd(q, k, v, seg, causal, scale, seg_k=seg_k)
    torch.cuda.synchronize()
    # a query no key of its segment meets has lse ~ -1e30 on both sides
    # (its weight in a ring's merge is zero); hold the finite ones
    live = lse_r > -1e29
    if ring and not causal:
        print(f"  {label}: {int((~live).sum())} of {live.numel()} query rows meet no key of "
              "theirs in this block", flush=True)
    e_fwd = check_outputs(label, [("out", out_k, out_r, tol),
                                  ("lse", lse_k[live], lse_r[live], LSE_TOL)], failures)
    if ring and not causal:
        # the ring's backward takes the row's whole out and lse: this block
        # merged with the diagonal one (the queries' own chunk, causal), as
        # rank 1 of two merges them; a row this block masks whole then has
        # p = exp(-1e30 - lse) = 0 here, as in the ring
        from pyrecover_tpu_torch.ops.ring_attention import _merge

        kd, vd = (torch.randn_like(x) for x in (k, v))
        o_d, l_d = fa.flash_fwd_reference(q, kd, vd, seg, True, scale)
        acc, lse_g = _merge(*_merge(None, None, o_d, l_d), out_r, lse_r)
        bwd = (q, k, v, seg, acc.to(q.dtype).contiguous(), lse_g.contiguous(), dout, causal,
               scale)
    else:
        bwd = (q, k, v, seg, out_r, lse_r, dout, causal, scale)
    dq_r = fa.flash_bwd_dq_reference(*bwd, seg_k=seg_k)
    dq_k = fa.flash_bwd_dq(*bwd, seg_k=seg_k)
    torch.cuda.synchronize()
    e_dq = check_outputs(label, [("dq", dq_k, dq_r, tol)], failures)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(*bwd, seg_k=seg_k)
    dk_k, dv_k = fa.flash_bwd_dkv(*bwd, seg_k=seg_k)
    torch.cuda.synchronize()
    e_dkv = check_outputs(label, [("dk", dk_k, dk_r, tol), ("dv", dv_k, dv_r, tol)], failures)
    errs = {"fwd": e_fwd, "dq": e_dq, "dkv": e_dkv}
    if not timed:
        return None

    del dq_r, dk_r, dv_r, out_k, lse_k, dq_k, dk_k, dv_k
    torch.cuda.empty_cache()
    ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_fwd(q, k, v, seg, causal, scale, seg_k=seg_k), 10),
        "dq": cuda_time_ms(lambda: fa.flash_bwd_dq(*bwd, seg_k=seg_k), 10),
        "dkv": cuda_time_ms(lambda: fa.flash_bwd_dkv(*bwd, seg_k=seg_k), 10),
    }
    plain_ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_fwd_reference(q, k, v, seg, causal, scale, seg_k),
                            3, 1),
        "dq": cuda_time_ms(lambda: fa.flash_bwd_dq_reference(*bwd, seg_k=seg_k), 3, 1),
        "dkv": cuda_time_ms(lambda: fa.flash_bwd_dkv_reference(*bwd, seg_k=seg_k), 3, 1),
    }
    # the one PyTorch call computing the forward: SDPA on (b, h, s, d); with
    # segment ids its boolean mask (same segment, and causal), where no
    # query row is masked whole (a whole-masked row is NaN there)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if seg is not None:
        keys = seg if seg_k is None else seg_k
        mask = (seg[:, :, None] == keys[:, None, :])
        if causal:
            mask = mask & torch.ones(s, sk, dtype=torch.bool, device="cuda").tril()
        mask = mask[:, None]
    sdpa_kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    lib_ok = mask is None or bool(mask.any(-1).all())
    lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **sdpa_kw), 10) if lib_ok else None
    # SDPA's backward (dq, dk, dv together): a yardstick for K2 + K3
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True, **sdpa_kw)
    dot = dout.transpose(1, 2).contiguous()
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg), dot, retain_graph=True), 10) if lib_ok else None
    # the autograd node names the backend whose backward ran
    lib_bwd_op = o.grad_fn.name()
    print(json.dumps({"library_backward_ms": lib_bwd, "library_backward_op": lib_bwd_op,
                      "note": "F.scaled_dot_product_attention backward, dq+dk+dv"}))
    library_backend = sdpa_backend(qt, kt, vt, causal) if mask is None else "attn_mask"

    pairs = (valid_pairs(b, s, causal, seg) if seg_k is None else int(
        ((seg[:, :, None] == seg_k[:, None, :])
         & (torch.ones(s, sk, dtype=torch.bool, device="cuda").tril() if causal else True))
        .sum().item())) * hq
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    work = {
        "fwd": (4 * d * pairs, nbytes(q, k, v, seg, seg_k, out_r, lse_r)),
        "dq": (6 * d * pairs, nbytes(q, k, v, seg, seg_k, out_r, lse_r, dout, q)),
        "dkv": (8 * d * pairs, nbytes(q, k, v, seg, seg_k, out_r, lse_r, dout, k, v)),
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
    # the dp phase's TP2 shape: llama-1b's heads split over 2 tensor ranks
    # (hq 8, hkv 4, d 128, bf16); each rank attends over all of its batch
    # shard's rows, and TP2's batch shards (data x fsdp) are 1
    tp_rows = kernel_case(fa, "llama-1b-tp2", DP_BATCH // (1 * 1), 2048, 2048, 8, 4, 128, bf16,
                          1, True, True, f)
    for row, trow in zip(rows, tp_rows):
        row["tp_shape"] = {k: trow[k] for k in (
            "instance", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_backward_ms")}
    # the ring's blocks (item 16): SP2's shape a rank (b SP_BATCH, s SP_SEQ / 2,
    # GQA 16/8, d 128, bf16), the keys with segment ids of their own, as off
    # the diagonal: causal, and full (an earlier chunk, some query rows
    # meeting no key of theirs)
    for causal in (True, False):
        key = "causal" if causal else "full"
        ring_rows = kernel_case(fa, f"ring-seg_k-{key}", SP_BATCH, SP_SEQ // 2, SP_SEQ // 2, 16,
                                8, 128, bf16, 0, causal, True, f, ring=True)
        for row, rrow in zip(rows, ring_rows):
            row.setdefault("ring_seg_k_shape", {})[key] = {k: rrow[k] for k in (
                "instance", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_backend", "library_backward_ms")}
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
    runs = [_smoke_flags(run) for run in runs]
    for run, smoke in runs:
        smoke["layers"] = get_args(run).model.n_layers
    from pyrecover_tpu_torch.checkpoint.sharded import _leaf_digest
    from pyrecover_tpu_torch.train_state import param_leaves

    models = []
    build = train.build_model
    train.build_model = lambda *a: models.append(build(*a)) or models[-1]
    if len(runs) > 1:
        config = get_args(runs[0][0])
        mesh.initialize_distributed(required=config.distributed, backend=config.dist_backend,
                                    device_type=config.device)
    for run, smoke in runs:
        if smoke["wait_for"]:
            wait_for(smoke["wait_for"], Path(smoke["wait_for"]).exists, timeout=600.0)
        fa.reset_launch_counts()
        with _moe_harness(train, smoke) as held:
            out = train.main(run)
        out["launches"] = fa.launch_counts()
        if smoke["guard_moe"]:
            out["moe_dispatch_guarded"] = held["guarded"]
        if smoke["force_picks"]:
            out["moe_pick_flips"] = held["flips"]
        model = models.pop()
        out["stage_layers"] = list(getattr(model, "stage_layer_ids", ()))
        leaves = param_leaves(model)
        del model
        if len(runs) > 1:
            out["params_digests"] = {leaf.path: _leaf_digest(leaf.parts) for leaf in leaves}
        # the experts this rank holds of each MoE leaf (its first layer's)
        out["experts_held"] = {leaf.path: int(leaf.parts[0].shape[0]) for leaf in leaves
                               if "moe_w" in leaf.path}
        del leaves  # the run's parameters: not held through the next run
        print("trainer summary: " + json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if len(runs) > 1:
        mesh.destroy_distributed()
    if os.environ.get("CHIP_SMOKE_SUMMARY_DIR"):
        path = Path(os.environ["CHIP_SMOKE_SUMMARY_DIR"]) / f"rank{rank}.json"
        path.write_text(json.dumps(out))


def _smoke_flags(run):
    """``(argv, harness settings)`` of one trainer run: the flags this script
    reads itself, taken out of the trainer's. ``--smoke-moe-dispatch NAME``
    sets the model's ``moe_dispatch`` in code (as the JAX package's tests
    set it: neither trainer has a flag for it); ``--smoke-guard-moe`` holds
    every call of an MoE dispatch backend to the transfer guard;
    ``--smoke-wait-for PATH`` starts the run once PATH exists (another
    process's checkpoint, published by one rename); ``--smoke-record-picks
    PATH`` publishes the run's first forward's routing picks, a layer each,
    at PATH, and ``--smoke-force-picks PATH`` routes the run's first
    forward by those picks (counting where its own differ); ``--smoke-packed``
    trains on `PackedRows` (the trainer phase's packed documents, segment
    ids and all) in place of the synthetic rows (a ``packed`` key, only
    where it is given); ``--smoke-plant NAME`` plants a known fault in the
    port for the run (`_plant`; a ``plant`` key, only where it is given)."""
    valued = {"--smoke-moe-dispatch": "dispatch", "--smoke-wait-for": "wait_for",
              "--smoke-record-picks": "record_picks", "--smoke-force-picks": "force_picks"}
    argv, smoke = [], {"guard_moe": False, **{key: None for key in valued.values()}}
    it = iter(run)
    for arg in it:
        if arg == "--smoke-guard-moe":
            smoke["guard_moe"] = True
        elif arg == "--smoke-packed":
            smoke["packed"] = True
        elif arg == "--smoke-plant":
            smoke["plant"] = next(it)
        elif arg in valued:
            smoke[valued[arg]] = next(it)
        else:
            argv.append(arg)
    return argv, smoke


@contextlib.contextmanager
def _moe_harness(train, smoke):
    """`_smoke_flags`' settings over one ``train.main`` call; yields the
    count of guarded dispatch calls (``guarded``) and the first forward's
    routing flips a layer against the forced picks (``flips``). The guard
    holds each backend's own work (routing, the row moves, the expert
    products, the combine): the all-reduces around it are gloo's, which
    stages CUDA tensors through the host with a stream synchronize that the
    guard would flag in any step of two ranks on one card."""
    import torch

    from pyrecover_tpu_torch.models import llama, moe
    from pyrecover_tpu_torch.ops import ring_attention
    from pyrecover_tpu_torch.parallel import pipeline
    from pyrecover_tpu_torch.telemetry import detectors

    build, backends, ffn, top_k = (train.build_model, dict(moe._BACKENDS), moe.moe_ffn,
                                   moe._top_k)
    dataset = train.build_dataset
    planted = (llama.sequence_offset, ring_attention._blocks, pipeline._Stage.__init__,
               moe._seq_ctx)
    held = {"guarded": 0, "flips": []}
    if smoke.get("plant"):
        _plant(smoke["plant"])
    if smoke.get("packed"):
        def packed(config):
            n = config.training_samples or config.batch_size * config.training_steps
            rows = PackedRows(n, config.sequence_length, config.model.vocab_size, seed=0)
            return rows, 0, config.model

        train.build_dataset = packed
    if smoke["dispatch"]:
        def build_with(config, device):
            model_cfg = dataclasses.replace(config.model, moe_dispatch=smoke["dispatch"])
            return build(dataclasses.replace(config, model=model_cfg), device)

        train.build_model = build_with
    if smoke["guard_moe"]:
        def guard(fn):
            def call(*a, **kw):
                with detectors.transfer_watch(fn="moe_dispatch"):
                    held["guarded"] += 1
                    return fn(*a, **kw)
            return call

        moe._BACKENDS.update({name: guard(fn) for name, fn in backends.items()})
    if smoke["record_picks"] or smoke["force_picks"]:
        # the first forward is the first ``layers`` moe_ffn calls, one a
        # layer; every routing pass inside one (the EP form's second, for
        # the aux, too) takes that layer's picks
        layer, picks = [-1], []
        forced = torch.load(smoke["force_picks"]) if smoke["force_picks"] else None

        def ffn_counted(*a, **kw):
            layer[0] += 1
            return ffn(*a, **kw)

        def top_k_held(probs, K):
            own, at = top_k(probs, K), layer[0]
            if at >= smoke["layers"]:
                return own
            if forced is None:
                if len(picks) == at:
                    picks.append(own.cpu())
                    if len(picks) == smoke["layers"]:
                        tmp = Path(smoke["record_picks"] + ".tmp")
                        torch.save(picks, tmp)
                        os.replace(tmp, smoke["record_picks"])
                return own
            want = forced[at].to(own.device)
            if len(held["flips"]) == at:
                held["flips"].append(int((own != want).any(dim=-1).sum()))
            return want

        moe.moe_ffn, moe._top_k = ffn_counted, top_k_held
    try:
        yield held
    finally:
        train.build_model, train.build_dataset = build, dataset
        moe._BACKENDS.update(backends)
        moe.moe_ffn, moe._top_k = ffn, top_k
        (llama.sequence_offset, ring_attention._blocks, pipeline._Stage.__init__,
         moe._seq_ctx) = planted


PLANTS = ("rope-offset", "ring-diagonal", "pp-chunk-order", "moe-chunk-capacity")


def _plant(name):
    """Plant the known fault ``name`` in the port (`_moe_harness` restores
    it): ``rope-offset`` drops a sequence rank's RoPE offset (local
    positions on every rank); ``ring-diagonal`` runs only the ring's
    diagonal block, its earlier chunks skipped forward and backward;
    ``pp-chunk-order`` runs each stage's virtual chunks in reverse (the
    interleaved layers out of order); ``moe-chunk-capacity`` routes each
    sequence chunk of an MoE row as a row of its own (its capacity, its
    first-come order and its aux: the routing before whole-row routing).
    `seqpipe_plant_phase` shows that the sequence and pipeline limits fail
    each."""
    from pyrecover_tpu_torch.models import llama, moe
    from pyrecover_tpu_torch.ops import ring_attention
    from pyrecover_tpu_torch.parallel import pipeline

    blocks, stage_init = ring_attention._blocks, pipeline._Stage.__init__
    if name == "rope-offset":
        llama.sequence_offset = lambda model, s_local: 0
    elif name == "ring-diagonal":
        ring_attention._blocks = lambda mesh, causal: [
            (step, blk_causal, runs and step == 0) for step, blk_causal, runs in
            blocks(mesh, causal)]
    elif name == "pp-chunk-order":
        def reversed_chunks(self, *a, **kw):
            stage_init(self, *a, **kw)
            self.chunks.reverse()

        pipeline._Stage.__init__ = reversed_chunks
    elif name == "moe-chunk-capacity":
        moe._seq_ctx = lambda mesh: None
    else:
        raise ValueError(f"--smoke-plant {name!r}: expected one of {PLANTS}")


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
    return proc, trainer_summary(label, proc.stdout, proc.stderr), wall


def trainer_summary(label, stdout, stderr):
    """A trainer child's summary from its output (None when it did not
    finish); its log lines about checkpoints are echoed."""
    keep = ("checkpoint", "Resume", "Stopping", "Finished", "Stopped", "step ", "Quarantined",
            "retry", "Error", "emergency", "ckpt_backpressure", "elastic")
    for line in stderr.splitlines():
        if any(k in line for k in keep):
            print(f"  [{label}] {line[24:] if line[:2] == '20' else line}", flush=True)
    summary = [line for line in stdout.splitlines() if line.startswith("trainer summary: ")]
    return json.loads(summary[0][len("trainer summary: "):]) if summary else None


def run_trainer(label, argv, timeout=400, mode="--trainer"):
    """`start_trainer`, failing the script unless the run finished; returns
    its summary and wall seconds."""
    proc, summary, wall = start_trainer(label, argv, timeout, mode=mode)
    if proc.returncode != 0 or summary is None:
        print(proc.stderr[-6000:], flush=True)
        fail(f"trainer run {label} exited {proc.returncode}")
    return summary, wall


class Prestarted:
    """A `trainer_child` run started ahead of its turn: its process starts
    now and holds its run until the file ``go`` exists (``--smoke-wait-for``),
    so its interpreter start and imports overlap the work before its turn
    (it holds no card memory while it waits). `run` makes ``go`` and
    returns `run_trainer`'s ``(summary, wall seconds)``, the wall from
    ``go``; `stop` ends the process if it still runs."""

    def __init__(self, label, argv, go, timeout=400):
        self.label, self.go, self.timeout = label, Path(go), timeout
        self.go.unlink(missing_ok=True)
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        env.pop("PYRECOVER_FAULT_PLAN", None)
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--trainer", *argv,
             "--smoke-wait-for", str(self.go)], cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def run(self):
        t0 = time.monotonic()
        self.go.touch()
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        finally:
            self.stop()
        wall = time.monotonic() - t0
        summary = trainer_summary(self.label, out, err)
        if self.proc.returncode != 0 or summary is None:
            print(err[-6000:], flush=True)
            fail(f"trainer run {self.label} exited {self.proc.returncode}")
        return summary, wall

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@contextlib.contextmanager
def prestarted(*runs):
    """`Prestarted` runs, ``(label, argv, go[, timeout])`` each, as ``{label:
    run}``; any still running on the way out (a failure before its turn)
    is stopped."""
    started = {}
    try:
        for label, *rest in runs:
            started[label] = Prestarted(label, *rest)
        yield started
    finally:
        for run in started.values():
            run.stop()


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
    import threading

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
    # B2's process starts now and waits for its turn (`Prestarted`)
    with prestarted(("B2", argv("b", "--resume-from-checkpoint", "latest"),
                     CKPT_DIR / "go_b2")) as pre:
        # A, then B1 in the same process (one start for the two): B1's
        # deadline has passed when it starts, as it had when B1 ran in a
        # process of its own
        summaries, ab_wall = run_group("A+B1", argv("a") + ["--then"] + argv(
            "b", "--timeaware-checkpointing", "--job-end-time", str(time.time() + 1.0),
            "--preempt-check-interval", "2"))
        a, b1 = summaries[0]
        exp_b = CKPT_DIR / "b"
        k = b1["end_step"]
        marker = read_requeue_marker(exp_b) or {}
        if not (b1["stopped_early"] and 0 < k < CKPT_STEPS
                and (exp_b / f"ckpt_{k}_final.ckpt").exists()
                and (exp_b / "REQUEUE").exists() and marker.get("step") == k):
            fail(f"run B1 did not stop early with ckpt_<k>_final and REQUEUE: end step {k}, "
                 f"marker {marker}, files {sorted(p.name for p in exp_b.iterdir())}")
        seg_b1 = read_run("B1", exp_b, 0, k, exp_b / f"ckpt_{k}_final.ckpt", "preemption")
        if "preempt_stop" not in [e["event"] for e in seg_b1]:
            telemetry_problems.append("B1: no preempt_stop")
        # what B2's pre-check and load will read: just written by B1, so it
        # may still be in the page cache
        cached_b1 = page_cache_share(exp_b / f"ckpt_{k}_final.ckpt")
        # B2 runs in its own thread while A's end state is read here
        b2_out = []
        b2_thread = threading.Thread(target=lambda: b2_out.append(pre["B2"].run()),
                                     name="checkpoint-B2")
        b2_thread.start()
        exp_a = CKPT_DIR / "a"
        if ((a["end_step"], a["stopped_early"]) != (CKPT_STEPS, False)
                or not (exp_a / "DONE").exists()):
            fail(f"run A ended at step {a['end_step']}, stopped early {a['stopped_early']}")
        digest = (exp_a / (final + ".sha256")).read_text()
        rows_a = loss_rows(exp_a)
        read_run("A", exp_a, 0, CKPT_STEPS, exp_a / final, "healthy")
        # A's end state stays for the zerostall phase: its leaves' content
        # addresses, its loss CSV, its background save's blocking window,
        # and the file, which the serving check reads
        from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import chunk_bytes_default

        kept = CKPT_DIR / "a_final.ckpt"
        os.replace(exp_a / final, kept)
        ZS_REF.update(layers=layers, a_file=kept, rows_a=rows_a, a_summary=a,
                      a_chunks=file_leaf_chunks(kept, chunk_bytes_default()),
                      vanilla_bg_blocking_s=[sv["blocking_s"] for sv in a["saves"][:-1]])
        shutil.rmtree(exp_a)
        b2_thread.join()
    if not b2_out:
        fail("trainer run B2 (see above)")
    b2, b2_wall = b2_out[0]
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
        "process_wall_s": {"A+B1": ab_wall, "B2": b2_wall},
        "step_ms": {"A": a["step_ms"], "B2": b2["step_ms"]},
        "launches": {"A": a["launches"], "B1": b1["launches"], "B2": b2["launches"]},
        "goodput": {"A": a["goodput"], "B1": b1["goodput"], "B2": b2["goodput"]},
    }}), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        fail("checkpoint phase: " + "; ".join(bad))
    # the operator's verdict on the same pair, off the phase's critical
    # path: it reads while the other chains run (`cli_check`)
    CLI_CHECK.update(t0=time.monotonic(), pair=[kept.name, f"b/{final}"], proc=subprocess.Popen(
        [sys.executable, "-m", "pyrecover_tpu_torch.checkpoint.check_equality", str(kept),
         str(exp_b / final)], cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    return exp_b / final, layers


# the checkpoint phase's operator check, started at its end
CLI_CHECK = {}


def cli_check():
    """``python -m pyrecover_tpu_torch.checkpoint.check_equality`` on the
    checkpoint phase's A and B2 finals must exit 0 (the bit-exact resume's
    verdict); prints the ``cli`` line."""
    proc = CLI_CHECK.get("proc")
    if proc is None:
        fail("the checkpoint phase did not start its check_equality run")
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    line = {"check_equality": {"pair": CLI_CHECK["pair"], "rc": proc.returncode,
                               "seconds": time.monotonic() - CLI_CHECK["t0"],
                               "verdict": (out.strip().splitlines() or [""])[-1]}}
    print(json.dumps({"cli": line}), flush=True)
    if proc.returncode != 0:
        fail(f"check_equality on A's and B2's finals exited {proc.returncode}: {out[-2000:]} "
             f"{err[-2000:]}")


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
    # the sequence and pipeline legs (item 16) run beside this whole phase:
    # its processes leave the card room for them (beside the checkpoint
    # phase's chains they ran it out of memory), and its saves' blocking is
    # held to vanilla A's, taken before, with margin to spare
    sp_chains, sp_finish = seqpipe_phase_chains()
    sp_join = start_chains("seqpipe", sp_chains)

    def argv(name, *extra, depth=layers, steps=CKPT_STEPS, every=ZS_EVERY):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(depth),
            "--training-steps", str(steps), "--checkpoint-dir", str(ZS_DIR),
            "--experiment-name", name, "--checkpoint-frequency", str(every),
            "--max-kept-checkpoints", "1", "--checkpoint-engine", "zerostall",
            "--log-loss-to-csv", "--telemetry", "--hang-watchdog-timeout", str(CKPT_WATCHDOG_S),
            *extra]

    def go(label, args, want_class, mode="--trainer", timeout=400, pre=None):
        """One run (``pre``: its `Prestarted` process, started on ``args``)
        and the doctor's verdict on it."""
        summary, wall = (pre.run() if pre is not None
                         else run_trainer(label, args, timeout=timeout, mode=mode))
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

    # Z-F's depth: its state beside Z-A's and the 2-layer chains' files
    free = shutil.disk_usage(ZS_DIR).free - 4 * 2.1 * state_bytes(layers)
    depth = ZF_LAYERS
    while depth > 1 and 2.1 * state_bytes(depth) > free:  # cut depth, never width
        depth -= 1
    # the chains' trainer runs start now and wait for their turn
    # (`Prestarted`): Z-B1, P and Z-F after Z-A, Z-B2 after Z-B1 (E, a child
    # of its own kind, starts at its turn)
    zb1_args = argv("zb", "--timeaware-checkpointing", "--job-end-time", str(time.time() + 1.0),
                    "--preempt-check-interval", "2", every=CKPT_EVERY)
    zb2_args = argv("zb", "--resume-from-checkpoint", "latest", every=CKPT_EVERY)
    p_args = argv("p", "--ckpt-auto-ceiling", str(P_CEILING), steps=P_STEPS, every="auto")
    zf_args = argv("zf", depth=depth, steps=ZF_STEPS, every=ZF_EVERY)
    with prestarted(("Z-B1", zb1_args, ZS_DIR / "go_zb1"), ("Z-B2", zb2_args, ZS_DIR / "go_zb2"),
                    ("P", p_args, ZS_DIR / "go_p"), ("Z-F", zf_args, ZS_DIR / "go_zf", 900)) as pre:
        # -- Z-A: the straight run ----------------------------------------------
        za, exp_za = go("Z-A", argv("za"), "healthy")
        za_chunks = manifest_chunks(exp_za / final)
        ZS_REF["za_chunks"] = za_chunks
        checks["Z-A ends at 4 with DONE"] = (
            za["end_step"] == CKPT_STEPS and not za["stopped_early"]
            and (exp_za / "DONE").exists())
        checks["Z-A's final state = vanilla A's, leaf by leaf (content addresses)"] = (
            za_chunks == ZS_REF["a_chunks"])
        checks["Z-A loss CSV: one row a step, equal to vanilla A's"] = (
            loss_rows(exp_za) == ZS_REF["rows_a"])
        checks["every Z-A save moved its snapshot through pinned buffers"] = all(
            sv["pinned_bytes"] > 0 for sv in za["saves"])
        first, steady = za["saves"][0], za["saves"][1:-1]
        # the engine's purpose: a steady-state save blocks less than the vanilla
        # background save of the same state in this run
        checks["a steady-state zerostall save blocks less than the vanilla background save"] = (
            bool(steady) and max(sv["blocking_s"] for sv in steady) < min(
                ZS_REF["vanilla_bg_blocking_s"]))

        res = {}

        def serving_chain():
            """Serving from Z-A's manifest against the vanilla reader of A's
            file, in this process beside the other chains."""
            config = get_args(train_argv() + ["--model-layers", str(layers)]).model
            served_v, res["info_v"] = served_digests(ZS_REF["a_file"], config)
            served_z, res["info_z"] = served_digests(exp_za / final, config)
            checks["serving: Z-A's manifest = vanilla A's file, digest for digest"] = (
                served_z == served_v and res["info_z"]["engine"] == "zerostall")
            ZS_REF["a_file"].unlink()

        def zb_chain():
            """Z-B1, stopped by a deadline, and Z-B2, its `latest` resume from
            disk (the vanilla B runs' save interval)."""
            b1, exp_zb = go("Z-B1", zb1_args, "preemption", pre=pre["Z-B1"])
            k = b1["end_step"]
            marker = read_requeue_marker(exp_zb) or {}
            checks["Z-B1 stops early with ckpt_<k>_final and REQUEUE"] = (
                b1["stopped_early"] and 0 < k < CKPT_STEPS
                and (exp_zb / f"ckpt_{k}_final.zs.json").exists() and marker.get("step") == k)
            b2, _ = go("Z-B2", zb2_args, "healthy", pre=pre["Z-B2"])
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
            p_sum, exp_p = go("P", p_args, "healthy", pre=pre["P"])
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
        def full_depth_run():
            """Z-F: ZF_STEPS steps at ``depth`` with a save at ZF_EVERY."""
            zf, exp_zf = go("Z-F", zf_args, "healthy", pre=pre["Z-F"])
            checks["Z-F ends with DONE"] = zf["end_step"] == ZF_STEPS and (exp_zf / "DONE").exists()
            shutil.rmtree(exp_zf, ignore_errors=True)
            res["zf"] = zf

        # four independent chains at once (their own directories; the card holds
        # three 2-layer runs and the deep one) and the serving check in this
        # process: their times overlap, E's RAM restore and Z-B2's disk load
        # under the same load
        with low_water("zerostall chains (the seqpipe legs beside)", ZS_DIR):
            chains_s = run_chains("zerostall", (full_depth_run, zb_chain, emergency_run,
                                                autopilot_run, serving_chain))
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
            "serving": {"vanilla_s": res["info_v"]["seconds"],
                        "zerostall_s": res["info_z"]["seconds"]},
            "policy": [{k: r[k] for k in ("step", "source", "interval_steps", "cost_s", "mtti_s",
                                          "reason")} for r in recs],
            "Z-F": {"layers": depth, "steps": ZF_STEPS, "state_gb": state_bytes(depth) / 1e9,
                    "reduced": f"depth cut to {depth} of {LAYERS} layers (full width) to make room "
                               "for the fleet phase and the sequence and pipeline legs",
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
        sp_join()
        sp_finish()
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


# each phase's chains (`run_chains`): a chain's name -> its seconds
CHAIN_S = {}


def run_chains(what, fns):
    """Run the independent chains ``fns`` at once, a thread each (the runs
    of one chain stay in order); fails the script, naming the ``what``
    phase, if any chain raised. Returns the seconds they took together;
    each chain's are under ``CHAIN_S[what]``."""
    import threading

    errors = []
    seconds = CHAIN_S.setdefault(what, {})

    def chain(fn):
        t = time.monotonic()
        try:
            fn()
        except BaseException as e:  # surfaced below
            errors.append(f"{fn.__name__}: {type(e).__name__}: {e}")
        seconds[fn.__name__] = time.monotonic() - t

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


def start_chains(what, fns):
    """`run_chains` in a background thread, beside whatever the caller runs
    next. Returns ``join()``: it waits for the chains and fails the script,
    naming the ``what`` phase, if any chain raised."""
    import threading

    box = {}

    def run():
        try:
            run_chains(what, fns)
        except BaseException as e:  # `fail` exits: surfaced by join()
            box["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=run, name=f"{what}-chains")
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            fail(f"{what} phase (beside another): {box['error']}")

    return join


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
        fail(f"trainer run {label}: " + " | ".join(failed))
    return summaries, wall


def csv_losses(exp):
    """``{step: loss}`` of the experiment directory ``exp``'s loss CSV."""
    return {int(r[0]): float(r[1]) for r in loss_rows(exp)[1:]}


def rel(a, b):
    return abs(a - b) / abs(b)


def go_runs(kind, plan, runs, problems, world=None, fp32=(), rank_env=None, per_step=None):
    """``plan``'s runs (label, argv) one after another in one process (or
    group of ``world`` processes): one start for them all. Each run's
    per-rank summaries go into ``runs[label]``; a rank that did not launch
    the flash kernels layers x steps (``per_step[label][rank]`` a step where
    it names the label: one count, or the forward's, dq's and dk/dv's), all
    on the tensor-core instances (the ``fp32`` labels' on the FMA ones,
    which fp32 runs), goes into ``problems``.
    ``rank_env`` as `run_group`'s. Prints a line a run (``kind`` first);
    returns the runs' per-rank summaries in plan order."""
    joined = []
    for _, args in plan:
        joined += (["--then"] if joined else []) + args
    summaries, wall = run_group("+".join(label for label, _ in plan), joined, world, rank_env)
    out = []
    for i, (label, _) in enumerate(plan):
        per_rank = [sm[i] for sm in summaries] if len(plan) > 1 else summaries
        runs[label] = {"summaries": per_rank, "wall_s": wall}
        steps = per_rank[0]["end_step"] - per_rank[0]["start_step"]
        for rank, sm in enumerate(per_rank):
            per = per_step[label][rank] if label in (per_step or {}) else DP_LAYERS
            want = dict(zip(("fwd", "dq", "dkv"),
                            per if isinstance(per, (tuple, list)) else (per,) * 3))
            expect = {k: 0 if label in fp32 and k.endswith("_wgmma")
                      else steps * want[k.split("_")[0]] for k in sm["launches"]}
            if sm["launches"] != expect:
                problems.append(f"{label} rank {rank}: launches {sm['launches']}, want "
                                f"{expect}")
        sm = per_rank[0]
        print(f"  {kind} run {label}: {world or 1} process(es) (one start for {len(plan)} "
              f"runs, {wall:.1f} s), losses {sm['losses']}, first step "
              f"{sm.get('first_step_s') or 0:.1f} s, steps ms {sm['window_step_ms']}, saves "
              f"{sum(sv['blocking_s'] for sv in sm['saves']):.1f} s, load "
              f"{sm['ckpt_load_s']:.1f} s, peak {sm['peak_mem_gib']} GiB", flush=True)
        out.append(per_rank)
    return out


def ep_argv(root, name, *extra):
    """An expert leg's trainer flags: moe-4x1b's width at DP_LAYERS layers,
    EP_STEPS steps, its loss CSV and telemetry under ``root / name``."""
    return moe_argv(layers=DP_LAYERS, steps=EP_STEPS) + [
        "--checkpoint-dir", str(root), "--experiment-name", name, "--log-loss-to-csv",
        "--telemetry", *extra]


def hold_to(got, want, sm, ref, step1_rtol=DP_STEP1_RTOL):
    """An MoE run held to its reference: its losses ``got`` ({step: loss},
    from step 1) against ``want``, its summary ``sm`` against ``ref``'s.
    Step 1 within ``step1_rtol``, the later steps and every layer's aux
    within EP_LOSS_RTOL, step 1's gradient norm within WIRE_NORM_RTOL, the
    aux finite. Returns the errors and whether all hold."""
    errs = {"step1": rel(got[1], want[1]),
            "later": max(rel(got[s_], want[s_]) for s_ in sorted(got)[1:]),
            "step1_grad_norm": rel(sm["grad_norms"][0], ref["grad_norms"][0]),
            "aux": max(rel(x, y) for x, y in zip(sm["moe_aux"], ref["moe_aux"]))}
    ok = (sorted(got) == list(range(1, len(sm["losses"]) + 1))
          and errs["step1"] <= step1_rtol and errs["later"] <= EP_LOSS_RTOL
          and errs["aux"] <= EP_LOSS_RTOL and errs["step1_grad_norm"] <= WIRE_NORM_RTOL
          and all(math.isfinite(x) for x in sm["moe_aux"]))
    return errs, ok


def serve_sharded(ckpt, args):
    """Serve the sharded checkpoint ``ckpt`` on the card and hold it to the
    vanilla reader of the same state: the state read into host leaves (DCP,
    one process), its ``.params`` (all that serving reads) written as a
    ``PYRCKPT2`` file beside it and served. Both restores' parameters must
    hash the same."""
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
    # the params alone: a card's run writes at most 45 GiB, and the moments
    # are twice their bytes
    save_ckpt_vanilla(vanilla, [leaf for leaf in leaves if leaf.path.startswith(".params")])
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
    # the model axes: two ranks on the one card over gloo, as A2's
    fs2 = ["--distributed", "--fsdp", "2", "--dist-backend", "gloo"]
    tp2 = ["--distributed", "--tp", "2", "--dist-backend", "gloo"]
    runs, checks, problems = {}, {}, []

    def go(label, args, world=None, rank_env=None):
        return go_runs("dp", [(label, args)], runs, problems, world, rank_env=rank_env)[0]

    exp_b, exp_v = DP_DIR / "b", DP_DIR / "v2"
    res = {}

    def r0_run():
        """R0: one process, no group."""
        go("R0", argv("r0", "--checkpoint-frequency", "0"))

    def r1_run():
        """R1: a group of one on NCCL (the default backend), env rendezvous;
        then, in the same process, CF: FS2's (the wire chain's first run)
        step-2 checkpoint resumed at dp 1 through the elastic preflight, and
        V1 (V2's step-2 file at dp 1) once that file is published (one
        process start for the three, not two); then FS2's final checkpoint
        served."""
        wait_for("FS2's step-2 checkpoint", fs2_ckpt2.exists, timeout=600.0)
        v2_ckpt2 = exp_v / "ckpt_2.ckpt"
        go_runs("dp", [
            ("R1", argv("r1", "--checkpoint-frequency", "0", "--distributed", "--dp", "1")),
            ("CF", argv("cf", "--checkpoint-frequency", "0", "--resume-from-checkpoint",
                        str(fs2_ckpt2), "--elastic-resume", "on")),
            ("V1", argv("v1", "--checkpoint-frequency", "0", "--resume-from-checkpoint",
                        str(v2_ckpt2), "--smoke-wait-for", str(v2_ckpt2)))],
            runs, problems, world=1)
        # each save is published by one rename
        wait_for("FS2's final checkpoint", fs2_final.exists, timeout=600.0)
        res["serving_fs2"] = serve_sharded(fs2_final, argv("x"))

    fs2_ckpt2, fs2_final = DP_DIR / "fs2" / "ckpt_2", DP_DIR / "fs2" / f"ckpt_{DP_STEPS}_final"

    def a_chain():
        """A2: two ranks on the one card over gloo, sharded engine, async
        save at 2; then C, one process resuming A2's step-2 sharded
        checkpoint through the elastic preflight; then A2's final checkpoint
        served."""
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
        """V2: dp2 with the vanilla engine (host 0 writes; V1 resumes it at
        dp 1 in R1's process); in V2's process pair TP2 (--tp 2, vanilla, 2
        steps and its save at 2) and TF, TP2's step-2 file resumed at --fsdp
        2 for steps 3-4."""
        res["v2"], res["tp2"], res["tf"] = go_runs("dp", [
            ("V2", argv("v2", *dist2, "--checkpoint-frequency", "2", "--training-steps", "3")),
            ("TP2", argv("tp2", *tp2, "--checkpoint-frequency", "2", "--training-steps", "2")),
            ("TF", argv("tf", *fs2, "--checkpoint-frequency", "0", "--resume-from-checkpoint",
                        str(DP_DIR / "tp2" / "ckpt_2_final.ckpt"), "--elastic-resume", "on"))],
            runs, problems, world=2)
        res["v_files"] = sorted(p.name for p in exp_v.iterdir() if p.name.startswith("ckpt_"))

    wire_runs = {
        "Q8": ("--grad-allreduce", "int8"),
        "Q8B": ("--grad-allreduce", "int8", "--grad-bucket-mb", str(WIRE_BUCKET_MB)),
        "B16": ("--grad-allreduce", "bf16"),
        "Z1": ("--optimizer-sharding", "zero1"),
        "Z1Q": ("--optimizer-sharding", "zero1", "--grad-allreduce", "int8"),
    }

    def r_chain():
        """R0, then R1 and CF: one process at a time, so the card holds nine
        of the phase's processes at once, not ten (ten went out of
        memory)."""
        r0_run()
        r1_run()

    def wire_chain():
        """FS2 (--fsdp 2, sharded engine, saves at 2 and 4), then Q8, Q8B,
        B16, Z1, Z1Q: A2's two ranks, data and weights, WIRE_STEPS steps,
        one run after another in one process pair (one start for the six;
        each wire run's final ``.params`` digests taken in memory, no
        checkpoint written)."""
        res["fs2"] = go_runs("dp", [("FS2", argv("fs2", *fs2, "--checkpoint-engine", "sharded",
                                                 "--checkpoint-frequency", "2"))] + [
            (label, argv(label.lower(), *dist2, *extra, "--training-steps", str(WIRE_STEPS)))
            for label, extra in wire_runs.items()], runs, problems, world=2)[0]

    # five independent chains at once (their own experiment directories; the
    # card holds their nine processes): their seconds overlap
    chains_s = run_chains("dp", (r_chain, wire_chain, a_chain, b_chain, v_chain))

    r0_rows, r1_rows = loss_rows(DP_DIR / "r0"), loss_rows(DP_DIR / "r1")
    r0, r1 = csv_losses(DP_DIR / "r0"), csv_losses(DP_DIR / "r1")
    checks["R1 (NCCL, world 1) loss CSV = R0's, bit for bit"] = r1_rows == r0_rows
    r1_err = max(rel(r1[s], r0[s]) for s in r0)

    a2 = res["a2"]
    a = csv_losses(DP_DIR / "a2")
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

    c = csv_losses(DP_DIR / "c")
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
    v = csv_losses(DP_DIR / "v1")
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
    # the model axes (fsdp and tensor), against R0 as A2 and the wire are
    fs, tp = csv_losses(DP_DIR / "fs2"), csv_losses(DP_DIR / "tp2")
    fs_step1 = rel(fs[1], r0[1])
    fs_later = max(rel(fs[s_], r0[s_]) for s_ in range(2, DP_STEPS + 1))
    checks[f"FS2 (--fsdp 2) step 1 loss within {DP_STEP1_RTOL:g} of R0's"] = (
        fs_step1 <= DP_STEP1_RTOL)
    checks[f"FS2 steps 2-{DP_STEPS} within {DP_LOSS_RTOL:g} of R0's"] = fs_later <= DP_LOSS_RTOL
    checks["FS2: both ranks end at step 4, sharded saves at 2 and 4"] = (
        all(sm["end_step"] == DP_STEPS for sm in res["fs2"])
        and sorted(p.name for p in (DP_DIR / "fs2").glob("ckpt_*")) == ["ckpt_2", "ckpt_4_final"])
    param_gib = 16 * n_params / 2**30  # one rank's fp32 params, gradients, mu and nu at dp
    fs_saving = [a_["peak_mem_gib"] - f_["peak_mem_gib"] for a_, f_ in zip(a2, res["fs2"])
                 if a_["peak_mem_gib"] is not None and f_["peak_mem_gib"] is not None]
    checks[f"FS2: each rank's peak at least {FS_PEAK_SHARE:.3g} of one rank's param + grad + "
           "moment bytes below A2's"] = (
        len(fs_saving) == 2 and min(fs_saving) >= FS_PEAK_SHARE * param_gib)
    tp_err = max(rel(tp[s_], r0[s_]) for s_ in (1, 2)) if sorted(tp) == [1, 2] else math.inf
    tp_norm_err = rel(runs["TP2"]["summaries"][0]["grad_norms"][0],
                      runs["R0"]["summaries"][0]["grad_norms"][0])
    checks[f"TP2 (--tp 2): losses within {WIRE_LOSS_RTOL:g} of R0's"] = tp_err <= WIRE_LOSS_RTOL
    checks[f"TP2: step 1's gradient norm within {WIRE_NORM_RTOL:g} of R0's"] = (
        tp_norm_err <= WIRE_NORM_RTOL)
    checks["TP2: one vanilla file, host 0's, the whole leaves under the JAX paths"] = (
        sorted(p.name for p in (DP_DIR / "tp2").glob("ckpt_*")) == ["ckpt_2_final.ckpt"]
        and read_ckpt_meta(DP_DIR / "tp2" / "ckpt_2_final.ckpt")["paths"] == want_paths)
    cf, tf = csv_losses(DP_DIR / "cf"), csv_losses(DP_DIR / "tf")
    cf_err = max(rel(cf[s_], fs[s_]) for s_ in (3, 4)) if sorted(cf) == [3, 4] else math.inf
    # TP2 stops at its save: TF's steps 3-4 are held to R0's, as TP2's are
    tf_err = max(rel(tf[s_], r0[s_]) for s_ in (3, 4)) if sorted(tf) == [3, 4] else math.inf
    checks[f"CF: FS2's step 2 resumed at dp 1, steps 3-4 within {DP_LOSS_RTOL:g} of FS2's"] = (
        cf_err <= DP_LOSS_RTOL)
    checks[f"TF: TP2's step 2 resumed at --fsdp 2, steps 3-4 within {DP_LOSS_RTOL:g} of "
           "R0's"] = tf_err <= DP_LOSS_RTOL

    def elastic_events(name):
        return [(e["saved_topology"]["mesh"], e["target_topology"]["devices"], e["step"])
                for e in read_events(DP_DIR / name / f"{name}_telemetry.jsonl")
                if e["event"] == "elastic_resume"]

    cf_elastic, tf_elastic = elastic_events("cf"), elastic_events("tf")
    checks["CF: elastic_resume from fsdp 2 onto 1 device, sampler_rescaled 2 -> 1"] = (
        len(cf_elastic) == 1 and cf_elastic[0][0]["fsdp"] == 2 and cf_elastic[0][1:] == (1, 2)
        and [(e["saved_replicas"], e["target_replicas"]) for e in rescaled("cf")] == [(2, 1)])
    checks["TF: elastic_resume from tensor 2 onto fsdp 2, sampler_rescaled 1 -> 2"] = (
        len(tf_elastic) == 1 and tf_elastic[0][0]["tensor"] == 2 and tf_elastic[0][1:] == (2, 2)
        and [(e["saved_replicas"], e["target_replicas"]) for e in rescaled("tf")] == [(1, 2)])
    serving_fs2 = res["serving_fs2"]
    checks["serving: FS2's sharded checkpoint (each rank's slices) = the vanilla reader of its "
           "state, digest for digest"] = serving_fs2.pop("equal")
    checks["every rank launched the flash kernels layers x steps, on tensor cores"] = not problems

    def line(label):
        sm = runs[label]["summaries"]
        return {
            "ranks": len(sm),
            "backend": {"R0": None, "R1": "cuda:nccl,cpu:gloo", "C": None, "CF": None,
                        "V1": None}.get(label, "gloo"),
            "mesh": sm[0].get("mesh"),
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
        "chain_s": CHAIN_S.get("dp"),
        "mesh": {
            "route": "gloo, two ranks on the one card; FSDP2 gathers the fsdp slices a "
                     "block at a time (all_gather_into_tensor) and reduce-scatters them "
                     "(reduce_scatter_tensor), the tensor pair as all_reduce",
            "errors_vs_R0": {"FS2_step1": fs_step1, "FS2_steps2_4": fs_later, "TP2": tp_err,
                             "TP2_step1_grad_norm": tp_norm_err},
            "resume_errors": {"CF_vs_FS2": cf_err, "TF_vs_R0": tf_err},
            "FS2_peak_saving_gib": fs_saving, "param_grad_moment_gib_per_rank": param_gib,
            "elastic_resume": {"CF": cf_elastic, "TF": tf_elastic},
            "serving_FS2": serving_fs2,
            "tp_launches": runs["TP2"]["summaries"][0]["launches"],
        },
        # the expert legs (item 10), when `expert_phase` ran before this phase
        "ep": EP_RESULT.get("ep"),
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



# the expert legs' line, for the dp line (`expert_phase_chains` runs them
# beside the checkpoint phase, before the dp phase); where they write
EP_RESULT = {}
EP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ep"


def expert_phase_chains():
    """The expert axis on the card (see the module docstring, item 10): its
    legs as three chains for `run_chains`, and the function that checks
    their results and prints the ``ep`` line (failing the script on any
    violation). An MoE pair holds ~14 GB of the card: beside the dp phase's
    nine llama processes they ran out of its 80 GB, so they run beside the
    checkpoint phase instead, whose one trainer and the soak's small
    processes leave the card room."""
    from pyrecover_tpu_torch.telemetry import read_events

    shutil.rmtree(EP_DIR, ignore_errors=True)
    EP_DIR.mkdir(parents=True)
    runs, problems, res = {}, [], {}

    ep2 = ["--distributed", "--ep", "2", "--dist-backend", "gloo"]
    fs2 = ["--distributed", "--fsdp", "2", "--dist-backend", "gloo"]
    tp2 = ["--distributed", "--tp", "2", "--dist-backend", "gloo"]
    short, fp32 = ["--training-steps", str(EP_SHORT_STEPS)], ["--model-dtype", "fp32"]
    grouped = ["--smoke-moe-dispatch", "grouped"]
    e2_ckpt2, me1_picks = EP_DIR / "e2" / "ckpt_2_final", str(EP_DIR / "me1_picks.pt")

    def leg(name, *extra):
        return ep_argv(EP_DIR, name, *extra)

    def me1_chain():
        """ME1 (which publishes its first forward's routing picks for MT) and
        ME1F (fp32, grouped), the references (ep 1), then ER: E2's step 2
        resumed at ep 1, one process (at fsdp 2, where the sampler would
        rescale, its two gloo ranks cost the phase ~25 s; the CPU tests hold
        that resume)."""
        res["er"] = go_runs("ep", [
            ("ME1", leg("me1", "--smoke-record-picks", me1_picks)),
            ("ME1F", leg("me1f", *fp32, *grouped)),
            ("ER", leg("er", "--resume-from-checkpoint", str(e2_ckpt2), "--elastic-resume", "on",
                       "--smoke-wait-for", str(e2_ckpt2)))], runs, problems, fp32=FP32_LEGS)[2]

    def e2_chain():
        """E2 (grouped EP, the sharded engine, 2 steps and one save, at step
        2: the checkpoint ER resumes and serving reads) in one process pair;
        then that checkpoint served."""
        res["e2"], = go_runs("ep", [("E2", leg("e2", *ep2, "--checkpoint-engine", "sharded",
                                                "--checkpoint-frequency", "2", *short,
                                                *grouped))],
                             runs, problems, world=2)
        res["serving_e2"] = serve_sharded(e2_ckpt2, leg("x"))

    def short_chain():
        """EQ (fp32, every MoE dispatch call under the transfer guard), MF
        (fsdp 2) and MT (tp 2, bf16; its first forward routed by ME1's picks:
        a tensor-split step rounds its partial sums apart from one process's,
        which flips near-tied picks, and the count of its own picks that
        differ is kept) in one process pair."""
        go_runs("ep", [("EQ", leg("eq", *ep2, *short, *fp32, "--smoke-guard-moe")),
                       ("MF", leg("mf", *fs2, *short)),
                       ("MT", leg("mt", *tp2, *short, *grouped, "--smoke-force-picks", me1_picks,
                                  "--smoke-wait-for", me1_picks))],
                runs, problems, world=2, fp32=FP32_LEGS)

    def finish():
        """Check the legs' results, print the ``ep`` line; returns it."""
        checks = {}

        def events(name, kind):
            return [e for e in read_events(EP_DIR / name / f"{name}_telemetry.jsonl")
                    if e["event"] == kind]

        # the bf16 legs against ME1, the fp32 one (EQ) against ME1F
        ref = {"E2": "ME1", "MF": "ME1", "EQ": "ME1F", "MT": "ME1"}
        losses = {label: csv_losses(EP_DIR / label.lower())
                  for label in (*ref, "ME1", "ME1F", "ER")}
        first = {label: runs[label]["summaries"][0] for label in (*ref, "ME1", "ME1F")}
        # ER continues E2's state at ep 1, ME1's configuration: its steps 3-4
        # are held to ME1's
        ep_err = {"ER_vs_ME1": max(rel(losses["ER"][s_], losses["ME1"][s_]) for s_ in (3, 4))
                  if sorted(losses["ER"]) == [3, 4] else math.inf}
        for label, base in ref.items():
            step1_rtol = EP_LOSS_RTOL if label == "MT" else DP_STEP1_RTOL
            errs, ok = hold_to(losses[label], losses[base], first[label], first[base],
                               step1_rtol)
            ep_err.update({f"{label}_{k}": v for k, v in errs.items()})
            checks[f"{label} ({EP_LEG_FLAGS[label]}) against {base}: step 1 loss within "
                   f"{step1_rtol:g}, steps 2-{len(losses[label])} and the aux loss within "
                   f"{EP_LOSS_RTOL:g}, step 1's gradient norm within {WIRE_NORM_RTOL:g}"] = ok
        flips = [sm.get("moe_pick_flips") for sm in runs["MT"]["summaries"]]
        tokens = MOE_BATCH * MOE_SEQ
        checks[f"MT: every layer's first-forward routing taken from ME1's picks (its own "
               f"differ in {flips} of {tokens} tokens a layer)"] = (
            flips == [flips[0]] * 2 and len(flips[0]) == DP_LAYERS)
        eq_guarded = [sm.get("moe_dispatch_guarded") for sm in runs["EQ"]["summaries"]]
        checks["EQ: every MoE dispatch call (layers x steps a rank, auto at fp32: scatter) "
               "silent under the transfer guard"] = eq_guarded == [DP_LAYERS * EP_SHORT_STEPS] * 2
        held = {label: [sm["experts_held"] for sm in runs[label]["summaries"]]
                for label in ("E2", "ER")}
        checks["E2: each rank holds 2 of the 4 experts of every moe_w* leaf; ER (ep 1) all 4"] = (
            all(set(h.values()) == {2} and len(h) == 3 for h in held["E2"])
            and all(set(h.values()) == {4} for h in held["ER"]))
        # one rank's expert parameters at ep 2: 2 of the 4 experts of each layer
        expert_gib = 16 * DP_LAYERS * 2 * 3 * 2048 * 7168 / 2**30
        me1_peak = first["ME1"]["peak_mem_gib"]
        e2_saving = [me1_peak - sm["peak_mem_gib"] for sm in res["e2"]
                     if sm["peak_mem_gib"] is not None and me1_peak is not None]
        checks[f"E2: each rank's peak at least {EP_PEAK_SHARE:.3g} of its expert parameters' "
               "16 B below ME1's"] = (
            len(e2_saving) == 2 and min(e2_saving) >= EP_PEAK_SHARE * expert_gib)
        checks[f"E2: both ranks end at step {EP_SHORT_STEPS}, one sharded save there"] = (
            all(sm["end_step"] == EP_SHORT_STEPS for sm in res["e2"])
            and sorted(p.name for p in (EP_DIR / "e2").glob("ckpt_*"))
            == [f"ckpt_{EP_SHORT_STEPS}_final"])
        er_elastic = [(e["saved_topology"]["mesh"], e["target_topology"]["devices"], e["step"])
                      for e in events("er", "elastic_resume")]
        checks[f"ER: E2's step 2 at ep 1 (one process), steps 3-4 within {EP_LOSS_RTOL:g} of "
               "ME1's, elastic_resume from expert 2 onto 1 device"] = (
            ep_err["ER_vs_ME1"] <= EP_LOSS_RTOL and len(er_elastic) == 1
            and er_elastic[0][0]["expert"] == 2 and er_elastic[0][1:] == (1, 2))
        serving_e2 = res["serving_e2"]
        checks["serving: E2's sharded checkpoint (each rank's experts) = the vanilla reader of "
               "its state, digest for digest"] = serving_e2.pop("equal")
        checks["every rank launched the flash kernels layers x steps, on tensor cores (the "
               "fp32 legs on the FMA instances)"] = not problems
        line = {"ep": {
            "card": card_line(),
            "route": "gloo, two ranks on the one card; each rank routes its rows over all "
                     "experts, runs its own, and one fp32 all_reduce over expert x tensor "
                     "sums the partial outputs (its conjugate sums the input's and the "
                     "router's gradients)",
            "model": "moe-4x1b's width (dim 2048, 4 top-2 experts of ffn 7168, GQA 16/8, "
                     f"vocab 32768), {DP_LAYERS} layers, seq {MOE_SEQ}, batch {MOE_BATCH}",
            "runs": {label: {"ranks": len(r["summaries"]),
                             "mesh": r["summaries"][0].get("mesh"),
                             "losses": r["summaries"][0]["losses"],
                             "moe_aux": r["summaries"][0]["moe_aux"],
                             "window_step_ms": r["summaries"][0]["window_step_ms"],
                             "peak_mem_gib": [sm["peak_mem_gib"] for sm in r["summaries"]],
                             "wall_s": r["wall_s"]} for label, r in runs.items()},
            "references": ref, "errors": ep_err,
            "limits": {"step1_rtol": DP_STEP1_RTOL, "MT_step1_rtol": EP_LOSS_RTOL,
                       "loss_rtol": EP_LOSS_RTOL, "grad_norm_rtol_step1": WIRE_NORM_RTOL},
            "MT_pick_flips": {"tokens_a_layer": tokens, "per_rank_per_layer": flips},
            "experts_held": held, "E2_peak_saving_gib": e2_saving,
            "expert_gib_per_rank": expert_gib, "EQ_dispatch_guarded": eq_guarded,
            "elastic_resume_ER": er_elastic, "serving_E2": serving_e2,
            "chain_s": CHAIN_S.get("checkpoint"),
            "launches": {label: runs[label]["summaries"][0]["launches"] for label in runs},
            "checks": checks,
        }}
        for what, ok in checks.items():
            print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
        print(json.dumps(line), flush=True)
        EP_RESULT.update(line)
        bad = [what for what, ok in checks.items() if not ok]
        shutil.rmtree(EP_DIR, ignore_errors=True)
        if bad or problems:
            fail("expert legs: " + "; ".join(bad + problems))
        return line

    return (me1_chain, e2_chain, short_chain), finish


def expert_phase():
    """The expert legs alone (``--time-phases DIR expert_phase``)."""
    chains, finish = expert_phase_chains()
    run_chains("checkpoint", chains)
    return finish()


SEQPIPE_RESULT = {}


def seqpipe_argv(name, layers, seq, batch, steps, *extra):
    """A sequence or pipeline leg's trainer flags: llama-1b's width at
    ``layers`` layers, ``batch`` rows of ``seq``, ``steps`` steps (the data
    drawn for PP_STEPS or SP_STEPS whatever a leg's cut), flash (the ring
    over it at --sp above 1), its loss CSV and telemetry under
    ``SEQPIPE_DIR / name``."""
    total = PP_STEPS if seq == 2048 else SP_STEPS
    return train_argv() + [
        "--use-flash-attention", "--model-layers", str(layers), "--sequence-length", str(seq),
        "--batch-size", str(batch), "--training-samples", str(batch * total),
        "--training-steps", str(steps), "--checkpoint-dir", str(SEQPIPE_DIR),
        "--experiment-name", name, "--log-loss-to-csv", "--telemetry", *extra]


def hold_seqpipe(label, base, losses, first):
    """A sequence or pipeline leg held to its one-process reference:
    ``(errors, the check's words, whether it held)``: step 1's loss within
    SP_STEP1_RTOL (a ring leg, its label ``SP...``) or PP_STEP1_RTOL, the
    later steps' within SEQPIPE_LOSS_RTOL, step 1's gradient norm within
    WIRE_NORM_RTOL, every loss finite. ``losses`` maps a label to its
    ``{step: loss}``, ``first`` to rank 0's summary."""
    step1 = SP_STEP1_RTOL if label.startswith("SP") else PP_STEP1_RTOL
    got, want = losses[label], losses[base]
    e = {"step1": rel(got[1], want[1]),
         "later": max((rel(got[s_], want[s_]) for s_ in sorted(got)[1:]), default=0.0),
         "step1_grad_norm": rel(first[label]["grad_norms"][0], first[base]["grad_norms"][0])}
    n = len(first[label]["losses"])
    what = (f"{label} against {base}: step 1 within {step1:g}, steps 2-{n} within "
            f"{SEQPIPE_LOSS_RTOL:g}, step 1's gradient norm within {WIRE_NORM_RTOL:g}")
    ok = (sorted(got) == list(range(1, n + 1)) and e["step1"] <= step1
          and e["later"] <= SEQPIPE_LOSS_RTOL and e["step1_grad_norm"] <= WIRE_NORM_RTOL
          and all(math.isfinite(x) for x in first[label]["losses"]))
    return e, what, ok


def composed_plans(gloo2):
    """The composed legs' runs (item 17): ``(PMI and PMI1, SM2 and SM1, PF,
    [PT, PZ])`` as ``(label, argv)``, the first of each pair for the process
    pair, the second for one process; the four-rank legs' flags name no
    backend (gloo on the one card, NCCL across four)."""
    moe = [*SEQPIPE_MOE, "--training-steps", str(COMPOSED_STEPS)]
    pmi = [*moe, "--remat", "--remat-policy", "full", "--smoke-packed"]
    sm = [*moe, "--moe-capacity-factor", SM_CF, "--smoke-moe-dispatch", "scatter"]
    micro = ["--pp-schedule", "1f1b", "--pp-microbatches", str(PP_MICRO)]
    short = ["--training-steps", str(COMPOSED_STEPS)]

    def pp(name, *extra):
        return seqpipe_argv(name, PP_LAYERS, 2048, DP_BATCH, PP_STEPS, *extra)

    def sp(name, *extra):
        return seqpipe_argv(name, SM_LAYERS, SM_SEQ, 1, SP_STEPS, *extra)

    quad = ["--distributed", "--pp", "2"]
    return ([("PMI", pp("pmi", *gloo2, "--pp", "2", *micro, "--pp-virtual-stages", "2",
                        *pmi)),
             ("PMI1", pp("pmi1", *pmi, "--smoke-moe-dispatch", "einsum"))],
            [("SM2", sp("sm2", *gloo2, "--sp", "2", *sm)), ("SM1", sp("sm1", *sm))],
            ("PF", pp("pf", *quad, "--fsdp", "2", "--pp-schedule", "1f1b",
                      "--pp-microbatches", "2", *short)),
            [("PT", pp("pt", *quad, "--tp", "2", *micro, "--pp-virtual-stages", "2", *short)),
             ("PZ", pp("pz", *quad, "--dp", "2", "--optimizer-sharding", "zero1", *short))])


def composed_launches():
    """Each composed leg's flash launches a step and rank (`go_runs`): a
    stage's layers x microbatches (PMI's forward twice: full remat), a ring
    rank i's (i + 1) x layers."""
    half = PP_LAYERS // 2
    return {"PMI": [(2 * half * PP_MICRO, half * PP_MICRO, half * PP_MICRO)] * 2,
            "PMI1": [(2 * PP_LAYERS, PP_LAYERS, PP_LAYERS)],
            "SM2": [SM_LAYERS, 2 * SM_LAYERS], "SM1": [SM_LAYERS], "PP1": [PP_LAYERS],
            "PF": [half * 2] * 4, "PT": [half * PP_MICRO] * 4, "PZ": [half * 2] * 4}


def hold_composed_moe(losses, first, errs):
    """PMI held to PMI1 at PP_STEP1_RTOL and SM2 to SM1 at SP_STEP1_RTOL,
    the later steps and the aux within EP_LOSS_RTOL, step 1's gradient norm
    within WIRE_NORM_RTOL (`hold_to`); their errors go into ``errs``.
    Returns ``{label: (its reference, (the check's words, whether it
    held))}``."""
    out = {}
    for label, base, step1 in (("PMI", "PMI1", PP_STEP1_RTOL), ("SM2", "SM1", SP_STEP1_RTOL)):
        if label not in losses:
            continue
        e, ok = hold_to(losses[label], losses[base], first[label], first[base], step1)
        errs.update({f"{label}_{k}": v for k, v in e.items()})
        out[label] = (base, (f"{label} against {base}: step 1 within {step1:g}, the later "
                             f"steps and the aux within {EP_LOSS_RTOL:g}, step 1's gradient "
                             f"norm within {WIRE_NORM_RTOL:g}", ok))
    return out


def seqpipe_phase_chains():
    """The sequence and pipeline axes on the card (module docstring, item
    17): their legs as two chains for `run_chains`, and the function that
    checks their results and prints the ``seqpipe`` line (failing the
    script on any violation)."""
    from pyrecover_tpu_torch.telemetry import read_events

    shutil.rmtree(SEQPIPE_DIR, ignore_errors=True)
    SEQPIPE_DIR.mkdir(parents=True)
    runs, problems, res = {}, [], {}
    gloo2 = ["--distributed", "--dist-backend", "gloo"]
    pg2_ckpt = SEQPIPE_DIR / "pg2" / "ckpt_2_final"

    def sp(name, *extra):
        return seqpipe_argv(name, SP_LAYERS, SP_SEQ, SP_BATCH, SP_STEPS, *extra)

    def pp(name, *extra):
        return seqpipe_argv(name, PP_LAYERS, 2048, DP_BATCH, PP_STEPS, *extra)

    pp2 = [*gloo2, "--pp", "2"]
    micro = ["--pp-schedule", "1f1b", "--pp-microbatches", str(PP_MICRO)]
    half = PP_LAYERS // 2
    # each ring rank i runs i + 1 blocks a layer (the diagonal and the
    # earlier chunks); each stage its layers x microbatches (the forward
    # twice under full remat)
    per_step = {"SP2": [SP_LAYERS, 2 * SP_LAYERS], "SPK": [SP_LAYERS, 2 * SP_LAYERS],
                "SP1": [SP_LAYERS], "SPK1": [SP_LAYERS], "PP1": [PP_LAYERS],
                "PR1": [PP_LAYERS], "PG2": [half * 2] * 2, "P1F": [half * PP_MICRO] * 2,
                "PI": [half * PP_MICRO] * 2, **composed_launches()}

    def pair_chain():
        """PG2 (gpipe, M 2, the sharded engine, 2 steps and one save), SP2,
        SPK (packed rows), P1F (1f1b, M 4), PI (interleaved, V 2, M 4), PMI
        and SM2 (`composed_plans`) in one process pair."""
        pmi, sm2, _, _ = composed_plans(gloo2)
        go_runs("seqpipe", [
            ("PG2", pp("pg2", *pp2, "--checkpoint-engine", "sharded",
                       "--checkpoint-frequency", "2", "--training-steps", "2")),
            ("SP2", sp("sp2", *gloo2, "--sp", "2")),
            ("SPK", sp("spk", *gloo2, "--sp", "2", "--smoke-packed")),
            ("P1F", pp("p1f", *pp2, *micro, "--training-steps", "3")),
            ("PI", pp("pi", *pp2, *micro, "--pp-virtual-stages", "2", "--training-steps", "3")),
            pmi[0], sm2[0]], runs, problems, world=2, per_step=per_step)

    def one_chain():
        """SP1, SPK1, PP1, PMI1 and SM1 (the references, one process), then
        PR1 (PG2's save at pp 1, elastic), then PG2's save served."""
        pmi, sm2, _, _ = composed_plans(gloo2)
        go_runs("seqpipe", [
            ("SP1", sp("sp1")), ("SPK1", sp("spk1", "--smoke-packed")), ("PP1", pp("pp1")),
            pmi[1], sm2[1],
            ("PR1", pp("pr1", "--resume-from-checkpoint", str(pg2_ckpt), "--elastic-resume",
                       "on", "--smoke-wait-for", str(pg2_ckpt)))],
            runs, problems, per_step=per_step)
        res["serving"] = serve_sharded(pg2_ckpt, pp("x"))

    def finish():
        """Check the legs' results and PF's (`composed_chains`, run before),
        print the ``seqpipe`` line; returns it."""
        checks, errs = {}, {}
        losses = {label: csv_losses(SEQPIPE_DIR / label.lower()) for label in runs}
        runs.update(COMPOSED["runs"])
        losses.update(COMPOSED["losses"])
        problems.extend(COMPOSED["problems"])
        first = {label: r["summaries"][0] for label, r in runs.items()}
        ref = {"SP2": "SP1", "SPK": "SPK1", "PG2": "PP1", "P1F": "PP1", "PI": "PP1",
               "PF": "PP1"}
        for label, base in ref.items():
            e, what, ok = hold_seqpipe(label, base, losses, first)
            errs.update({f"{label}_{k}": v for k, v in e.items()})
            checks[what] = ok
        for label, (base, what) in hold_composed_moe(losses, first, errs).items():
            ref[label] = base
            checks[what[0]] = what[1]
        pr1 = losses["PR1"]
        errs["PR1_vs_PP1"] = (max(rel(pr1[s_], losses["PP1"][s_]) for s_ in (3, 4))
                              if sorted(pr1) == [3, 4] else math.inf)
        elastic = [(e["saved_topology"]["mesh"], e["target_topology"]["devices"], e["step"])
                   for e in read_events(SEQPIPE_DIR / "pr1" / "pr1_telemetry.jsonl")
                   if e["event"] == "elastic_resume"]
        checks[f"PR1: PG2's step 2 at pp 1 (one process), steps 3-4 within "
               f"{SEQPIPE_LOSS_RTOL:g} of PP1's, elastic_resume from pipeline 2 onto 1 "
               "device"] = (errs["PR1_vs_PP1"] <= SEQPIPE_LOSS_RTOL and len(elastic) == 1
                            and elastic[0][0]["pipeline"] == 2 and elastic[0][1:] == (1, 2))
        stages = {label: [sm["stage_layers"] for sm in runs[label]["summaries"]]
                  for label in ("PG2", "P1F", "PI", "PMI", "PF")}
        checks["each stage held its layers: 0-1 and 2-3, interleaved (V 2) 0, 2 and 1, 3 "
               "(each stage's two fsdp ranks alike in PF)"] = (
            stages["PG2"] == stages["P1F"] == [[0, 1], [2, 3]]
            and stages["PI"] == stages["PMI"] == [[0, 2], [1, 3]]
            and stages["PF"] == [[0, 1], [0, 1], [2, 3], [2, 3]])
        serving = res["serving"]
        checks["serving: PG2's sharded checkpoint (each stage's layers) = the vanilla reader "
               "of its state, digest for digest"] = serving.pop("equal")
        checks["every rank launched the flash kernels on tensor cores, ring rank i (i + 1) x "
               "layers a step, a stage its layers x microbatches (the forward twice under "
               "full remat)"] = not problems
        line = {"seqpipe": {
            "card": card_line(),
            "route": "gloo, two ranks on the one card: the ring's k/v and segment-id chunks "
                     "and the stages' activations and cotangents by batch_isend_irecv, staged "
                     "through host buffers (mesh.p2p_route gloo-host); the ring's blocks on "
                     "K1-K3 (the keys' segment ids their own off the diagonal)",
            "model": f"llama-1b's width (dim 2048, GQA 16/8, ffn 7168, vocab 32768); sp legs "
                     f"{SP_LAYERS} layers, {SP_BATCH} rows of {SP_SEQ}; pp legs {PP_LAYERS} "
                     f"layers, {DP_BATCH} rows of 2048; PMI and SM moe-4x1b's width (4 top-2 "
                     f"experts), SM {SM_LAYERS} layers, one row of {SM_SEQ}, capacity factor "
                     f"{SM_CF}; PF four ranks",
            "runs": {label: {"ranks": len(r["summaries"]),
                             "mesh": r["summaries"][0].get("mesh"),
                             "losses": r["summaries"][0]["losses"],
                             "window_step_ms": r["summaries"][0]["window_step_ms"],
                             "peak_mem_gib": [sm["peak_mem_gib"] for sm in r["summaries"]],
                             "wall_s": r["wall_s"]} for label, r in runs.items()},
            "references": ref, "errors": errs,
            "limits": {"sp_step1_rtol": SP_STEP1_RTOL, "pp_step1_rtol": PP_STEP1_RTOL,
                       "loss_rtol": SEQPIPE_LOSS_RTOL, "grad_norm_rtol_step1": WIRE_NORM_RTOL,
                       "moe_later_and_aux_rtol": EP_LOSS_RTOL},
            "stage_layers": stages, "elastic_resume_PR1": elastic, "serving_PG2": serving,
            "launches": {label: [sm["launches"] for sm in r["summaries"]]
                         for label, r in runs.items()},
            "chain_s": {what: CHAIN_S.get(what)
                        for what in ("seqpipe", "trainer", "zerostall")},
            "checks": checks,
        }}
        for what, ok in checks.items():
            print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
        print(json.dumps(line), flush=True)
        SEQPIPE_RESULT.update(line)
        bad = [what for what, ok in checks.items() if not ok]
        shutil.rmtree(SEQPIPE_DIR, ignore_errors=True)
        if bad or problems:
            fail("sequence and pipeline legs: " + "; ".join(bad + problems))
        return line

    return (pair_chain, one_chain), finish


def seqpipe_phase():
    """The sequence and pipeline legs alone (``--time-phases DIR
    seqpipe_phase``), the composed legs first."""
    run_chains("composed", composed_chains())
    shutil.rmtree(COMPOSED_DIR, ignore_errors=True)
    chains, finish = seqpipe_phase_chains()
    run_chains("seqpipe", chains)
    return finish()


# PF's per-rank summaries, losses and launch problems (`composed_chains`),
# held to PP1 by the seqpipe legs' `finish`
COMPOSED = {"runs": {}, "losses": {}, "problems": []}
COMPOSED_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "composed"


def composed_chains():
    """PF (`composed_plans`): one group of four ranks on the card over gloo
    (item 17), as one chain beside the trainer phase, whose one process
    leaves the card and the host room for it (beside the zerostall phase
    the group outlasted that phase's own chains, and the MoE legs beside
    the trainer phase ran the card out of memory). Its results wait in
    `COMPOSED` for PP1, which the seqpipe legs run. PT and PZ, which the one
    card's time could not hold, run across four cards
    (`seqpipe_cards_phase`)."""
    shutil.rmtree(COMPOSED_DIR, ignore_errors=True)
    COMPOSED_DIR.mkdir(parents=True)
    COMPOSED.update(runs={}, losses={}, problems=[])

    def pf_chain():
        label, argv = composed_plans([])[2]
        runs = {}
        go_runs("composed", [(label, [str(COMPOSED_DIR) if a == str(SEQPIPE_DIR) else a
                                      for a in argv] + ["--dist-backend", "gloo"])],
                runs, COMPOSED["problems"], world=4, per_step=composed_launches())
        COMPOSED["runs"].update(runs)
        COMPOSED["losses"].update({label: csv_losses(COMPOSED_DIR / label.lower())})

    return (pf_chain,)


def trainer_and_composed_phase():
    """The trainer phase (its own process) with the composed legs beside it
    (`composed_chains`)."""
    run_chains("trainer", (run_trainer_phase, *composed_chains()))
    shutil.rmtree(COMPOSED_DIR, ignore_errors=True)
    print(json.dumps({"trainer_chain_s": CHAIN_S["trainer"]}), flush=True)


def seqpipe_plant_phase():
    """Known faults planted in the sequence and pipeline legs, to show
    that their limits catch them (``--time-phases . seqpipe_plant_phase``;
    not part of the whole check): SPR (SP2 with the RoPE offset dropped),
    SPD (SP2 with only the ring's diagonal block run), PIR (PI with each
    stage's chunks in reverse) and SMC (SM2 with each sequence chunk routed
    as a row: capacity and aux per chunk), `_plant`, beside SP2, PI and SM2,
    each held to SP1 / PP1 by `hold_seqpipe` (SM2 and SMC to SM1 by
    `hold_to`). Prints the ``seqpipe_plants`` line; fails unless SP2, PI and
    SM2 hold and every planted run fails."""
    shutil.rmtree(SEQPIPE_DIR, ignore_errors=True)
    SEQPIPE_DIR.mkdir(parents=True)
    runs, problems = {}, []
    gloo2 = ["--distributed", "--dist-backend", "gloo"]
    micro = ["--pp-schedule", "1f1b", "--pp-microbatches", str(PP_MICRO),
             "--pp-virtual-stages", "2", "--training-steps", "3"]
    half = PP_LAYERS // 2

    def sp(name, *extra):
        return seqpipe_argv(name, SP_LAYERS, SP_SEQ, SP_BATCH, SP_STEPS, *extra)

    def pp(name, *extra):
        return seqpipe_argv(name, PP_LAYERS, 2048, DP_BATCH, PP_STEPS, *extra)

    per_step = {"SP1": [SP_LAYERS], "PP1": [PP_LAYERS], "SP2": [SP_LAYERS, 2 * SP_LAYERS],
                "SPR": [SP_LAYERS, 2 * SP_LAYERS], "SPD": [SP_LAYERS] * 2,
                "PI": [half * PP_MICRO] * 2, "PIR": [half * PP_MICRO] * 2,
                "SMC": [SM_LAYERS, 2 * SM_LAYERS], **composed_launches()}
    _, (sm2, sm1), _, _ = composed_plans(gloo2)
    smc = ("SMC", [a.replace("sm2", "smc") for a in sm2[1]] + ["--smoke-plant",
                                                                "moe-chunk-capacity"])

    def pair_chain():
        go_runs("plant", [
            ("SP2", sp("sp2", *gloo2, "--sp", "2")),
            ("SPR", sp("spr", *gloo2, "--sp", "2", "--smoke-plant", "rope-offset")),
            ("SPD", sp("spd", *gloo2, "--sp", "2", "--smoke-plant", "ring-diagonal")),
            ("PI", pp("pi", *gloo2, "--pp", "2", *micro)),
            ("PIR", pp("pir", *gloo2, "--pp", "2", *micro, "--smoke-plant", "pp-chunk-order")),
            sm2, smc], runs, problems, world=2, per_step=per_step)

    def one_chain():
        go_runs("plant", [("SP1", sp("sp1")), ("PP1", pp("pp1")), sm1], runs, problems,
                per_step=per_step)

    run_chains("plant", (pair_chain, one_chain))
    losses = {label: csv_losses(SEQPIPE_DIR / label.lower()) for label in runs}
    first = {label: r["summaries"][0] for label, r in runs.items()}
    errs, held = {}, {}
    for label, base in (("SP2", "SP1"), ("SPR", "SP1"), ("SPD", "SP1"), ("PI", "PP1"),
                        ("PIR", "PP1")):
        e, _, held[label] = hold_seqpipe(label, base, losses, first)
        errs.update({f"{label}_{k}": v for k, v in e.items()})
    for label in ("SM2", "SMC"):
        e, held[label] = hold_to(losses[label], losses["SM1"], first[label], first["SM1"],
                                 SP_STEP1_RTOL)
        errs.update({f"{label}_{k}": v for k, v in e.items()})
    checks = {"SP2, PI and SM2 hold their limits": held["SP2"] and held["PI"] and held["SM2"],
              "SPR, SPD, PIR and SMC (each a planted fault) fail them": not (
                  held["SPR"] or held["SPD"] or held["PIR"] or held["SMC"]),
              "every rank launched the flash kernels on tensor cores, its count": not problems}
    line = {"seqpipe_plants": {
        "card": card_line(), "plants": {"SPR": "rope-offset", "SPD": "ring-diagonal",
                                        "PIR": "pp-chunk-order", "SMC": "moe-chunk-capacity"},
        "errors": errs, "held": held,
        "limits": {"sp_step1_rtol": SP_STEP1_RTOL, "pp_step1_rtol": PP_STEP1_RTOL,
                   "loss_rtol": SEQPIPE_LOSS_RTOL, "grad_norm_rtol_step1": WIRE_NORM_RTOL},
        "losses": {label: r["summaries"][0]["losses"] for label, r in runs.items()},
        "checks": checks}}
    print(json.dumps(line), flush=True)
    shutil.rmtree(SEQPIPE_DIR, ignore_errors=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad or problems:
        fail("planted faults: " + "; ".join(bad + problems))
    return line


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

    def go(label, args, rank_env=None, flash_per_step=(1, 1, 1)):
        summaries, wall = run_torchrun(label, args, n, rank_env)
        runs[label] = {"summaries": summaries, "wall_s": wall}
        layers = int(args[len(args) - 1 - args[::-1].index("--model-layers") + 1])
        steps = summaries[0]["end_step"] - summaries[0]["start_step"]
        want = {}
        for key, per in zip(("fwd", "dq", "dkv"), flash_per_step):
            want[key] = want[f"{key}_wgmma"] = per * layers * steps
        checks[f"{label}: every rank launched the flash kernels layers x steps (the forward "
               "twice under full remat), on tensor cores"] = all(
            sm["launches"] == want for sm in summaries)
        print(f"  dp run {label}: {n} ranks on {n} cards, {wall:.1f} s, losses "
              f"{summaries[0]['losses']}", flush=True)
        return summaries

    m0, m0_wall = run_group("M0", argv("m0", "--checkpoint-frequency", "0"))
    runs["M0"] = {"summaries": m0, "wall_s": m0_wall}
    m = csv_losses(DP_DIR / "m0")
    na = go("NA", argv("na", *dist, "--checkpoint-engine", "sharded",
                       "--checkpoint-frequency", "2", "--grad-bucket-mb", "0"))
    a = csv_losses(DP_DIR / "na")
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
    k = csv_losses(DP_DIR / "nk")
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
        csv_losses(DP_DIR / "nz") == a
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
    mesh_errors = {}
    if n == 4:
        # the model axes one rank a card over NCCL: dp 2 x fsdp 2
        # held to M0 as NA is, fsdp 2 x tp 2 as the dp phase's TP2
        go("NDF", argv("ndf", "--distributed", "--dp", "2", "--fsdp", "2"))
        ndf = csv_losses(DP_DIR / "ndf")
        mesh_errors["NDF_step1_vs_M0"] = rel(ndf[1], m[1])
        mesh_errors["NDF_steps2_4_vs_M0"] = max(rel(ndf[s_], m[s_])
                                                for s_ in range(2, DP_STEPS + 1))
        checks[f"NDF (dp 2 x fsdp 2): step 1 within {DP_STEP1_RTOL:g} of M0's, steps 2-"
               f"{DP_STEPS} within {DP_LOSS_RTOL:g}"] = (
            mesh_errors["NDF_step1_vs_M0"] <= DP_STEP1_RTOL
            and mesh_errors["NDF_steps2_4_vs_M0"] <= DP_LOSS_RTOL)
        nft = go("NFT", argv("nft", "--distributed", "--fsdp", "2", "--tp", "2"))
        ft = csv_losses(DP_DIR / "nft")
        mesh_errors["NFT_vs_M0"] = max(rel(ft[s_], m[s_]) for s_ in range(1, DP_STEPS + 1))
        mesh_errors["NFT_step1_grad_norm_vs_M0"] = rel(nft[0]["grad_norms"][0],
                                                       m0[0]["grad_norms"][0])
        checks[f"NFT (fsdp 2 x tp 2): losses within {DP_LOSS_RTOL:g} of M0's, step 1's "
               f"gradient norm within {WIRE_NORM_RTOL:g}"] = (
            mesh_errors["NFT_vs_M0"] <= DP_LOSS_RTOL
            and mesh_errors["NFT_step1_grad_norm_vs_M0"] <= WIRE_NORM_RTOL)
        # llama-8b at full depth, --fsdp 4, one row a rank, full remat: a
        # state (16 B a parameter) no one card holds
        big = go("N8F", train_argv() + N8F_MODEL + [
            "--attention-impl", "flash", "--batch-size", "4", "--training-samples", "12",
            "--training-steps", "3", "--remat", "--remat-policy", "full",
            "--checkpoint-dir", str(DP_DIR), "--experiment-name", "n8f", "--telemetry",
            "--distributed", "--fsdp", "4"], flash_per_step=(2, 1, 1))
        n8 = 8.03e9  # llama-8b's parameters (dim 4096, 32 layers, vocab 131072)
        mesh_errors["N8F_peak_gib"] = [sm["peak_mem_gib"] for sm in big]
        mesh_errors["N8F_state_gb_whole"] = 16 * n8 / 1e9
        checks["N8F (llama-8b, --fsdp 4): finite losses, every rank under 80 GB"] = (
            all(math.isfinite(x) for x in big[0]["losses"]) and len(big[0]["losses"]) == 3
            and all((sm["peak_mem_gib"] or 1e9) * 2**30 < 80e9 for sm in big))

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
            "mesh": sm[0].get("mesh"),
        }

    out = {"dp_cards": {
        "card": card, "cards": n, "layers": DP_LAYERS, "batch_size": DP_BATCH,
        "steps": DP_STEPS, "state_gb": state_bytes(DP_LAYERS) / 1e9,
        "runs": {label: line(label) for label in runs},
        "errors": {"NA_step1_vs_M0": step1_err, "NA_steps2_4_vs_M0": later_err,
                   "NK_vs_NA": k_err, "NQ_vs_NA": q_err},
        "NK_bit_equal_NA": k == a,
        "mesh": mesh_errors,
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
    if n == 4:
        out.update(ep_cards_phase(n))
        out.update(seqpipe_cards_phase(n))
    return out


def ep_cards_phase(n=4):
    """The expert axis one rank a card over NCCL (see the module docstring,
    item 11), at the one-card legs' configuration (moe-4x1b's width,
    DP_LAYERS layers): NE (``--dp 2 --ep 2``) and NEF (``--fsdp 2 --ep 2``)
    held to ME0 (one process on card 0) as the dp phase holds E2 to ME1;
    NET (``--ep 2 --tp 2``, fp32) and NEQ (``--dp 2 --ep 2``, fp32, the whole
    step under ``--transfer-guard disallow``: over NCCL no collective stages
    through the host) held to ME0F (ME0 at fp32), NET at bf16 following in
    `seqpipe_cards_phase` (NETB, with ME0's picks); N8E: moe-8x1b at full depth,
    ``--ep 4`` (2 of its 8 experts a card), one row of seq 2048 a rank, full
    remat, 3 steps, its step ms and peak. Returns the ``ep_cards`` line."""
    from pyrecover_tpu_torch.models import presets
    from pyrecover_tpu_torch.telemetry import read_events

    card = card_line()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    runs, checks, errors = {}, {}, {}

    def leg(name, *extra):
        return ep_argv(DP_DIR, name, *extra)

    def go(label, args, flash_per_step=(1, 1, 1), fp32=False):
        summaries, wall = run_torchrun(label, args, n)
        runs[label] = {"summaries": summaries, "wall_s": wall}
        layers = int(args[len(args) - 1 - args[::-1].index("--model-layers") + 1])
        steps = summaries[0]["end_step"] - summaries[0]["start_step"]
        want = {}
        for key, per in zip(("fwd", "dq", "dkv"), flash_per_step):
            want[key] = per * layers * steps
            want[f"{key}_wgmma"] = 0 if fp32 else want[key]
        checks[f"{label}: every rank launched the flash kernels layers x steps (the forward "
               "twice under full remat), on " + ("the FMA instances (fp32)" if fp32 else
                                                 "tensor cores")] = all(
            sm["launches"] == want for sm in summaries)
        print(f"  ep run {label}: {n} ranks on {n} cards, {wall:.1f} s, losses "
              f"{summaries[0]['losses']}", flush=True)
        return summaries

    fp32 = ["--model-dtype", "fp32"]
    grouped = ["--smoke-moe-dispatch", "grouped"]
    refs, ref_wall = run_group("ME0+ME0F", leg("me0") + ["--then"]
                               + leg("me0f", *fp32, *grouped))
    runs["ME0"] = {"summaries": [refs[0][0]], "wall_s": ref_wall}
    runs["ME0F"] = {"summaries": [refs[0][1]], "wall_s": ref_wall}
    legs = (("NE", ["--dp", "2", "--ep", "2", *grouped], "ME0"),
            ("NEF", ["--fsdp", "2", "--ep", "2", *grouped], "ME0"),
            ("NET", ["--ep", "2", "--tp", "2", *fp32, *grouped], "ME0F"),
            ("NEQ", ["--dp", "2", "--ep", "2", *fp32, "--training-steps",
                     str(EP_SHORT_STEPS + 1), "--transfer-guard", "disallow"], "ME0F"))
    for label, axes, base in legs:
        got = go(label, leg(label.lower(), "--distributed", *axes), fp32=base == "ME0F")
        errs, ok = hold_to(csv_losses(DP_DIR / label.lower()), csv_losses(DP_DIR / base.lower()),
                           got[0], runs[base]["summaries"][0])
        errors.update({f"{label}_{k}_vs_{base}": v for k, v in errs.items()})
        shown = " ".join(axes).replace("--smoke-moe-dispatch grouped", "(grouped)")
        checks[f"{label} ({shown}) against "
               f"{base}: step 1 within {DP_STEP1_RTOL:g}, later steps and the aux within "
               f"{EP_LOSS_RTOL:g}, step 1's gradient norm within {WIRE_NORM_RTOL:g}"] = ok
    found = [e for e in read_events(DP_DIR / "neq" / "neq_telemetry.jsonl")
             if e["event"] == "implicit_transfer"]
    errors["NEQ_implicit_transfer"] = len(found)
    checks[f"NEQ: {EP_SHORT_STEPS} steps after the first under --transfer-guard disallow, no "
           "implicit_transfer"] = not found
    # moe-8x1b at full depth, --ep 4: 2 of its 8 experts a card, the
    # backbone replicated, one row (seq 2048) a rank, full remat
    big = go("N8E", train_argv() + N8E_MODEL + [
        "--attention-impl", "flash", "--batch-size", "1", "--training-samples", "3",
        "--training-steps", "3", "--remat", "--remat-policy", "full",
        "--checkpoint-dir", str(DP_DIR), "--experiment-name", "n8e", "--telemetry",
        "--distributed", "--ep", str(n)], flash_per_step=(2, 1, 1))
    errors["N8E_peak_gib"] = [sm["peak_mem_gib"] for sm in big]
    errors["N8E_median_step_ms_2_3"] = (float(np.median(big[0]["window_step_ms"][1:]))
                                        if len(big[0]["window_step_ms"]) > 1 else None)
    errors["N8E_state_gb_whole"] = 16 * presets.analytic_param_count(presets.moe_8x1b()) / 1e9
    checks["N8E (moe-8x1b, --ep 4): finite losses and aux, every rank under 80 GB"] = (
        all(math.isfinite(x) for x in big[0]["losses"] + big[0]["moe_aux"])
        and len(big[0]["losses"]) == 3
        and all((sm["peak_mem_gib"] or 1e9) * 2**30 < 80e9 for sm in big))
    out = {"ep_cards": {
        "card": card, "cards": n, "layers": DP_LAYERS, "batch_size": MOE_BATCH, "seq": MOE_SEQ,
        "runs": {label: {"ranks": len(r["summaries"]), "losses": r["summaries"][0]["losses"],
                         "moe_aux": r["summaries"][0]["moe_aux"],
                         "window_step_ms": r["summaries"][0]["window_step_ms"],
                         "peak_mem_gib": [sm["peak_mem_gib"] for sm in r["summaries"]],
                         "mesh": r["summaries"][0].get("mesh"), "wall_s": r["wall_s"]}
                 for label, r in runs.items()},
        "errors": errors,
        "limits": {"step1_rtol": DP_STEP1_RTOL, "loss_rtol": EP_LOSS_RTOL,
                   "grad_norm_rtol_step1": WIRE_NORM_RTOL},
        "checks": checks,
    }}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    shutil.rmtree(DP_DIR, ignore_errors=True)
    if bad:
        fail("ep_cards phase: " + "; ".join(bad))
    return out


# --dp-cards 4's sequence and pipeline runs (item 16): llama-1b at full
# depth over a --sp 4 ring at SP_SEQ, one row; llama-8b at --pp 4 1f1b
N8P_MICRO = 8


def seqpipe_cards_phase(n=4, legs=("NS", "N8P", "NETB", "NPT", "NPF", "PT", "PZ")):
    """The sequence and pipeline axes one rank a card over NCCL (module
    docstring, item 16): NS0 (one process on card 0) and NS (``--sp 4``),
    llama-1b at full depth, one row of SP_SEQ, 3 steps, NS held to NS0 at
    the one-card SP limits; N8P, llama-8b at full depth, ``--pp 4
    --pp-schedule 1f1b`` with N8P_MICRO microbatches of one row, seq 2048,
    full remat, 3 steps: finite, each card under 80 GB. And the expert run
    rerun at bf16: NETB (``--ep 2 --tp 2``) with ME0's routing
    picks in its first forward (as the one-card MT), held to ME0. And the
    pipeline beside another model axis across cards (FSDP2's first run over
    NCCL): NPT (``--pp 2 --tp 2``, 1f1b, M 4) and NPF (``--pp 2 --fsdp
    2``, gpipe), llama-1b at full depth, 4 rows of 2048, 3 steps: finite,
    each card under 80 GB, every rank's flash launches exact, and the two
    train one run (losses within SEQPIPE_LOSS_RTOL of each other). And PT
    and PZ (`composed_plans`: 4 layers, the one card's PF beside them),
    one rank a card, held to PP1 (one process) at the seqpipe legs' limits
    (`hold_seqpipe`). ``legs`` names the ones to run (`ns_cards_phase`: NS
    alone). Returns the ``seqpipe_cards`` line."""
    card = card_line()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    runs, checks, errors = {}, {}, {}

    def go(label, args, per_step, fp32=False, timeout=600):
        summaries, wall = run_torchrun(label, args, n, timeout=timeout)
        runs[label] = {"summaries": summaries, "wall_s": wall}
        steps = summaries[0]["end_step"] - summaries[0]["start_step"]
        bad = []
        for rank, sm in enumerate(summaries):
            want = {}
            for key, per in zip(("fwd", "dq", "dkv"), per_step[rank]):
                want[key] = per * steps
                want[f"{key}_wgmma"] = 0 if fp32 else want[key]
            if sm["launches"] != want:
                bad.append((rank, sm["launches"], want))
        checks[f"{label}: every rank launched the flash kernels its count a step, on tensor "
               "cores"] = not bad
        print(f"  {label}: {n} ranks on {n} cards, {wall:.1f} s, losses "
              f"{summaries[0]['losses']}{f', launches off: {bad}' if bad else ''}", flush=True)
        return summaries

    def layers_of(args):
        return int(args[len(args) - 1 - args[::-1].index("--model-layers") + 1])

    if "NS" in legs:
        ns_args = train_argv() + [
            "--use-flash-attention", "--sequence-length", str(SP_SEQ), "--batch-size", "1",
            "--training-samples", "3", "--training-steps", "3", "--checkpoint-dir", str(DP_DIR),
            "--log-loss-to-csv", "--telemetry"]
        ns0, wall = run_group("NS0", ns_args + ["--experiment-name", "ns0"])
        runs["NS0"] = {"summaries": ns0, "wall_s": wall}
        ns = go("NS", ns_args + ["--experiment-name", "ns", "--distributed", "--sp", str(n)],
                [[(i + 1) * layers_of(ns_args)] * 3 for i in range(n)], timeout=240)
        got, want = csv_losses(DP_DIR / "ns"), csv_losses(DP_DIR / "ns0")
        errors["NS_step1_vs_NS0"] = rel(got[1], want[1])
        errors["NS_later_vs_NS0"] = max(rel(got[s_], want[s_]) for s_ in (2, 3))
        errors["NS_step1_grad_norm_vs_NS0"] = rel(ns[0]["grad_norms"][0], ns0[0]["grad_norms"][0])
        checks[f"NS (--sp {n}, seq {SP_SEQ}, {layers_of(ns_args)} layers) against NS0: step 1 "
               f"within {SP_STEP1_RTOL:g}, steps 2-3 within {SEQPIPE_LOSS_RTOL:g}, step 1's "
               f"gradient norm within {WIRE_NORM_RTOL:g}"] = (
            sorted(got) == [1, 2, 3] and errors["NS_step1_vs_NS0"] <= SP_STEP1_RTOL
            and errors["NS_later_vs_NS0"] <= SEQPIPE_LOSS_RTOL
            and errors["NS_step1_grad_norm_vs_NS0"] <= WIRE_NORM_RTOL)
    if "N8P" in legs:
        # llama-8b at full depth over 4 stages: 8 layers and the whole embedding
        # and output a card, one row a microbatch, full remat (the forward twice)
        per_stage = layers_of(N8F_MODEL) // n * N8P_MICRO
        big = go("N8P", train_argv() + N8F_MODEL + [
            "--use-flash-attention", "--batch-size", str(N8P_MICRO),
            "--training-samples", str(3 * N8P_MICRO), "--training-steps", "3", "--remat",
            "--remat-policy", "full", "--checkpoint-dir", str(DP_DIR), "--experiment-name", "n8p",
            "--telemetry", "--distributed", "--pp", str(n), "--pp-schedule", "1f1b",
            "--pp-microbatches", str(N8P_MICRO)], [[2 * per_stage, per_stage, per_stage]] * n)
        errors["N8P_peak_gib"] = [sm["peak_mem_gib"] for sm in big]
        errors["N8P_median_step_ms_2_3"] = (float(np.median(big[0]["window_step_ms"][1:]))
                                            if len(big[0]["window_step_ms"]) > 1 else None)
        checks[f"N8P (llama-8b, --pp {n} 1f1b, M {N8P_MICRO}): finite losses, every rank under "
               "80 GB"] = (
            all(math.isfinite(x) for x in big[0]["losses"]) and len(big[0]["losses"]) == 3
            and all((sm["peak_mem_gib"] or 1e9) * 2**30 < 80e9 for sm in big))
    if "NETB" in legs:
        # NETB: NET at bf16, its first forward routed by ME0's picks (as the one-card MT)
        picks = str(DP_DIR / "me0_picks.pt")
        grouped = ["--smoke-moe-dispatch", "grouped"]
        me0, wall = run_group("ME0", ep_argv(DP_DIR, "me0", "--smoke-record-picks", picks))
        runs["ME0"] = {"summaries": me0, "wall_s": wall}
        net = go("NETB", ep_argv(DP_DIR, "netb", "--distributed", "--ep", "2", "--tp", "2",
                                 *grouped, "--smoke-force-picks", picks), [[DP_LAYERS] * 3] * n)
        errs, ok = hold_to(csv_losses(DP_DIR / "netb"), csv_losses(DP_DIR / "me0"), net[0], me0[0],
                           EP_LOSS_RTOL)
        errors.update({f"NETB_{k}_vs_ME0": v for k, v in errs.items()})
        errors["NETB_pick_flips"] = [sm.get("moe_pick_flips") for sm in net]
        checks[f"NETB (--ep 2 --tp 2, bf16, ME0's picks) against ME0: losses and the aux within "
               f"{EP_LOSS_RTOL:g}, step 1's gradient norm within {WIRE_NORM_RTOL:g}"] = ok
    if "NPT" in legs and "NPF" in legs:
        half = LAYERS // 2
        composed = train_argv() + [
            "--use-flash-attention", "--batch-size", "4", "--training-samples", "12",
            "--training-steps", "3", "--checkpoint-dir", str(DP_DIR), "--log-loss-to-csv",
            "--telemetry", "--distributed", "--pp", "2"]
        # a stage's layers x its microbatches (NPT's tensor peers share the
        # rows; NPF's fsdp ranks hold 2 of the 4, gpipe's M 2 of 1 row each)
        npt = go("NPT", composed + ["--experiment-name", "npt", "--tp", "2", "--pp-schedule",
                                    "1f1b", "--pp-microbatches", "4"], [[half * 4] * 3] * n)
        npf = go("NPF", composed + ["--experiment-name", "npf", "--fsdp", "2"],
                 [[half * 2] * 3] * n)
        got, want = csv_losses(DP_DIR / "npt"), csv_losses(DP_DIR / "npf")
        errors["NPT_vs_NPF"] = max(rel(got[s_], want[s_]) for s_ in want) if got else math.inf
        errors["NPT_NPF_peak_gib"] = [sm["peak_mem_gib"] for sm in npt + npf]
        checks[f"NPT (--pp 2 --tp 2, 1f1b) and NPF (--pp 2 --fsdp 2), llama-1b at full depth: "
               f"finite, every card under 80 GB, losses within {SEQPIPE_LOSS_RTOL:g} of each "
               "other"] = (
            sorted(got) == sorted(want) == [1, 2, 3] and errors["NPT_vs_NPF"] <= SEQPIPE_LOSS_RTOL
            and all(math.isfinite(x) for x in npt[0]["losses"] + npf[0]["losses"])
            and all((sm["peak_mem_gib"] or 1e9) * 2**30 < 80e9 for sm in npt + npf))
    quad = [(label, argv) for label, argv in composed_plans([])[3] if label in legs]
    if quad:
        def here(argv):
            return [str(DP_DIR) if a == str(SEQPIPE_DIR) else a for a in argv]

        pp1, wall = run_group("PP1", here(seqpipe_argv("pp1", PP_LAYERS, 2048, DP_BATCH,
                                                       PP_STEPS)))
        runs["PP1"] = {"summaries": pp1, "wall_s": wall}
        launches = composed_launches()
        first, losses = {"PP1": pp1[0]}, {"PP1": csv_losses(DP_DIR / "pp1")}
        for label, argv in quad:
            first[label] = go(label, here(argv), [[x] * 3 for x in launches[label]])[0]
            losses[label] = csv_losses(DP_DIR / label.lower())
            e, what, ok = hold_seqpipe(label, "PP1", losses, first)
            errors.update({f"{label}_{k}": v for k, v in e.items()})
            checks[what] = ok
    out = {"seqpipe_cards": {
        "card": card, "cards": n,
        "runs": {label: {"ranks": len(r["summaries"]), "losses": r["summaries"][0]["losses"],
                         "window_step_ms": r["summaries"][0]["window_step_ms"],
                         "peak_mem_gib": [sm["peak_mem_gib"] for sm in r["summaries"]],
                         "mesh": r["summaries"][0].get("mesh"), "wall_s": r["wall_s"],
                         "launches": [sm["launches"] for sm in r["summaries"]]}
                 for label, r in runs.items()},
        "errors": errors,
        "limits": {"sp_step1_rtol": SP_STEP1_RTOL, "pp_step1_rtol": PP_STEP1_RTOL,
                   "loss_rtol": SEQPIPE_LOSS_RTOL, "ep_loss_rtol": EP_LOSS_RTOL,
                   "grad_norm_rtol_step1": WIRE_NORM_RTOL},
        "checks": checks,
    }}
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    shutil.rmtree(DP_DIR, ignore_errors=True)
    if bad:
        fail("seqpipe_cards phase: " + "; ".join(bad))
    return out


def ns_cards_phase():
    """NS0 and NS alone (``--dp-cards``'s ring over NCCL; ``--time-phases .
    ns_cards_phase`` on four cards)."""
    return seqpipe_cards_phase(4, legs=("NS",))


def composed_cards_phase():
    """PT and PZ alone across four cards (``--time-phases .
    composed_cards_phase``)."""
    return seqpipe_cards_phase(4, legs=("PT", "PZ"))


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
    (item 7) and the expert legs (item 10, `expert_phase_chains`) as chains
    beside it: their processes take the card and the host where the
    checkpoint phase leaves them room (beside the drills the soak slowed the
    fleet's replicas past their drill; beside the dp phase's llama runs the
    expert pairs ran out of the card's memory, and beside these chains the
    sequence and pipeline legs did: they run beside the zerostall phase).
    Prints the ``chaos`` and ``ep`` lines; fails on any violation."""
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    reports, failures = {}, []
    ep_chains, ep_finish = expert_phase_chains()
    run_chains("checkpoint", (checkpoint_phase,
                              *(chaos_chain(reports, g) for g in CHAOS_GROUPS), *ep_chains))
    cli_check()
    chaos_line(reports, failures)
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    if failures:
        fail("chaos groups: " + "; ".join(failures))
    ep_finish()


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

    from pyrecover_tpu_torch.models.decode import kv_layout
    from pyrecover_tpu_torch.serving import BlockPool, blocks_for, paged_forward
    from pyrecover_tpu_torch.serving.kvpool import make_block_table

    n = len(tokens)
    pool = BlockPool(model.config, blocks_for(n, SERVE_BLOCK) + 1, SERVE_BLOCK, kv_mode=kv_mode,
                     device=model.tok_embed.device, **kv_layout(model))
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


def serving_phase(ckpt, config, device="cuda", step=None, smt=None):
    """Serve the model of ``config`` (llama-1b) from the trainer's checkpoint
    ``ckpt`` of ``step`` (see the module docstring, item 8); with ``smt``
    (`smt_ranks`, started ahead) SMT runs beside its int8 checks and is held
    to its fp32 engine (item 18). ``device="cpu"`` rehearses the phase at a
    small size; its times mean nothing."""
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
    # the one-card fp32 engine's peak: its weights, its pool and activations
    engine_peak = None
    if cuda:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    got = serve_all(model32, equal_work)
    if cuda:
        engine_peak = (torch.cuda.max_memory_allocated() - base
                       + sum(p.numel() * p.element_size() for p in model32.parameters()))
    if smt is not None:
        smt.start()
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
    if smt is not None:
        failures += smt_line(smt, got, model32, engine_peak)
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


# ======================= the serving mesh (item 18) =======================

# SMT: two ranks over gloo on the one card at tensor 2, each rank's peak at
# least SMT_PEAK_SHARE of a rank's weight bytes below the one-card fp32
# engine's (its weights, pool and activations)
SMT_MESH, SMT_PEAK_SHARE = {"tensor": 2}, 1 / 3
SMT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "smt"
# the four-card legs (`serving_cards_phase`): MoE at NSE_LAYERS of moe-4x1b's
# depth and the hot swap between two manifests at NSW_LAYERS of llama-1b's
# (full width, seeded weights), cut to stay inside one call
NS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "serving_cards"
NSE_LAYERS, NSW_LAYERS = 4, 4
NSW_PROBE = dict(n_requests=4, prompt_lens=(16, 64), new_tokens=(16, 16), arrival_rate=50.0)


def serving_config(argv, dtype):
    """The serving model config of the trainer flags ``argv`` at compute
    dtype ``dtype`` (sdpa: the serving forwards attend through the pool)."""
    from pyrecover_tpu_torch.config import get_args

    return dataclasses.replace(get_args(argv).model, compute_dtype=dtype, attention_impl="sdpa")


def _wait_for_go(go, timeout=1800.0):
    t0 = time.monotonic()
    while not Path(go).exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no go file {go} within {timeout} s")
        time.sleep(0.05)


def serving_mesh_child(argv):
    """One rank of a serving mesh (``chip_smoke.py --serving-mesh-rank
    JSON``): after its go file (when named) it joins the group, runs each
    leg of ``legs`` (`_mesh_serve_leg`, `_mesh_swap_leg`) and writes its
    results to ``<out>/rank<r>.json``."""
    args = json.loads(argv[0])
    import torch

    from pyrecover_tpu_torch.parallel import mesh as meshmod
    from pyrecover_tpu_torch.serving import load_serving_params  # noqa: F401 (the imports ahead)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = args.get("device", "cuda")  # "cpu" rehearses the legs at a small size
    if args.get("go"):
        _wait_for_go(args["go"])
    meshmod.initialize_distributed(required=True, backend=args.get("backend"),
                                   device_type=kind)
    device = meshmod.local_device(kind)
    rank = meshmod.rank()
    out = {}
    for leg in args["legs"]:
        run = _mesh_swap_leg if leg.get("swap") else _mesh_serve_leg
        out[leg["label"]] = run(leg, rank, device, Path(args["out"]))
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (Path(args["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    meshmod.destroy_distributed()


def _leg_mesh(leg):
    from pyrecover_tpu_torch.parallel import mesh as meshmod

    return meshmod.build_mesh(meshmod.MeshConfig(data=1, **leg["mesh"]).shape(
        meshmod.world_size()))


def _engine(model, serve=None):
    """The serving phase's engine sizing (``serve``: a leg's copy of it,
    ``[slots, block, chunk, budget]``)."""
    from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine

    slots, block, chunk, budget = serve or (SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK,
                                            SERVE_BUDGET)
    return ServingEngine(model, ServingConfig(block_size=block, max_seqs=slots,
                                              prefill_chunk=chunk, prefill_token_budget=budget))


def leg_sizes():
    """What a serving-mesh leg takes from this process: the engine sizing,
    the EQUAL workload's shape and the teacher-forced prompt's length."""
    return {"serve": [SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK, SERVE_BUDGET], "equal": EQUAL,
            "tf_prompt": TF_PROMPT}


def _mesh_serve_leg(leg, rank, device, out_dir):
    """Restore ``leg["ckpt"]`` onto the leg's mesh, prefill the
    teacher-forced prompt (``prefill``: every rank, rank 0 keeps the logits),
    serve the EQUAL workload (rank 0 pumps, the others follow) and time the
    decode step at SERVE_SLOTS live slots through the lockstep; the rank's
    allocator peak over the leg."""
    import torch

    from pyrecover_tpu_torch.serving import blocks_for, load_serving_params, sample_workload
    from pyrecover_tpu_torch.serving.kvpool import make_block_table

    cfg = serving_config(leg["argv"], leg["dtype"])
    mesh = _leg_mesh(leg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    model, info = load_serving_params(leg["ckpt"], cfg, device=device, mesh=mesh)
    res = {"restore_s": time.monotonic() - t0,
           "plan": {k: info[k] for k in ("resharded_leaves", "plan_bytes_moved", "bytes")},
           "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    if leg.get("prefill"):
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (leg["tf_prompt"],)).tolist()
        logits = paged_prefill(model, prompt)
        if rank == 0:
            np.save(out_dir / f"{leg['label']}_prefill.npy", logits.float().cpu().numpy())
        del logits
    engine = _engine(model, leg["serve"])
    slots = leg["serve"][0]
    res["pool_bytes"] = engine.pool.pool_bytes()
    if rank == 0:
        work = sample_workload(vocab_size=cfg.vocab_size, max_model_len=cfg.max_seq_len, seed=1,
                               **leg["equal"])
        t0 = time.monotonic()
        rids = [engine.submit(r["prompt"], r["max_new_tokens"]) for r in work]
        engine.run_until_drained()
        res["serve_s"] = time.monotonic() - t0
        res["tokens"] = [engine.result(r) for r in rids]
        engine.pool.check_drained()
        pool = engine.pool
        width = pool.table_width(engine.max_model_len)
        pos = [len(r["prompt"]) for r in work[:slots]]
        tables = np.stack([make_block_table(width, pool.alloc(i, blocks_for(
            p + 1, pool.block_size))) for i, p in enumerate(pos)])
        toks = np.ones((len(pos), 1), np.int64)
        res["decode_step_ms"] = host_ms(lambda: engine._forward(toks, pos, tables), 20,
                                        lambda: cuda and torch.cuda.synchronize(device))
        for i in range(len(pos)):
            pool.release(i)
        engine.release_followers()
    else:
        engine.follow()
    res["steps"] = engine.steps_run
    res["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    return res


def _mesh_swap_leg(leg, rank, device, out_dir):
    """NSW: serve the first manifest of ``leg["exp"]`` on the leg's mesh,
    hot-swap to the second with requests in flight (every rank's swapper
    places its own box; rank 0's plan flips), then serve a probe; a cold
    restore of the second serves the probe again."""
    import torch

    from pyrecover_tpu_torch.serving import load_serving_params, sample_workload
    from pyrecover_tpu_torch.serving.hotswap import HotSwapper

    cfg = serving_config(leg["argv"], leg["dtype"])
    mesh = _leg_mesh(leg)
    exp = Path(leg["exp"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    host = {}
    model, _ = load_serving_params(exp / "ckpt_1.zs.json", cfg, device=device, mesh=mesh,
                                   host_bytes=host)
    engine = _engine(model, leg["serve"])
    swapper = HotSwapper(engine, exp, cfg, loaded_path=exp / "ckpt_1.zs.json",
                         loaded_host=host, mesh=mesh)
    probe = sample_workload(vocab_size=cfg.vocab_size, max_model_len=cfg.max_seq_len, seed=3,
                            **NSW_PROBE)
    res = {}
    if rank == 0:
        for r in probe:
            engine.submit(r["prompt"], r["max_new_tokens"])
        engine.step()
        t0 = time.monotonic()
        if not swapper.swap_to(exp / "ckpt_2.zs.json"):
            raise RuntimeError(f"swap rejected: {swapper.rejected}")
        engine.run_until_drained()
        deadline = time.monotonic() + 300.0
        while engine.weights_step != 2:  # the other ranks' fetches may outlast the requests
            if time.monotonic() > deadline or swapper.rejected:
                raise RuntimeError(f"no flip to step 2 within 300 s: {swapper.rejected}")
            engine.step()
        res["swap_s"] = time.monotonic() - t0
        rids = [engine.submit(r["prompt"], r["max_new_tokens"]) for r in probe]
        engine.run_until_drained()
        res["after"] = [engine.result(r) for r in rids]
        engine.release_followers()
    else:
        engine.follow()
        swapper.join_fetch()
    res["flips"] = engine.flips
    res["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    del engine, model, swapper, host
    gc.collect()
    cold, _ = load_serving_params(exp / "ckpt_2.zs.json", cfg, device=device, mesh=mesh)
    cold_engine = _engine(cold, leg["serve"])
    if rank == 0:
        rids = [cold_engine.submit(r["prompt"], r["max_new_tokens"]) for r in probe]
        cold_engine.run_until_drained()
        res["cold"] = [cold_engine.result(r) for r in rids]
        cold_engine.release_followers()
    else:
        cold_engine.follow()
    return res


class ServingMeshRanks:
    """The ranks of a serving mesh on the one card (``LOCAL_RANK`` 0 each,
    over gloo), started now and holding their legs until `run` makes their
    go file (their interpreter start and imports overlap the work before
    their turn); `stop` ends any still running."""

    def __init__(self, label, legs, world, timeout=900, device="cuda"):
        self.label, self.timeout = label, timeout
        self.out = SMT_DIR / label
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.go = self.out / "go"
        args = json.dumps({"legs": legs, "out": str(self.out), "go": str(self.go),
                           "backend": "gloo", "device": device})
        port = free_port()
        self.procs = []
        for rank in range(world):
            env = {k: v for k, v in os.environ.items() if k not in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "PYRECOVER_FAULT_PLAN")}
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--serving-mesh-rank", args],
                cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self.t_go = None

    def start(self):
        """Let the ranks run (returns at once)."""
        self.t_go = time.monotonic()
        self.go.touch()

    def collect(self):
        """Wait for the ranks; their results in rank order and the wall
        seconds from the go. Fails the script unless every rank finished."""
        failed, outs = [], []
        try:
            for rank, proc in enumerate(self.procs):
                _, err = proc.communicate(timeout=self.timeout)
                path = self.out / f"rank{rank}.json"
                if proc.returncode != 0 or not path.exists():
                    failed.append(f"rank {rank} exited {proc.returncode}: {err[-3000:]}")
                else:
                    outs.append(json.loads(path.read_text()))
        finally:
            self.stop()
        if failed:
            fail(f"serving mesh {self.label}: " + " | ".join(failed))
        return outs, time.monotonic() - self.t_go

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def smt_ranks(device="cuda"):
    """SMT's two ranks, started ahead of the serving phase: tensor 2 over
    gloo on the one card, at fp32 compute, from the serving phase's own
    checkpoint (`serving_checkpoint`'s path, written before their go).
    ``device="cpu"`` rehearses them at the size `train_argv` gives."""
    ckpt = CKPT_DIR / "serve" / f"ckpt_{SERVE_CKPT_STEPS}_final.ckpt"
    legs = [{"label": "SMT", "mesh": SMT_MESH, "ckpt": str(ckpt), "argv": train_argv(),
             "dtype": "float32", **leg_sizes()}]
    return ServingMeshRanks("SMT", legs, world=2, device=device)


def hold_to_one_card(label, got, want, model, gap_limit=GREEDY_GAP):
    """``got``'s requests against the one-card engine's ``want``: the
    divergences, and which a near-tie excuses (lockstep's top two logits of
    ``model`` at the first divergence within ``gap_limit``, the fleet
    line's rule). Returns ``(ok, detail dict)``."""
    gaps = lockstep_gaps(model, got, want)
    excused = sum(g <= gap_limit for g in gaps)
    return excused == len(gaps), {"requests": len(want), "diverged": len(gaps),
                                  "excused": excused, "top2_gaps": gaps, "gap_limit": gap_limit,
                                  "label": label}


def smt_line(ranks, got, model32, engine_peak):
    """SMT's checks and ``serving_mesh`` line (module docstring, item 18)
    against the one-card fp32 engine's tokens ``got`` and peak."""
    outs, wall = ranks.collect()
    legs = [o["SMT"] for o in outs]
    failures = []

    def check(what, ok, detail):
        print(f"  SMT {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    ok, tokens = hold_to_one_card("SMT", legs[0]["tokens"], got, model32)
    check("tokens equal the one-card fp32 engine's", ok,
          f"{tokens['requests'] - tokens['diverged']} of {tokens['requests']} requests equal; "
          f"{tokens['diverged']} diverge, {tokens['excused']} excused (gaps "
          f"{tokens['top2_gaps']} <= {GREEDY_GAP})")
    plan = legs[0]["plan"]
    check("plan", plan["plan_bytes_moved"] > 0 and all(leg["plan"] == plan for leg in legs),
          f"{plan['resharded_leaves']} leaves resharded, {plan['plan_bytes_moved']} bytes moved "
          "onto the mesh, on every rank")
    if engine_peak is None:  # a CPU rehearsal: no allocator peak to hold
        engine_peak = max(leg["weight_bytes"] for leg in legs) * 2
        print("  SMT peaks: not measured on the CPU", flush=True)
    margin = [engine_peak - leg["peak_bytes"] for leg in legs]
    check("each rank's peak below the one-card engine's",
          all(m >= SMT_PEAK_SHARE * leg["weight_bytes"] for m, leg in zip(margin, legs)),
          f"peaks {[round(leg['peak_bytes'] / 2**30, 3) for leg in legs]} GiB against the "
          f"one-card engine's {engine_peak / 2**30:.3f} GiB: margins "
          f"{[round(m / 2**30, 3) for m in margin]} GiB, at least {SMT_PEAK_SHARE:.3f} of a "
          f"rank's weights ({[round(leg['weight_bytes'] / 2**30, 3) for leg in legs]} GiB)")
    line = {"mesh": SMT_MESH, "ranks": len(legs), "backend": "gloo, one card",
            "serving_dtype": "float32", "tokens": tokens, "plan": plan,
            "restore_s": [leg["restore_s"] for leg in legs], "serve_s": legs[0]["serve_s"],
            "decode_step_ms_8_slots": legs[0]["decode_step_ms"],
            "peak_gib": [leg["peak_bytes"] / 2**30 for leg in legs],
            "one_card_engine_peak_gib": engine_peak / 2**30,
            "rank_weight_gib": [leg["weight_bytes"] / 2**30 for leg in legs],
            "pool_bytes": [leg["pool_bytes"] for leg in legs], "wall_s": wall,
            "card": card_line()}
    print(json.dumps({"serving_mesh": line}), flush=True)
    return failures


def serving_phases():
    """The serving checkpoint, the serving phase and SMT beside it, as the
    whole check runs them (for ``--time-phases``)."""
    from pyrecover_tpu_torch.config import get_args

    smt = smt_ranks()
    try:
        ckpt, step = serving_checkpoint()
        serving_phase(ckpt, get_args(train_argv()).model, "cuda", step, smt)
    finally:
        smt.stop()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def seeded_checkpoint(path, argv, seed, engine="vanilla", device="cuda"):
    """A params-only checkpoint of the model of the trainer flags ``argv``
    at seeded weights (fp32), written from ``device``."""
    import torch

    from pyrecover_tpu_torch.config import get_args
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.train_state import param_leaves

    cfg = dataclasses.replace(get_args(argv).model, param_dtype="float32")
    model = Transformer(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    leaves = param_leaves(model)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if engine == "zerostall":
        from pyrecover_tpu_torch.checkpoint.zerostall import save_ckpt_zerostall

        save_ckpt_zerostall(path, leaves, extra_meta={"step": seed}, background=False)
    else:
        from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla

        save_ckpt_vanilla(path, leaves, extra_meta={"step": seed})
    del model, leaves
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def serving_cards_phase(n=4, device="cuda"):
    """Serving meshes one rank a card over NCCL (module docstring, item
    18): NST4 (tensor 4, fp32 and bf16), NSPT (pipeline 2 x tensor 2), NSFT
    (fsdp 2 x tensor 2) on the serving checkpoint S, NSE (moe-4x1b's width,
    NSE_LAYERS deep, seeded, expert 4, no-drop), NSW (a hot swap at tensor 4
    between two seeded manifests, NSW_LAYERS deep), each held to the
    one-card engine on card 0; then NPT and NPF again (`seqpipe_cards_phase`).
    Prints the ``serving_cards`` line. ``device="cpu"`` rehearses the legs
    (not NPF) on gloo ranks at the size `train_argv` and `moe_argv` give."""
    import torch

    cuda = device == "cuda"
    if cuda and torch.cuda.device_count() < n:
        fail(f"serving_cards_phase needs {n} cards, this host has {torch.cuda.device_count()}")
    card = card_line() if cuda else "cpu"
    shutil.rmtree(NS_DIR, ignore_errors=True)
    NS_DIR.mkdir(parents=True)
    try:
        ckpt, _ = serving_checkpoint()
        llama = train_argv()
        moe = moe_argv(layers=NSE_LAYERS, device=device)
        swap = llama + ["--model-layers", str(NSW_LAYERS)]
        moe_ckpt = NS_DIR / "moe" / "ckpt_1.ckpt"
        seeded_checkpoint(moe_ckpt, moe, 1, device=device)
        for step in (1, 2):
            seeded_checkpoint(NS_DIR / "swap" / f"ckpt_{step}.zs.json", swap, step, "zerostall",
                              device)
        legs = [{**leg, **leg_sizes()} for leg in [
            {"label": "NST4", "mesh": {"tensor": 4}, "ckpt": str(ckpt), "argv": llama,
             "dtype": "float32", "prefill": True},
            {"label": "NST4-bf16", "mesh": {"tensor": 4}, "ckpt": str(ckpt), "argv": llama,
             "dtype": "bfloat16", "prefill": True},
            {"label": "NSPT", "mesh": {"pipeline": 2, "tensor": 2}, "ckpt": str(ckpt),
             "argv": llama, "dtype": "float32", "prefill": True},
            {"label": "NSFT", "mesh": {"fsdp": 2, "tensor": 2}, "ckpt": str(ckpt),
             "argv": llama, "dtype": "float32", "prefill": True},
            {"label": "NSE", "mesh": {"expert": 4}, "ckpt": str(moe_ckpt), "argv": moe,
             "dtype": "float32", "prefill": True},
            {"label": "NSW", "mesh": {"tensor": 4}, "exp": str(NS_DIR / "swap"), "argv": swap,
             "dtype": "float32", "swap": True},
        ]]
        # the one-card references on card 0, before the ranks start (their
        # times are then the card's alone)
        work = sample_equal(serving_config(llama, "float32"))
        refs = one_card_refs(ckpt, llama, work, device=device)
        refs_moe = one_card_refs(moe_ckpt, moe, sample_equal(serving_config(moe, "float32")),
                                 dtypes=("float32",), device=device)
        out = NS_DIR / "ranks"
        out.mkdir()
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                            "PYRECOVER_FAULT_PLAN")}
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(n), str(Path(__file__).resolve()), "--serving-mesh-rank",
             json.dumps({"legs": legs, "out": str(out), "device": device})],
            cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        _, err = proc.communicate(timeout=720)
        wall = time.monotonic() - t0
        paths = [out / f"rank{r}.json" for r in range(n)]
        if proc.returncode != 0 or not all(p.exists() for p in paths):
            fail(f"serving_cards ranks exited {proc.returncode}: {err[-6000:]}")
        ranks = [json.loads(p.read_text()) for p in paths]
        failures, line = [], {"card": card, "ranks": n, "wall_s": wall}

        def check(what, ok, detail):
            print(f"  {what}: {detail}{'' if ok else '  FAIL'}", flush=True)
            if not ok:
                failures.append(what)

        for leg in legs:
            label = leg["label"]
            per = [r[label] for r in ranks]
            row = {"mesh": leg["mesh"], "dtype": leg["dtype"],
                   "peak_gib": [p["peak_bytes"] / 2**30 for p in per]}
            if leg.get("swap"):
                flips = [p["flips"] for p in per]
                ok = (all(f == flips[0] for f in flips) and [s for _, s in flips[0]] == [2]
                      and per[0]["after"] == per[0]["cold"])
                row.update(flips=flips[0], swap_s=per[0]["swap_s"])
                check(f"{label}: every rank flips at one step; the probe after equals a cold "
                      "restore", ok, f"flips {flips}, swap {per[0]['swap_s']:.2f} s")
                line[label] = row
                continue
            ref = (refs_moe if label == "NSE" else refs)[leg["dtype"]]
            got = np.load(NS_DIR / "ranks" / f"{label}_prefill.npy")
            err_rel = rel_norm_err(torch.from_numpy(got), ref["prefill"])
            limit = TF_REL_NORM[leg["dtype"]]
            check(f"{label}: paged prefill against the one-card engine's", err_rel <= limit,
                  f"rel norm err {err_rel:.3e} (limit {limit:.0e})")
            ok, tokens = hold_to_one_card(label, per[0]["tokens"], ref["tokens"], ref["model"],
                                          GREEDY_GAP)
            if leg["dtype"] == "float32":
                check(f"{label}: tokens equal the one-card engine's", ok,
                      f"{tokens['diverged']} of {tokens['requests']} diverge, "
                      f"{tokens['excused']} excused (gaps {tokens['top2_gaps']})")
            row.update(prefill_rel_norm_err=err_rel, tokens=tokens,
                       plan=per[0]["plan"], restore_s=[p["restore_s"] for p in per],
                       decode_step_ms_8_slots=per[0]["decode_step_ms"],
                       one_card_decode_step_ms_8_slots=ref["decode_step_ms"],
                       one_card_engine_peak_gib=ref["peak_bytes"] / 2**30,
                       steps=per[0]["steps"])
            check(f"{label}: plan moves bytes", per[0]["plan"]["plan_bytes_moved"] > 0,
                  f"{per[0]['plan']}")
            line[label] = row
        del refs, refs_moe
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        print(json.dumps({"serving_cards": line}), flush=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        shutil.rmtree(NS_DIR, ignore_errors=True)
    # NPF held to NPT again, since its FSDP2 gradient sync changed
    npf = seqpipe_cards_phase(n, legs=("NPT", "NPF")) if cuda else None
    if failures:
        fail("serving_cards: " + "; ".join(failures))
    return line, npf


def sample_equal(cfg):
    from pyrecover_tpu_torch.serving import sample_workload

    return sample_workload(vocab_size=cfg.vocab_size, max_model_len=cfg.max_seq_len, seed=1,
                           **EQUAL)


def one_card_refs(ckpt, argv, work, dtypes=("float32", "bfloat16"), device="cuda"):
    """The one-card engine on card 0 for each compute dtype: its tokens for
    ``work``, its paged prefill of the teacher-forced prompt, its decode
    step at SERVE_SLOTS live slots, its peak (weights, pool, activations),
    and the model (for the near-tie gaps)."""
    import torch

    from pyrecover_tpu_torch.serving import blocks_for, load_serving_params, paged_forward
    from pyrecover_tpu_torch.serving.kvpool import make_block_table

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for dtype in dtypes:
        cfg = serving_config(argv, dtype)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        model, _ = load_serving_params(ckpt, cfg, device="cuda" if cuda else "cpu")
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (TF_PROMPT,)).tolist()
        prefill = paged_prefill(model, prompt).float()
        tokens = serve_all(model, work)
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        engine = _engine(model)
        pool = engine.pool
        width = pool.table_width(engine.max_model_len)
        pos = [len(r["prompt"]) for r in work[:SERVE_SLOTS]]
        tables = np.stack([make_block_table(width, pool.alloc(i, blocks_for(p + 1, SERVE_BLOCK)))
                           for i, p in enumerate(pos)])
        toks = np.ones((SERVE_SLOTS, 1), np.int64)
        ms = host_ms(lambda: paged_forward(model, pool.arrays, toks, pos, tables,
                                           block_size=SERVE_BLOCK), 20, sync)
        del engine, pool
        out[dtype] = {"tokens": tokens, "prefill": prefill.cpu(), "peak_bytes": peak,
                      "decode_step_ms": ms, "model": model}
    return out


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
    its idle share). M-T's steps after the first run under ``--transfer-guard
    disallow`` (no other run is needed for that). Returns the launch counts
    and the line."""
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
    argv = moe_argv() + ["--experiment-name", "moe-train", "--telemetry", "--transfer-guard",
                         "disallow"]
    path = Path(get_args(argv).checkpoint_dir) / "moe-train" / "moe-train_telemetry.jsonl"
    try:
        out = train.main(argv)
    except detectors.ImplicitTransferError as e:
        fail(f"implicit transfers in the MoE step's dispatch: {e}")
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

    found = [e for e in read_events(path) if e["event"] == "implicit_transfer"]
    print(json.dumps({"moe_transfer_guard": {"guarded_steps": MOE_STEPS - 1,
                                             "implicit_transfer": len(found), "events": found,
                                             "error": None}}), flush=True)
    if found:
        fail(f"implicit transfers in the MoE step's dispatch: {found}")
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

    _, eids, _, _, _, valid, *_ = moe._route(h16, weights[0], cfg.n_experts, cfg.moe_top_k, C)
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
import inspect, json, os, shutil, sys, time
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
    fn = getattr(c, name)
    fn(fa) if "fa" in inspect.signature(fn).parameters else fn()
    out[name] = time.monotonic() - t
    print(f"phase {name} took {out[name]:.1f} s", flush=True)
# the serving phases' input, and the zerostall phase's (the checkpoint
# phase's vanilla file): removed once every named phase has run
shutil.rmtree(c.CKPT_DIR, ignore_errors=True)
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
    if argv[:1] == ["--serving-mesh-rank"]:
        serving_mesh_child(argv[1:])
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
    timed("trainer", trainer_and_composed_phase)
    timed("checkpoint", checkpoint_and_chaos_phase)
    timed("zerostall", zerostall_phase)
    smt = smt_ranks()  # its two ranks start now and wait for their turn
    try:
        serve_ckpt, serve_step = timed("serving_checkpoint", serving_checkpoint)
        timed("serving", serving_phase, serve_ckpt, get_args(train_argv()).model, "cuda",
              serve_step, smt)
    finally:
        smt.stop()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    dp = timed("dp", dp_phase)
    timed("drills", drill_phase)
    if args.profile:
        timed("profile", profile_phase, flash["step_ms"])
    print(json.dumps({"telemetry": TELEMETRY}), flush=True)
    phases["total"] = time.monotonic() - t0
    print(json.dumps({"phases_s": phases}), flush=True)
    for row, key in zip(rows, ("fwd", "dq", "dkv")):
        row["launches"] = counts[key]
        row["launches_moe"] = moe_counts[key]
        # TP2's rank 0, at the tensor-local shape
        row["tp_shape"]["launches"] = dp["dp"]["mesh"]["tp_launches"][key]
        # E2's rank 0, at the MoE shape (expert peers attend over the same rows)
        row["launches_ep"] = EP_RESULT["ep"]["launches"]["E2"][key]
        # every rank of the ring (SP2, SPK: rank i runs i + 1 blocks a layer)
        # and of the stages (PG2, P1F, PI: layers x microbatches)
        sp_pp = SEQPIPE_RESULT["seqpipe"]["launches"]
        row["launches_sp"] = {label: [r[key] for r in sp_pp[label]]
                              for label in ("SP2", "SPK", "SM2")}
        row["launches_pp"] = {label: [r[key] for r in sp_pp[label]]
                              for label in ("PG2", "P1F", "PI", "PMI", "PF")}
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
