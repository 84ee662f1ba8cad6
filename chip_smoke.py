"""Drive the PyTorch/H100 port once on the card and check it.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also device time by kernel
    python3 chip_smoke.py --trainer ARGS...   # one trainer run (the checkpoint
                                              # phase's subprocess)
    python3 chip_smoke.py --trainer-phase     # the trainer phase alone (item 6,
                                              # run as a subprocess)

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
   instance, held at the true d), and times each kernel, its plain version and
   ``F.scaled_dot_product_attention`` at the training shape. Each output is
   held element by element and by its relative norm, and each error is
   printed beside its limit.
4. Train phase: ``pyrecover_tpu_torch.train.main`` trains llama-1b at full
   width with flash attention on synthetic data, fed by its prefetching
   ``DataLoader``, for a few steps; every loss
   must be finite, each kernel must have launched once per layer per step,
   and every forward, dq and dk/dv launch must have gone to a tensor-core
   instance.
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
   depth with flash attention, deterministic algorithms, verified
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
   was in the page cache.
8. Serving phase, on B2's final checkpoint at the checkpoint phase's depth:
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
   lockstep baseline: tokens/s, TTFT/TPOT/e2e percentiles, decode-step ms
   at 8 live slots (with paged attention's share and the device's busy time
   under ``torch.profiler``) and prefill-chunk ms, pool bytes and resident
   sequences, peak memory. Every engine run must end with its pool drained.
   Prints one ``serving`` line.

Prints one ``{"kernels": [...]}`` JSON line and, last, one
``{"ok": true, "device": {...}}`` line. Any failed check exits non-zero
before that line.
"""

import argparse
import csv
import gc
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

# the checkpoint phase: steps per run, periodic save interval, and where the
# runs write (two llama-1b checkpoints, ~30.4 GB, must fit at once)
CKPT_STEPS, CKPT_EVERY = 4, 3
# the last figures measured with sha256 sidecars (PERF.md §2; H100 80GB HBM3,
# 700 W), printed beside this run's
SHA256_SIDECAR_FIGURES = {"precheck_s": 20.37, "final_save_s": [36.40, 37.79], "load_s": 36.05,
                  "serving_restore_s": 21.13}
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ckpt"
# the serving phase (llama-1b at full width, bf16 compute unless it says fp32)
SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK, SERVE_BUDGET = 8, 16, 256, 512
TF_PROMPT = 1024  # teacher-forced prompt, prefilled in chunks of SERVE_CHUNK
# the timed workload: requests, prompt and output length ranges, arrivals/s
TIMED = dict(n_requests=16, prompt_lens=(16, 1024), new_tokens=(16, 128), arrival_rate=50.0)
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


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


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
        m = re.search(r"Compiling entry function .*?((?:fwd|dq|dkv)(?:_wgmma)?_kernel)I(\w*?)Li(\d+)E",
                      line)
        if m:
            dtype = "fp32" if m.group(2) == "f" else "bf16"
            name, spill = f"{m.group(1)}<{dtype}, {m.group(3)}>", ""
        elif name and "spill stores" in line:
            spill = ", " + ", ".join(p.strip() for p in line.split(",")[1:])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            lines.append(f"{name}: {m.group(1)} registers{spill}")
            name = None
    return lines


def cuda_time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
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
    print(json.dumps({"library_backward_ms": lib_bwd,
                      "note": "F.scaled_dot_product_attention backward, dq+dk+dv"}))

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
            "name": name, "route": route,
            "source": "pyrecover_tpu_torch/csrc/" + (
                "flash_attention_sm90.cuh" if route == "cuda-wgmma" else "flash_attention.cu"),
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[key], "ms": ms[key], "plain_ms": plain_ms[key],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"  {name} ({rows[-1]['route']}): {ms[key]:.3f} ms, plain {plain_ms[key]:.3f} ms, "
              f"library {lib_ms} ms, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({rows[-1]['bound_by']})", flush=True)
    return rows


def kernel_phase(fa):
    import torch

    bf16, fp32, f = torch.bfloat16, torch.float32, []
    # the path's shape: llama-1b attention, bf16, s 2048, GQA 16/8, d 128
    rows = kernel_case(fa, "llama-1b", 2, 2048, 2048, 16, 8, 128, bf16, 1, True, True, f)
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
    # and dout to d 128, launches, and slices; held at the true d
    for d in (80, 96):
        for name, dtype in (("bf16", bf16), ("fp32", fp32)):
            kernel_case(fa, f"{name}-d{d}-ragged-seg", 1, 1000, 1000, 8, 2, d, dtype, 3, True,
                        False, f)
    if f:
        fail("kernels disagree with their plain versions: " + ", ".join(f))
    return rows


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


def train_phase(fa):
    import torch

    from pyrecover_tpu_torch import train

    layers, steps = LAYERS, STEPS
    if layers < 20:
        print(f"chip_smoke: depth cut to {layers} of llama-1b's 20 layers", flush=True)
    fa.reset_launch_counts()
    flash = train.main(train_argv() + ["--attention-impl", "flash", "--training-steps", str(steps)])
    counts = fa.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    losses = flash["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"flash losses {losses}")
    want = layers * steps
    if counts != {k: want for k in ("fwd", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma")}:
        fail(f"launch counts {counts}, want {want} each (layers x steps), every forward, "
             f"dq and dk/dv launch on a tensor-core instance")
    print(json.dumps({
        "train": {
            "layers": layers, "steps": steps, "batch_size": BATCH, "losses": losses,
            "step_ms": flash["step_ms"], "tokens_per_sec": flash["tokens_per_sec"],
            "mfu_pct": flash["mfu_pct"], "peak_mem_gib": flash["peak_mem_gib"],
            "launches": counts,
            # batches through the prefetching DataLoader: how often and how
            # long a step found its queue empty
            "loader": {"stalls": flash["loader_stalls"], "stall_s": flash["loader_stall_s"]},
        }
    }), flush=True)
    return counts, flash


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
    the flash launch counts as one JSON line."""
    import torch

    torch.use_deterministic_algorithms(True)
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    out = train.main(argv)
    out["launches"] = fa.launch_counts()
    print("trainer summary: " + json.dumps(out), flush=True)


def run_trainer(label, argv, timeout=400):
    """Run `trainer_child` in a subprocess; returns its summary and wall
    seconds. Its log lines about checkpoints are echoed."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trainer", *argv],
                          cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.monotonic() - t0
    keep = ("checkpoint", "Resume", "Stopping", "Finished", "Stopped", "step ")
    for line in proc.stderr.splitlines():
        if any(k in line for k in keep):
            print(f"  [{label}] {line[24:]}", flush=True)
    summary = [line for line in proc.stdout.splitlines() if line.startswith("trainer summary: ")]
    if proc.returncode != 0 or not summary:
        print(proc.stderr[-6000:], flush=True)
        fail(f"trainer run {label} exited {proc.returncode}")
    return json.loads(summary[0][len("trainer summary: "):]), wall


def loss_rows(exp):
    with open(exp / f"{exp.name}_loss_log.csv", newline="") as f:
        return list(csv.reader(f))


def checkpoint_phase():
    """Train, stop at a deadline, resume, and hold the resumed run's final
    checkpoint to a straight run's, byte for byte (see the module
    docstring, item 7). Returns B2's final checkpoint, which the serving
    phase reads (the caller removes ``CKPT_DIR`` after it), and the depth."""
    from pyrecover_tpu_torch.preempt import read_requeue_marker

    card = card_line()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    free = shutil.disk_usage(CKPT_DIR).free
    layers = LAYERS
    while layers > 1 and 2.1 * state_bytes(layers) > free:  # cut depth, never width
        layers -= 1
    print(f"checkpoint phase on {card}: {free / 1e9:.1f} GB free under {CKPT_DIR.parent}, "
          f"{state_bytes(layers) / 1e9:.2f} GB a checkpoint", flush=True)
    if layers < LAYERS:
        print(f"chip_smoke: checkpoint phase depth cut to {layers} of llama-1b's {LAYERS} "
              f"layers: the disk cannot hold two checkpoints", flush=True)

    def argv(name, *extra):
        return train_argv() + [
            "--attention-impl", "flash", "--model-layers", str(layers),
            "--training-steps", str(CKPT_STEPS), "--checkpoint-dir", str(CKPT_DIR),
            "--experiment-name", name, "--checkpoint-frequency", str(CKPT_EVERY),
            "--max-kept-checkpoints", "1", "--verify-checkpoints", "--log-loss-to-csv", *extra,
        ]

    final = f"ckpt_{CKPT_STEPS}_final.ckpt"
    a, a_wall = run_trainer("A", argv("a"))
    exp_a = CKPT_DIR / "a"
    if (a["end_step"], a["stopped_early"]) != (CKPT_STEPS, False) or not (exp_a / "DONE").exists():
        fail(f"run A ended at step {a['end_step']}, stopped early {a['stopped_early']}")
    digest = (exp_a / (final + ".sha256")).read_text()
    rows_a = loss_rows(exp_a)
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

    # what B2's pre-check and load will read: just written by B1, so it may
    # still be in the page cache
    cached_b1 = page_cache_share(exp_b / f"ckpt_{k}_final.ckpt")
    b2, b2_wall = run_trainer("B2", argv("b", "--resume-from-checkpoint", "latest"))
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
    }
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
    }}), flush=True)
    bad = [what for what, ok in checks.items() if not ok]
    if bad:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        fail("checkpoint phase: " + "; ".join(bad))
    return exp_b / final, layers


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


def serving_phase(ckpt, config, device="cuda"):
    """Serve the model of ``config`` (llama-1b at the checkpoint phase's
    depth) from the checkpoint phase's final checkpoint (see the module
    docstring, item 8). ``device="cpu"`` rehearses the phase at a small
    size; its times mean nothing."""
    import dataclasses

    import torch

    from pyrecover_tpu_torch.models.decode import decode_forward, generate_tokens, init_kv_cache
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
        print(f"chip_smoke: serving phase depth cut to {layers} of llama-1b's {LAYERS} layers, "
              "as the checkpoint phase ran", flush=True)

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
    model32, info = load_serving_params(ckpt, cfg32, device=device)
    check("restore", info["checksum"] == "xxh64tree" and info["leaves"] == 12
          and info["step"] == CKPT_STEPS,
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
    excused, gaps = 0, []
    for g, w in zip(got, want):
        if g == w:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        cache = init_kv_cache(cfg32, 1, j, device=device)  # lockstep's logits at the divergence
        top2 = decode_forward(model32, cache, torch.tensor([w[:j]], device=device), 0)[0, -1]
        top2 = top2.topk(2).values
        gaps.append((top2[0] - top2[1]).item())
        excused += gaps[-1] <= GREEDY_GAP
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
    _, report = run_loadgen(engine, timed_work)
    engine.pool.check_drained()
    _, lock = lockstep_baseline(model16, timed_work, max_len=cfg16.max_seq_len)
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


def profile_phase(wall_ms):
    """Device time by kernel over two steady llama-1b flash training steps
    of ``train.main`` under ``torch.profiler`` (steps 1-2 are skipped),
    grouped into the flash kernels, matrix products and the rest, and the
    device's idle share: 1 - busy / ``wall_ms``, the unprofiled step time
    of the train phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from pyrecover_tpu_torch import train

    captured, clocks = [], []

    def on_step(step):
        prof.step()
        clocks.append(card_line(CLOCKS))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=2),
                 on_trace_ready=lambda p: captured.append(p.events())) as prof:
        train.main(train_argv() + ["--attention-impl", "flash", "--training-steps", "4"],
                   on_step=on_step)
    if not captured:
        fail("the profiler's window did not close")
    busy, by_name = device_busy_ms(captured[0])
    busy, by_name = busy / 2, {name: ms / 2 for name, ms in by_name.items()}

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
    print(json.dumps({"profile": {
        "per_step_ms": {"wall": wall_ms, "device_busy": busy, **groups},
        "idle_pct": 100.0 * max(wall_ms - busy, 0.0) / wall_ms,
        "top_kernels_ms_per_step": [[n[:90], ms] for n, ms in top],
        "after_each_step": {CLOCKS: clocks},
    }}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--trainer"]:
        trainer_child(argv[1:])
        return
    if argv == ["--trainer-phase"]:
        trainer_phase()
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two training steps by kernel")
    args = ap.parse_args(argv)

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

    rows = kernel_phase(fa)
    counts, flash = train_phase(fa)
    attention_check(fa, flash["losses"][0])
    run_trainer_phase()
    ckpt, layers = checkpoint_phase()
    try:
        serving_phase(ckpt, get_args(train_argv() + ["--model-layers", str(layers)]).model)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if args.profile:
        profile_phase(flash["step_ms"])
    for row, key in zip(rows, ("fwd", "dq", "dkv")):
        row["launches"] = counts[key]
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
