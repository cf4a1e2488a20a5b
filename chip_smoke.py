#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the PADPS-FR scheduler and the ML serving
path behind its jobs) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. build every CUDA kernel of the main paths from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together), print the card's name and
   power limit and ptxas's registers and spills of the tensor-core
   flash-attention and SSD-scan kernels and of both placement sweeps' four
   forms (staged or direct, repay_init or not; a spill fails the run);
2. hold each kernel against its plain torch version on the card, at the
   main paths' shapes and at ragged sizes, and time both with CUDA events:
   the single-instance sweep at 10^6 rows and at the deep instance's ramp
   blocks (64 to 65536 rows x 10 tasks, 6 devices), the fleet-parallel
   sweep at a full round (64 instances x 4096 rows x 7 tasks, 4 devices)
   and at schedule_many's rounds of 64 x 16, 64 and 512 rows; both sweeps
   also on an 8-byte-aligned view and on rows of 7000 tasks, kernel 2 on
   64-instance rounds of mixed live widths at R = 16 and R = 1 and a
   ragged tail; every comparison exact (``torch.equal``), over five
   option variants;
3. the ``schedule()`` path, through ``PADPSFRScheduler(engine="cuda")``:
   the paper's Example 1 (|TSS|=1024 |TFS|=620 rejects=146 rank=4
   power=31.5, T3 split 12:12);
4. the deep 10-task x 4-variant instance on 6 devices (winner at rank
   425399), checked against the plain engine on CPU tensors;
5. the placement options (``resilience=1``; the preemptive resume cost),
   checked against the plain engine on CPU tensors;
6. the fleet-parallel path, ``schedule_many`` on ``engine="cuda"``: 64 band
   instances (7 tasks x 4 variants) on a 4-device fleet, with
   ``block_size=16`` and with the default ramp, each instance checked
   against the card's solo ``schedule()`` and the plain engine; instances/s
   of the many-walk and of the solo loop, and the device split;
7. ``schedule_many``'s options: a ragged heterogeneous batch with mixed
   fleets and an infeasible member under ``resilience=1`` and under the
   preemptive resume cost, checked against the plain engine;
8. the flash-attention kernels against their plain version (the reference
   kernel tests' six cases at float32, through the CUDA-core kernel, and at
   bfloat16, through the tensor-core kernel; smollm-135m's and
   recurrentgemma-2b's prefill shapes, and recurrentgemma-2b's local
   attention, hd 256 with 10 query heads on one kv head, at S = T = 4096
   where its 2048 window binds), the tensor-core kernel timed beside the
   plain version and ``scaled_dot_product_attention`` at both prefill
   shapes, with its bound and achieved TFLOP/s;
8b. the tensor-core flash-attention kernel at the MoE, VLM and enc-dec
   models' prefill shapes (``NEW_ATTN``: hd 128 at GQA groups 1 and 6,
   causal; hd 64 without a mask and causal; a cross-attention of S 128
   against T 1024), each against the plain version and timed beside it and
   beside SDPA (``is_causal`` where causal, no mask otherwise: both exact);
9. the SSD-scan kernels against their plain version (the reference kernel
   tests' four cases at float32, through the CUDA-core kernel, and at
   bfloat16, through the tensor-core kernel; chunk 48 and mamba2-130m's
   prefill shape at bfloat16), the tensor-core kernel timed beside the
   plain version at mamba2-130m's shape and required faster;
9b. the RG-LRU-scan kernel (a time-chunked scan) against its plain version
   (the reference kernel tests' four cases at float32 and bfloat16, and
   recurrentgemma-2b's prefill shape with the reference's decay and with a
   slow decay, a near 1, whose state carries across many chunks), timed
   beside the plain version at that shape and required faster, with
   ptxas's registers and spills (none allowed).  In 9 and 9b, y is held
   at atol = rtol and the final state at atol alone, as the reference
   kernel tests hold them;
10. ``ServeEngine.generate`` at the full published widths and depths of
    smollm-135m (30 layers), mamba2-130m (24), recurrentgemma-2b (26),
    qwen2-vl-2b (28; 256 patch embeddings on a 16 x 16 grid with 3-D
    M-RoPE positions, then 768 tokens), seamless-m4t-large-v2 (24 encoder
    layers over 1024 frame embeddings, 24 decoder layers over 1024 tokens)
    and moonshot-v1-16b-a3b (48 MoE layers, 64 experts top-6; 28.1 B
    parameters, run last, the earlier models freed) in bfloat16 with seeded
    random weights: 8 prompts of 1024 positions, 32 greedy tokens each; the
    prefill's launches by the layer's kind (30 flash-attention; 24
    SSD-scan; 18 RG-LRU-scan and 8 flash-attention; 28; 72 = 24 encoder +
    2 x 24 decoder; 48; every flash-attention and SSD-scan launch on its
    tensor-core kernel), the rotary kernel once a layer that rotates q and
    k, and no other launch; under ``ServeEngine(jit=False)``
    (every op dispatched from the host) and then ``jit=True`` (the default:
    the prefill and the decode step captured as CUDA graphs, kernels 3-5
    inside the captured prefill) on the same weights, greedy tokens equal,
    also for a second prompt length (512 positions: under ``jit`` a second
    prefill graph, its peak memory read); the wrappers count a prefill's
    kernels once in each engine's first ``generate`` (under ``jit``, the
    eager warm-up before the captures) and none in ``jit``'s second (the
    replays run no wrapper); each prefill graph's kernel nodes stand for
    the same launches and each decode graph's for none; a traced
    ``generate`` (under ``jit`` a replay) launches the same, by its
    wrappers or its prefill graph's nodes, and shows each of them among its
    device kernels (``kernels.counts.seen``; the profiler drops a record
    now and then, so a count there may fall short); the prefill's last logits through the kernels
    beside those through their plain versions (for the MoE model also the
    tokens whose expert set differs); under each setting prefill ms (three
    calls; under ``jit`` also each capture's first call), decode ms a
    token, tokens/s, the card's peak memory and the device split of a
    traced ``generate``; for the MoE model also the captured prefill and
    decode ms under ``moe_impl="batched"`` on the same weights;
11. the six models at full width in float32 on the card and on the CPU
    (the plain path) with the same weights, at full depth but for
    moonshot-v1-16b-a3b's 2 of 48 layers (112 GB of float32 weights fit
    nowhere): 2 prompts of 128 positions (qwen2-vl-2b: an 8 x 8 patch grid
    and 64 tokens; seamless-m4t-large-v2: 128 frames and 128 tokens) and 4
    decode steps fed the same tokens, logits compared, the card's float32
    prefill on the CUDA-core flash and SSD kernels; the card's steps both
    eagerly and through ``ServeEngine(jit=True)`` (a replayed prefill, its
    launches read from its graph's kernel nodes and shown among its traced
    device kernels, and decode steps on one captured graph), each within
    the tolerance; for the MoE model the
    tokens routed to another expert set on the card than on the CPU, and
    the same prefill and decode steps on the card under
    ``moe_impl="batched"``, greedy tokens equal to "vmap"'s and logits
    within 1e-5 of max |logit|;
12. (run after phase 7) the service path, at the JAX package's bench sizes
    (``benchmarks/scheduler_scale.py``, nothing cut), on ``engine="cuda"``:
    (a) ``bench_replan``'s arrival leg (the deep instance recorded
    exhaustively, a light task arrives), (b) ``bench_churn``'s exit leg (the
    band at base 83 on 6 devices with an eps task recorded last, which
    exits) and failure leg (the same fleet plus one tiny device, which
    fails): each warm ``replan`` timed against the cold ``schedule()`` it
    replaces, plans equal on the card and equal to the plain engine's, the
    recordings equal too, the warm replan's launches, rows swept and rows
    placed by the host's scalar oracle, and its device split traced; (c)
    ``bench_churn``'s 200-event trace (``default_rng(11)``) through
    ``SchedulerService(engine="cuda", max_stale=5)`` and the same service on
    the plain engine, event by event, each solved event's plan equal to a
    cold ``schedule()`` on the card: warm-hit rate, latency by kind, solved
    events/s (over telemetry latency and over the service's wall time,
    re-records included) against the cold loop; (d) ``bench_resilience``'s instance at
    k = 0, 1, 2 (8, 20, 32 W) and ``run_fault_injection`` over seeds 0-7 (no
    miss at k = 1 and 2; all 4 tasks miss at k = 0); (e) ``what_if_many``
    of 64 candidate arrivals against 6 held tasks of a ``fleet_parallel``
    band instance, each equal to a solo ``schedule()`` on the card;
13. (run after phase 7) fleet planning on ``engine="cuda"``:
    ``launch.schedule.main`` with its docstring's flags and
    tests/test_cli.py's, ``plan_fleet`` on examples/quickstart.py's three
    jobs and tests/test_scheduler_fleet.py's two cases, and Example 1 on
    ``make_hetero_fleet``'s FPGA + GPU + CPU fleet, each output and plan
    equal to the plain engine's, kernel 1 launched by every feasible plan;
14. (after phase 11) training smollm-135m at its full published width and
    depth (30 layers, 134.5 M parameters) through the port's entry points,
    on the differentiable ``attn_impl="xla"`` route: (a) one AdamW step at
    float32, seq 256, batch 2, on the card and on the CPU from the same
    weights (drawn on the CPU), loss and grad norm within 1e-3 relative,
    and the largest relative difference of any updated leaf; then two
    steps of ``TrainLoop(jit=True)``'s captured step (the warm-up and
    capture, then a replay) against two eager steps on the card: loss and
    grad norm of each, and every updated leaf, within 1e-6 relative
    (bitwise reported); (b) ``launch.train.build_loop(full=True)`` for 30
    bfloat16 steps on float32 master weights at train_4k's seq 4096 with
    the batch cut from 256 to 8, each step a replay of one CUDA graph of
    the whole step over the donated state (``TrainLoop``'s default
    ``jit=True, donate=True``; one capture, 29 replays): the mean loss of
    the last 5 steps below that of the first 5, no kernel launched in the
    steps and no node of kernels 3-5 in the graph, ms a step (median of
    steps 4-30), the first call's ms (warm-up and capture), tokens/s, peak
    memory allocated and reserved, the graph's kernel nodes and the
    device's busy share of one traced replay; (b') ``TrainLoop(jit=False)``
    for 8 steps from the same seed: each loss and grad norm within 1e-3
    relative of the captured run's (bitwise reported), its ms a step and
    peak beside the captured ones; (c) 10 captured steps, a checkpoint and
    a fresh captured loop resumed to 20 against 20 straight captured steps
    at seq 1024, batch 4, params bitwise equal (every sum of the step's
    backward has a fixed order on the card: the embedding's and the MoE
    slots' go through ``index_put_(accumulate=True)``, which sorts);
    (d) at the params of (b)'s step 30 (cloned before the traced replay,
    which moves the donated state on), the
    loss under no_grad on ``attn_impl="pallas"`` launches kernel 3 once a
    layer (30, on the tensor cores) and agrees with the "xla" route's
    within 2e-2, the train step on "pallas" raises the wrapper's error, and
    kernel 3 is timed at this shape (S = T = 4096) beside its plain version
    and SDPA; (e) moonshot-v1-16b-a3b at full width, 2 of its 48 layers,
    bf16 on float32 masters, seq 256, batch 2, under ``moe_impl="vmap"``
    and ``"batched"``: 4 captured steps, then two replays of that graph
    from one state, and 2 captured steps, a checkpoint and a fresh captured
    loop resumed to 4 against the straight run, each pair bitwise equal in
    every leaf of the train state and every loss and grad norm (the largest
    difference reported);
15. (after phase 14) the dry-run and a 1-device mesh: (a) in processes of
    their own, started together (host only, no card), the reduced (4, 2)
    train cell of tests/test_dryrun_small.py for smollm-135m, mamba2-130m
    and moonshot-v1-16b-a3b, the single-pod (16, 16) cells smollm-135m x
    train_4k / prefill_32k / decode_32k and moonshot-v1-16b-a3b x train_4k
    under both ``moe_impl``s, and recurrentgemma-2b x decode_32k on the
    multi-pod (2, 16, 16) mesh, at full width and depth, each traced on
    ``meta`` shards in a fake 512-rank world: per-device FLOPs, bytes,
    collective bytes by op (all-to-alls included), ``arg_bytes``, peak
    live bytes, the roofline terms against the JAX package's modelled V5E
    fleet (data, not a measurement) and ``trace_s``; moonshot's two
    layouts side by side with their useful shares (6ND/256 over the FLOPs),
    "batched" at most 3.0e14 FLOPs a device and 5x fewer than "vmap"; and
    smollm-135m x train_4k's counts beside torch 2.13's (``F3_TORCH_213``),
    each within 1%;
    (b) meanwhile, on the card, a world-1 NCCL group and a (1, 1) mesh:
    one float32 AdamW step of full-width smollm-135m with the train state
    and batch as DTensors against the same step on plain tensors (loss and
    grad norm within 1e-6 relative; no kernel launched), and the dry-run's
    ``arg_bytes`` of that cell against the card's allocation growth from
    placing the state and batch (within 1%); then the same step of
    full-width moonshot-v1-16b-a3b cut to 2 of its 48 layers under
    ``moe_impl="batched"`` (within 1e-6; no kernel; a (1, 1) mesh replicates
    everything, so this holds the DTensor path on NCCL, not the expert
    split, which tests/test_torch_sharding.py's gloo case holds); (c) the shares of the H100 SXM
    bf16 dense peak (989 TFLOP/s) of phase 14's train step and phase 10's
    smollm-135m prefill: achieved TFLOP/s from their traced FLOPs and
    measured times, ``mfu`` (6 or 2 N D over time x peak) and the traced
    FLOPs' share, beside the card's name and power limit.

Float32 matrix products run in full float32 on the card
(``torch.backends.cuda.matmul.allow_tf32`` is set False, as is cuDNN's
TF32 switch, though nothing here calls cuDNN).

The launch counts are zeroed just before each main-path run and read just
after it (for phase 6, around the many-walk alone: it must launch the
fleet-parallel kernel and never the single-instance one; for phase 10,
around each of three ``generate``s of each engine, where a captured
step's replay runs no wrapper and counts nothing: what a replay launched
is read from a traced ``generate``'s device kernels
(``repro_torch.kernels.counts.seen``), and the last line's counts for
kernels 3-5 are the wrappers' own; for phase 13, around each run on the card; for
phase 14, around (a)'s card step, (b)'s 30 steps (which must launch no
kernel; a replay runs no wrapper, and the graph's kernel nodes must stand
for none of kernels 3-5) and (d)'s no-grad loss on the "pallas" route; for
phase 15, around (b)'s DTensor step, which must launch none; for
phase 12, around the warm replans of (a)-(b)
alone, around each call on the card's service in (c), around
``power_premium`` and around ``run_fault_injection`` in (d), where the warm
arrival replans, the trace's calls and each of (d)'s two runs must launch
the single-instance kernel (the recordings, cold walks and checks lie
outside), and around (e)'s ``what_if_many`` alone, which must launch the
fleet-parallel kernel and never the single-instance one);
the comparisons of phases 2, 8, 9 and 9b are outside those windows.  The last three lines are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is present or when run outside a checkout of
the repository.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float64 (non-tensor-core)
# peak, the rate the placement sweep's scalar float64 chain runs at.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
# float64 adds/subtracts/compares per sweep step, counted from the kernel:
# c-tcfg, -extra, tcfg+ii, +eps, c>gate, avail>eps, share-tsd, tsd>eps,
# rem-avail, >eps, avail-rem, <=gate.
OPS_PER_STEP = 12

SWEEP_ROWS = 1_000_000
RAGGED_ROWS = (1, 7, 1025)
# The main path's launches of the two sweeps: the deep instance's block
# ramp (rows x 10 tasks on 6 devices) for kernel 1, and schedule_many's
# rounds of 64 instances (7 tasks, 4 devices) at block_size=16 and on the
# ramp's first blocks for kernel 2.
DEEP_BLOCKS = (64, 512, 4096, 32768, 65536)
DEEP_TASKS = 10
MANY_ROUNDS = (16, 64, 512)
# n_t = 7000: rows too wide to stage (the kernels read them directly).
WIDE_ROWS = (300, 7000, 4)
# The fleet-parallel round: _MANY_ROUND_ROWS = 2^18 rows at the JAX
# package's fleet_parallel widths (7 tasks, 4 devices).
ROUND = dict(B=64, R=4096, n_t=7, n_f=4)
# (rows, n_t, n_f) of a ragged stack: a 1-row instance, mixed widths, and
# 1-device fleets, which keep no survivor under resilience=1.
RAGGED_STACK = ((1, 3, 2), (700, 6, 5), (17, 2, 1), (4096, 7, 3), (64, 4, 4),
                (1025, 7, 4), (5, 1, 1))
MANY_B = 64
TIMED_REPS = 30
EXAMPLE1 = dict(n_tss=1024, n_tfs=620, rejects=146, rank=4, power=31.5)
DEEP_RANK = 425399

# The ML kernels' bound: the H100 SXM's dense bfloat16 tensor-core peak (NVIDIA
# data sheet), the rate the attention and SSD products could run at; and its
# float32 rate outside the tensor cores, where the RG-LRU scan's element-wise
# recurrence runs.
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
# float32 operations an RG-LRU step needs: two sigmoids (negate, exp, add,
# divide: 4 each), a = exp(-c lam sr) (multiply, exp), a * a, 1 - that,
# max, sqrt, sigmoid(i) * x, the gated product, a * h + g (2).  The chunked
# kernel's decay product, chunk fold and rerun of a * h + g are its own
# overhead and are not counted.
OPS_PER_RGLRU_STEP = 18
ML_REPS = 10
# The reference kernel tests' cases (tests/test_kernels.py), with their
# tolerances against the plain version: 2e-5 at float32, 2e-2 at bfloat16.
ATTN_CASES = (  # B, S, T, H, K, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, 0), (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 32, False, 0), (1, 256, 256, 4, 2, 64, True, 64),
    (2, 96, 200, 4, 4, 128, False, 0), (1, 64, 64, 2, 2, 256, True, 0),
)
SSD_CASES = (  # B, S, nh, hp, ng, ds, chunk
    (2, 128, 4, 16, 1, 32, 32), (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16), (1, 128, 2, 8, 1, 8, 128),
)
SSD_EXTRA = ((1, 96, 2, 8, 1, 8, 48),)  # chunk 48: ops.ssd_scan's chunk 64 at S = 96
RGLRU_CASES = ((2, 128, 64), (1, 100, 200), (2, 64, 256), (1, 32, 16))  # B, S, W
ML_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The serving path's kernel shapes: 8 prompts of 1024 tokens through
# smollm-135m (9 query heads, 3 kv heads of 64) and mamba2-130m (24 heads of
# 64, one B/C group of state 128, chunks of 256).
SMOLLM_ATTN = (8, 1024, 1024, 9, 3, 64, True, 0)
MAMBA_SSD = (8, 1024, 24, 64, 1, 128, 256)
# recurrentgemma-2b: local attention (10 query heads on one kv head of 256,
# window 2048) at its prefill shape, where S < window, and at S = T = 4096,
# where the window binds; its RG-LRU layers at lru_width 2560.
RGEMMA_ATTN = (8, 1024, 1024, 10, 1, 256, True, 2048)
RGEMMA_ATTN_WINDOW = (2, 4096, 4096, 10, 1, 256, True, 2048)
RGEMMA_RGLRU = (8, 1024, 2560)
# qwen2-vl-2b's decode attention in the benchmark's cells (12 query heads on
# 2 kv heads of 128, bf16): 256 rows at a 768-slot cache (chat) and 16
# rows at 8200 slots (doc); B, H, K, T, hd.
DECODE_ATTN = {"chat": (256, 12, 2, 768, 128), "doc": (16, 12, 2, 8200, 128)}
# moonlight-16b-a3b's latent decode attention in its benchmark cell (16
# query heads against a 512-wide latent and a 64-wide rope key, bf16): 64
# rows at a 768-slot cache, timed at fill 512 (prompt + new / 2); B, H, T,
# the timed fill; the score scale 1 / sqrt(128 + 64).
MLA_DECODE = (64, 16, 768, 512)
MLA_SCALE = 192 ** -0.5
# The rotary kernel's shapes in the benchmark's cells (bf16; B, S): qwen2-vl's
# M-RoPE over 12 query and 2 kv heads of 128 at a chat decode step (256 rows)
# and at the doc cell's prefill (16 pages of 8192 positions), and
# moonlight's 64-wide rope columns of 16 query heads and the shared key at
# a decode step (64 rows).
ROTARY = {"chat_decode": (256, 1), "doc_prefill": (16, 8192), "moonlight_decode": (64, 1)}
# The MoE, VLM and enc-dec models' prefill attention (8 prompts of 1024
# positions, bf16): moonshot-v1-16b-a3b (16 query and 16 kv heads of 128),
# qwen2-vl-2b (12 query heads on 2 kv heads of 128), seamless-m4t-large-v2
# (16 heads of 64: the encoder's self-attention and the decoder's
# cross-attention without a mask, its self-attention causal), and a
# cross-attention of 128 decoder positions against 1024 encoder frames.
NEW_ATTN = {
    "moonshot-v1-16b-a3b": (8, 1024, 1024, 16, 16, 128, True, 0),
    "qwen2-vl-2b": (8, 1024, 1024, 12, 2, 128, True, 0),
    "seamless-m4t-large-v2 encoder": (8, 1024, 1024, 16, 16, 64, False, 0),
    "seamless-m4t-large-v2 decoder self": (8, 1024, 1024, 16, 16, 64, True, 0),
    "seamless-m4t-large-v2 cross": (8, 1024, 1024, 16, 16, 64, False, 0),
    "cross S 128, T 1024": (8, 128, 1024, 16, 16, 64, False, 0),
}
SERVE = dict(batch=8, prompt=1024, new=32)
# the card's idle time inside each edge of a profiler's window (``_trace``)
TRACE_MARGIN_S = 0.05
# moonshot-v1-16b-a3b last: its 56.1 GB of bf16 weights need the card to itself
SERVE_MODELS = ("smollm-135m", "mamba2-130m", "recurrentgemma-2b", "qwen2-vl-2b",
                "seamless-m4t-large-v2", "moonshot-v1-16b-a3b")
CHECK = dict(batch=2, prompt=128, steps=4, rel_tol=1e-3)
# Phase 11 cuts moonshot-v1-16b-a3b to 2 of its 48 layers at full width:
# 112 GB of float32 weights fit neither the card nor the host.
CHECK_LAYERS = {"moonshot-v1-16b-a3b": 2}
# ... and serves it on the card under both MoE layouts: greedy tokens equal,
# logits within this share of max |logit|
MOE_LAYOUT_REL_TOL = 1e-5
# The vision stub's patch grid: 16 x 16 = VLM_PATCHES patches in phase 10,
# 8 x 8 in phase 11's 128-position prompts.
SERVE_GRID, CHECK_GRID = 16, 8
# Phase 14: training full-width, full-depth smollm-135m.  train_4k's shape
# (seq 4096, batch 256) with the batch cut to 8 for the card and the time
# limit; 30 steps at lr 1e-3 on the launcher's warm-up cosine schedule.
TRAIN = dict(arch="smollm-135m", seq_len=4096, batch=8, steps=30, lr=1e-3, shape="train_4k")
TRAIN_CHECK = dict(seq_len=256, batch=2, lr=1e-3, rel_tol=1e-3)  # (a): float32, card vs CPU
TRAIN_JIT_REL_TOL = 1e-6  # (a): float32, the captured step vs the eager one on the card
TRAIN_EAGER = dict(steps=8, rel_tol=1e-3)  # (b'): TrainLoop(jit=False) vs (b)'s first steps
TRAIN_RESUME = dict(seq_len=1024, batch=4, steps=20)  # (c): resume at step 10, bitwise
# (e): moonshot-v1-16b-a3b at full width, 2 of its 48 layers (as phase 11
# cuts it), bf16 on float32 masters, under both MoE layouts: 4 captured
# steps, two replays of its graph from one state, and a resume at step 2
TRAIN_DETERMINISM = dict(arch="moonshot-v1-16b-a3b", layers=2, seq_len=256, batch=2, steps=4,
                         lr=1e-3)
TRAIN_ROUTE_TOL = 2e-2  # (d): the bf16 tolerance of the reference kernel tests

# phase 15: the dry-run's cells, traced on the host (one process each,
# started together); (a) the reduced (4, 2) train cell of
# tests/test_dryrun_small.py and full-size cells (arch, shape, mesh,
# moe_impl): smollm-135m's three kinds and moonshot-v1-16b-a3b's training
# under both MoE layouts on the single pod, recurrentgemma-2b's decode on
# the multi-pod mesh (its Griffin gates' partial sum; full depth)
DRYRUN_SMALL = ("smollm-135m", "mamba2-130m", "moonshot-v1-16b-a3b")
DRYRUN_CELLS = (("smollm-135m", "train_4k", "single", "vmap"),
                ("smollm-135m", "prefill_32k", "single", "vmap"),
                ("smollm-135m", "decode_32k", "single", "vmap"),
                ("moonshot-v1-16b-a3b", "train_4k", "single", "vmap"),
                ("moonshot-v1-16b-a3b", "train_4k", "single", "batched"),
                ("recurrentgemma-2b", "decode_32k", "multi", "vmap"))
# "batched" must trace moonshot's training at most this many FLOPs a device
# and this many times fewer than "vmap" (6ND/256 = 9.8e13; the recompute,
# the capacity factor and attention's score products on top)
MOE_BATCHED_MAX_FLOPS, MOE_BATCHED_MIN_GAIN = 3.0e14, 5.0
# smollm-135m x train_4k on the single pod as torch 2.13 (a CPU host)
# traces it, by experiments/dryrun_by_op.py: the card host's torch must
# trace each count within F3_REL_TOL of these (tests/test_torch_dryrun.py
# holds the CPU's torch to them too, so a change that moves them shows)
F3_TORCH_213 = {"flops": 8687119788781.0, "bytes": 1367589988992.0, "peak_bytes": 14965719316.0,
                "coll_all-gather": 360422928.0, "coll_all-reduce": 7430568.0,
                "coll_reduce-scatter": 4146455808.0, "coll_all-to-all": 1937768448.0,
                "coll_collective-permute": 0.0}
F3_REL_TOL = 0.01
MESH_CHECK = dict(rel_tol=1e-6, bytes_rel_tol=0.01)  # (b): DTensor step vs plain; arg_bytes
# (b)'s MoE step: moonshot-v1-16b-a3b at full width, 2 of its 48 layers (as
# phase 11 cuts it), float32, under moe_impl="batched"
MESH_MOE_LAYERS = 2
# launch.schedule's flags: its module docstring's (the JAX package's too),
# and tests/test_cli.py's.
SCHEDULE_ARGV = {
    "docstring": ["--slices", "4", "--slice-chips", "64", "--t-slr", "3600", "--t-cfg", "45",
                  "--job", "yi-34b:train_4k:1800:900",
                  "--job", "smollm-135m:decode_32k:600:5000"],
    "test_cli": ["--slices", "4", "--slice-chips", "64", "--t-slr", "3600", "--t-cfg", "45",
                 "--job", "yi-34b:train_4k:1800:250",
                 "--job", "smollm-135m:decode_32k:600:5000"],
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# instances (copied from the JAX package's benchmarks/scheduler_scale.py)
# ---------------------------------------------------------------------------


def band_tasks(n_t, nv, seed=7, base=86.0, slope=5.0, noise=1.0, ii=(8.0, 16.0)):
    """Tasks whose shares fall near-affinely with power: the power-sorted
    TFS opens with a long band of rows that pass eq. 7 but fail placement,
    so the winner lands 1e5+ rows deep."""
    from repro_torch.core import Task, TaskVariant

    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n_t):
        pws = np.sort(rng.uniform(3.0, 9.0, nv))
        shr = np.maximum(base - slope * pws + rng.uniform(0, noise, nv), 0.5)
        period, data, t_slr = 50.0, 1.0, 100.0
        ths = data * t_slr / (period * shr)
        tasks.append(
            Task(
                name=f"B{i}",
                period=period,
                data=data,
                init_interval=float(rng.uniform(*ii)),
                variants=tuple(
                    TaskVariant(cu=j + 1, throughput=float(t), power=float(p))
                    for j, (t, p) in enumerate(zip(ths, pws, strict=True))
                ),
            )
        )
    return tasks


def deep_instance():
    """The deep streaming instance: 10 tasks x 4 variants on 6 devices."""
    from repro_torch.core import FleetSpec

    return band_tasks(10, 4, base=86.0), FleetSpec(n_f=6, t_slr=100.0, t_cfg=0.0)


def sweep_block(rng, B, n_t, capacity):
    """A block of rows spread around the fleet capacity (mixed verdicts)."""
    base = rng.uniform(0.5, 1.5, (B, n_t))
    scale = rng.uniform(0.4, 1.3, (B, 1)) * capacity / n_t
    return base * scale


def fleet_parallel_instances():
    """The JAX package's fleet_parallel instance (benchmarks/scheduler_scale.py):
    64 band instances of 7 tasks x 4 variants on one 4-device pod."""
    from repro_torch.core import FleetSpec, ScheduleInstance

    insts = [ScheduleInstance(tasks=tuple(band_tasks(7, 4, seed=100 + s, base=84.0)))
             for s in range(MANY_B)]
    return insts, FleetSpec(n_f=4, t_slr=100.0, t_cfg=0.0)


def random_instances(rng, n):
    """Ragged heterogeneous instances: 1-5 tasks of 1-3 variants each, on
    fleets of 1-5 FPGA/GPU/CPU devices (the JAX package's test harness)."""
    from repro_torch.core import DeviceProfile, FleetSpec, ScheduleInstance, Task, TaskVariant

    insts = []
    for _ in range(n):
        tasks = []
        for i in range(int(rng.integers(1, 6))):
            nv = int(rng.integers(1, 4))
            ths, pws = np.sort(rng.uniform(0.3, 4.0, nv)), np.sort(rng.uniform(1.0, 9.0, nv))
            tasks.append(Task(
                name=f"T{i}", period=float(rng.uniform(20.0, 100.0)),
                data=float(rng.uniform(5.0, 80.0)), init_interval=float(rng.uniform(0.0, 8.0)),
                variants=tuple(TaskVariant(cu=j + 1, throughput=float(t), power=float(p))
                               for j, (t, p) in enumerate(zip(ths, pws, strict=True))),
            ))
        devices = []
        for _ in range(int(rng.integers(1, 6))):
            klass = ("fpga", "gpu", "cpu")[int(rng.integers(3))]
            devices.append(DeviceProfile(
                t_slr=float(rng.uniform(30.0, 120.0)),
                t_cfg=float(rng.uniform(0.5, 10.0)) if klass == "fpga" else 0.0, klass=klass,
            ))
        insts.append(ScheduleInstance(tasks=tuple(tasks), fleet=FleetSpec.heterogeneous(devices)))
    return insts


def instance_stack(rng, shapes, device, small: bool = False):
    """A packed (B, R, n_t) stack of instances with their own tables, on the
    card, with its resilience=1 survivor tables: (main args, survivor args).
    ``small`` scales the per-task costs by 8 / n_t, so rows of thousands of
    tasks can fit too."""
    import torch

    from repro_torch.core.placement_backends import InstanceBatch, survivor_batch_tables

    blocks = []
    for rows, n_t, n_f in shapes:
        scale = min(1.0, 8.0 / n_t) if small else 1.0
        t_slr = rng.uniform(60.0, 140.0, n_f)
        blocks.append((sweep_block(rng, rows, n_t, t_slr.sum()),
                       rng.uniform(1.0, 5.0, n_t) * scale, t_slr,
                       rng.uniform(0.0, 6.0, n_f) * scale))
    batch = InstanceBatch.pack(blocks)
    slr_s, cfg_s, nfe_s = survivor_batch_tables(batch.t_slr, batch.t_cfg, batch.n_f_eff, 1)

    def on(a, dtype=torch.float64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    main = (on(batch.shares), on(batch.iis), on(batch.t_slr), on(batch.t_cfg),
            on(batch.n_t_eff, torch.int32), on(batch.n_f_eff, torch.int32))
    return main, (*main[:2], on(slr_s), on(cfg_s), main[4], on(nfe_s, torch.int32))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu"))
    t0 = time.perf_counter()
    # One nvcc per source, all at once: each build is a separate process.
    procs = [
        subprocess.Popen([sys.executable, "-c", f"from repro_torch.kernels import _build; "
                          f"_build.load_library({name!r})"], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for name in sources
    ]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise RuntimeError(f"kernel builds failed: {dict(zip(sources, codes, strict=True))}")
    for name in sources:
        _build.load_library(name)
    secs = time.perf_counter() - t0
    print(f"[build] {sources} in {secs:.2f} s -> {_build.build_dir()}", flush=True)
    ptxas = _ptxas_summary(_build.build_log("flash_attention_mma"), "flash_attention_kernel_mma")
    print("[build] flash_attention_mma ptxas: " + json.dumps(ptxas), flush=True)
    ssd_log = _build.build_log("ssd_scan_mma")
    ssd_ptxas = {name: _ptxas_summary(ssd_log, name, "hp")
                 for name in ("ssd_chunk_kernel", "ssd_score_kernel", "ssd_state_kernel",
                              "ssd_out_kernel")}
    print("[build] ssd_scan_mma ptxas: " + json.dumps(ssd_ptxas), flush=True)
    # The sweeps' forms by template arguments (staged or direct, repay_init).
    sweep_ptxas = {name: _ptxas_summary(_build.build_log(name), f"{name}_kernel", None)
                   for name in ("placement_sweep", "placement_sweep_batch")}
    print("[build] placement sweeps ptxas (staged, repay_init): " + json.dumps(sweep_ptxas),
          flush=True)
    spills = {(name, form): v for name, forms in sweep_ptxas.items() for form, v in forms.items()
              if v.get("spill_store_bytes", 0) or v.get("spill_load_bytes", 0)}
    if spills:
        raise AssertionError(f"placement sweeps: ptxas reports spills in {spills}")
    return {"sources": sources, "seconds": secs, "flash_attention_mma_ptxas": ptxas,
            "ssd_scan_mma_ptxas": ssd_ptxas, "placement_sweep_ptxas": sweep_ptxas}


def _template_args(mangled: str) -> str:
    """A mangled template argument list as text: 'I13__nv_bfloat16fLi8ELb1EE'
    -> '__nv_bfloat16,float,8,1' (named types, builtin letters, literals; a
    substitution 'S..._' repeats the last named type)."""
    out, named, i = [], "?", 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":  # a literal: L <type letter> <value> E
            j = mangled.index("E", i)
            out.append(mangled[i + 2:j])
            i = j + 1
        elif mangled[i] == "S":
            out.append(named)
            i = mangled.index("_", i) + 1
        elif mangled[i].isdigit():  # a named type: <length> <name>
            j = i
            while mangled[j].isdigit():
                j += 1
            named = mangled[j:j + int(mangled[i:j])]
            out.append(named)
            i = j + len(named)
        else:
            out.append({"f": "float", "d": "double", "i": "int"}.get(mangled[i], mangled[i]))
            i += 1
    return ",".join(out)


def _ptxas_summary(log: str, kernel: str, key: str | None = "hd") -> dict:
    """Registers and spill bytes of each instance of ``kernel``, keyed by
    ``key`` and its integer template argument (a head width; ``kernel``
    alone when it has none), or with ``key=None`` by all its template
    arguments, from nvcc's ``-Xptxas=-v`` report."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            args = line.split(kernel)[1] if kernel in line else None
            if args is None:
                cur = None
            elif key is None and args.startswith("I"):
                cur = out.setdefault(_template_args(args), {})
            elif args.startswith("ILi"):
                cur = out.setdefault(key + args.split("ILi")[1].split("E")[0], {})
            else:
                cur = out.setdefault(kernel, {})
        elif cur is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            cur.update(spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
    if not out:
        raise AssertionError(f"no ptxas report for {kernel}")
    return out


# Device cycles of the spin queued ahead of each timed run: about 1 ms at
# the H100's clock, well above the wrappers' host time for one launch.
SPIN_CYCLES = 2_000_000


def _events_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events.

    Each run is queued behind a spin on the stream, so the start event,
    ``fn``'s launches and the end event are all enqueued before the device
    reaches them: the time between the events is the device's work, not
    the host's time to check arguments and launch.  A ``fn`` that waits on
    the device itself (the plain versions read a count back every step)
    is timed in full from the start event on.
    """
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _equal_outs(got, want, what: str) -> int:
    """Kernel outputs == plain outputs, exactly; the largest difference (0)."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for g, w, out in zip(got, want, ("feasible", "placed", "n_splits", "devices_used"),
                         strict=True):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {out} differs")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    return err


def _one_in(t):
    """``t`` copied into a buffer one element in: contiguous, 8-byte aligned
    and not 16-byte aligned."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 8
    return view


def _timed(kernel, plain, steps_fn, args, n_bytes: int, plan, **rec) -> dict:
    """One shape's record: the kernel's and the plain version's device time
    (call: PADPS-FR, resume cost 0), the plan's path, and the bound from the
    bytes and this input's row-steps."""
    call = dict(repay_init=True, resume_cost=0.0)
    ms = _events_ms(lambda: kernel(*args, **call), TIMED_REPS)
    plain_ms = _events_ms(lambda: plain(*args, **call), TIMED_REPS)
    (feas, *_), steps = steps_fn(*args, call["resume_cost"], call["repay_init"])
    return {**rec, "path": plan.path, "warps": plan.warps, "grid": plan.grid,
            "feasible_rows": int(feas.sum()), "row_steps": steps, "bytes": n_bytes, "ms": ms,
            "plain_ms": plain_ms, **_bound(n_bytes, steps), "library_ms": None}


def phase_kernel_vs_plain(device) -> dict:
    """placement_sweep: kernel == plain version on the card (ragged rows,
    10^6 rows, the deep ramp's blocks, an 8-byte-aligned view, rows of 7000
    tasks; five option variants each), then timed at 10^6 rows and at each
    of the deep ramp's blocks."""
    import torch

    from repro_torch.core import FleetSpec
    from repro_torch.core.placement_backends import survivor_tables
    from repro_torch.kernels.placement_step import (
        _plain_sweep,
        placement_sweep_cuda,
        placement_sweep_plain,
        sweep_plan,
    )

    rng = np.random.default_rng(3)
    on = dict(dtype=torch.float64, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def tables(n_t, fleet, iis_hi=5.0):
        iis = torch.tensor(rng.uniform(1.0, iis_hi, n_t), **on)
        slr = torch.tensor(fleet.t_slr_arr, **on)
        cfg = torch.tensor(fleet.t_cfg_arr, **on)
        slr_s, cfg_s = (torch.tensor(a, **on)
                        for a in survivor_tables(fleet.t_slr_arr, fleet.t_cfg_arr, 1))
        return iis, [
            ("padpsfr", slr, cfg, dict(repay_init=True, resume_cost=0.0)),
            ("padpsfr-resume9.5", slr, cfg, dict(repay_init=True, resume_cost=9.5)),
            ("preemptive-resume0", slr, cfg, dict(repay_init=False, resume_cost=0.0)),
            ("preemptive-resume9.5", slr, cfg, dict(repay_init=False, resume_cost=9.5)),
            ("survivors-k1", slr_s, cfg_s, dict(repay_init=True, resume_cost=0.0)),
        ]

    table_fleet = FleetSpec(n_f=8, t_slr=80.0, t_cfg=4.0)
    deep_fleet = deep_instance()[1]
    wide_fleet = FleetSpec(n_f=WIDE_ROWS[2], t_slr=2e4, t_cfg=0.5)
    cases = [(f"B={B}", B, 8, table_fleet) for B in (*RAGGED_ROWS, SWEEP_ROWS)]
    cases += [(f"deep B={B}", B, DEEP_TASKS, deep_fleet) for B in DEEP_BLOCKS]
    cases += [(f"one-in B={DEEP_BLOCKS[-1]}", DEEP_BLOCKS[-1], DEEP_TASKS, deep_fleet),
              (f"wide B={WIDE_ROWS[0]} n_t={WIDE_ROWS[1]}", WIDE_ROWS[0], WIDE_ROWS[1], wide_fleet)]
    max_err, inputs = 0, {}
    for name, B, n_t, fleet in cases:
        iis, variants = tables(n_t, fleet, iis_hi=5.0 if n_t <= 10 else 1.0)
        shares = torch.tensor(sweep_block(rng, B, n_t, fleet.capacity), **on)
        if name.startswith("one-in"):
            shares = _one_in(shares)
        for vname, s_tab, c_tab, kw in variants:
            max_err = max(max_err, _equal_outs(placement_sweep_cuda(shares, iis, s_tab, c_tab, **kw),
                                               placement_sweep_plain(shares, iis, s_tab, c_tab, **kw),
                                               f"placement_sweep {vname} {name}"))
        plan = sweep_plan(1, B, n_t, fleet.n_f, sm_count=sms, aligned=shares.data_ptr() % 16 == 0)
        feas = placement_sweep_cuda(shares, iis, variants[0][1], variants[0][2])[0]
        print(f"[kernel] placement_sweep {name}: 5 variants equal to plain, {plan.path} path "
              f"(last: {int(feas.sum())}/{B} feasible)", flush=True)
        inputs[name] = (plan, (shares, iis, variants[0][1], variants[0][2]))

    def timed(name, **rec):
        plan, args = inputs[name]
        B, n_t = args[0].shape
        n_f = args[2].shape[0]
        n_bytes = 8 * B * n_t + 8 * (n_t + 2 * n_f) + B * (1 + 4 + 4 + 4)
        return _timed(placement_sweep_cuda, placement_sweep_plain, _plain_sweep, args, n_bytes,
                      plan, rows=B, n_t=n_t, n_f=n_f, **rec)

    rec = timed(f"B={SWEEP_ROWS}", max_abs_err=max_err)
    print("[kernel] " + json.dumps({"placement_sweep_timing": rec}), flush=True)
    rec["main_path"] = [timed(f"deep B={B}") for B in DEEP_BLOCKS]
    for r in rec["main_path"]:
        print(f"[kernel] placement_sweep deep block {r['rows']} x {r['n_t']}: {r['ms']:.4f} ms "
              f"({r['path']}), bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms",
              flush=True)
    return rec


def _bound(n_bytes: int, row_steps: int) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = row_steps * OPS_PER_STEP / FP64_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_batch_kernel_vs_plain(device) -> dict:
    """placement_sweep_batch: kernel == plain version on the card over the
    whole (B, R) output (the full round; the ragged stack; 64-instance
    rounds at R = 16 and R = 1 with mixed live widths, so several widths
    share a warp; a stack whose rows are no multiple of a tile; an
    8-byte-aligned view of the round; rows of 7000 tasks; five option
    variants each, survivors included), then timed at the full round and at
    schedule_many's 64-instance rounds of 16, 64 and 512 rows."""
    import torch

    from repro_torch.kernels.placement_step import (
        _plain_sweep_batch,
        placement_sweep_batch_cuda,
        placement_sweep_batch_plain,
        sweep_plan,
    )

    rng = np.random.default_rng(4)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def mixed(B, R, n_t, n_f):  # instance 0 at the padded widths, the rest mixed
        return [(R, n_t, n_f)] + [(R, int(rng.integers(1, n_t + 1)), int(rng.integers(1, n_f + 1)))
                                  for _ in range(B - 1)]

    B0, n_t0, n_f0 = ROUND["B"], ROUND["n_t"], ROUND["n_f"]
    stacks = {
        "full-round": instance_stack(rng, [(ROUND["R"], n_t0, n_f0)] * B0, device),
        "ragged": instance_stack(rng, RAGGED_STACK, device),
        "round-R16-mixed": instance_stack(rng, mixed(B0, 16, n_t0, n_f0), device),
        "R1-mixed": instance_stack(rng, mixed(B0, 1, n_t0, n_f0), device),
        "ragged-tail-5x33x10": instance_stack(rng, mixed(5, 33, 10, n_f0), device),
        "wide-2x40x7000": instance_stack(rng, [(40, 7000, 3), (40, 6995, 2)], device, small=True),
    }
    main, surv = stacks["full-round"]
    stacks["one-in-full-round"] = ((_one_in(main[0]), *main[1:]), (_one_in(surv[0]), *surv[1:]))
    for R in MANY_ROUNDS:
        stacks[f"round-R{R}"] = instance_stack(rng, [(R, n_t0, n_f0)] * B0, device)
    variants = [
        ("padpsfr", 0, dict(repay_init=True, resume_cost=0.0)),
        ("padpsfr-resume9.5", 0, dict(repay_init=True, resume_cost=9.5)),
        ("preemptive-resume0", 0, dict(repay_init=False, resume_cost=0.0)),
        ("preemptive-resume9.5", 0, dict(repay_init=False, resume_cost=9.5)),
        ("survivors-k1", 1, dict(repay_init=True, resume_cost=0.0)),
    ]
    max_err = 0
    for kind, tables in stacks.items():
        for name, which, kw in variants:
            args = tables[which]
            max_err = max(max_err, _equal_outs(placement_sweep_batch_cuda(*args, **kw),
                                               placement_sweep_batch_plain(*args, **kw),
                                               f"placement_sweep_batch {name} {kind}"))
        B, R, n_t = tables[0][0].shape
        plan = sweep_plan(B, R, n_t, tables[0][2].shape[1], sm_count=sms,
                          aligned=tables[0][0].data_ptr() % 16 == 0)
        feas = placement_sweep_batch_cuda(*tables[0])[0]
        print(f"[kernel] placement_sweep_batch {kind} B={B} R={R}: 5 variants equal to plain, "
              f"{plan.path} path (last: {int(feas.sum())}/{B * R} feasible; survivor widths "
              f"{tables[1][5].tolist() if B < 16 else 'full'})", flush=True)

    def timed(kind, **rec):
        args = stacks[kind][0]
        B, R, n_t = args[0].shape
        n_f = args[2].shape[1]
        # Shares and tables read once, two int32 counts an instance, 13 B of
        # outputs a row written once.
        n_bytes = 8 * B * R * n_t + 8 * B * (n_t + 2 * n_f) + 8 * B + 13 * B * R
        plan = sweep_plan(B, R, n_t, n_f, sm_count=sms)
        return _timed(placement_sweep_batch_cuda, placement_sweep_batch_plain, _plain_sweep_batch,
                      args, n_bytes, plan, B=B, R=R, n_t=n_t, n_f=n_f, rows=B * R, **rec)

    rec = timed("full-round", max_abs_err=max_err)
    print("[kernel] " + json.dumps({"placement_sweep_batch_timing": rec}), flush=True)
    rec["main_path"] = [timed(f"round-R{R}") for R in MANY_ROUNDS]
    for r in rec["main_path"]:
        print(f"[kernel] placement_sweep_batch round {r['B']} x {r['R']} x {r['n_t']}: "
              f"{r['ms']:.4f} ms ({r['path']}), bound {r['bound_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f} ms", flush=True)
    return rec


def _same_result(a, b, what: str, counts: bool = True) -> None:
    """Two ScheduleResults agree field for field (exact); ``counts=False``
    leaves out |TFS| and |TNFS|, which a recorded or warm result reports as
    -1 where a cold exhaustive walk counts them."""
    fields = ("feasible", "chosen_rank", "n_placement_rejects", "total_power", "n_tss")
    if counts:
        fields += ("n_tfs", "n_tnfs")
    for f in fields:
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{what}: {f} {getattr(a, f)} != {getattr(b, f)}")
    if a.feasible:
        if a.combo != b.combo:
            raise AssertionError(f"{what}: combo {a.combo} != {b.combo}")
        sa = [(s.task, s.devices, s.share_parts) for s in a.plan.splits]
        sb = [(s.task, s.devices, s.share_parts) for s in b.plan.splits]
        if sa != sb:
            raise AssertionError(f"{what}: splits {sa} != {sb}")
        ga = [[(g.kind, g.task, g.start, g.end) for g in s.segments] for s in a.plan.scripts]
        gb = [[(g.kind, g.task, g.start, g.end) for g in s.segments] for s in b.plan.scripts]
        if ga != gb:
            raise AssertionError(f"{what}: plan segments differ")


def phase_example1(engine: str) -> None:
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler, render_gantt

    tasks, fleet = example1_tasks(), example1_fleet()
    res = PADPSFRScheduler(fleet, engine=engine).schedule(tasks, count_all_rejects=True)
    got = dict(n_tss=res.n_tss, n_tfs=res.n_tfs, rejects=res.n_placement_rejects,
               rank=res.chosen_rank, power=res.total_power)
    if got != EXAMPLE1:
        raise AssertionError(f"Example 1: {got} != {EXAMPLE1}")
    sp = res.plan.splits
    if not (len(sp) == 1 and sp[0].task == 2 and sp[0].devices == (1, 2)
            and [round(p) for p in sp[0].share_parts] == [12, 12]):
        raise AssertionError(f"Example 1: T3 split is {sp}")
    print(f"[example1] {res.summary(tasks)}")
    print(render_gantt(res.plan, tasks, fleet), flush=True)


def phase_deep(engine: str) -> dict:
    from repro_torch.core import PADPSFRScheduler, WalkStats

    tasks, fleet = deep_instance()
    runs = []
    for _ in range(2):  # the first run pays one-time set-up (pinned pool, module load)
        ws = WalkStats()
        t0 = time.perf_counter()
        res = PADPSFRScheduler(fleet, engine=engine, exhaustive=False).schedule(
            tasks, walk_stats=ws
        )
        runs.append((time.perf_counter() - t0, ws, res))
    if res.chosen_rank != DEEP_RANK:
        raise AssertionError(f"deep instance: rank {res.chosen_rank} != {DEEP_RANK}")
    _same_result(runs[0][2], res, "deep instance, first run vs second")
    t0 = time.perf_counter()
    ref = PADPSFRScheduler(fleet, engine="torch", exhaustive=False).schedule(tasks)
    plain_s = time.perf_counter() - t0
    _same_result(res, ref, "deep instance cuda vs torch")
    rec = {
        "instance": "10t4v_nf6", "rank": res.chosen_rank,
        "rejects": res.n_placement_rejects, "combo": list(res.combo.variant_idx),
        "schedule_s": [r[0] for r in runs], "walk_stats": [r[1].as_dict() for r in runs],
        "torch_cpu_schedule_s": plain_s,
        "device_us": _device_split(lambda: PADPSFRScheduler(
            fleet, engine=engine, exhaustive=False).schedule(tasks)),
    }
    print("[deep] " + json.dumps(rec), flush=True)
    return rec


def _trace(run):
    """Run ``run()`` under torch.profiler; (its result, the device events
    (kernels, copies, sets) as (name, start us, end us), the traced wall
    us).  (The host-side ops' device times, which would count the same
    kernels a second time, are left out.)  The profiler drops device events
    near the edges of its window (on the H100 one traced replay in 30 lost
    its first 64), so the card idles ``TRACE_MARGIN_S`` inside each edge,
    outside the timed wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        out = run()
        wall_us = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    events = [(e.key, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, events, wall_us


def _device_split(run, kernels: tuple[str, ...] = ("placement_sweep_kernel",)) -> dict:
    """Device time of one traced ``run()`` by kind, from its device events
    (``_trace``): each kernel named in ``kernels``, host-to-device and
    device-to-host copies, the rest; the busy share, the union of those
    events' intervals over the traced wall time; and ``launches_seen``,
    the wrappers' launches the traced kernels stand for
    (``kernels.counts.seen``)."""
    from repro_torch.kernels import counts

    _, events, wall_us = _trace(run)
    split = {**dict.fromkeys(kernels, 0.0), "memcpy_htod": 0.0, "memcpy_dtoh": 0.0}
    other: dict[str, float] = {}
    for key, a, b in events:
        us = b - a
        named = [k for k in kernels if k in key]
        if named:
            split[named[0]] += us
        elif "HtoD" in key:
            split["memcpy_htod"] += us
        elif "DtoH" in key:
            split["memcpy_dtoh"] += us
        else:
            other[key] = other.get(key, 0.0) + us
    if not events:
        return {"device_us": "not measured (the profiler recorded no device time)"}
    busy, end = 0.0, float("-inf")
    for a, b in sorted((a, b) for _, a, b in events):  # the union of the events' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    split["other"] = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    split["device_events"] = len(events)
    split["device_busy_us"] = busy
    split["traced_wall_us"] = wall_us
    split["device_busy_share"] = busy / wall_us
    split["launches_seen"] = counts.seen(key for key, _, _ in events)
    return split


def phase_options(engine: str) -> None:
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler

    tasks, fleet = example1_tasks(), example1_fleet()
    for kw in (dict(resilience=1), dict(repay_init=False, t_capture=4.5, t_store=5.0)):
        got = PADPSFRScheduler(fleet, engine=engine).schedule(tasks, count_all_rejects=True, **kw)
        want = PADPSFRScheduler(fleet, engine="torch").schedule(tasks, count_all_rejects=True, **kw)
        _same_result(got, want, f"Example 1 {kw}")
        print(f"[options] {kw}: {got.summary()}", flush=True)


def _counted(run):
    """Run ``run()`` with every kernel's launch count set to 0 just before
    it; return its result and the counts read just after
    (``flash_attention_mma``, ``ssd_scan_mma``: the launches on the
    tensor-core kernels, a part of ``flash_attention``'s and ``ssd_scan``'s).
    The counts are ``repro_torch.kernels.counts``'s: the launches the
    wrappers made, none of a captured serving step's replays."""
    from repro_torch.kernels import counts

    counts.reset()
    out = run()
    return out, counts.read()


def _check_many_launches(what: str, launches: dict) -> None:
    """The many-walk runs on the fleet-parallel kernel alone: no
    per-instance path launched the single-instance kernel."""
    if launches["placement_sweep_batch"] <= 0 or launches["placement_sweep"] != 0:
        raise AssertionError(f"{what}: launches {launches}; want placement_sweep_batch > 0 "
                             f"and placement_sweep == 0")


def phase_many(engine: str, block_size: int | None) -> dict:
    """schedule_many over the fleet-parallel instance, against the card's
    solo schedule() loop and the plain engine, instance by instance."""
    from repro_torch.core import PADPSFRScheduler, WalkStats

    insts, fleet = fleet_parallel_instances()
    sched = PADPSFRScheduler(fleet, engine=engine, block_size=block_size)

    def many_twice():  # the first run pays one-time set-up (pinned pool, first launches)
        runs = []
        for _ in range(2):
            ws = WalkStats()
            t0 = time.perf_counter()
            res = sched.schedule_many(insts, walk_stats=ws)
            runs.append((time.perf_counter() - t0, ws, res))
        return runs

    runs, launches = _counted(many_twice)
    what = f"schedule_many block_size={block_size}"
    _check_many_launches(what, launches)
    res = runs[-1][2]
    t0 = time.perf_counter()
    loop = [sched.schedule(i.tasks) for i in insts]
    loop_s = time.perf_counter() - t0
    want = PADPSFRScheduler(fleet, engine="torch", block_size=block_size).schedule_many(insts)
    for i, r in enumerate(res):
        _same_result(runs[0][2][i], r, f"{what}: instance {i}, first run vs second")
        _same_result(r, loop[i], f"{what}: instance {i}, many vs solo schedule() on the card")
        _same_result(r, want[i], f"{what}: instance {i}, cuda vs torch")
    ws = runs[-1][1]
    ranks = sorted(r.chosen_rank for r in res)
    rec = {
        "block_size": block_size, "instances": len(insts),
        "feasible": sum(r.feasible for r in res),
        "chosen_rank_min_median_max": [ranks[0], ranks[len(ranks) // 2], ranks[-1]],
        "many_s": [r[0] for r in runs], "loop_s": loop_s,
        "many_instances_per_s": len(insts) / runs[-1][0],
        "loop_instances_per_s": len(insts) / loop_s,
        "walk_stats": {k: v for k, v in ws.as_dict().items() if k != "block_sizes"},
        "launches_two_runs": launches,
        "device_us": _device_split(lambda: sched.schedule_many(insts),
                                   kernels=("placement_sweep_batch_kernel",)),
    }
    print("[many] " + json.dumps(rec), flush=True)
    return rec


def phase_options_many(engine: str) -> dict:
    """schedule_many's placement options on a ragged heterogeneous batch
    with mixed fleets and an infeasible member, against the plain engine."""
    from repro_torch.core import FleetSpec, PADPSFRScheduler, ScheduleInstance, Task, TaskVariant

    rng = np.random.default_rng(2026)
    hog = Task("hog", period=10.0, data=1000.0, init_interval=1.0,
               variants=(TaskVariant(cu=1, throughput=1.0, power=5.0),))
    insts = random_instances(rng, 24)
    insts.insert(5, ScheduleInstance(tasks=(hog,)))
    fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
    total = {"placement_sweep": 0, "placement_sweep_batch": 0}
    for kw in (dict(resilience=1), dict(repay_init=False, t_capture=4.5, t_store=5.0)):
        got, launches = _counted(lambda kw=kw: PADPSFRScheduler(fleet, engine=engine).schedule_many(
            insts, count_all_rejects=True, **kw))
        _check_many_launches(f"schedule_many {kw}", launches)
        want = PADPSFRScheduler(fleet, engine="torch").schedule_many(
            insts, count_all_rejects=True, **kw)
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _same_result(g, w, f"schedule_many {kw}: instance {i}")
        if got[5].feasible:
            raise AssertionError("schedule_many: the infeasible member was placed")
        total = {k: total[k] + launches[k] for k in total}
        print(f"[many-options] {kw}: {sum(r.feasible for r in got)}/{len(got)} feasible, "
              f"launches {json.dumps(launches)}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 12: the service path (delta replanner, SchedulerService, faultsim)
# ---------------------------------------------------------------------------


def _stdout(main, argv) -> tuple[int, str]:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _fleet_jobs(steps: tuple[int, int, int], order: tuple[str, ...]):
    """ML jobs as examples/quickstart.py and tests/test_scheduler_fleet.py
    build them: yi-34b training (3600 s), mamba2-130m training (1800 s) and
    smollm-135m decoding (600 s), in ``order``, with ``steps`` steps a
    period."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.variants import JobSpec

    spec = {"yi-34b": ("train_4k", 3600), "mamba2-130m": ("train_4k", 1800),
            "smollm-135m": ("decode_32k", 600)}
    return [JobSpec(cfg=get_arch(a), shape=get_shape(spec[a][0]), period_s=spec[a][1],
                    steps_per_period=n) for a, n in zip(order, steps, strict=True)]


def phase_fleet() -> dict:
    """Fleet planning on engine="cuda" (kernel 1), each plan and output
    equal to the plain engine's: ``launch.schedule.main`` with its
    docstring's flags (infeasible: no slice holds yi-34b's 900 steps) and
    tests/test_cli.py's; ``plan_fleet`` on examples/quickstart.py's three
    jobs and on tests/test_scheduler_fleet.py's feasible and infeasible
    cases; Example 1 on make_hetero_fleet's FPGA + GPU + CPU fleet
    (examples/hetero_fleet.py).  The launch counts are zeroed around each
    run on the card; a feasible plan must have launched kernel 1."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.configs.paper_examples import example1_tasks
    from repro_torch.core import FleetSpec, PADPSFRScheduler
    from repro_torch.core.variants import JobSpec, make_hetero_fleet
    from repro_torch.launch import schedule

    def check(what, counts, feasible):
        if counts["placement_sweep_batch"] or (feasible and counts["placement_sweep"] <= 0):
            raise AssertionError(f"fleet planning {what}: launches {counts}; a feasible plan "
                                 f"must launch placement_sweep, none placement_sweep_batch")
        launches[what] = counts["placement_sweep"]

    launches, rec = {}, {}
    for what, argv in SCHEDULE_ARGV.items():
        got, counts = _counted(lambda: _stdout(schedule.main, argv))
        want = _stdout(schedule.main, [*argv, "--engine", "torch"])
        if got != want:
            raise AssertionError(f"launch.schedule {what}: the card's output differs from the "
                                 f"plain engine's:\n{got[1]}\n---\n{want[1]}")
        check(f"cli_{what}", counts, got[0] == 0)
        rec[f"cli_{what}"] = {"rc": got[0], "summary": got[1].splitlines()[-1] if got[0]
                              else next(ln for ln in got[1].splitlines() if "chosen-rank" in ln)}
    tight = [JobSpec(cfg=get_arch("yi-34b"), shape=get_shape("train_4k"), period_s=10.0,
                     steps_per_period=100000)]
    for what, jobs, fleet, opts in (
        ("quickstart", _fleet_jobs((500, 2000, 4000), ("yi-34b", "mamba2-130m", "smollm-135m")),
         FleetSpec(n_f=4, t_slr=3600.0, t_cfg=45.0, name="v5e-fleet"), (16, 32, 64)),
        ("test_scheduler_fleet", _fleet_jobs((600, 3000, 2000),
                                             ("yi-34b", "smollm-135m", "mamba2-130m")),
         FleetSpec(n_f=4, t_slr=3600.0, t_cfg=45.0), (16, 32, 64)),
        ("test_scheduler_fleet_infeasible", tight, FleetSpec(n_f=2, t_slr=10.0, t_cfg=1.0),
         (64, 128)),
    ):
        (tasks, got), counts = _counted(lambda: schedule.plan_fleet(jobs, fleet, opts))
        _, want = schedule.plan_fleet(jobs, fleet, opts, engine="torch")
        _same_result(got, want, f"plan_fleet {what}")
        check(what, counts, got.feasible)
        rec[what] = {"feasible": got.feasible, "rank": got.chosen_rank,
                     "power_w": got.total_power, "n_tfs": got.n_tfs,
                     "combo": list(got.combo.variant_idx) if got.feasible else None}
    if not rec["quickstart"]["feasible"] or rec["test_scheduler_fleet_infeasible"]["feasible"]:
        raise AssertionError(f"fleet planning: feasibility {rec}")
    fleet = make_hetero_fleet({"fpga": 2, "gpu": 1, "cpu": 1}, t_slr=60.0, name="fpga+gpu+cpu")
    got, counts = _counted(lambda: PADPSFRScheduler(fleet).schedule(
        example1_tasks(), count_all_rejects=True))
    want = PADPSFRScheduler(fleet, engine="torch").schedule(example1_tasks(),
                                                            count_all_rejects=True)
    _same_result(got, want, "Example 1 on the FPGA + GPU + CPU fleet")
    check("hetero_example1", counts, got.feasible)
    rec["hetero_example1"] = {"summary": got.summary(), "feasible": got.feasible}
    rec["launches"] = launches
    print("[fleet] " + json.dumps(rec), flush=True)
    return rec


def arrival_task():
    """bench_replan's light arrival (benchmarks/scheduler_scale.py)."""
    from repro_torch.core import Task, TaskVariant

    return Task(name="arrival", period=10.0, data=25.0, init_interval=0.5,
                variants=(TaskVariant(cu=1, throughput=5.0, power=1.0),
                          TaskVariant(cu=2, throughput=10.0, power=2.5)))


def eps_task(t_slr: float, name: str = "eps"):
    """bench_churn's one-variant task of negligible share and power: appended
    last and recorded, every recorded reject dies among the real tasks."""
    from repro_torch.core import Task, TaskVariant

    period, share = 50.0, 1e-6
    return Task(name=name, period=period, data=1.0, init_interval=1.0,
                variants=(TaskVariant(cu=1, throughput=t_slr / (period * share), power=1e-6),))


def churn_deep_instance():
    """bench_churn's deep instance: the band at base 83, winner ~58k rows deep."""
    from repro_torch.core import FleetSpec

    return band_tasks(10, 4, base=83.0), FleetSpec(n_f=6, t_slr=100.0, t_cfg=0.0)


def churn_task(rng, name: str):
    """bench_churn's random arrival: shares fall near-affinely with power,
    scaled to the trace fleet's t_slr = 35."""
    from repro_torch.core import Task, TaskVariant

    nv = int(rng.integers(2, 5))
    pws = np.sort(rng.uniform(3.0, 9.0, nv))
    shr = np.maximum(31.0 - 2.8 * pws + rng.uniform(0.0, 1.5, nv), 4.0)
    period = float(rng.uniform(20, 60))
    ths = 1.0 * 35.0 / (period * shr)
    return Task(name=name, period=period, data=1.0, init_interval=float(rng.uniform(2.0, 8.0)),
                variants=tuple(TaskVariant(cu=j + 1, throughput=float(t), power=float(p))
                               for j, (t, p) in enumerate(zip(ths, pws, strict=True))))


def resilience_instance():
    """bench_resilience's crafted instance: four share-25 tasks fill four
    devices, so each resilience level forces hot share-10 upgrades."""
    from repro_torch.core import FleetSpec, Task, TaskVariant

    tasks = [Task(name=f"R{i}", period=10.0, data=20.0, init_interval=1.0,
                  variants=(TaskVariant(cu=1, throughput=2.4, power=2.0),
                            TaskVariant(cu=2, throughput=6.0, power=8.0)))
             for i in range(4)]
    return tasks, FleetSpec(n_f=4, t_slr=30.0, t_cfg=1.0)


def _ms_runs(fn, reps: int):
    """``fn()``'s result and its host wall times in ms over ``reps`` runs."""
    out, times = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def _same_state(a, b, what: str) -> None:
    """Two PlanStates hold the same rows, verdicts and death depths."""
    for name in ("rec_pow", "rec_sumshr", "rec_chosen", "rec_verdict", "rec_depth"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: PlanState.{name} differs")
    if a.complete_below != b.complete_below or a.origin != b.origin:
        raise AssertionError(f"{what}: PlanState coverage or origin differs")


def _warm_leg(name: str, engine: str, record, replan, cold, reps: int) -> dict:
    """Record once, then time the warm replan and the cold schedule() it
    replaces; the warm plan must equal the cold one.  The launch counts are
    zeroed just before the warm replans and read just after them (the
    recording and the cold walks lie outside), and each warm replan's
    WalkStats says how many rows it swept (``rows``: dispatched, or placed
    by the prefix probe) and how many the scalar oracle placed on the host
    (``probe_rows``: the incumbent check and the prefix probe).  Returns
    the record with the results under ``_res`` (record, warm, cold)."""
    from repro_torch.core import WalkStats

    rec, rec_ms = _ms_runs(record, 1)
    stats: list = []

    def warm_once():
        stats.append(WalkStats())
        return replan(rec.plan_state, stats[-1])

    (warm, warm_ms), counts = _counted(lambda: _ms_runs(warm_once, reps))
    cold_res, cold_ms = _ms_runs(cold, reps)
    _same_result(warm, cold_res, f"{name} on {engine}: warm replan vs cold schedule()",
                 counts=False)
    walk = stats[-1].as_dict()
    return {"leg": name, "engine": engine, "rank": cold_res.chosen_rank,
            "recorded_rows": rec.plan_state.n_recorded, "origin": warm.plan_state.origin,
            "warm_launches": counts["placement_sweep"],
            "warm_launches_a_run": counts["placement_sweep"] / reps,
            "warm_walk": {k: walk[k] for k in ("rows", "probe_rows", "n_blocks", "block_sizes")},
            "record_ms": rec_ms[0], "warm_ms": warm_ms, "cold_ms": cold_ms,
            "warm_over_cold": statistics.median(cold_ms) / statistics.median(warm_ms),
            "_res": (rec, warm, cold_res)}


def phase_replan_legs(engine: str) -> dict:
    """Phase 12 (a) and (b): bench_replan's arrival leg and bench_churn's exit
    and failure legs at the bench's full sizes, each recorded exhaustively,
    the warm replan timed against the cold schedule() of the post-event
    instance on ``engine`` and on the plain engine, plans and recordings
    equal across the two, the warm replan's device split traced."""
    from repro_torch.core import DeviceProfile, FleetSpec, PADPSFRScheduler

    tasks, fleet = deep_instance()
    ctasks, cfleet = churn_deep_instance()
    extended = [*tasks, arrival_task()]
    eps = eps_task(cfleet.t_slr)
    dev = DeviceProfile(t_slr=cfleet.t_slr, t_cfg=cfleet.t_cfg)
    tiny = DeviceProfile(t_slr=0.5, t_cfg=cfleet.t_cfg)
    big = FleetSpec.heterogeneous([dev] * cfleet.n_f + [tiny], name="churn-het")
    small = FleetSpec.heterogeneous([dev] * cfleet.n_f, name="churn-het")

    def legs(eng: str) -> dict:  # leg -> (record, replan from a state, cold)
        s, cs, bs, ss = (PADPSFRScheduler(f, engine=eng, exhaustive=False)
                         for f in (fleet, cfleet, big, small))
        return {
            "arrival": (lambda: s.schedule(tasks, record_state=True, record_exhaustive=True),
                        lambda st, ws=None: s.replan(st, extended, walk_stats=ws),
                        lambda: s.schedule(extended)),
            "exit": (lambda: cs.schedule([*ctasks, eps], record_state=True,
                                         record_exhaustive=True),
                     lambda st, ws=None: cs.replan(st, ctasks, walk_stats=ws),
                     lambda: cs.schedule(ctasks)),
            "failure": (lambda: bs.schedule(ctasks, record_state=True, record_exhaustive=True),
                        lambda st, ws=None: bs.replan(st, ctasks, fleet=small, walk_stats=ws),
                        lambda: ss.schedule(ctasks)),
        }

    card, plain = legs(engine), legs("torch")
    out = {}
    for name, fns in card.items():
        c = _warm_leg(name, engine, *fns, reps=3)
        p = _warm_leg(name, "torch", *plain[name], reps=1)
        what = f"{name} leg, {engine} vs torch"
        _same_state(c["_res"][0].plan_state, p["_res"][0].plan_state, what + " (recording)")
        _same_result(c["_res"][1], p["_res"][1], what + " (warm replan)", counts=False)
        _same_state(c["_res"][1].plan_state, p["_res"][1].plan_state, what + " (warm state)")
        state = c.pop("_res")[0].plan_state
        rec = {**c, "torch_cpu": {k: p[k] for k in ("record_ms", "warm_ms", "cold_ms")},
               "device_us": _device_split(lambda fns=fns, st=state: fns[1](st))}
        print("[replan] " + json.dumps(rec), flush=True)
        out[name] = rec
    if engine != "torch" and out["arrival"]["warm_launches"] <= 0:
        raise AssertionError("phase 12 (a): the warm arrival replans launched placement_sweep "
                             f"{out['arrival']['warm_launches']} times")
    return out


def phase_churn_trace(engine: str, n_events: int = 200) -> dict:
    """Phase 12 (c): bench_churn's 200-event trace (default_rng(11)) through
    SchedulerService(engine, max_stale=5) and, event by event, through the
    same service on the plain engine: the same admissions and plans; each
    solved event's plan equal to a cold schedule() on ``engine``; the
    warm-hit rate, latency by kind, and solved events/s against the cold
    loop, over the events' telemetry latency and over the wall time of
    the service's calls (its re-records included).  The launch counts are
    zeroed just before each call on ``engine``'s service and read just
    after it."""
    from repro_torch.core import FleetSpec, PADPSFRScheduler
    from repro_torch.service import SchedulerService

    fleet = FleetSpec(n_f=4, t_slr=35.0, t_cfg=1.0)
    card = SchedulerService(fleet, engine=engine, max_stale=5)
    cpu = SchedulerService(fleet, engine="torch", max_stale=5)
    rng = np.random.default_rng(11)
    solved, kinds, counter = [], [], 0
    launches: dict[str, int] = {}
    wall_s = 0.0

    def on_card(kind: str, call):  # one service call, counted and timed alone
        nonlocal wall_s

        def timed():
            t0 = time.perf_counter()
            out = call()
            return out, time.perf_counter() - t0

        (tel, dt), counts = _counted(timed)
        wall_s += dt
        launches[kind] = launches.get(kind, 0) + counts["placement_sweep"]
        return tel

    for _ in range(n_events):
        roll = float(rng.random())
        n_alive = len(card.tasks)
        if (roll < 0.55 and n_alive < 8) or n_alive < 2:
            kind, counter = "arrival", counter + 1
            task = churn_task(rng, f"c{counter}")
            tel, tel_cpu = on_card(kind, lambda: card.submit(task)), cpu.submit(task)
        elif roll < 0.80 and n_alive:
            kind = "exit"
            name = card.tasks[int(rng.integers(0, n_alive))].name
            tel, tel_cpu = on_card(kind, lambda: card.remove(name)), cpu.remove(name)
        elif roll < 0.90 and card.fleet.n_f > 1:
            kind = "failure"
            tel, tel_cpu = on_card(kind, card.fail_device), cpu.fail_device()
        else:
            kind = "recovery"
            tel, tel_cpu = on_card(kind, card.recover_device), cpu.recover_device()
        kinds.append(kind)
        what = f"churn trace event {len(kinds) - 1} ({tel.event})"
        if (tel.admitted, card.tasks, card.fleet) != (tel_cpu.admitted, cpu.tasks, cpu.fleet):
            raise AssertionError(f"{what}: {engine} and torch services diverged")
        if (card.plan is None) != (cpu.plan is None):
            raise AssertionError(f"{what}: one service holds no plan")
        if card.plan is not None:
            _same_result(card.plan, cpu.plan, f"{what}, {engine} vs torch", counts=False)
        if tel.path not in ("admission", "noop") and card.tasks:
            solved.append((kind, card.tasks, card.fleet, tel, card.plan))
    scheds: dict = {}

    def cold_loop(check: bool) -> None:
        for i, (_, ts, fl, _, plan) in enumerate(solved):
            if fl not in scheds:
                scheds[fl] = PADPSFRScheduler(fl, engine=engine)
            res = scheds[fl].schedule(ts)
            if check:
                _same_result(plan, res, f"churn trace solved event {i}: live vs cold", counts=False)

    cold_loop(True)  # also the warm-up
    _, cold_ms = _ms_runs(lambda: cold_loop(False), 1)
    warm_paths = ("cache", "warm", "warm_exit", "warm_failure")
    hits = sum(tel.path in warm_paths for *_, tel, _ in solved)
    per_kind: dict[str, list[float]] = {}
    for kind, _, _, tel, _ in solved:
        per_kind.setdefault(kind, []).append(tel.latency_s * 1e3)
    warm_ms = sum(tel.latency_s for *_, tel, _ in solved) * 1e3
    paths: dict[str, int] = {}
    for tel in card.telemetry:
        paths[tel.path] = paths.get(tel.path, 0) + 1
    rec = {
        "n_events": n_events, "n_solved": len(solved),
        "event_mix": {k: kinds.count(k) for k in sorted(set(kinds))},
        "warm_hit_rate": hits / max(1, len(solved)), "paths": paths,
        "paths_torch": {p: sum(t.path == p for t in cpu.telemetry) for p in paths},
        "rerecords": card.rerecord_count, "rerecords_torch": cpu.rerecord_count,
        "per_kind_mean_ms": {k: statistics.mean(v) for k, v in sorted(per_kind.items())},
        "per_kind_median_ms": {k: statistics.median(v) for k, v in sorted(per_kind.items())},
        "warm_total_ms": warm_ms, "service_wall_ms": wall_s * 1e3,
        "cold_total_ms": cold_ms[0],
        "events_per_s_warm": len(solved) / warm_ms * 1e3,
        "events_per_s_warm_wall": len(solved) / wall_s,
        "events_per_s_cold": len(solved) / cold_ms[0] * 1e3,
        "launches_by_kind": launches, "launches": sum(launches.values()),
    }
    print("[churn] " + json.dumps(rec), flush=True)
    if engine != "torch" and rec["launches"] <= 0:
        raise AssertionError("phase 12 (c): the trace's service calls launched placement_sweep "
                             f"{rec['launches']} times")
    return rec


def phase_resilience(engine: str) -> dict:
    """Phase 12 (d): bench_resilience's instance at k = 0, 1, 2 (8, 20, 32 W)
    and run_fault_injection over seeds 0-7: no miss at k = 1 and 2, all four
    tasks missing at k = 0."""
    from repro_torch.core import PADPSFRScheduler
    from repro_torch.service import power_premium, run_fault_injection

    tasks, fleet = resilience_instance()
    sched = PADPSFRScheduler(fleet, engine=engine)
    points = {}
    for k in (0, 1, 2):
        res, ms = _ms_runs(lambda k=k: sched.schedule(tasks, resilience=k), 3)
        _same_result(res, PADPSFRScheduler(fleet, engine="torch").schedule(tasks, resilience=k),
                     f"resilience k={k}, {engine} vs torch")
        points[k] = {"power": res.total_power, "rank": res.chosen_rank, "ms": ms}
    premium, premium_counts = _counted(lambda: power_premium(fleet, tasks, engine=engine))
    if [points[k]["power"] for k in (0, 1, 2)] != [8.0, 20.0, 32.0] or [
            premium[k]["power"] for k in (0, 1, 2)] != [8.0, 20.0, 32.0]:
        raise AssertionError(f"resilience ladder: {points}, {premium}")

    def inject():
        runs = {k: [run_fault_injection(fleet, tasks, resilience=k, n_failures=k, seed=s,
                                        engine=engine) for s in range(8)] for k in (1, 2)}
        k0 = run_fault_injection(fleet, tasks, resilience=0, n_failures=1, seed=0,
                                 engine=engine)
        return runs, k0

    (runs, k0), inject_counts = _counted(inject)
    misses = {}
    for k in (1, 2):
        misses[k] = [r.total_misses for r in runs[k]]
        if any(misses[k]) or not all(r.survived for r in runs[k]):
            raise AssertionError(f"fault injection at k={k}: misses {misses[k]}")
    if k0.total_misses != 4:
        raise AssertionError(f"fault injection at k=0: {k0.total_misses} misses, want 4")
    launches = {"power_premium": premium_counts["placement_sweep"],
                "fault_injection": inject_counts["placement_sweep"]}
    if engine != "torch" and min(launches.values()) <= 0:
        raise AssertionError(f"phase 12 (d): placement_sweep launches {launches}")
    rec = {"points": points, "premium_pct": {k: premium[k]["premium_pct"] for k in premium},
           "misses_k1": misses[1], "misses_k2": misses[2], "misses_k0_seed0": k0.total_misses,
           "launches": launches}
    print("[resilience] " + json.dumps(rec), flush=True)
    return rec


def phase_what_if(engine: str) -> dict:
    """Phase 12 (e): the service holds the first 6 tasks of one band instance
    of the fleet_parallel batch (4 devices) and is asked about 64 candidate
    arrivals, the seventh task of each of the 64 instances, in one
    what_if_many: kernel-2 launches only, each result equal to a solo
    schedule() on the card."""
    from repro_torch.core import PADPSFRScheduler
    from repro_torch.service import SchedulerService

    insts, fleet = fleet_parallel_instances()
    svc = SchedulerService(fleet, engine=engine)
    for t in insts[0].tasks[:6]:
        if not svc.submit(t).admitted:
            raise AssertionError(f"what-if: held task {t.name} was not admitted")
    cands = [inst.tasks[6] for inst in insts]
    (runs, launches) = _counted(lambda: _ms_runs(lambda: svc.what_if_many(cands), 2))
    got, many_ms = runs
    _check_many_launches("what_if_many", launches)
    sched = PADPSFRScheduler(fleet, engine=engine)
    solo, solo_ms = _ms_runs(lambda: [sched.schedule(svc.tasks + (c,)) for c in cands], 1)
    for i, (g, w) in enumerate(zip(got, solo, strict=True)):
        _same_result(g, w, f"what_if_many candidate {i} vs solo schedule()")
    rec = {"held_tasks": len(svc.tasks), "candidates": len(cands),
           "feasible": sum(g.feasible for g in got), "many_ms": many_ms, "solo_loop_ms": solo_ms[0],
           "launches_two_runs": launches}
    print("[what_if] " + json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the ML serving path: kernels 3 and 4, the two served models
# ---------------------------------------------------------------------------


def _ml_bound(n_ops: float, n_bytes: int, ops_per_s: float = BF16_OPS_PER_S) -> dict:
    ops_ms = n_ops / ops_per_s * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": n_ops, "bytes": n_bytes}


def _err(got, want, tol: float, what: str, rtol: float | None = None) -> float:
    """Max |got - want|; raise where it passes atol = tol and rtol (= tol
    unless given; the scans' final states pass ``rtol=0``, atol alone, as
    the reference kernel tests hold them)."""
    import torch

    rtol = tol if rtol is None else rtol
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((diff > tol + rtol * w.abs()).any()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} over tolerance {tol} "
                             f"(rtol {rtol})")
    return float(diff.max())


def _scan_errs(got, want, tol: float, what: str) -> dict:
    """y at atol = rtol = tol, the final state at atol alone."""
    return {"y": _err(got[0], want[0], tol, f"{what}: y"),
            "state": _err(got[1], want[1], tol, f"{what}: state", rtol=0.0)}


def _max_errs(errs: dict, dtype: str) -> str:
    """'y <max>, state <max>' over the cases of one dtype."""
    picked = [e for c, e in errs.items() if c.endswith(dtype)]
    return ", ".join(f"{k} {max(e[k] for e in picked):.3g}" for k in ("y", "state"))


def _attn_inputs(case, dtype, device, seed):
    import torch

    B, S, T, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(sh), dtype=torch.float32).to(device, dtype)
            for sh in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


def _time_attention(case, device, seed: int) -> dict:
    """flash_attention at a prefill shape in bf16, causal (S == T) or
    without a mask: checked against the plain version, then timed beside it
    and beside scaled_dot_product_attention (the yardstick; the port never
    calls it), whose ``is_causal`` is exact only where the window does not
    bind."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    B, S, T, H, K, hd, causal, window = case
    if (causal and S != T) or 0 < window < S:
        raise ValueError(f"{case}: SDPA's is_causal is not this attention")
    q, k, v = _attn_inputs(case, torch.bfloat16, device, seed)
    kw = dict(causal=causal, window=window)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    err = _err(got, want, ML_TOL["bfloat16"], f"flash_attention {case}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))  # SDPA's (B, heads, S, hd) views
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    ms = _events_ms(lambda: flash_attention_cuda(q, k, v, **kw), ML_REPS)
    plain_ms = _events_ms(lambda: flash_attention_plain(q, k, v, **kw), ML_REPS)
    library_ms = _events_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), ML_REPS)
    # causal, S == T, no binding window: query i sees keys 0..i; else all T
    visible = S * (S + 1) // 2 if causal else S * T
    n_bytes = 2 * (2 * B * S * H * hd + 2 * B * T * K * hd)  # q, o, k, v in bf16
    n_ops = 4 * B * H * hd * visible
    return {"shape": dict(zip(("B", "S", "T", "H", "K", "hd", "causal", "window"), case,
                              strict=True)),
            "dtype": "bfloat16", "max_abs_err": err, "sdpa_vs_plain_max_abs_err": lib_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "tflops": n_ops / (ms * 1e-3) / 1e12, "sdpa_tflops": n_ops / (library_ms * 1e-3) / 1e12,
            "kernel_over_sdpa": ms / library_ms, "plain_over_kernel": plain_ms / ms,
            **_ml_bound(n_ops, n_bytes)}


def phase_flash_vs_plain(device) -> dict:
    """flash_attention: kernel vs plain version on the card at the reference
    cases and recurrentgemma-2b's binding window; timed at smollm-135m's
    prefill shape (the returned record) and recurrentgemma-2b's."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    errs = {}
    for i, case in enumerate((*ATTN_CASES, RGEMMA_ATTN_WINDOW)):
        names = ("bfloat16",) if case == RGEMMA_ATTN_WINDOW else ML_TOL
        for name in names:
            q, k, v = _attn_inputs(case, getattr(torch, name), device, i)
            kw = dict(causal=case[6], window=case[7])
            mma_before = flash_attention_cuda.mma_launches
            got, want = flash_attention_cuda(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            mma = flash_attention_cuda.mma_launches - mma_before
            if mma != (name == "bfloat16"):
                raise AssertionError(f"flash_attention {case} {name}: {mma} tensor-core launches; "
                                     f"want bfloat16 on the tensor-core kernel, float32 off it")
            errs[f"{case} {name}"] = _err(got, want, ML_TOL[name], f"flash_attention {case} {name}")
    print(f"[kernel] flash_attention: {len(errs)} cases within tolerance (the reference's "
          f"and recurrentgemma-2b's window {RGEMMA_ATTN_WINDOW}), max abs err "
          f"f32 {max(e for c, e in errs.items() if c.endswith('float32')):.3g}, "
          f"bf16 {max(e for c, e in errs.items() if c.endswith('bfloat16')):.3g}", flush=True)

    rec = {**_time_attention(SMOLLM_ATTN, device, 99), "case_errs": errs}
    print("[kernel] " + json.dumps({"flash_attention_timing": {
        k: v for k, v in rec.items() if k != "case_errs"}}), flush=True)
    rec["recurrentgemma"] = _time_attention(RGEMMA_ATTN, device, 96)
    print("[kernel] " + json.dumps({"flash_attention_timing_recurrentgemma":
                                    rec["recurrentgemma"]}), flush=True)
    for what, r in (("smollm-135m", rec), ("recurrentgemma-2b", rec["recurrentgemma"])):
        print(f"[kernel] flash_attention (tensor cores) at {what}'s prefill: {r['ms']:.4f} ms, "
              f"{r['tflops']:.1f} TFLOP/s; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"plain {r['plain_ms']:.4f} ms ({r['plain_over_kernel']:.1f}x the kernel's time); "
              f"SDPA {r['library_ms']:.4f} ms (the kernel takes {r['kernel_over_sdpa']:.2f}x)",
              flush=True)
    return rec


def phase_flash_new_shapes(device) -> dict:
    """flash_attention (tensor cores) at the MoE, VLM and enc-dec models'
    prefill shapes (NEW_ATTN): hd 128 at GQA groups 1 and 6, hd 64 without
    a mask, and a cross-attention with S != T; each held against the plain
    version, timed beside it and beside SDPA, all on the tensor-core
    kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    recs = {}
    for i, (what, case) in enumerate(NEW_ATTN.items()):
        mma_before = flash_attention_cuda.mma_launches
        recs[what] = r = _time_attention(case, device, 80 + i)
        if flash_attention_cuda.mma_launches == mma_before:
            raise AssertionError(f"flash_attention at {what}: no tensor-core launch")
        print(f"[kernel] flash_attention (tensor cores) at {what} {case}: {r['ms']:.4f} ms, "
              f"{r['tflops']:.1f} TFLOP/s, max abs err {r['max_abs_err']:.3g}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; SDPA "
              f"{r['library_ms']:.4f} ms (the kernel takes {r['kernel_over_sdpa']:.2f}x)",
              flush=True)
    print("[kernel] " + json.dumps({"flash_attention_new_shapes": recs}), flush=True)
    return recs


def _time_decode(case, device, seed: int) -> dict:
    """The decode kernel at one of DECODE_ATTN's shapes in bf16, the cache
    filled to its last slot and the position a 0-d tensor on the card:
    timed beside the plain route (chunked_attention) and beside
    scaled_dot_product_attention (the yardstick; the port never calls it)
    over the live keys, which a query at the last live key sees all of,
    so no mask; the bound from the live cache's bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.layers import chunked_attention

    B, H, K, T, hd = case
    q, k, v = _attn_inputs((B, 1, T, H, K, hd), torch.bfloat16, device, seed)
    idx = torch.tensor(T - 1, dtype=torch.int32, device=device)
    length = idx + 1
    got = decode_attention_cuda(q, k, v, q_offset=idx, kv_len=length)
    want = chunked_attention(q, k, v, q_offset=T - 1, kv_len=T, kv_chunk=T)
    err = _err(got, want, ML_TOL["bfloat16"], f"decode_attention {case}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))  # SDPA's (B, heads, S, hd) views
    lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    ms = _events_ms(lambda: decode_attention_cuda(q, k, v, q_offset=idx, kv_len=length),
                    TIMED_REPS)
    plain_ms = _events_ms(lambda: chunked_attention(q, k, v, q_offset=T - 1, kv_len=T,
                                                    kv_chunk=T), ML_REPS)
    library_ms = _events_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
                            TIMED_REPS)
    n_bytes = 2 * (2 * B * H * hd + 2 * B * T * K * hd)  # q, o and the live k, v in bf16
    n_ops = 4 * B * H * hd * T  # q k and p v, on the CUDA cores in float32
    return {"shape": dict(zip(("B", "H", "K", "T", "hd"), case, strict=True)),
            "dtype": "bfloat16", "fill": T, "max_abs_err": err,
            "sdpa_vs_plain_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "plain_over_kernel": plain_ms / ms,
            "kernel_over_sdpa": ms / library_ms,
            **_ml_bound(n_ops, n_bytes, ops_per_s=FP32_OPS_PER_S)}


def phase_decode_vs_plain(device) -> dict:
    """decode_attention: the kernel through ``ops.flash_attention`` (S ==
    1 on the card, one launch a call) vs the plain route, chunked_attention
    on the same inputs, at the benchmark cells' shapes (DECODE_ATTN) in
    float32 and bf16, the position a 0-d tensor at a middle and the last
    fill: within ML_TOL, and at bf16 also within half a bf16 unit (2**-8 of
    the magnitude) and 2e-5 of the plain route at float32 on the same
    operands, the kernel's one rounding; then timed at both shapes (the
    chat shape's record returned, the doc shape's under "doc")."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.layers import chunked_attention

    errs = {}
    for i, (what, case) in enumerate(DECODE_ATTN.items()):
        B, H, K, T, hd = case
        for name in ML_TOL:
            q, k, v = _attn_inputs((B, 1, T, H, K, hd), getattr(torch, name), device, 70 + i)
            for pos in (T // 2 + 3, T - 1):
                idx = torch.tensor(pos, dtype=torch.int32, device=device)
                before = decode_attention_cuda.launches
                got = ops.flash_attention(q, k, v, q_offset=idx, kv_len=idx + 1)
                if decode_attention_cuda.launches != before + 1:
                    raise AssertionError(f"decode_attention {what} {name}: "
                                         f"{decode_attention_cuda.launches - before} launches")
                want = chunked_attention(q, k, v, q_offset=pos, kv_len=pos + 1, kv_chunk=T)
                key = f"{what} fill {pos + 1} {name}"
                errs[key] = _err(got, want, ML_TOL[name], f"decode_attention {key}")
                if name == "bfloat16":
                    want32 = chunked_attention(q.float(), k.float(), v.float(), q_offset=pos,
                                               kv_len=pos + 1, kv_chunk=T)
                    _err(got, want32, 2e-5, f"decode_attention {key} against float32",
                         rtol=2.0**-8)
                del got, want
            del q, k, v
    print(f"[kernel] decode_attention: {len(errs)} cases within tolerance (the cells' shapes "
          f"{DECODE_ATTN}), max abs err "
          f"f32 {max(e for c, e in errs.items() if c.endswith('float32')):.3g}, "
          f"bf16 {max(e for c, e in errs.items() if c.endswith('bfloat16')):.3g}", flush=True)
    rec = {**_time_decode(DECODE_ATTN["chat"], device, 60), "case_errs": errs}
    rec["doc"] = _time_decode(DECODE_ATTN["doc"], device, 61)
    print("[kernel] " + json.dumps({"decode_attention_timing": rec}), flush=True)
    for what, r in (("chat", rec), ("doc", rec["doc"])):
        print(f"[kernel] decode_attention at the {what} cell's shape {DECODE_ATTN[what]}: "
              f"{r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); plain {r['plain_ms']:.4f} ms "
              f"({r['plain_over_kernel']:.1f}x the kernel's time); SDPA {r['library_ms']:.4f} ms "
              f"(the kernel takes {r['kernel_over_sdpa']:.2f}x)", flush=True)
    return rec


def _mla_inputs(B, H, T, dtype, device, seed):
    import torch

    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(sh), dtype=torch.float32).to(device, dtype)
            for sh in ((B, H, 576), (B, T, 512), (B, T, 64))]


def phase_mla_decode_vs_plain(device) -> dict:
    """mla_decode (kernel 7): the kernel through ``ops.mla_decode`` (one
    launch a call) vs its plain route, ``mla_decode_plain`` on the same
    inputs, at the benchmark cell's shape (MLA_DECODE) in float32 and bf16,
    the length a 0-d tensor at fills 1, 512, 767 and 768: within ML_TOL, and
    at bf16 also within half a bf16 unit (2**-8 of the magnitude) and 2e-5
    of the plain route at float32 on the same operands; then, in bf16 at
    the timed fill, timed beside the plain route, the live bytes' bound and
    scaled_dot_product_attention over the expanded heads (the yardstick;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.mla_decode import mla_decode_cuda, mla_decode_plain

    B, H, T, fill = MLA_DECODE
    errs = {}
    for name in ML_TOL:
        q, c, kr = _mla_inputs(B, H, T, getattr(torch, name), device, 90)
        for n in (1, fill, T - 1, T):
            length = torch.tensor(n, dtype=torch.int32, device=device)
            before = mla_decode_cuda.launches
            got = ops.mla_decode(q, c, kr, kv_len=length, scale=MLA_SCALE)
            if mla_decode_cuda.launches != before + 1:
                raise AssertionError(f"mla_decode {name}: "
                                     f"{mla_decode_cuda.launches - before} launches")
            want = mla_decode_plain(q, c, kr, kv_len=n, scale=MLA_SCALE)
            key = f"fill {n} {name}"
            errs[key] = _err(got, want, ML_TOL[name], f"mla_decode {key}")
            if name == "bfloat16":
                want32 = mla_decode_plain(q.float(), c.float(), kr.float(), kv_len=n,
                                          scale=MLA_SCALE)
                _err(got, want32, 2e-5, f"mla_decode {key} against float32", rtol=2.0**-8)
            del got, want
        del q, c, kr
    print(f"[kernel] mla_decode: {len(errs)} cases within tolerance (the cell's shape "
          f"{MLA_DECODE[:3]}), max abs err "
          f"f32 {max(e for k, e in errs.items() if k.endswith('float32')):.3g}, "
          f"bf16 {max(e for k, e in errs.items() if k.endswith('bfloat16')):.3g}", flush=True)

    q, c, kr = _mla_inputs(B, H, T, torch.bfloat16, device, 91)
    length = torch.tensor(fill, dtype=torch.int32, device=device)
    got = mla_decode_cuda(q, c, kr, kv_len=length, scale=MLA_SCALE)
    err = _err(got, mla_decode_plain(q, c, kr, kv_len=fill, scale=MLA_SCALE),
               ML_TOL["bfloat16"], f"mla_decode timed fill {fill}")
    ms = _events_ms(lambda: mla_decode_cuda(q, c, kr, kv_len=length, scale=MLA_SCALE),
                    TIMED_REPS)
    plain_ms = _events_ms(lambda: mla_decode_plain(q, c, kr, kv_len=length, scale=MLA_SCALE),
                          ML_REPS)
    # SDPA's (B, heads, S, width) views of the live part: one kv head of
    # keys (latent ‖ rope) and values (the latent) for the 16 query heads
    qt = q[:, :, None]
    kt = torch.cat([c[:, :fill], kr[:, :fill]], dim=-1)[:, None]
    vt = c[:, None, :fill]
    lib = F.scaled_dot_product_attention(qt, kt, vt, scale=MLA_SCALE, enable_gqa=True)
    lib_err = float((lib[:, :, 0].float() - got.float()).abs().max())
    library_ms = _events_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=MLA_SCALE, enable_gqa=True), TIMED_REPS)
    n_bytes = 2 * B * (fill * (512 + 64) + H * (512 + 64) + H * 512)  # the live rows, q, o
    n_ops = 2 * B * H * fill * (2 * 512 + 64)  # scores and the latent sum, on the tensor cores
    rec = {"shape": dict(zip(("B", "H", "T"), MLA_DECODE[:3], strict=True)),
           "dtype": "bfloat16", "fill": fill, "max_abs_err": err,
           "sdpa_vs_kernel_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "plain_over_kernel": plain_ms / ms,
           "kernel_over_sdpa": ms / library_ms, "case_errs": errs,
           **_ml_bound(n_ops, n_bytes)}
    print("[kernel] " + json.dumps({"mla_decode_timing": rec}), flush=True)
    print(f"[kernel] mla_decode at the cell's shape {MLA_DECODE[:3]}, fill {fill}: {ms:.4f} ms; "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, {rec['bound_ms'] / ms:.1%} of "
          f"it); plain {plain_ms:.4f} ms ({rec['plain_over_kernel']:.1f}x the kernel's time); "
          f"SDPA {library_ms:.4f} ms (the kernel takes {rec['kernel_over_sdpa']:.2f}x)",
          flush=True)
    return rec


def phase_mla_replay(device) -> dict:
    """moonlight-16b-a3b's 27 layers at its attention widths (the rest cut
    small: d_model 256, 8 experts of 64, vocab 1024) through
    ``ServeEngine.generate(jit=True)``: one decode graph whose replays each
    launch kernel 7 once a layer (``CudaGraphStep.launches``); returns the
    launches a replay and over the generate's replays."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    full = get_arch("moonlight-16b-a3b")
    cfg = dataclasses.replace(full, name="moonlight-small", d_model=256, d_ff=64, vocab=1024,
                              dense_d_ff=128,
                              moe=dataclasses.replace(full.moe, n_experts=8, top_k=2))
    model = Model(cfg, generator=torch.Generator(device).manual_seed(0), device=device,
                  dtype=torch.bfloat16)
    engine = ServeEngine(model, ServeConfig(max_len=40), jit=True)
    tokens = torch.randint(0, cfg.vocab, (4, 20), device=device, dtype=torch.int32,
                           generator=torch.Generator(device).manual_seed(1))
    engine.generate({"tokens": tokens}, 8)
    (key,) = list(engine._decode.graphs)
    per_replay = engine._decode.launches(key).get("mla_decode", 0)
    if per_replay != cfg.n_layers:
        raise AssertionError(f"a moonlight decode replay launched mla_decode {per_replay} "
                             f"times, not once a layer ({cfg.n_layers})")
    rec = {"per_replay": per_replay, "replayed": engine._decode.replayed["mla_decode"],
           "rotary_replayed": engine._decode.replayed["rotary"]}
    print("[launches] " + json.dumps({"mla_decode_moonlight_decode": rec}), flush=True)
    del engine, model
    return rec


def _rotary_case(what: str, dtype, device, seed: int):
    """(q, k, positions, theta, sections) at a benchmark cell's shape
    (ROTARY): qwen2-vl's M-RoPE over a decode step (a 0-d position
    expanded to (B, 1, 3), as the captured step holds it) or the doc
    cell's prefill (a 96 x 64 patch grid with (0, r, c) streams, then text
    in all three); latent attention's rope columns of q and of the latent
    product where they lie, at a Moonlight decode step."""
    import torch

    B, S = ROTARY[what]
    g = torch.Generator(device).manual_seed(seed)
    if what == "moonlight_decode":
        q = torch.randn((B, S, 16, 192), generator=g, device=device).to(dtype)[..., 128:]
        kv = torch.randn((B, S, 576), generator=g, device=device).to(dtype)
        pos = torch.full((), 511, dtype=torch.long, device=device).expand(B, S)
        return q, kv[:, :, None, 512:], pos, 5e4, None
    q = torch.randn((B, S, 12, 128), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, 2, 128), generator=g, device=device).to(dtype)
    if S == 1:
        pos = torch.full((), 767, dtype=torch.long, device=device).expand(B, S, 3)
    else:
        r, c = torch.meshgrid(torch.arange(96), torch.arange(64), indexing="ij")
        patches = torch.stack([torch.zeros_like(r), r, c], dim=-1).reshape(-1, 3)
        text = (patches.shape[0] + torch.arange(S - patches.shape[0]))[:, None].expand(-1, 3)
        pos = torch.cat([patches, text])[None].expand(B, S, 3).contiguous().to(device)
    return q, k, pos, 1e6, (16, 24, 24)


def _graph_ms(fn, n: int, reps: int) -> float:
    """Device ms of one of ``n`` calls of ``fn`` captured as one CUDA graph
    (a layer's launch inside a captured step), by ``_events_ms``."""
    import torch

    fn()  # the library loaded and the plain route's shapes warmed outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = _events_ms(graph.replay, reps) / n
    del graph
    return ms


def phase_rotary_vs_plain(device) -> dict:
    """rotary (kernel 8): the kernel through ``ops.rotary`` (one launch a
    call, q and k rotated in place) vs its plain route, ``rotary_plain``
    (``layers.apply_rope`` / ``apply_mrope`` on each) on the same inputs, at
    the benchmark cells' shapes (ROTARY) in float32 and bf16: at float32
    within 1e-6 (absolute and relative); at bf16 within half a bf16 unit
    (2**-8 of the magnitude) and 2e-5 of the plain route at float32, with
    the count of bf16 elements that differ from the plain route's bf16
    output.  Then timed in bf16 against the bytes bound (each element of q
    and k read and written once) and the plain route: the decode shapes as
    one of a layer count of launches in a captured graph, the prefill
    shape by events (the doc shape's record returned, the others under
    their names).  No single PyTorch call computes the rotation."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.rotary import rotary_cuda, rotary_plain

    errs, differ = {}, {}
    for i, what in enumerate(ROTARY):
        for name in ML_TOL:
            q, k, pos, theta, sections = _rotary_case(what, getattr(torch, name), device, 80 + i)
            before = rotary_cuda.launches
            got = ops.rotary(q.clone(), k.clone(), pos, theta, sections)
            if rotary_cuda.launches != before + 1:
                raise AssertionError(f"rotary {what} {name}: {rotary_cuda.launches - before} "
                                     f"launches")
            key = f"{what} {name}"
            if name == "float32":
                want = rotary_plain(q, k, pos, theta, sections)
                errs[key] = max(_err(g, w, 1e-6, f"rotary {key}") for g, w in zip(got, want))
            else:
                want = rotary_plain(q.float(), k.float(), pos, theta, sections)
                errs[key] = max(_err(g, w, 2e-5, f"rotary {key} against float32", rtol=2.0**-8)
                                for g, w in zip(got, want))
                plain = rotary_plain(q, k, pos, theta, sections)
                differ[what] = [sum(int((g != w).sum()) for g, w in zip(got, plain)),
                                q.numel() + k.numel()]
            del q, k, got, want
    print(f"[kernel] rotary: {len(errs)} cases within tolerance (the cells' shapes {ROTARY}), "
          f"max abs err f32 {max(e for c, e in errs.items() if c.endswith('float32')):.3g}, "
          f"bf16 {max(e for c, e in errs.items() if c.endswith('bfloat16')):.3g}; bf16 "
          f"elements that differ from the plain route's bf16 output: {differ}", flush=True)

    recs = {}
    for i, what in enumerate(ROTARY):
        q, k, pos, theta, sections = _rotary_case(what, torch.bfloat16, device, 85 + i)
        n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
        # the rotation's 6 operations a pair of elements; the angles' sincos aside
        n_ops = 3 * (q.numel() + k.numel())
        kernel = lambda: rotary_cuda(q, k, pos, theta, sections)  # noqa: E731
        plain = lambda: rotary_plain(q, k, pos, theta, sections)  # noqa: E731
        if q.shape[1] == 1:  # a decode step: a launch a layer in the captured step
            layers = 27 if what == "moonlight_decode" else 28
            ms, plain_ms = (_graph_ms(fn, layers, TIMED_REPS) for fn in (kernel, plain))
        else:
            ms, plain_ms = _events_ms(kernel, TIMED_REPS), _events_ms(plain, ML_REPS)
        recs[what] = {"shape": {"q": list(q.shape), "k": list(k.shape),
                                "positions": list(pos.shape)},
                      "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                      "plain_over_kernel": plain_ms / ms, "library_ms": None,
                      **_ml_bound(n_ops, n_bytes, ops_per_s=FP32_OPS_PER_S)}
        del q, k, pos
    rec = {**recs.pop("doc_prefill"), **recs, "max_abs_err": max(errs.values()),
           "case_errs": errs, "bf16_differ": differ}
    print("[kernel] " + json.dumps({"rotary_timing": rec}), flush=True)
    for what, r in (("doc_prefill", rec), *((w, rec[w]) for w in recs)):
        print(f"[kernel] rotary at {what} {r['shape']}: {r['ms'] * 1e3:.2f} us a launch; bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of "
              f"it); plain {r['plain_ms'] * 1e3:.2f} us ({r['plain_over_kernel']:.1f}x the "
              f"kernel's time)", flush=True)
    return rec


def _ssd_inputs(case, dtype, device, seed):
    import torch

    B, S, nh, hp, ng, ds = case[:6]
    rng = np.random.default_rng(seed)

    def on(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(device, dt)

    return (on(rng.standard_normal((B, S, nh, hp)), dtype),
            on(np.logaddexp(rng.standard_normal((B, S, nh)), 0.0)),
            on(-np.exp(rng.standard_normal(nh) * 0.3)),
            on(rng.standard_normal((B, S, ng, ds)) * 0.3, dtype),
            on(rng.standard_normal((B, S, ng, ds)) * 0.3, dtype),
            on(rng.standard_normal(nh)))


def phase_ssd_vs_plain(device) -> dict:
    """ssd_scan: kernel vs plain version on the card, y at atol = rtol and
    the final state at atol alone: the reference cases at float32 (the
    CUDA-core kernel) and bfloat16 (the tensor-core kernel), chunk 48 and
    mamba2-130m's prefill shape at bfloat16.  The tensor-core kernel is
    timed at mamba2-130m's shape beside the plain version and must beat it.
    No single PyTorch call computes the scan, so there is no library time."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain

    def check(case, name, seed):
        args = _ssd_inputs(case, getattr(torch, name), device, seed)
        mma_before = ssd_scan_cuda.mma_launches
        got = ssd_scan_cuda(*args, chunk=case[6], return_state=True)
        want = ssd_scan_plain(*args, chunk=case[6], return_state=True)
        torch.cuda.synchronize()
        mma = ssd_scan_cuda.mma_launches - mma_before
        if mma != (name == "bfloat16"):
            raise AssertionError(f"ssd_scan {case} {name}: {mma} tensor-core launches; want "
                                 f"bfloat16 on the tensor-core kernel, float32 off it")
        return args, _scan_errs(got, want, ML_TOL[name], f"ssd_scan {case} {name}")

    errs = {}
    for i, case in enumerate((*SSD_CASES, *SSD_EXTRA)):
        for name in ML_TOL if case in SSD_CASES else ("bfloat16",):
            errs[f"{case} {name}"] = check(case, name, i)[1]
    print(f"[kernel] ssd_scan: {len(errs)} cases within tolerance (the reference's at float32 "
          f"and bfloat16, and chunk 48; y at atol = rtol, state at atol alone), max abs err "
          f"f32 {_max_errs(errs, 'float32')}; bf16 {_max_errs(errs, 'bfloat16')}", flush=True)

    B, S, nh, hp, ng, ds, chunk = MAMBA_SSD
    args, err = check(MAMBA_SSD, "bfloat16", 98)
    ms = _events_ms(lambda: ssd_scan_cuda(*args, chunk=chunk, return_state=True), ML_REPS)
    plain_ms = _events_ms(lambda: ssd_scan_plain(*args, chunk=chunk, return_state=True), ML_REPS)
    if ms >= plain_ms:
        raise AssertionError(f"ssd_scan (tensor cores) at mamba2-130m's shape: {ms} ms, not "
                             f"faster than the plain version's {plain_ms} ms")
    # a chunk of L per head: L(L+1)/2 (s <= t) pairs of a ds dot and an hp
    # axpy, then the inter-chunk term and the state update, 2 ds hp a position each
    n_heads_chunks = B * nh * (S // chunk)
    n_ops = n_heads_chunks * (chunk * (chunk + 1) * (ds + hp) + 4 * chunk * ds * hp)
    # x, B, C, y in bf16; dt f32; A, D f32; final state f32
    n_bytes = 2 * (2 * B * S * nh * hp + 2 * B * S * ng * ds) + 4 * B * S * nh + 8 * nh \
        + 4 * B * nh * ds * hp
    rec = {"shape": dict(zip(("B", "S", "nh", "hp", "ng", "ds", "chunk"), MAMBA_SSD, strict=True)),
           "dtype": "bfloat16", "max_abs_err": max(err.values()), "max_abs_err_y": err["y"],
           "max_abs_err_state": err["state"], "case_errs": errs, "ms": ms,
           "plain_ms": plain_ms, "plain_over_kernel": plain_ms / ms, "library_ms": None,
           **_ml_bound(n_ops, n_bytes)}
    print("[kernel] " + json.dumps({"ssd_scan_timing": {
        k: v for k, v in rec.items() if k != "case_errs"}}), flush=True)
    print(f"[kernel] ssd_scan (tensor cores) at mamba2-130m's prefill: {ms:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); plain {plain_ms:.4f} ms "
          f"({rec['plain_over_kernel']:.1f}x the kernel's time); max abs err y {err['y']:.3g}, "
          f"state {err['state']:.3g}", flush=True)
    return rec


def _rglru_inputs(case, dtype, device, seed, slow: bool = False):
    """x, r, i standard normal in ``dtype``, log_lambda float32: standard
    normal, or with ``slow`` uniform in [-8, -4], where a = exp(-8
    softplus(lam) sigmoid(r)) lies in about [0.87, 1) and the state carries
    across many chunks."""
    import torch

    B, S, W = case
    rng = np.random.default_rng(seed)

    def on(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(device, dt)

    return (*(on(rng.standard_normal((B, S, W)), dtype) for _ in range(3)),
            on(rng.uniform(-8.0, -4.0, W) if slow else rng.standard_normal(W)))


def phase_rglru_vs_plain(device) -> dict:
    """rglru_scan: kernel vs plain version (y and the final state) on the
    card at the reference cases and recurrentgemma-2b's prefill shape, with
    the reference's decay and a slow one; timed there, and required faster
    than the plain version, with no spills in ptxas's report.  The kernel
    returns the float32 state, the plain version the state rounded to x's
    type (the reference oracle's convention): at bfloat16 the two differ by
    that rounding, inside 2e-2.  No single PyTorch call computes the scan,
    so there is no library time."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import rglru_plan, rglru_scan_cuda, rglru_scan_plain

    errs = {}
    for i, case in enumerate(RGLRU_CASES):
        for name, tol in ML_TOL.items():
            args = _rglru_inputs(case, getattr(torch, name), device, i)
            got = rglru_scan_cuda(*args, return_state=True)
            want = rglru_scan_plain(*args, return_state=True)
            torch.cuda.synchronize()
            errs[f"{case} {name}"] = _scan_errs(got, want, tol, f"rglru_scan {case} {name}")
    print(f"[kernel] rglru_scan: {len(errs)} reference cases within tolerance (y at atol = "
          f"rtol, state at atol alone), max abs err f32 {_max_errs(errs, 'float32')}; "
          f"bf16 {_max_errs(errs, 'bfloat16')}", flush=True)

    B, S, W = RGEMMA_RGLRU
    errs_prefill, errs_slow = {}, {}
    for name, tol in ML_TOL.items():
        for errs_at, slow, seed in ((errs_prefill, False, 95), (errs_slow, True, 94)):
            args = _rglru_inputs(RGEMMA_RGLRU, getattr(torch, name), device, seed, slow=slow)
            got = rglru_scan_cuda(*args, return_state=True)
            want = rglru_scan_plain(*args, return_state=True)
            errs_at[name] = _scan_errs(got, want, tol, f"rglru_scan recurrentgemma-2b shape "
                                       f"{name}{' slow decay' if slow else ''}")
    print(f"[kernel] rglru_scan at recurrentgemma-2b's shape: max abs err bf16 y "
          f"{errs_prefill['bfloat16']['y']:.3g}, state {errs_prefill['bfloat16']['state']:.3g}; "
          f"slow decay bf16 y {errs_slow['bfloat16']['y']:.3g}, state "
          f"{errs_slow['bfloat16']['state']:.3g}; f32 {json.dumps(errs_prefill['float32'])}, "
          f"slow {json.dumps(errs_slow['float32'])}", flush=True)
    ptxas = _ptxas_summary(_build.build_log("rglru_scan"), "rglru_chunk_scan_kernel", None)
    print("[build] rglru_scan ptxas: " + json.dumps(ptxas), flush=True)
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_store_bytes", 0) or v.get("spill_load_bytes", 0)}
    if spills:
        raise AssertionError(f"rglru_scan: ptxas reports spills in {spills}")
    plan = rglru_plan(B, S, W, torch.bfloat16)
    args = _rglru_inputs(RGEMMA_RGLRU, torch.bfloat16, device, 95)  # the timed inputs
    ms = _events_ms(lambda: rglru_scan_cuda(*args, return_state=True), ML_REPS)
    plain_ms = _events_ms(lambda: rglru_scan_plain(*args, return_state=True), ML_REPS)
    if ms >= plain_ms:
        raise AssertionError(f"rglru_scan at recurrentgemma-2b's shape: {ms} ms, not faster "
                             f"than the plain version's {plain_ms} ms")
    # x, r, i read and y written once in bf16; log_lambda f32; the f32 state
    n_bytes = 2 * 4 * B * S * W + 4 * W + 4 * B * W
    rec = {"shape": dict(zip(("B", "S", "W"), RGEMMA_RGLRU, strict=True)), "dtype": "bfloat16",
           "plan": {k: getattr(plan, k) for k in ("grid", "threads", "tile", "chunk",
                                                  "n_chunks", "window", "vec")},
           "max_abs_err": max(errs_prefill["bfloat16"].values()),
           "max_abs_err_y": errs_prefill["bfloat16"]["y"],
           "max_abs_err_state": errs_prefill["bfloat16"]["state"],
           "max_abs_err_float32": errs_prefill["float32"],
           "slow_decay_errs": errs_slow, "registers": ptxas,
           "case_errs": errs, "ms": ms, "plain_ms": plain_ms,
           "plain_over_kernel": plain_ms / ms, "library_ms": None,
           **_ml_bound(OPS_PER_RGLRU_STEP * B * S * W, n_bytes, FP32_OPS_PER_S)}
    print("[kernel] " + json.dumps({"rglru_scan_timing": {
        k: v for k, v in rec.items() if k not in ("case_errs", "registers")}}), flush=True)
    print(f"[kernel] rglru_scan (chunked) at recurrentgemma-2b's prefill: {ms:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); plain {plain_ms:.4f} ms "
          f"({rec['plain_over_kernel']:.1f}x the kernel's time)", flush=True)
    return rec


def _cpu_tree(tree: dict) -> dict:
    return {k: _cpu_tree(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}


# The kernels' symbols, as the profiler names them, by wrapper: the bf16
# serving path's SSD scan runs the tensor-core kernel's four passes.
KERNEL_SYMBOLS = {
    "flash_attention": ("flash_attention_kernel",),
    "decode_attention": ("decode_attention_kernel",),
    "ssd_scan": ("ssd_chunk_kernel", "ssd_score_kernel", "ssd_state_kernel", "ssd_out_kernel"),
    "rglru_scan": ("rglru_chunk_scan_kernel",),
    "rotary": ("rotary_kernel",),
}


def _routed(run):
    """Run ``run()`` recording each MoE layer's top-k experts, a (B, S, k)
    tensor sorted along k, in call order; returns (result, routes)."""
    from repro_torch.models import layers, transformer

    routes = []
    real = transformer.moe_layer

    def spy(x, router, *w, top_k, capacity_factor, impl):
        out, probs = real(x, router, *w, top_k=top_k, capacity_factor=capacity_factor,
                          impl=impl)
        routes.append(layers._top_k(probs, top_k)[1].sort(dim=-1).values.cpu())
        return out, probs

    transformer.moe_layer = spy
    try:
        return run(), routes
    finally:
        transformer.moe_layer = real


def _route_diff(got: list, want: list) -> dict:
    """Tokens whose top-k expert set differs between two runs' routes, over
    every MoE layer, and the first layer where one does (-1: none)."""
    differ = [int((g != w).any(-1).sum()) for g, w in zip(got, want, strict=True)]
    return {"route_tokens_differ": sum(differ),
            "route_tokens": sum(int(g[..., 0].numel()) for g in got),
            "first_layer_differing": next((i for i, d in enumerate(differ) if d), -1)}


def _prefill_vs_plain(model, batch) -> dict:
    """The prefill's last logits through the kernels and, on the same card,
    through their plain versions: max |difference| beside max |logit|, the
    rows whose argmax agrees, and the plain logits' top-2 margin on the rows
    that differ; for an MoE model also the tokens routed to another expert
    set.  bf16 rounds at other places in the two, so a near tie can flip a
    greedy token or a route; phase 11 holds the logits strictly, at
    float32."""
    import torch

    from repro_torch.kernels import ops

    (got, _), got_routes = _routed(lambda: model.prefill(batch))
    names = ("flash_attention", "ssd_scan", "rglru_scan")
    saved = {n: getattr(ops, f"{n}_cuda") for n in names}
    try:
        for n in names:
            setattr(ops, f"{n}_cuda", getattr(ops, f"{n}_plain"))
        (want, _), want_routes = _routed(lambda: model.prefill(batch))
    finally:
        for n, fn in saved.items():
            setattr(ops, f"{n}_cuda", fn)
    g, w = got.float(), want.float()
    agree = g.argmax(-1) == w.argmax(-1)
    top2 = torch.topk(w, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])[~agree]
    rec = {"max_abs_diff": float((g - w).abs().max()), "max_abs_logit": float(w.abs().max()),
           "argmax_agree_rows": int(agree.sum()), "rows": int(agree.numel()),
           "plain_top2_margin_where_differs": margin.tolist()}
    if got_routes:
        rec.update(_route_diff(got_routes, want_routes))
    return rec


def _mrope_positions(B: int, grid: int, n_text: int) -> np.ndarray:
    """Qwen2-VL's position ids for a grid x grid patch prefix, then text:
    patch (r, c) at (t, h, w) = (0, r, c), text token i at grid + i in all
    three streams."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    patches = np.stack([np.zeros_like(r), r, c], axis=-1)
    text = np.repeat((grid + np.arange(n_text))[:, None], 3, axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(np.concatenate([patches, text])[None], (B, grid * grid + n_text, 3)))


def _serve_batch(cfg, B: int, S: int, seed: int, grid: int) -> dict:
    """A prompt batch of S positions for the model's family, CPU tensors:
    token ids; a vision model's prefix of grid x grid patch embeddings and
    its 3-D positions; an enc-dec model's S frame embeddings (the stub
    frontends' inputs)."""
    import torch

    rng = np.random.default_rng(seed)
    n_tok = S - grid * grid if cfg.family == "vlm" else S
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, grid * grid, cfg.d_model)).astype(np.float32))
        batch["positions"] = torch.from_numpy(_mrope_positions(B, grid, n_tok).astype(np.int32))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return batch


def _on(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def phase_serve(name: str, device) -> dict:
    """ServeEngine.generate at the model's full published width and depth in
    bfloat16, weights from init_params with a seeded generator on the
    card: under ``jit=False`` (every op dispatched from the host), then
    under ``jit=True`` (the default: prefill and decode as CUDA graphs) on
    the same weights, greedy tokens equal."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import ExecConfig, Model

    cfg = get_arch(name)
    B, S, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    gc.collect()  # the earlier models' weights go before this one's come
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(device) / 1e9
    model = Model(cfg, generator=torch.Generator(device).manual_seed(0), device=device,
                  dtype=getattr(torch, cfg.dtype))
    batch = _on(_serve_batch(cfg, B, S, 13, SERVE_GRID), device)
    short = _on(_serve_batch(cfg, B, S // 2, 14, SERVE_GRID), device)
    eager, eager_out = _serve_engine(model, batch, short, device, jit=False)
    captured, outs = _serve_engine(model, batch, short, device, jit=True)
    for what, got, want in zip(("", "shorter prompt's "), outs, eager_out, strict=True):
        if not torch.equal(got, want):
            rows = (got != want).any(-1).nonzero()[:, 0].tolist()
            raise AssertionError(f"serve {name}: jit=True {what}tokens differ from "
                                 f"jit=False's in rows {rows}")
    out = outs[0]
    rec = {
        "model": name, "layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "params": model.n_params(), "batch": B, "prompt": S, "new": new,
        "batch_keys": sorted(batch), "card_gb_held_before": held_gb,
        "jit_tokens_equal_eager": True, "first_row": out[0, :8].tolist(),
        # the default engine's (jit=True) numbers at the top level
        **{k: captured[k] for k in ("generate_s", "tokens_per_s", "prefill_ms",
                                    "decode_ms_per_token", "launches", "card_gb_peak")},
        "jit_true": captured, "jit_false": eager,
        "prefill_vs_plain": _prefill_vs_plain(model, batch),
    }
    if cfg.family == "moe":  # the other layout of the experts' slots, on the same weights
        from repro_torch.serve import ServeConfig, ServeEngine

        batched = Model(cfg, ExecConfig(moe_impl="batched"), params=model.params, device=device)
        engine = ServeEngine(batched, ServeConfig(max_len=S + new))
        engine.generate(batch, 2)  # the captures
        ms = _prefill_decode_ms(engine, batch, S, new)
        rec["moe_impl_batched"] = {"jit": True, "prefill_ms": ms[0],
                                   "decode_ms_per_token": ms[1]}
        del batched, engine
        gc.collect()
    print("[serve] " + json.dumps(rec), flush=True)
    del model
    torch.cuda.empty_cache()
    return rec


def _check_launches(what: str, launches: dict, want: dict) -> None:
    """``launches`` (by ``kernels.counts``' names) are ``want``, one a layer
    of its kind, and no other; every flash and SSD one on the tensor cores
    (bfloat16)."""
    if {k: n for k, n in launches.items() if n and not k.endswith("_mma")} != want:
        raise AssertionError(f"{what}: launches {launches}; want {want} (one a layer of its "
                             f"kind, in the prefill) and no other")
    for kernel in ("flash_attention", "ssd_scan"):
        if launches.get(f"{kernel}_mma", 0) != launches.get(kernel, 0):
            raise AssertionError(f"{what}: {launches.get(f'{kernel}_mma', 0)} of "
                                 f"{launches.get(kernel, 0)} {kernel} launches on the "
                                 f"tensor-core kernel; want all of them (bfloat16)")


def _serve_engine(model, batch: dict, short: dict, device, *, jit: bool) -> tuple[dict, list]:
    """One engine's run of phase 10: two timed ``generate``s of ``batch``
    (the first warms up; under ``jit`` it captures prefill and decode,
    each step run once eagerly first, and the second replays them), then
    one of ``short``, a shorter prompt (under ``jit`` a second prefill
    graph).  The wrappers' launch counts of each: a prefill's kernels once
    a layer of their kind and a decode step's decode attention once a layer
    with a KV cache (every step eagerly, the warm-up step under ``jit``),
    and no other, every flash and SSD launch on the tensor cores; under
    ``jit`` the replaying second none (a replay runs no wrapper).  The
    tokens of the second and the short ``generate``; three timed prefills
    and the decode steps' mean ms; the card's peak memory from the engine's
    first call, after the first prompt length and after both; under
    ``jit``, each prefill graph's launches (its kernel nodes) held to the
    prefill's want and each decode graph's to a step's; a traced 8-token
    ``generate`` (under ``jit``, a replay): its launches (the wrappers' or
    its graphs'), held to the same wants and each shown among its device
    kernels, and its device split; under ``jit``, each capture's ms (the
    first call of a step: warm-up and capture)."""
    import torch

    from repro_torch.kernels.counts import decode_launches, prefill_launches, total
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.graphs import signature

    cfg = model.cfg
    want = prefill_launches(cfg)
    S, new = SERVE["prompt"], SERVE["new"]
    # a generate's launches: its prefill's, then one decode step's under jit
    # (the warm-up before the capture) or every step's eagerly
    generate_want = total(want, decode_launches(cfg, 1 if jit else new - 1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    engine = ServeEngine(model, ServeConfig(max_len=S + new), jit=jit)

    def run(b):
        t0 = time.perf_counter()
        out = engine.generate(b, new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs = []
    for which in ("first", "second"):
        (out, gen_s), counts = _counted(lambda: run(batch))
        _check_launches(f"serve {cfg.name} jit={jit}, {which} generate", counts,
                        {} if jit and which == "second" else generate_want)
        runs.append((out, gen_s, counts))
    out = runs[1][0]
    if not torch.equal(out, runs[0][0]):
        raise AssertionError(f"serve {cfg.name} jit={jit}: the second generate's tokens differ "
                             f"from the first's")
    in_range = bool(((out >= 0) & (out < cfg.vocab)).all())
    if tuple(out.shape) != (SERVE["batch"], new) or not in_range:
        raise AssertionError(f"serve {cfg.name}: tokens {tuple(out.shape)} out of range")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    reserved_gb = torch.cuda.max_memory_reserved(device) / 1e9
    decode_graphs = len(engine._decode.graphs) if jit else 0
    (out_short, short_s), short_counts = _counted(lambda: run(short))
    # under jit the decode step replays its graph, unless the shorter prompt
    # changed its state's shape (an enc-dec's cross cache): a new capture,
    # whose warm-up step launches
    _check_launches(f"serve {cfg.name} jit={jit}, a shorter prompt's generate", short_counts,
                    total(want, decode_launches(cfg, len(engine._decode.graphs) - decode_graphs))
                    if jit else generate_want)
    prefill_ms, decode_ms = _prefill_decode_ms(engine, batch, S, new)
    rec = {"jit": jit, "generate_first_s": runs[0][1], "generate_s": runs[1][1],
           "tokens_per_s": len(out) * new / runs[1][1], "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms, "launches_first": runs[0][2],
           "launches_second": runs[1][2], "card_gb_peak": peak_gb,
           "card_gb_reserved_peak": reserved_gb,
           "short_prompt": {"positions": int(short["tokens"].shape[1]) + (
               int(short["patch_embeds"].shape[1]) if "patch_embeds" in short else 0),
                            "generate_s": short_s, "launches": short_counts,
                            "card_gb_peak_both_prompts": torch.cuda.max_memory_allocated(
                                device) / 1e9,
                            "card_gb_reserved_peak_both_prompts":
                                torch.cuda.max_memory_reserved(device) / 1e9},
           "launches_wrappers": {k: runs[0][2][k] + runs[1][2][k] + short_counts[k]
                                 for k in runs[0][2]}}
    if jit:
        rec["capture_ms"] = {"prefill": [c["ms"] for c in engine._prefill.captures],
                             "decode": [c["ms"] for c in engine._decode.captures]}
    if jit:  # what each replay launches: the graphs' kernel nodes
        rec["graph_launches"] = {
            step: [engine_step.launches(key) for key in engine_step.graphs]
            for step, engine_step in (("prefill", engine._prefill), ("decode", engine._decode))}
        for got in rec["graph_launches"]["prefill"]:
            _check_launches(f"serve {cfg.name}, a prefill graph's kernel nodes", got, want)
        for got in rec["graph_launches"]["decode"]:
            _check_launches(f"serve {cfg.name}, a decode graph's kernel nodes", got,
                            decode_launches(cfg, 1))
    traced_want = total(want, decode_launches(cfg, 7))  # 8 tokens: a prefill and 7 steps
    split, traced = _counted(lambda: _device_split(
        lambda: (engine.generate(batch, 8), torch.cuda.synchronize()),
        kernels=tuple(k for n in traced_want for k in KERNEL_SYMBOLS[n])))
    if "launches_seen" not in split:
        raise AssertionError(f"serve {cfg.name} jit={jit}: {split['device_us']}; the traced "
                             f"generate's launches cannot be read")
    # the traced generate's launches: the wrappers' (eager) or its graphs'
    # replays (the graphs' kernel nodes), each shown in the trace
    _check_launches(f"serve {cfg.name} jit={jit}, the traced generate's wrappers", traced,
                    {} if jit else traced_want)
    rec["launches"] = (total(engine._prefill.launches(signature((batch,))),
                             decode_launches(cfg, 7)) if jit else
                       {k: n for k, n in traced.items() if n})
    _check_traced(f"serve {cfg.name} jit={jit}, the traced generate", split["launches_seen"],
                  rec["launches"])
    rec["device_us"] = split
    del engine
    gc.collect()  # the graphs and their pool go with the engine
    torch.cuda.empty_cache()
    return rec, [out, out_short]


def _check_traced(what: str, seen: dict, launches: dict) -> None:
    """A trace's launches ``seen`` (``kernels.counts.seen`` of its device
    kernels) show every kernel of ``launches`` run, on the kernel
    ``launches`` names (tensor-core or not), and no other.  The profiler
    drops a device record now and then (71 of a float32 prefill's 72 flash
    launches in one traced replay on an H100, and 70 in another), so a count
    may fall short of ``launches``', never above it: ``launches`` come
    exactly from the wrappers or a graph's kernel nodes."""
    short = {k: (seen.get(k, 0), n) for k, n in launches.items() if not 1 <= seen.get(k, 0) <= n}
    if set(seen) != set(launches) or short:
        raise AssertionError(f"{what}: its device kernels stand for launches {seen}; want "
                             f"each of {launches} seen at least once and at most as often, "
                             f"and no other")


def _prefill_decode_ms(engine, batch: dict, S: int, new: int) -> tuple[list, float]:
    """Three timed ``engine.prefill``s, then ``new - 1`` greedy
    ``engine.decode`` steps: (the prefills' ms, the steps' mean ms)."""
    import torch

    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = engine.prefill(batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(last.float()).all()):
        raise AssertionError(f"serve {engine.model.cfg.name}: prefill logits are not finite")
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, new):
        logits, state = engine.decode(state, tok, S + t - 1)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    return prefill_ms, (time.perf_counter() - t0) * 1e3 / (new - 1)


def phase_serve_check(name: str, device) -> dict:
    """The full-width model at float32 on the card (kernels) and on the CPU
    (plain path) with the same weights: prefill, then decode steps fed the
    same tokens (the CPU's argmax), logits within rel_tol of max |logit|."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.counts import prefill_launches
    from repro_torch.models import Model
    from repro_torch.serve.engine import _pad_cache_to

    full = get_arch(name)
    cfg = dataclasses.replace(full, dtype="float32",
                              n_layers=CHECK_LAYERS.get(name, full.n_layers))
    B, S, steps = CHECK["batch"], CHECK["prompt"], CHECK["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    gpu = Model(cfg, generator=torch.Generator(device).manual_seed(1), device=device)
    cpu = Model(cfg, params=_cpu_tree(gpu.params), device="cpu")
    batch = _serve_batch(cfg, B, S, 21, CHECK_GRID)
    ((g_last, g_state), g_routes), counts = _counted(
        lambda: _routed(lambda: gpu.prefill(_on(batch, device))))
    want = prefill_launches(cfg)
    if (counts["flash_attention_mma"] or counts["ssd_scan_mma"]
            or counts["flash_attention"] != want.get("flash_attention", 0)
            or counts["ssd_scan"] != want.get("ssd_scan", 0)):
        raise AssertionError(f"serve check {name}: float32 prefill launches {counts}; want "
                             f"{want} on the CUDA-core flash and SSD kernels, none on tensor "
                             f"cores")
    (c_last, c_state), c_routes = _routed(lambda: cpu.prefill(batch))
    routes = [(g_routes, c_routes)]
    g_state = _pad_cache_to(g_state, cfg.family, S + steps)
    c_state = _pad_cache_to(c_state, cfg.family, S + steps)
    errs, scales, errs_captured = [], [], []
    pairs = [(g_last, c_last)]
    step = torch.argmax(c_last, dim=-1).to(torch.int32)
    fed = []
    for t in range(steps):
        fed.append(step)
        (g_log, g_state), g_routes = _routed(
            lambda: gpu.decode_step(g_state, step.to(device), S + t))
        (c_log, c_state), c_routes = _routed(lambda: cpu.decode_step(c_state, step, S + t))
        pairs.append((g_log, c_log))
        routes.append((g_routes, c_routes))
        step = torch.argmax(c_log, dim=-1).to(torch.int32)
    moe_layouts = (_moe_layouts_agree(cfg, gpu, batch, S, fed, [g for g, _ in pairs], device)
                   if cfg.family == "moe" else None)
    captured = _captured_steps(gpu, batch, S, fed, want, device)
    for what, got in (("eager", [g for g, _ in pairs]), ("captured", captured)):
        for g, (_, c) in zip(got, pairs, strict=True):
            g = g.float().cpu()
            err, scale = float((g - c).abs().max()), float(c.abs().max())
            if what == "eager":
                errs.append(err)
                scales.append(scale)
            else:
                errs_captured.append(err)
            if not bool(torch.isfinite(g).all()) or err > CHECK["rel_tol"] * scale:
                raise AssertionError(f"serve check {name} ({what} steps): card vs CPU logits "
                                     f"differ by {err} (max |logit| {scale}, tolerance "
                                     f"{CHECK['rel_tol']} of it)")
    rec = {"model": name, "layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "dtype": "float32", "batch": B, "prompt": S, "decode_steps": steps,
           "batch_keys": sorted(batch),
           "max_abs_err": max(errs), "max_abs_err_by_step": errs, "max_abs_logit": max(scales),
           "captured_max_abs_err": max(errs_captured),
           "captured_max_abs_err_by_step": errs_captured, "rel_tol": CHECK["rel_tol"]}
    if cfg.family == "moe":  # the card's routes against the CPU's, prefill then each step
        rec["routes_card_vs_cpu"] = [_route_diff(g, c) for g, c in routes]
        rec["moe_impl_batched_vs_vmap"] = moe_layouts
    print("[serve-check] " + json.dumps(rec), flush=True)
    del gpu, cpu, g_state, c_state
    torch.cuda.empty_cache()
    return rec


def _captured_steps(model, batch: dict, S: int, fed: list, want: dict, device) -> list:
    """The same prefill and decode steps through ``ServeEngine(jit=True)``:
    a first prefill captures, a second replays, traced: no wrapper runs in
    it, and its device kernels stand for ``want``'s launches (float32: on
    the CUDA-core kernels); the decode steps fed ``fed`` (the first
    captures, the rest replay).  Returns the logits, prefill first."""
    import torch

    from repro_torch.kernels import counts
    from repro_torch.serve import ServeConfig, ServeEngine

    engine = ServeEngine(model, ServeConfig(max_len=S + len(fed)))
    on = _on(batch, device)
    engine.prefill(on)
    ((last, state), events, _), wrappers = _counted(
        lambda: _trace(lambda: (engine.prefill(on), torch.cuda.synchronize())[0]))
    (key,) = engine._prefill.graphs
    launches = engine._prefill.launches(key)
    if launches != want or any(wrappers.values()) or len(engine._prefill.captures) != 1:
        raise AssertionError(f"serve check {model.cfg.name}: a replayed float32 prefill's "
                             f"graph launches {launches} and its wrappers {wrappers}; want "
                             f"{want} (the CUDA-core kernels) and none, after one capture")
    _check_traced(f"serve check {model.cfg.name}, a replayed float32 prefill",
                  counts.seen(name for name, _, _ in events), launches)
    got = [last]
    for t, step in enumerate(fed):
        logits, state = engine.decode(state, step.to(device), S + t)
        got.append(logits)
    if len(engine._decode.captures) != 1:
        raise AssertionError(f"serve check {model.cfg.name}: {len(engine._decode.captures)} "
                             f"decode captures; want 1")
    return got


def _moe_layouts_agree(cfg, vmap, batch: dict, S: int, fed: list, logits: list,
                       device) -> dict:
    """The MoE model on the card under moe_impl="batched", on the "vmap"
    model's weights: the prefill and the decode steps fed the same tokens,
    each step's greedy tokens equal to "vmap"'s and its logits within
    MOE_LAYOUT_REL_TOL of max |logit|."""
    import torch

    from repro_torch.models import ExecConfig, Model
    from repro_torch.serve.engine import _pad_cache_to

    model = Model(cfg, ExecConfig(moe_impl="batched"), params=vmap.params, device=device)
    last, state = model.prefill(_on(batch, device))
    got = [last]
    state = _pad_cache_to(state, cfg.family, S + len(fed))
    for t, step in enumerate(fed):
        log, state = model.decode_step(state, step.to(device), S + t)
        got.append(log)
    errs, same = [], []
    for g, v in zip(got, logits, strict=True):
        g, v = g.float().cpu(), v.float().cpu()
        errs.append(float((g - v).abs().max()) / float(v.abs().max()))
        same.append(bool(torch.equal(torch.argmax(g, dim=-1), torch.argmax(v, dim=-1))))
    rec = {"rel_err_by_step": errs, "greedy_equal_by_step": same,
           "rel_tol": MOE_LAYOUT_REL_TOL}
    if not all(same) or max(errs) > MOE_LAYOUT_REL_TOL:
        raise AssertionError(f"serve check {cfg.name}: moe_impl='batched' against 'vmap' {rec}")
    del model, state
    return rec


# ---------------------------------------------------------------------------
# phase 14: training on the card
# ---------------------------------------------------------------------------


def _ml_launches(counts: dict) -> dict:
    return {k: counts[k] for k in ("flash_attention", "ssd_scan", "rglru_scan")}


def _train_batch(cfg, seq_len: int, batch: int, step: int, device) -> dict:
    import torch

    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import make_batch_fn

    raw = make_batch_fn(cfg, InputShape("chip", seq_len, batch, "train"))(step)
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in raw.items()}


def _leaf_rel(got, want) -> float:
    """The largest difference of any leaf, relative to the leaf's largest
    magnitude (``want``'s)."""
    from repro_torch._tree import leaves

    return max(float((a.to(b.device).float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(leaves(got), leaves(want), strict=True))


def _bitwise(got, want) -> bool:
    import torch

    from repro_torch._tree import leaves

    return all(torch.equal(a.to(b.device), b)
               for a, b in zip(leaves(got), leaves(want), strict=True))


def _captured_vs_eager(model, opt, state, batches: list) -> dict:
    """``TrainLoop(jit=True)``'s captured step (its first call the warm-up
    and capture, the next ones replays) against the eager step, each from
    ``state`` over ``batches``: per-step losses and grad norms, and the
    final states' largest leaf difference."""
    from repro_torch._tree import tree_map
    from repro_torch.serve.graphs import CudaGraphStep
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

    loop = TrainLoop(model, opt, None, TrainLoopConfig(), jit=True)
    if not isinstance(loop.step_fn, CudaGraphStep):
        raise AssertionError(f"TrainLoop(jit=True) on {model.device}: step {loop.step_fn}")
    captured = tree_map(lambda t: t.clone(), state)
    eager_step = make_train_step(model, opt)
    eager = state
    got, want = [], []
    for batch in batches:
        captured, g = loop.step_fn(captured, batch)
        eager, w = eager_step(eager, batch)
        got.append({k: float(g[k]) for k in ("loss", "grad_norm")})
        want.append({k: float(w[k]) for k in ("loss", "grad_norm")})
    (entry,) = loop.step_fn.graphs.values()
    rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want) for k in g)
    return {"steps": len(batches), "replays": entry.replays, "captured": got, "eager": want,
            "rel_diff": rel, "max_leaf_rel_diff": _leaf_rel(captured, eager),
            "bitwise": got == want and _bitwise(captured, eager)}


def phase_train_check(device) -> dict:
    """(a) One AdamW step of full-width smollm-135m at float32 on the card
    and on the CPU from the same weights (drawn on the CPU) and batch:
    loss and grad norm within rel_tol; the largest relative difference
    (to the leaf's largest magnitude) of any updated leaf.  Then two steps
    of the captured step (warm-up and capture, then a replay) against two
    eager steps on the card, from the same weights: losses, grad norms and
    every updated leaf within TRAIN_JIT_REL_TOL; bitwise reported."""
    import dataclasses

    import torch

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import ExecConfig, Model
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_arch(TRAIN["arch"]), dtype="float32")
    ex = ExecConfig(attn_impl="xla", remat="full")
    opt = AdamW(TRAIN_CHECK["lr"])
    cpu_model = Model(cfg, ex, params={}, device="cpu")
    gpu_model = Model(cfg, ex, params={}, device=device)
    cpu_state = init_train_state(cpu_model, opt, torch.Generator().manual_seed(0))
    gpu_state = tree_map(lambda t: t.to(device), cpu_state)
    S, B = TRAIN_CHECK["seq_len"], TRAIN_CHECK["batch"]
    batch = _train_batch(cfg, S, B, 0, "cpu")
    jit, jit_counts = _counted(lambda: _captured_vs_eager(
        gpu_model, opt, gpu_state, [_on(batch, device), _train_batch(cfg, S, B, 1, device)]))
    (gpu_state, g), counts = _counted(
        lambda: make_train_step(gpu_model, opt)(gpu_state, _on(batch, device)))
    if any(_ml_launches(counts).values()) or any(_ml_launches(jit_counts).values()):
        raise AssertionError(f"train check: the card's steps launched kernels {counts}, "
                             f"{jit_counts}")
    cpu_state, c = make_train_step(cpu_model, opt)(cpu_state, batch)
    rel = {k: abs(float(g[k]) - float(c[k])) / abs(float(c[k])) for k in ("loss", "grad_norm")}
    worst = _leaf_rel(gpu_state.params, cpu_state.params)
    rec = {"model": cfg.name, "dtype": "float32", "seq_len": S, "batch": B,
           "loss": [float(g["loss"]), float(c["loss"])],
           "grad_norm": [float(g["grad_norm"]), float(c["grad_norm"])],
           "rel_diff": rel, "rel_tol": TRAIN_CHECK["rel_tol"],
           "max_leaf_rel_diff_after_update": worst,
           "captured_vs_eager": {**jit, "rel_tol": TRAIN_JIT_REL_TOL}}
    print("[train-check] " + json.dumps(rec), flush=True)
    if max(rel.values()) > TRAIN_CHECK["rel_tol"] or not all(
            np.isfinite([float(g["loss"]), float(g["grad_norm"])])):
        raise AssertionError(f"train check: card vs CPU differ by {rel} (tolerance "
                             f"{TRAIN_CHECK['rel_tol']})")
    if not (jit["rel_diff"] <= TRAIN_JIT_REL_TOL and jit["max_leaf_rel_diff"] <= TRAIN_JIT_REL_TOL
            and jit["replays"] == 1):
        raise AssertionError(f"train check: the captured step differs from the eager one by "
                             f"{jit['rel_diff']} (metrics), {jit['max_leaf_rel_diff']} (leaves); "
                             f"{jit['replays']} replays (tolerance {TRAIN_JIT_REL_TOL})")
    del gpu_state, cpu_state, gpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train(device) -> dict:
    """(b) launch.train.build_loop at full width and depth in bfloat16 on
    float32 master weights, captured (``TrainLoop``'s defaults: one CUDA
    graph of the step over the donated state): 30 steps whose loss falls,
    that launch no kernel and whose graph holds no node of kernels 3-5, in
    one capture and 29 replays; ms a step (median of steps 4-30), the
    first call's ms (warm-up and capture), tokens/s, peak memory allocated
    and reserved, the graph's kernel nodes, and the device's busy share of
    one traced replay.  Returns the record, a clone of the state after step
    30 (the traced replay moves the donated state on to step 31) and the
    losses and grad norms."""
    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch.train import build_loop
    from repro_torch.serve.graphs import CudaGraphStep

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    S, B, steps = TRAIN["seq_len"], TRAIN["batch"], TRAIN["steps"]
    published = get_shape(TRAIN["shape"])
    print(f"[train] {TRAIN['arch']} at {TRAIN['shape']}'s seq {published.seq_len}, batch cut "
          f"from {published.global_batch} to {B}", flush=True)
    loop, _ = build_loop(TRAIN["arch"], full=True, seq_len=S, batch=B, steps=steps,
                         lr=TRAIN["lr"], log_every=0, device=device)
    if not isinstance(loop.step_fn, CudaGraphStep):
        raise AssertionError(f"train: build_loop's step on the card is {loop.step_fn}, not a "
                             f"CudaGraphStep")
    t0 = time.perf_counter()
    state, counts = _counted(lambda: loop.run(torch.Generator(device).manual_seed(0)))
    run_s = time.perf_counter() - t0
    if any(_ml_launches(counts).values()):
        raise AssertionError(f"train: the 30 steps launched kernels {counts}; want none")
    losses = [h["loss"] for h in loop.history]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if len(losses) != steps or not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"train: loss did not fall: first 5 {first}, last 5 {last}")
    graph = loop.step_fn
    (key,) = graph.graphs
    replays = graph.graphs[key].replays
    nodes = graph.kernels(key)
    node_launches = graph.launches(key)
    if len(graph.captures) != 1 or replays != steps - 1:
        raise AssertionError(f"train: {len(graph.captures)} captures and {replays} replays; "
                             f"want 1 and {steps - 1}")
    if node_launches:  # the XLA route: no kernel of the repository in the step
        raise AssertionError(f"train: the step's graph holds kernels {node_launches}")
    step_ms = statistics.median(h["step_time"] for h in loop.history[3:]) * 1e3
    peak = {"allocated": torch.cuda.max_memory_allocated(device) / 1e9,
            "reserved": torch.cuda.max_memory_reserved(device) / 1e9}
    gc.collect()  # what stays allocated between steps: the state, the graph's outputs
    between = torch.cuda.memory_allocated(device) / 1e9
    state_gb = sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9
    kept = tree_map(lambda t: t.clone(), state)  # step 30's, for (d)
    batch = _train_batch(loop.model.cfg, S, B, steps, device)
    split = _device_split(lambda: (loop.step_fn(state, batch), torch.cuda.synchronize()),
                          kernels=())
    if int(state.step) != steps + 1 or int(kept.step) != steps:
        raise AssertionError(f"train: donated state at step {int(state.step)}, kept "
                             f"{int(kept.step)}")
    rec = {"model": TRAIN["arch"], "layers": loop.model.cfg.n_layers,
           "d_model": loop.model.cfg.d_model, "dtype": loop.model.cfg.dtype,
           "master_dtype": "float32", "attn_impl": loop.model.ex.attn_impl,
           "remat": loop.model.ex.remat, "params": loop.model.n_params(),
           "seq_len": S, "batch": B, "published_batch": published.global_batch,
           "steps": steps, "jit": True, "donate": True, "captures": len(graph.captures),
           "replays": replays, "first_call_ms": loop.history[0]["step_time"] * 1e3,
           "capture_ms": graph.captures[0]["ms"], "kernel_nodes": len(nodes),
           "node_launches": node_launches,
           "loss_first5_mean": first, "loss_last5_mean": last,
           "losses": losses, "run_s": run_s, "ms_per_step_median_4_30": step_ms,
           "tokens_per_s": B * S / (step_ms / 1e3),
           "card_gb_peak": peak["allocated"], "card_gb_peak_reserved": peak["reserved"],
           "card_gb_between_steps": between, "state_gb": state_gb,
           "launches": counts, "device_us_one_step": split}
    print("[train] " + json.dumps(rec), flush=True)
    out = {"rec": rec, "state": kept, "batch": batch, "cfg": loop.model.cfg,
           "grad_norms": [h["grad_norm"] for h in loop.history]}
    del loop, graph, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_eager(device, trained: dict) -> dict:
    """(b') ``TrainLoop(jit=False)`` over (b)'s model, optimizer and batches
    for TRAIN_EAGER["steps"] steps from the same seed: each loss and grad
    norm within rel_tol of the captured run's; bitwise reported; its ms a
    step (median of steps 4-8) and peak memory beside the captured ones."""
    import dataclasses

    import torch

    from repro_torch.launch.train import build_loop
    from repro_torch.serve.graphs import CudaGraphStep
    from repro_torch.train import TrainLoop

    S, B, n = TRAIN["seq_len"], TRAIN["batch"], TRAIN_EAGER["steps"]
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device) / 1e9  # (b)'s state, kept for (d)
    proto, _ = build_loop(TRAIN["arch"], full=True, seq_len=S, batch=B, steps=TRAIN["steps"],
                          lr=TRAIN["lr"], log_every=0, device=device)
    loop = TrainLoop(proto.model, proto.optimizer, proto.batch_fn,
                     dataclasses.replace(proto.config, total_steps=n), jit=False)
    if isinstance(loop.step_fn, CudaGraphStep):
        raise AssertionError("train eager: TrainLoop(jit=False) captured its step")
    _, counts = _counted(lambda: loop.run(torch.Generator(device).manual_seed(0)))
    if any(_ml_launches(counts).values()):
        raise AssertionError(f"train eager: the steps launched kernels {counts}")
    got = {"loss": [h["loss"] for h in loop.history],
           "grad_norm": [h["grad_norm"] for h in loop.history]}
    want = {"loss": trained["rec"]["losses"][:n], "grad_norm": trained["grad_norms"][:n]}
    rel = max(abs(g - w) / abs(w) for k in got for g, w in zip(got[k], want[k], strict=True))
    rec = {"model": TRAIN["arch"], "seq_len": S, "batch": B, "steps": n, "jit": False,
           "losses": got["loss"], "grad_norms": got["grad_norm"],
           "rel_diff_vs_captured": rel, "rel_tol": TRAIN_EAGER["rel_tol"],
           "bitwise_vs_captured": got == want,
           "ms_per_step_median_4_8": statistics.median(
               h["step_time"] for h in loop.history[3:]) * 1e3,
           "captured_ms_per_step_median_4_30": trained["rec"]["ms_per_step_median_4_30"],
           "first_call_ms": loop.history[0]["step_time"] * 1e3,
           "card_gb_peak": torch.cuda.max_memory_allocated(device) / 1e9,
           "card_gb_peak_reserved": torch.cuda.max_memory_reserved(device) / 1e9,
           "card_gb_held_before": held, "launches": counts}
    print("[train-eager] " + json.dumps(rec), flush=True)
    if not rel <= TRAIN_EAGER["rel_tol"] or len(got["loss"]) != n:
        raise AssertionError(f"train eager: jit=False differs from the captured run by {rel} "
                             f"(tolerance {TRAIN_EAGER['rel_tol']})")
    del loop, proto
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_resume(device) -> dict:
    """(c) 10 captured steps, a checkpoint, and a fresh captured TrainLoop
    resumed to 20, against 20 captured steps straight through: params
    bitwise equal (the largest difference reported); each loop one
    capture, the other steps replays."""
    import tempfile

    import torch

    from repro_torch._tree import leaves
    from repro_torch.launch.train import build_loop
    from repro_torch.serve.graphs import CudaGraphStep

    def replays(loop) -> list:
        if not isinstance(loop.step_fn, CudaGraphStep):
            raise AssertionError(f"resume: the loop's step is {loop.step_fn}")
        return [len(loop.step_fn.captures)] + [e.replays for e in loop.step_fn.graphs.values()]

    kw = dict(full=True, seq_len=TRAIN_RESUME["seq_len"], batch=TRAIN_RESUME["batch"],
              steps=TRAIN_RESUME["steps"], lr=TRAIN["lr"], log_every=0, device=device)
    half = TRAIN_RESUME["steps"] // 2
    straight, _ = build_loop(TRAIN["arch"], **kw)
    state_a = straight.run(torch.Generator(device).manual_seed(1))
    with tempfile.TemporaryDirectory() as ck:
        first, _ = build_loop(TRAIN["arch"], ckpt_dir=ck, **kw)
        first.config.total_steps = first.config.ckpt_every = half
        first.run(torch.Generator(device).manual_seed(1))
        resumed, _ = build_loop(TRAIN["arch"], ckpt_dir=ck, **kw)
        state_b = resumed.run(torch.Generator(device).manual_seed(2))
    if int(resumed.history[0]["step"]) != half:
        raise AssertionError(f"resume: started at step {resumed.history[0]['step']}")
    graphs = {"straight": replays(straight), "first": replays(first),
              "resumed": replays(resumed)}
    want = {"straight": [1, TRAIN_RESUME["steps"] - 1], "first": [1, half - 1],
            "resumed": [1, half - 1]}
    if graphs != want:
        raise AssertionError(f"resume: [captures, replays] {graphs}; want {want}")
    pairs = list(zip(leaves(state_a.params), leaves(state_b.params), strict=True))
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    rec = {"model": TRAIN["arch"], "seq_len": TRAIN_RESUME["seq_len"],
           "batch": TRAIN_RESUME["batch"], "steps": TRAIN_RESUME["steps"], "jit": True,
           "captures_replays": graphs,
           "resumed_at": resumed.history[0]["step"], "max_abs_param_diff": diff,
           "bitwise": all(torch.equal(a, b) for a, b in pairs),
           "loss_straight_vs_resumed_last": [straight.history[-1]["loss"],
                                             resumed.history[-1]["loss"]]}
    print("[train-resume] " + json.dumps(rec), flush=True)
    if not rec["bitwise"]:
        raise AssertionError(f"resume: params not bitwise equal, differ by up to {diff}")
    del straight, first, resumed, state_a, state_b, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_route(device, trained: dict) -> dict:
    """(d) The route is the caller's, at (b)'s state after step 30 (a
    clone): Model.loss under no_grad on attn_impl="pallas" launches kernel
    3 once a layer and agrees with the "xla" route's loss within the bf16
    tolerance; the (eager) train step on the "pallas" route raises the
    wrapper's error.  Kernel 3 is also timed at this shape beside its plain
    version and SDPA."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import ExecConfig, Model
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    cfg, state, batch = trained["cfg"], trained["state"], trained["batch"]
    pallas = Model(cfg, ExecConfig(attn_impl="pallas", remat="full"), params={}, device=device)
    xla = Model(cfg, ExecConfig(attn_impl="xla", remat="full"), params={}, device=device)
    with torch.no_grad():
        (loss_k, _), counts = _counted(lambda: pallas.loss(state.params, batch))
        loss_x, _ = xla.loss(state.params, batch)
    want = {"flash_attention": cfg.n_layers, "ssd_scan": 0, "rglru_scan": 0}
    rel = abs(float(loss_k) - float(loss_x)) / abs(float(loss_x))
    try:
        make_train_step(pallas, AdamW(TRAIN["lr"]))(state, batch)
    except RuntimeError as e:
        if 'attn_impl="xla"' not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError("train route: the step on attn_impl='pallas' did not raise")
    timing = _time_attention((TRAIN["batch"], TRAIN["seq_len"], TRAIN["seq_len"], cfg.n_heads,
                              cfg.n_kv_heads, cfg.resolved_head_dim, True, 0), device, 41)
    rec = {"model": cfg.name, "seq_len": TRAIN["seq_len"], "batch": TRAIN["batch"],
           "pallas_route_launches": counts, "loss_pallas_route": float(loss_k),
           "loss_xla_route": float(loss_x), "rel_diff": rel, "rel_tol": TRAIN_ROUTE_TOL,
           "grad_step_refused": refused, "flash_attention_at_train_shape": timing}
    print("[train-route] " + json.dumps(rec), flush=True)
    if _ml_launches(counts) != want or counts["flash_attention_mma"] != cfg.n_layers:
        raise AssertionError(f"train route: no-grad pallas loss launched {counts}; want {want}, "
                             f"all on the tensor-core kernel")
    if not rel <= TRAIN_ROUTE_TOL:
        raise AssertionError(f"train route: pallas vs xla loss differ by {rel}")
    return rec


def _state_diff(got, want) -> tuple[bool, float]:
    """Two train states (and their losses and grad norms, appended), leaf
    by leaf on ``got``'s device: bitwise equal, and the largest absolute
    difference."""
    import torch

    from repro_torch._tree import leaves

    same, worst = True, 0.0
    for a, b in zip(leaves(got), leaves(want), strict=True):
        b = torch.as_tensor(b).to(a.device)
        same = same and a.dtype == b.dtype and torch.equal(a, b)
        if a.numel():
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    return same, worst


def phase_train_determinism(device) -> dict:
    """(e) moonshot-v1-16b-a3b at full width, cut to 2 layers, bf16 on
    float32 masters, under both MoE layouts: 4 captured steps straight;
    two replays of that loop's graph from one state (step 4's, copied back
    into the graph's donated inputs before each); 2 captured steps, a
    checkpoint and a fresh captured loop resumed to 4 against the straight
    run.  Each pair bitwise equal in every leaf of the state and every loss
    and grad norm; the largest difference reported."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import make_batch_fn
    from repro_torch.models import ExecConfig, Model
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.serve.graphs import CudaGraphStep
    from repro_torch.train import TrainLoop, TrainLoopConfig

    D = TRAIN_DETERMINISM
    cfg = dataclasses.replace(get_arch(D["arch"]), n_layers=D["layers"])
    S, B, n = D["seq_len"], D["batch"], D["steps"]
    batch_fn = make_batch_fn(cfg, InputShape("chip", S, B, "train"))
    out = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "master_dtype": "float32", "seq_len": S, "batch": B}
    for impl in ("vmap", "batched"):
        model = Model(cfg, ExecConfig(attn_impl="xla", remat=cfg.remat, moe_impl=impl),
                      params={}, device=device)
        opt = AdamW(linear_warmup_cosine(D["lr"], 1, n))

        def loop(steps: int, ckpt_dir: str = "") -> TrainLoop:
            lp = TrainLoop(model, opt, batch_fn, TrainLoopConfig(
                total_steps=steps, ckpt_every=0, log_every=0, ckpt_dir=ckpt_dir), jit=True)
            if not isinstance(lp.step_fn, CudaGraphStep):
                raise AssertionError(f"train determinism: the loop's step is {lp.step_fn}")
            return lp

        def metrics(lp, steps) -> list:
            return [torch.tensor([h["loss"], h["grad_norm"]], dtype=torch.float64)
                    for h in lp.history if h["step"] in steps]

        def on(raw: dict) -> dict:
            return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                    for k, v in raw.items()}

        straight = loop(n)
        state = straight.run(torch.Generator(device).manual_seed(3))
        # step n's state, on the host (the card holds the state and the
        # graph's pool, and no third copy): the replays below start from it
        # and the resume ends at it
        kept = tree_map(lambda t: t.cpu(), state)
        batch = on(batch_fn(n))
        runs = []
        for _ in range(2):
            torch._foreach_copy_(leaves(state), leaves(kept))  # the graph's donated inputs
            r, m = straight.step_fn(state, batch)  # a replay, in place
            tail = [torch.tensor([float(m["loss"]), float(m["grad_norm"])], dtype=torch.float64)]
            runs.append((r, tail) if runs else (tree_map(lambda t: t.cpu(), r), tail))
        replays_same, replays_diff = _state_diff(runs[1], runs[0])
        graphs = [len(straight.step_fn.captures),
                  *(e.replays for e in straight.step_fn.graphs.values())]
        want_metrics = metrics(straight, range(n // 2, n))
        del straight, state, r, runs
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as ck:
            head = loop(n // 2, ck)
            head.run(torch.Generator(device).manual_seed(3))
            del head
            gc.collect()
            torch.cuda.empty_cache()
            resumed = loop(n, ck)
            state_b = resumed.run(torch.Generator(device).manual_seed(99))
        if int(resumed.history[0]["step"]) != n // 2:
            raise AssertionError(f"train determinism: resumed at {resumed.history[0]['step']}")
        resume_same, resume_diff = _state_diff(
            (state_b, metrics(resumed, range(n // 2, n))), (kept, want_metrics))
        out[impl] = {"captures_replays": graphs,
                     "resumed_captures_replays": [len(resumed.step_fn.captures),
                                                  *(e.replays for e in
                                                    resumed.step_fn.graphs.values())],
                     "replays_bitwise": replays_same, "replays_max_abs_diff": replays_diff,
                     "resume_bitwise": resume_same, "resume_max_abs_diff": resume_diff,
                     "losses": [float(m[0]) for m in want_metrics]}
        del resumed, state_b, kept, model
        gc.collect()
        torch.cuda.empty_cache()
    print("[train-determinism] " + json.dumps(out), flush=True)
    for impl in ("vmap", "batched"):
        r = out[impl]
        if not (r["replays_bitwise"] and r["resume_bitwise"]):
            raise AssertionError(f"train determinism ({impl}): replays bitwise "
                                 f"{r['replays_bitwise']} (up to {r['replays_max_abs_diff']}), "
                                 f"resume bitwise {r['resume_bitwise']} "
                                 f"(up to {r['resume_max_abs_diff']})")
        if r["captures_replays"] != [1, n + 1] or r["resumed_captures_replays"] != [1, n // 2 - 1]:
            raise AssertionError(f"train determinism ({impl}): [captures, replays] "
                                 f"{r['captures_replays']}, {r['resumed_captures_replays']}")
    return out


def _dryrun_job(job: tuple) -> dict:
    """One phase-15 trace, run in a process of its own (no card): a
    full-size dry-run cell, a reduced (4, 2) train cell, or a plain
    one-device trace of a step the card times (phases 10 and 14)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import ExecConfig
    from repro_torch.roofline import roofline_terms
    from repro_torch.sharding import PRESETS

    kind, arch, shape = job
    t0 = time.perf_counter()
    if kind == "cell":
        shape, mesh, moe_impl = shape
        ex = ExecConfig(remat=get_arch(arch).remat, attn_impl="xla", moe_impl=moe_impl)
        row = dryrun.dryrun_cell(arch, shape, mesh, ex=ex, verbose=False)
        row["moe_impl"] = moe_impl
    else:
        cfg = get_arch(arch)
        if kind == "small":
            cfg = cfg.reduced()
            with fake_world(8):
                mesh = make_mesh((4, 2), ("data", "model"))
                costs, trace_s = dryrun.trace_cell(cfg, InputShape("t", 32, 8, "train"), mesh,
                                                   PRESETS["fsdp_tp_sp"],
                                                   ex=ExecConfig(remat="full", attn_impl="xla"))
        else:  # "step": one device, plain meta tensors
            S, B, k = shape
            costs, trace_s = dryrun.trace_cell(cfg, InputShape("chip", S, B, k))
        terms = roofline_terms(costs.flops, costs.bytes, costs.total_coll_bytes)
        row = {"arch": arch, "flops_per_device": costs.flops, "dot_flops_per_device":
               costs.dot_flops, "hbm_bytes_per_device": costs.bytes,
               "coll_bytes_per_device": costs.total_coll_bytes, "coll_per_op": costs.coll_bytes,
               "arg_bytes": costs.arg_bytes, "temp_bytes": costs.peak_bytes,
               "out_bytes": costs.out_bytes, "trace_s": trace_s,
               **{f"{t}_s": v for t, v in terms.items()}}
        if kind == "step":
            row["model_flops"] = dryrun._model_flops(cfg, InputShape("chip", S, B, k))
    row["job"], row["wall_s"] = list(job), time.perf_counter() - t0
    return row


def _dtensor_step(step, mesh, rules, model, state, batch, device) -> tuple[dict, int]:
    """One train step with ``state`` and ``batch`` placed on the card as
    DTensors (tensors already there keep their storage) under
    activation_sharding: its loss and grad norm, and the card's allocation
    growth from placing them."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_map
    from repro_torch.sharding import activation_sharding, batch_axes_tree, tree_shardings
    from repro_torch.train.step import train_state_axes

    def place(tree, axes):
        pl = tree_shardings(tree, axes, mesh, rules)
        return tree_map(lambda t, p: DTensor.from_local(t.to(device), mesh, p, run_check=False),
                        tree, pl)

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    d_state = place(state, train_state_axes(model))
    d_batch = place(batch, batch_axes_tree(batch))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before

    def sharded():
        with activation_sharding(mesh, rules):
            return step(d_state, d_batch)

    (_, metrics), counts = _counted(sharded)
    if any(_ml_launches(counts).values()):
        raise AssertionError(f"mesh check {model.cfg.name}: the DTensor step launched kernels "
                             f"{counts}")
    return {k: float(metrics[k].full_tensor()) for k in ("loss", "grad_norm")}, grown


def _mesh_record(name: str, cfg, ex, S: int, B: int, got: dict, want: dict, **extra) -> dict:
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in got}
    rec = {"model": cfg.name, "layers": cfg.n_layers, "moe_impl": ex.moe_impl,
           "dtype": "float32", "mesh": [1, 1], "backend": "nccl", "seq_len": S, "batch": B,
           "dtensor": got, "plain": want, "rel_diff": rel, "rel_tol": MESH_CHECK["rel_tol"],
           **extra}
    print(f"[{name}] " + json.dumps(rec), flush=True)
    if max(rel.values()) > MESH_CHECK["rel_tol"] or not all(np.isfinite(list(got.values()))):
        raise AssertionError(f"mesh check {cfg.name}: DTensor step vs plain differ by {rel}")
    return rec


def phase_mesh_one_device(device) -> dict:
    """(b) A world-1 NCCL group and a (1, 1) mesh on the card: one float32
    AdamW step of full-width smollm-135m (phase 14 (a)'s seq and batch)
    with the train state and batch as DTensors under activation_sharding,
    against the same step on plain tensors (loss and grad norm within
    rel_tol), and the dry-run's per-device argument bytes for this cell on
    this mesh against the card's allocation growth from placing the state
    and batch (within bytes_rel_tol); then the same step of full-width
    moonshot-v1-16b-a3b cut to MESH_MOE_LAYERS layers under
    moe_impl="batched", its state drawn on the card."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ExecConfig, Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import PRESETS
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_arch(TRAIN["arch"]), dtype="float32")
    ex = ExecConfig(attn_impl="xla", remat="full")
    opt = AdamW(TRAIN_CHECK["lr"])
    S, B = TRAIN_CHECK["seq_len"], TRAIN_CHECK["batch"]
    model = Model(cfg, ex, params={}, device=device)
    host = init_train_state(Model(cfg, ex, params={}, device="cpu"), opt,
                            torch.Generator().manual_seed(0))
    batch = _train_batch(cfg, S, B, 0, "cpu")
    rules = PRESETS["fsdp_tp_sp"]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        costs, _ = trace_cell(cfg, InputShape("chip", S, B, "train"), mesh, rules, ex=ex)
        step = make_train_step(model, opt)
        got, grown = _dtensor_step(step, mesh, rules, model, host, batch, device)
        _, p_metrics = step(tree_map(lambda t: t.to(device), host), _on(batch, device))
        want = {k: float(p_metrics[k]) for k in ("loss", "grad_norm")}
        bytes_rel = abs(grown - costs.arg_bytes) / costs.arg_bytes
        rec = _mesh_record("mesh-1", cfg, ex, S, B, got, want,
                           dryrun_arg_bytes=costs.arg_bytes, allocated_growth_bytes=grown,
                           bytes_rel_diff=bytes_rel)
        if bytes_rel > MESH_CHECK["bytes_rel_tol"]:
            raise AssertionError(f"mesh check: dry-run arg_bytes {costs.arg_bytes} vs allocated "
                                 f"{grown} ({bytes_rel:.4f} apart)")
        del host, p_metrics
        gc.collect()
        torch.cuda.empty_cache()

        moe_cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"), dtype="float32",
                                      n_layers=MESH_MOE_LAYERS)
        moe_ex = ExecConfig(attn_impl="xla", remat="full", moe_impl="batched")
        moe_model = Model(moe_cfg, moe_ex, params={}, device=device)
        moe_state = init_train_state(moe_model, opt, torch.Generator(device).manual_seed(0))
        moe_batch = _on(_train_batch(moe_cfg, S, B, 0, "cpu"), device)
        moe_step = make_train_step(moe_model, opt)
        got, _ = _dtensor_step(moe_step, mesh, rules, moe_model, moe_state, moe_batch, device)
        _, p_metrics = moe_step(moe_state, moe_batch)
        rec["moe"] = _mesh_record("mesh-1-moe", moe_cfg, moe_ex, S, B, got,
                                  {k: float(p_metrics[k]) for k in ("loss", "grad_norm")})
        del moe_state, p_metrics
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec


def _share(name: str, row: dict, ms: float, card: str) -> dict:
    """A timed step's shares of the H100 SXM bf16 dense peak from its traced
    per-device FLOPs and its measured time."""
    s = ms / 1e3
    rec = {"step": name, "card": card, "ms": ms, "traced_flops": row["flops_per_device"],
           "traced_dot_flops": row["dot_flops_per_device"], "model_flops": row["model_flops"],
           "achieved_tflops": row["flops_per_device"] / s / 1e12,
           "mfu": row["model_flops"] / (s * BF16_OPS_PER_S),
           "traced_share_of_peak": row["flops_per_device"] / (s * BF16_OPS_PER_S),
           "peak_flops": BF16_OPS_PER_S}
    print("[shares] " + json.dumps(rec), flush=True)
    return rec


def phase_dryrun(device, train_ms: float, prefill_ms: float, card: str) -> dict:
    """Phase 15: (a) the dry-run's traces in processes of their own, started
    together, while (b) runs on the card; then (c) the shares of phase 14's
    train step and phase 10's smollm-135m prefill."""
    import multiprocessing

    jobs = ([("small", a, None) for a in DRYRUN_SMALL]
            + [("cell", a, rest) for a, *rest in DRYRUN_CELLS]
            + [("step", TRAIN["arch"], (TRAIN["seq_len"], TRAIN["batch"], "train")),
               ("step", "smollm-135m", (SERVE["prompt"], SERVE["batch"], "prefill"))])
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        pending = pool.map_async(_dryrun_job, jobs)
        mesh = phase_mesh_one_device(device)
        rows = pending.get(timeout=900)
    wall = time.perf_counter() - t0
    for row in rows:
        kind = row["job"][0]
        if row.get("status", "OK") != "OK":
            raise AssertionError(f"dry-run {row['job']}: {row}")
        if not (row["flops_per_device"] > 0 and row["arg_bytes"] > 0):
            raise AssertionError(f"dry-run {row['job']}: no work or no arguments: {row}")
        if kind != "step" and not row["coll_bytes_per_device"] > 0:
            raise AssertionError(f"dry-run {row['job']}: sharded, but no collective: {row}")
        row["terms_against"] = "V5E, the JAX package's modelled TPU v5e fleet: not a measurement"
        print("[dryrun] " + json.dumps(row), flush=True)
    cells = {(r["arch"], r["shape"], r["mesh"], r["moe_impl"]): r
             for r in rows if r["job"][0] == "cell"}
    moe = _moe_layouts(cells)
    f3 = _against_torch_213(cells[("smollm-135m", "train_4k", "single", "vmap")])
    steps = [r for r in rows if r["job"][0] == "step"]
    shares = [_share("train step (phase 14)", steps[0], train_ms, card),
              _share("smollm-135m prefill (phase 10)", steps[1], prefill_ms, card)]
    print(f"[dryrun] phase 15 wall {wall:.1f} s", flush=True)
    return {"rows": rows, "mesh": mesh, "shares": shares, "wall_s": wall, "moe": moe, "f3": f3}


def _moe_layouts(cells: dict) -> dict:
    """moonshot-v1-16b-a3b x train_4k under both MoE layouts, side by side:
    FLOPs a device, the useful share (6ND/256 over them), collective bytes
    by op, argument and peak live bytes; "batched" within its bound."""
    rec = {}
    for impl in ("vmap", "batched"):
        r = cells[("moonshot-v1-16b-a3b", "train_4k", "single", impl)]
        rec[impl] = {"flops_per_device": r["flops_per_device"],
                     "useful_share": r["useful_flops_frac"], "coll_per_op": r["coll_per_op"],
                     "arg_bytes": r["arg_bytes"], "peak_live_bytes": r["temp_bytes"]}
    gain = rec["vmap"]["flops_per_device"] / rec["batched"]["flops_per_device"]
    rec["vmap_over_batched_flops"] = gain
    print("[dryrun-moe] " + json.dumps(rec), flush=True)
    if not (rec["batched"]["flops_per_device"] <= MOE_BATCHED_MAX_FLOPS
            and gain >= MOE_BATCHED_MIN_GAIN):
        raise AssertionError(f"moe_impl='batched': {rec['batched']['flops_per_device']:.4g} "
                             f"FLOPs a device, {gain:.2f}x fewer than 'vmap'; want at most "
                             f"{MOE_BATCHED_MAX_FLOPS:.1e} and {MOE_BATCHED_MIN_GAIN}x")
    return rec


def _against_torch_213(row: dict) -> dict:
    """This host's counts of smollm-135m x train_4k beside torch 2.13's
    (F3_TORCH_213), each with its relative difference, at most F3_REL_TOL
    (a count that is 0 there must be 0 here)."""
    import torch

    here = {"flops": row["flops_per_device"], "bytes": row["hbm_bytes_per_device"],
            "peak_bytes": row["temp_bytes"],
            **{f"coll_{op}": b for op, b in row["coll_per_op"].items()}}
    rec = {"torch": torch.__version__, "against": "2.13 (F3_TORCH_213)",
           **{k: {"here": v, "torch_213": F3_TORCH_213[k],
                  "rel": (v - F3_TORCH_213[k]) / F3_TORCH_213[k] if F3_TORCH_213[k] else
                  float(v != 0)}
              for k, v in here.items()}}
    print("[dryrun-f3] " + json.dumps(rec), flush=True)
    off = {k: v["rel"] for k, v in rec.items()
           if isinstance(v, dict) and not abs(v["rel"]) <= F3_REL_TOL}
    if off or set(here) != set(F3_TORCH_213):
        raise AssertionError(f"smollm-135m x train_4k on torch {torch.__version__}: counts "
                             f"{off} off torch 2.13's by more than {F3_REL_TOL}, or keys "
                             f"{sorted(set(here) ^ set(F3_TORCH_213))} unmatched")
    return rec



def _kernel_row(name: str, replaces: str, rec: dict, launches: int) -> dict:
    """A kernel's entry on the final ``kernels`` line: its source, the TPU
    code it stands for, its launches on the main path, and its phase's
    error, times and bound."""
    sources = {"flash_attention": "flash_attention_mma", "ssd_scan": "ssd_scan_mma"}
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces, "launches": launches,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


def main() -> int:
    import torch

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_build()
    device = torch.device("cuda", 0)
    timing = phase_kernel_vs_plain(device)
    timing_batch = phase_batch_kernel_vs_plain(device)
    timing_flash = phase_flash_vs_plain(device)
    phase_flash_new_shapes(device)
    timing_decode = phase_decode_vs_plain(device)
    timing_mla = phase_mla_decode_vs_plain(device)
    mla_replay = phase_mla_replay(device)
    timing_rotary = phase_rotary_vs_plain(device)
    timing_ssd = phase_ssd_vs_plain(device)
    timing_rglru = phase_rglru_vs_plain(device)

    launches = {}
    for name, run in (
        ("example1", lambda: phase_example1("cuda")),
        ("deep", lambda: phase_deep("cuda")),
        ("options", lambda: phase_options("cuda")),
    ):
        _, counts = _counted(run)
        launches[name] = counts["placement_sweep"]
        if launches[name] <= 0:
            raise AssertionError(f"main path '{name}' launched placement_sweep {launches[name]} times")
    print(f"[launches] placement_sweep per schedule() phase: {json.dumps(launches)}", flush=True)
    many_launches = {
        "many_block16": phase_many("cuda", 16)["launches_two_runs"]["placement_sweep_batch"],
        "many_ramp": phase_many("cuda", None)["launches_two_runs"]["placement_sweep_batch"],
        "many_options": phase_options_many("cuda")["placement_sweep_batch"],
    }
    print(f"[launches] placement_sweep_batch per schedule_many phase: "
          f"{json.dumps(many_launches)}", flush=True)

    # phase 13: fleet planning (launch.schedule, variants) on kernel 1
    fleet_launches = phase_fleet()["launches"]
    print(f"[launches] placement_sweep per fleet-planning run: {json.dumps(fleet_launches)}",
          flush=True)

    # phase 12: the service path; kernel 1 in the warm replans, the trace's
    # service calls and fault injection, kernel 2 in what_if_many
    legs = phase_replan_legs("cuda")
    churn = phase_churn_trace("cuda")
    resil = phase_resilience("cuda")
    what_if = phase_what_if("cuda")
    service_launches = {
        **{f"warm_{k}": v["warm_launches"] for k, v in legs.items()},
        "trace": churn["launches"], **resil["launches"],
        "what_if_many": what_if["launches_two_runs"]["placement_sweep_batch"]}
    print("[service] " + json.dumps({
        "launches": service_launches,
        "legs_ms": {k: {"record": v["record_ms"], "warm": statistics.median(v["warm_ms"]),
                        "cold": statistics.median(v["cold_ms"]),
                        "warm_over_cold": v["warm_over_cold"],
                        "warm_launches_a_run": v["warm_launches_a_run"],
                        "warm_probe_rows": v["warm_walk"]["probe_rows"]}
                    for k, v in legs.items()},
        "warm_hit_rate": churn["warm_hit_rate"],
        "events_per_s_latency_wall_cold": [churn["events_per_s_warm"],
                                           churn["events_per_s_warm_wall"],
                                           churn["events_per_s_cold"]],
        "fault_misses_k1_k2": [sum(resil["misses_k1"]), sum(resil["misses_k2"])]}), flush=True)

    serve = {name: phase_serve(name, device) for name in SERVE_MODELS}
    traced = {n: [r["jit_true"]["launches"], r["jit_false"]["launches"]]
              for n, r in serve.items()}
    print(f"[launches] a traced generate's, jit=True (its prefill graph's kernel nodes) and "
          f"jit=False (the wrappers'): "
          f"{json.dumps(traced)}", flush=True)
    for name in SERVE_MODELS:
        phase_serve_check(name, device)

    # phase 14: training (no kernel inside the steps; kernel 3 in (d)'s
    # no-grad loss on the "pallas" route)
    train_check = phase_train_check(device)
    trained = phase_train(device)
    train_eager = phase_train_eager(device, trained)
    train_resume = phase_train_resume(device)
    train_route = phase_train_route(device, trained)
    del trained["state"]
    gc.collect()
    torch.cuda.empty_cache()
    train_determinism = phase_train_determinism(device)
    print("[train-summary] " + json.dumps({
        "card": card, "ms_per_step": trained["rec"]["ms_per_step_median_4_30"],
        "ms_per_step_eager": train_eager["ms_per_step_median_4_8"],
        "first_call_ms": trained["rec"]["first_call_ms"],
        "tokens_per_s": trained["rec"]["tokens_per_s"],
        "card_gb_peak": trained["rec"]["card_gb_peak"],
        "card_gb_peak_reserved": trained["rec"]["card_gb_peak_reserved"],
        "card_gb_peak_eager_less_held": train_eager["card_gb_peak"]
        - train_eager["card_gb_held_before"],
        "card_gb_between_steps": trained["rec"]["card_gb_between_steps"],
        "kernel_nodes": trained["rec"]["kernel_nodes"],
        "device_busy_share": trained["rec"]["device_us_one_step"].get("device_busy_share"),
        "loss_first5_last5": [trained["rec"]["loss_first5_mean"],
                              trained["rec"]["loss_last5_mean"]],
        "card_vs_cpu_rel": train_check["rel_diff"],
        "captured_vs_eager_f32": [train_check["captured_vs_eager"]["rel_diff"],
                                  train_check["captured_vs_eager"]["max_leaf_rel_diff"],
                                  train_check["captured_vs_eager"]["bitwise"]],
        "eager_vs_captured_bf16": [train_eager["rel_diff_vs_captured"],
                                   train_eager["bitwise_vs_captured"]],
        "resume_max_abs_diff": train_resume["max_abs_param_diff"],
        "resume_bitwise": train_resume["bitwise"],
        "moonshot_2_layers_bitwise": {
            impl: [train_determinism[impl]["replays_bitwise"],
                   train_determinism[impl]["resume_bitwise"]] for impl in ("vmap", "batched")},
        "route_launches": train_route["pallas_route_launches"]["flash_attention"]}), flush=True)

    # phase 15: the dry-run (host traces) and a 1-device mesh on the card
    dry = phase_dryrun(device, trained["rec"]["ms_per_step_median_4_30"],
                       statistics.median(serve["smollm-135m"]["prefill_ms"]), card)
    print("[dryrun-summary] " + json.dumps({
        "card": card, "wall_s": dry["wall_s"],
        "mesh_1_rel_diff": dry["mesh"]["rel_diff"],
        "mesh_1_bytes_rel_diff": dry["mesh"]["bytes_rel_diff"],
        "mesh_1_moe_batched_rel_diff": dry["mesh"]["moe"]["rel_diff"],
        "moe_flops_vmap_batched": [dry["moe"][k]["flops_per_device"] for k in ("vmap", "batched")],
        "f3_rel": {k: v["rel"] for k, v in dry["f3"].items() if isinstance(v, dict)},
        "shares": {r["step"]: {k: r[k] for k in ("ms", "achieved_tflops", "mfu",
                                                 "traced_share_of_peak")}
                   for r in dry["shares"]}}), flush=True)
    del trained

    def served(kernel: str) -> int:  # the wrappers' launches over the counted generates
        return sum(r[jit]["launches_wrappers"][kernel] for r in serve.values()
                   for jit in ("jit_true", "jit_false"))

    # the bf16 main path's kernels
    kernels = []
    for name, replaces, rec, n in (
        ("placement_sweep", "src/repro/kernels/placement_step.py:136", timing,
         sum(launches.values()) + sum(fleet_launches.values())
         + sum(v for k, v in service_launches.items() if k != "what_if_many")),
        ("placement_sweep_batch", "src/repro/kernels/placement_step.py:267", timing_batch,
         sum(many_launches.values()) + service_launches["what_if_many"]),
        ("flash_attention", "src/repro/kernels/flash_attention.py:121", timing_flash,
         served("flash_attention_mma")
         + train_route["pallas_route_launches"]["flash_attention_mma"]),
        ("ssd_scan", "src/repro/kernels/ssd_scan.py:103", timing_ssd, served("ssd_scan_mma")),
        ("rglru_scan", "src/repro/kernels/rglru_scan.py:75", timing_rglru, served("rglru_scan")),
        # no TPU kernel: the reference's ops.flash_attention sends S == 1 to
        # chunked_attention in XLA ops
        ("decode_attention", "none (src/repro/kernels/ops.py:60)", timing_decode,
         served("decode_attention")),
        # no TPU kernel and no JAX model: latent attention is the port's alone
        ("mla_decode", "none (no latent attention in src/repro)", timing_mla,
         mla_replay["replayed"]),
        # no TPU kernel: the JAX package rotates q and k in XLA ops
        ("rotary", "none (src/repro/models/layers.py: apply_rope, apply_mrope)", timing_rotary,
         served("rotary") + mla_replay["rotary_replayed"]),
    ):
        kernels.append(_kernel_row(name, replaces, rec, n))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
