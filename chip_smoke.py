"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py

Phases, each reporting on lines of its own and its seconds; any failure
ends the script with a non-zero exit and no result line:

1. device  -- require CUDA; print ``nvidia-smi``'s name and power limit.
2. build   -- compile every CUDA kernel of the port from ``src/`` (one
              ``nvcc`` per source, all at once) and print the build time.
3. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving paths' shapes and at ragged, windowed, grouped,
              resumed, mixed-length and (scans) strongly decaying ones,
              two launches of decode and the scans on one input bitwise
              equal: bf16
              inputs (fp32 dt, A, gates
              and states for the scans), plain version in float32, stated
              tolerance; times of kernel, plain version and
              ``F.scaled_dot_product_attention`` where it computes the same
              function (a yardstick the port never calls) with CUDA events,
              and the least time the card could take for the same work.
              Flash also at whisper-large-v3's encoder (1536 frames, no
              mask), its cross attention at prefill (Sq 1024, Sk 1536) and
              in a decode step (Sq 1, where the decode kernel is timed on
              the same inputs beside it), Sq 1 over a ragged Sk and at G
              4, and pixtral-12b's prefill (S 2048, causal); yi-34b's G 7
              (56 heads over 8 of 128) at its prefill, ragged, windowed
              and unmasked, and decode at G 7 (seven of the kernel's 16
              rows a KV head).
              The flash backward against its plain formula (fp32) at
              yi-6b's training shape, the 100M example's, a ragged S, a
              window with q_offset and no mask with Sq != Sk; at head
              dim 256 (its wide kernels) at recurrentgemma-2b's training
              shape (MQA, window 2048), a window shorter than S, a ragged
              S with a q_offset and no mask with Sq != Sk; at MLA's
              pairs, minicpm3-4b's training shape (40 heads over 40, qk
              96 zero-padded to 128 beside v 64, scale 96^-0.5; the split
              kernels) and deepseek-v2-lite's (16 over 16 of (192, 128);
              the wide kernels), each pair also with a ragged S and a
              q_offset and with no mask at Sq != Sk; at whisper-large-v3's
              three training shapes ((64, 64), G 1: the encoder and cross
              attention without a mask, the decoder causal),
              pixtral-12b's (S 2048, causal, G 4) and yi-34b's (G 7: an
              odd count of a dK/dV CTA's steps), G 7 also ragged,
              windowed and unmasked: relative L2
              of dq, dk, dv within max(2e-2, 2 x the plain formula's bf16
              floor), two launches bitwise equal, the padded columns of
              dq and dk zero, the forward's lse within
              1e-3 of the plain lse and its out unchanged by asking for
              lse; times at yi-6b's, recurrentgemma-2b's, minicpm3-4b's,
              deepseek-v2-lite's, whisper-large-v3's three,
              pixtral-12b's and yi-34b's training shapes against SDPA's
              backward on the same inputs (and which of SDPA's kernels
              ran) and both bounds (the formula's five products at the
              function's own qk, the design's seven at the padded D), and
              each of its CUDA kernels' own time (delta, dK/dV, dQ and the
              wide pairs' sum of slices; torch.profiler).
              The SSD backward against its plain formula (fp32) at
              mamba2-2.7b's training shape and at G 2 and 4, chunks 64 and
              256, S equal to the chunk, an initial state and a final-state
              cotangent, strong decay and ragged P and N: each gradient
              within max(3e-2, 2 x the plain formula's bf16 floor)
              relative L2, two launches bitwise equal; its time and each of
              its CUDA kernels' (walks, chunks, reductions).
              The RG-LRU backward against its plain formula (fp32) at
              recurrentgemma-2b's training shape, ragged C and S, S 0, an
              initial state with a final-state cotangent, strong decay,
              gates near 0 and gate_a exactly 0 at a fifth of the steps
              (beta 0): dx within max(3e-2, 2 x the floor of rounding the
              plain one to bf16) relative L2 and the fp32 gradients within
              1e-4, two launches bitwise equal; its time against
              the bound of its bytes, the plain version's, and each of its
              CUDA kernels' (the scan, the reduction of d log_a).
   threefry -- the threefry kernel (jax.random's streams; it replaces no
              Pallas kernel) against its plain version on the card: raw
              bits (also past counter 2**32) and float32 uniforms bitwise,
              float32 normals (times a scale, or divided by one, stored
              in float32 or bf16) within THREEFRY_ULPS ulps and bf16
              draws (the data's patches and frames) within one bf16 ulp,
              each with its bitwise share; full-width yi-6b's init on the
              card against the plain version on the CPU on a few leaves
              (within one bf16 ulp); the kernel's time on one yi-34b
              feed-forward leaf against its bound (integer operations at
              the card's INT32 rate, or the bytes it stores) and the
              plain version's; the full-width yi-34b init with the
              kernel and with the torch.randn init it replaced, in turns
              (old, new, new, old), and its key tree (``lm.draw_keys``)
              alone; and one full-width yi-6b train block's tokens (B x
              PROMPT) drawn on the card, bitwise the plain version's on
              the CPU (and a serve prompt), as host ms to issue and
              device ms, beside the host draw copied to the card; each
              beside the card's name and power limit.
4. model   -- full-width yi-6b, mamba2-2.7b, recurrentgemma-2b, minicpm3-4b,
              deepseek-v2-lite-16b, whisper-large-v3 (prefill with 1536
              frames: the encoder, then the cross keys and values cached),
              pixtral-12b (prefill with 1024 patches before the prompt),
              yi-34b (all 60 layers, 64.1 GiB of weights; G 7) and
              mistral-nemo-12b (heads 4096 wide on a d_model of 5120,
              vocab 131072) in bf16 (random weights from a seed): prefill and 4
              decode steps (whisper's through the cached cross attention)
              through the kernels against the same weights through the
              plain versions (whisper's and pixtral's flash and decode
              launches counted against their layers); relative L2
              error of the logits against a stated bound, argmax agreement
              (in the MoE model the plain runs take the kernel run's
              experts, and the share of tokens they would have routed
              elsewhere is printed); prefill and decode-step times and
              where a decode step's device time goes.
   graphs  -- in each model phase, on its weights: a serve job's decode
              step (``core.jobs.DecodeStep``, the prompt alone) captured
              as a CUDA graph after its eager warm-up steps, the first
              block's prefill into the same caches, then 2 blocks of 8
              replays, every step's token and logits and the final caches
              bitwise the eager ``lm.decode_step`` loop's; the capture's
              seconds and a replay's launches; the step's wall ms eager
              and graphed in turns (eager, graphed, graphed, eager) and
              the device idle share of a graphed step (torch.profiler),
              beside the card's name and power limit.
5. serve   -- the serving entry point at full width on three paths, each
              with the kernels' launch counters set to 0 just before and
              read just after (a job's decode steps are graph replays,
              counted at every replay; the flash, decode, SSD and RG-LRU
              counts must equal what each job instance runs: two
              prefills, the capture's warm-up steps and its blocks'
              replays): ``--jobs yi-6b:8,yi-6b:2`` (flash and decode
              attention), ``--jobs mamba2-2.7b:8,recurrentgemma-2b:2`` (all
              four kernels) and ``--jobs minicpm3-4b:8,deepseek-v2-lite-16b:2``
              (flash at MLA's head dims; MLA decodes with plain matrix
              products, as in the JAX package), all ``--policy srtf
              --compare-fifo --batch 4 --prompt-len 1024 --tokens-per-block
              8``; every job must finish and every kernel of the path must
              have run.  A fourth path serves
              ``--jobs yi-6b:8,minicpm3-4b:4,yi-6b:8`` with ``--scenario
              poisson-open --time-scale 1e-6 --seed 0`` (Poisson
              arrivals from the scenario registry), submitting at the
              offsets 0, 0.1068 and 0.1875 s or failing.  A fifth serves
              ``--jobs pixtral-12b:8,whisper-large-v3:2`` (as the
              reference's serve job: pixtral's text path, whisper's
              decoder without frames), flash and decode attention.
              Then ``--jobs yi-34b:8,mamba2-2.7b:2`` (yi-34b at full
              width beside a short job; two yi-34b jobs, each holding
              its own weights, do not fit the card: flash, decode
              attention and the SSD scan) and ``--jobs
              mistral-nemo-12b:8,mistral-nemo-12b:2`` (flash and decode
              attention); each run's peak memory printed.
6. train   -- ``python -m repro_torch.launch.train --arch yi-6b
              --n-layers 12 --steps 6 --batch 4 --seq 1024`` (full width,
              depth cut so that fp32 weights, gradients and AdamW moments
              fit): every loss finite, one flash forward and backward
              launch per layer and step; each step's wall ms, the
              predictor's estimate and the peak memory; where a step's
              device time goes (torch.profiler).  The same at 2
              layers with a checkpoint at step 3 alone
              (``--no-final-checkpoint``), then resumed from it: the
              resumed steps bitwise equal to the uninterrupted ones (a
              checkpoint takes 31 GB at 12 layers, 10.4 GB at 2).  Then
              ``--jobs yi-6b:8,yi-6b:2 --n-layers 2`` under SRTF and FIFO,
              every job finishing, with the threefry kernel launched once
              a weight leaf part and twice a block (its tokens, drawn on
              the card) and a warm-up.  Then ``--arch mamba2-2.7b --n-layers
              56 --steps 4`` (full width, the deepest multiple of 8 layers
              that fits): every loss finite, one SSD forward and backward
              launch per layer and step, the step wall, peak memory and
              device split.  Then ``--arch recurrentgemma-2b --n-layers
              26 --steps 4`` (every layer at full width: 18 RG-LRU and 8
              local-attention layers): every loss finite, one RG-LRU
              forward and backward launch per recurrent layer and one
              flash forward and backward per local layer and step, the
              peak under 72 GiB, the step wall and device split.  Then
              ``--arch minicpm3-4b --n-layers 40 --steps 4`` and ``--arch
              deepseek-v2-lite-16b --n-layers 5 --steps 4`` (full width,
              MLA through the flash backward at (128, 64) and (192, 128);
              deepseek one dense and four MoE layers): every loss finite,
              one flash forward and backward launch per layer and step,
              the peak under 64 GiB, the step wall and device split.  Then
              ``--arch whisper-large-v3 --n-layers 32 --steps 4`` (every
              layer of both stacks, B 4 x (1024 tokens + 1536 frames)) and
              ``--arch pixtral-12b --n-layers 6 --steps 4 --seq 2048``
              (1024 patches before 1024 tokens): every loss finite, one
              flash forward and backward launch per attention layer
              (encoder, self, cross) and step, the peak under 64 GiB, the
              step wall and device split.  Then ``--arch
              deepseek-v2-lite-16b --n-layers 2 --steps 4`` twice from
              one seed (one dense and one MoE layer): every step's metrics
              bitwise equal between the runs; the second with a
              checkpoint at step 2 (``--no-final-checkpoint``: one of
              13.0 GB, in the temporary directory), then resumed from it:
              the resumed steps bitwise equal to the uninterrupted
              run's.  Then ``--arch yi-34b --n-layers 4 --steps 4``
              (full width, G 7): every loss finite, one flash forward and
              backward launch per layer and step, the peak under 64 GiB,
              the step wall and device split.  Then
              one step's gradients through the kernels against the plain
              versions, yi-6b at 12 layers, mamba2-2.7b at 16,
              recurrentgemma-2b at 9 (three (rec, rec, local) units),
              minicpm3-4b at 16 and deepseek-v2-lite-16b at 2 (one dense
              and one MoE layer, without remat; all three runs take the
              plain bf16 run's experts, and the share of routings the
              other two would have changed is printed), whisper-large-v3
              at 4 layers of each stack (the encoder's leaves included)
              and pixtral-12b at 2, each stacked leaf
              within max(5e-2, 2 x floor) relative L2 (floor: plain bf16
              vs plain fp32).
7. sharded -- the sharded steps (``launch.steps.build_step`` with a
              mesh, the ``Sharder``, every kernel inside ``local_map``)
              on a (1, 1) ``("data", "model")`` mesh of one NCCL rank (a
              HashStore: no port opened), at full width, against the
              unsharded steps on the same weights: one train step of
              yi-6b at 4 layers (nll, grad norm and every AdamW first
              moment), and prefill of B 4 x 1024 with 4 decode steps of
              yi-6b, mamba2-2.7b, recurrentgemma-2b and
              deepseek-v2-lite-16b at 3 layers with capacity factor 16
              (the expert-parallel MoE); each comparison bitwise or
              within MODEL_REL_L2 relative L2 (printed which); every
              kernel of each path launched; the one-rank log-sum-exp
              combine the identity.  The kernel phase checks the decode
              kernel's lse (-inf at length 0, ``out`` bitwise the same
              with it) and times it in turns with the kernel without it.
7b. ops   -- the seven kernels as operators (``torch.ops.repro_torch.*``):
              ``torch.library.opcheck`` on the card for every op at one
              shape per instantiation of its kernel (flash and its
              backward at every (D, Dv) pair, decode at every pair, both
              SSD scan and both RG-LRU instantiations with and without an
              initial state, the SSD backward at every (P, N) tile pair,
              both RG-LRU backward instantiations); then steps built as
              the sharded phase builds them, on a (1, 1) mesh: yi-6b's
              train and decode steps and mamba2-2.7b's and
              recurrentgemma-2b's train steps at full width, depth cut
              (TRACE_STEPS), B 4 x 1024 (recurrentgemma-2b: x 512),
              each traced by the dry-run
              (``launch.dryrun.trace_step``, both backends) in a child
              process under a fake process group, then run for real on
              both backends: the peak of allocated bytes from the
              arguments' placing on (``torch.cuda.max_memory_allocated``,
              reset once they are placed) must lie within [traced,
              traced x 1.05 + 256 MiB]; both printed with the arguments'
              bytes, real and traced, and the kernel run's launches
              (every op of the step's mixers, the backwards included).
8. scenario kernels -- ``--scenario poisson-open --scenario-kernels
              --time-scale 1e-6 --max-blocks 16``: the scenario's first
              workload (8 arrivals) as jobs of synthetic blocks on the
              card, solo baselines through a sweep cache in a temporary
              directory; run twice, the second run must measure no
              baseline.  Prints each job's turnaround and, per block
              shape, the median wall ms of one block (a CUDA graph's
              replay, captured once a shape at a job's warm-up, plus the
              synchronize the executor times) and its device ms replayed
              and eager.
9. reduced -- every arch of the zoo at ``.reduced()`` (head dim 32;
              reduced MLA's qk 48 padded to 64 beside v 32; dbrx-132b
              included), as the reference's ``make smoke`` and quickstart
              run them: prefill of B 4 x 8 tokens (whisper with its 32
              frames, pixtral after its 8 patches) and 4 decode steps in
              bf16, then one train step's gradients at B 4 x 64 tokens,
              through the kernels against the plain versions, the
              logits and each stacked leaf within max(5e-2, 2 x floor)
              relative L2 (MoE plain runs take the kernel run's
              experts); every kernel of the arch's mixers launched and no
              other.  Then the reference's ``make smoke`` serve line,
              ``--reduced --jobs yi-6b:4,minicpm3-4b:2 --policy srtf
              --compare-fifo --tokens-per-block 4 --prompt-len 8 --batch
              1`` (flash and decode attention), and the port's quickstart
              with its defaults (12 steps of reduced yi-6b, the staircase
              prediction from step 1, one flash forward and backward a
              layer and step).  The kernel phase checks (32, 32) and
              (64, 32) flash, their backward and (32, 32) decode at the
              reduced paths' shapes, with the others.
10. benchmarks -- the paper's benchmarks and the cluster example, each in
              a subprocess with the checkout's ``src`` alone on the path
              and a temporary working directory (no package of the
              reference importable): ``repro_torch.benchmarks.run``'s
              ``main`` at full size with a sweep cache in the temporary
              directory, every module (the DES ones on the host, the
              executor rows on ``cuda``: four policies and SRTF under
              EWMA over two long+short pairs, ``jobs=1``; the roofline
              reading a dry-run record or saying it found none): exit 0,
              no ``ERROR`` row, rows from every module, the executor's
              rows its four policies and ``srtf+ewma`` for both workloads
              and the note.  The executor sweep runs once a smoke run,
              here: the child hands back each of its cells and the solo
              baselines it measured, and every cell's jobs must finish on
              the card, each spec's baseline be measured once (the EWMA
              sweep reads them from the cache); each cell's arrivals,
              finishes and overlap are printed on ``[sweep]`` lines;
              ``--machine
              des --subset 2 --no-cache`` under ``--engine python`` and
              ``--engine compiled``: equal rows once ``us_per_call`` is
              dropped; ``python -m repro_torch.examples.cluster_sim`` at
              its defaults: exit 0 and its four policy lines.  Rows are
              printed on ``[bench]`` lines.
11. perf    -- the DES perf lane, ``python -m repro_torch.benchmarks.perf
              --jobs 4 --repeat 2 --out <temporary>`` in full mode, run
              the same way (on the host): exit 0, the reference's eleven
              rows in its order, each python engine row's ``blocks``
              equal to its ``.compiled`` row's, the compiled rows'
              engine ``compiled-*``, both dispatchers' rows the same
              ``cells``, the JSON written equal to the rows printed, and
              no ``BENCH_des_torch.json`` written into the checkout's
              root (its ``BENCH_des.json`` unchanged).  Rows are printed
              on ``[perf]`` lines.
12. analysis -- ``python -m repro_torch.analysis --json`` over the
              checkout (the port's core, its benchmark modules and
              ``tests/test_torch_*.py``) in a subprocess run the same way:
              exit 0, ``ok`` true and no blocking finding; one
              ``[analysis]`` line with the blocking, baselined and stale
              counts and the seconds.

The line before the last is a JSON object with one entry per kernel and
timed shape (flash: yi-6b's, recurrentgemma-2b's, minicpm3-4b's,
deepseek-v2-lite's, pixtral-12b's and yi-34b's prefill and whisper-large-v3's
encoder, cross attention and cross attention at Sq 1, and the reduced
paths' (32, 32) serve prefill and training shape and (64, 32) training
shape; the flash backward: yi-6b's, recurrentgemma-2b's,
minicpm3-4b's, deepseek-v2-lite's, whisper-large-v3's three,
pixtral-12b's and yi-34b's training shapes and the reduced (32, 32) and
(64, 32) ones; the SSD backward: mamba2-2.7b's; decode: yi-6b's,
recurrentgemma-2b's, yi-34b's and the reduced make smoke line's decode
steps;
RG-LRU: recurrentgemma-2b's prefill at B 4 and at B 1; the RG-LRU
backward: recurrentgemma-2b's training shape; decode also yi-6b's with
the lse; threefry: yi-34b's feed-forward leaf, a normal stored in bf16;
launches summed over the serve, train, sharded and reduced paths, the
threefry kernel's over the serve, train and reduced paths, where it draws
every job's weights and batches); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import faulthandler
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.profiler

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate, float32 rate outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# INT32 rate of an H100 SXM: 64 INT32 lanes on each SM (Hopper
# architecture white paper) at the 1.98 GHz boost clock, times the card's
# SM count (132 on the SXM part).
INT32_PER_SM_CLOCK, BOOST_HZ = 64, 1.98e9
# The threefry kernel against its plain version on the card: bits and
# uniforms bitwise; float32 normals within THREEFRY_ULPS (the plain
# version's FMAs, a float64 product and sum rounded once more to float32,
# round twice where the sum needs more than 53 bits); bf16 values within
# one bf16 ulp.
THREEFRY_ULPS = 4
# The threefry phase's timing: yi-34b's feed-forward matrix of one layer
# (d 7168 x d_ff 20480), a normal times 1 / sqrt(7168) stored in bf16, as
# the serving init draws it; and the whole yi-34b init (60 layers, 64.1
# GiB of bf16) with this tree's kernel and with the torch.randn init the
# port had before, in turns.
THREEFRY_LEAF = (7168, 20480)
# Seconds of every phase of the whole script on a tree before the
# threefry kernel (NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's total.
PREVIOUS_TOTAL_S = 662.6
# Seconds after which the run dumps every thread's stack and exits 1.
WATCHDOG_S = 1150
# Kernel vs plain version: |kernel - plain| <= tol + tol * |plain|, with the
# bf16 tolerances of tests/test_kernels.py.  Attention (2e-2): the kernels
# round probabilities to bf16 before the PV product (flash) and the output
# to bf16 (both), ~0.4% relative per rounding.  Scans (3e-2): the kernels
# accumulate in fp32 in another order than the plain versions and round y
# or h to bf16; a long scan carries each step's rounding into the next.
ATTN_TOL = 2e-2
SCAN_TOL = 3e-2
# Full-width model, kernels vs plain versions: relative L2 error of each
# logits vector.  The kernels and the plain versions round to bf16 at
# different places (flash rounds probabilities; the scans sum in another
# order, so outputs whose fp32 values straddle a rounding boundary come out
# one ulp apart), and every layer carries the last one's differences on
# through the residual stream.  How far such roundings travel depends on
# the model's depth and weights -- random weights amplify them, and 64
# Mamba-2 layers far more than 32 attention layers -- so the run measures
# it: the floor is the error of the plain path in bf16 against the plain
# path in fp32 on the same (bf16-valued) weights.  Two paths with
# independent roundings of that size differ by ~1.4 floor; the bound is
# twice the floor, and never below the 5e-2 that yi-6b was held to.  In a
# MoE model a rounding can also tip a near tie in the router and send a
# token to another expert, a difference that would swamp the kernels' own;
# so the plain runs take the kernel run's experts (gates from their own
# probabilities), and the run reports the share of tokens each would have
# sent elsewhere.
MODEL_REL_L2 = 5e-2
# Flash backward, kernel vs the plain formula in fp32 on the same bf16
# inputs: relative L2 of each gradient within max(BWD_REL_L2, 2 x floor),
# the floor the plain formula in bf16 against it in fp32 (the kernel rounds
# P and dS to bf16 before its products, as the bf16 formula does); the
# forward's lse within LSE_TOL absolute of the plain lse (fp32 sums in
# another order and ex2.approx).
BWD_REL_L2 = 2e-2
LSE_TOL = 1e-3
# SSD backward, kernel vs its plain formula in fp32 on the same bf16 inputs:
# relative L2 of each gradient within max(SSD_BWD_REL_L2, 2 x floor), the
# floor the plain formula with each product's operands rounded to bf16 as
# the kernel rounds them, against it in fp32, and never above
# SSD_BWD_REL_L2 (the scans' bf16 tolerance).
SSD_BWD_REL_L2 = 3e-2
# RG-LRU backward, kernel vs its plain formula in fp32 on the same inputs:
# dx (bf16) within max(RGLRU_BWD_REL_L2, 2 x floor) relative L2, the floor
# the plain dx rounded to bf16; the fp32 gradients (the gates, log_a and
# the initial state) within RGLRU_BWD_F32_REL_L2, the CPU tests' fp32
# tolerance: the kernel recomputes h_{t-1} in fp32 with the plain
# version's formula, so only the order of fp32 sums differs (a kernel that
# took h_{t-1} from the bf16 h would miss it by ~1e-3).
RGLRU_BWD_REL_L2 = 3e-2
RGLRU_BWD_F32_REL_L2 = 1e-4

B, PROMPT, TOKENS_PER_BLOCK, LONGEST = 4, 1024, 8, 8
MAX_SEQ = PROMPT + LONGEST * TOKENS_PER_BLOCK + 8   # make_serve_job's max_seq
# Blocks of the graphs phase's replays, held to the eager steps (within
# MAX_SEQ with the capture's warm-up steps and the timed runs, each after
# a fresh prefill).
GRAPH_BLOCKS = 2
SERVE_COMMON = ["--policy", "srtf", "--compare-fifo", "--batch", str(B),
                "--prompt-len", str(PROMPT), "--tokens-per-block",
                str(TOKENS_PER_BLOCK)]
# The serving paths, each with the kernels it must launch and its pacing.
POISSON = ["--scenario", "poisson-open", "--time-scale", "1e-6", "--seed",
           "0"]
SERVE_PATHS = [
    ("yi-6b:8,yi-6b:2", ("flash_attention", "decode_attention"), []),
    ("mamba2-2.7b:8,recurrentgemma-2b:2",
     ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan"), []),
    ("minicpm3-4b:8,deepseek-v2-lite-16b:2", ("flash_attention",), []),
    # the reference serve docstring's mix, under Poisson arrivals
    ("yi-6b:8,minicpm3-4b:4,yi-6b:8", ("flash_attention", "decode_attention"),
     POISSON),
    # served as the reference's serve job serves them: pixtral's text path,
    # whisper's decoder with cross attention skipped (no frames)
    ("pixtral-12b:8,whisper-large-v3:2",
     ("flash_attention", "decode_attention"), []),
    # yi-34b at full width beside a small arch's short job: each serve job
    # holds its own weights (64.1 GiB of bf16 for yi-34b), so two yi-34b
    # jobs do not fit the card
    ("yi-34b:8,mamba2-2.7b:2",
     ("flash_attention", "decode_attention", "ssd_scan"), []),
    ("mistral-nemo-12b:8,mistral-nemo-12b:2",
     ("flash_attention", "decode_attention"), []),
]
# submission_offsets("poisson-open", 3, time_scale=1e-6, seed=0) of the JAX
# package, to 4 decimals: the scenario path must submit at these.
POISSON_OFFSETS = (0.0, 0.1068, 0.1875)
MODELS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b",
          "deepseek-v2-lite-16b", "whisper-large-v3", "pixtral-12b",
          "yi-34b", "mistral-nemo-12b")
# Training: full-width yi-6b cut to 12 layers (fp32 weights, gradients and
# AdamW moments, 16 bytes a parameter: 2.6 B parameters, 41.6 GB; the 32
# layers' 97 GB do not fit the card), B 4 x 1024 tokens.
TRAIN_LAYERS, TRAIN_STEPS = 12, 6
# Checkpoint and resume at full width with 2 layers: 10.4 GB a checkpoint.
RESUME_LAYERS = 2
TRAIN_JOBS = "yi-6b:8,yi-6b:2"
# Full-width mamba2-2.7b at B 4 x 1024 peaks at ~2.9 GiB + 1.06 GiB a
# layer: 0.60 GiB of parameter state (fp32 weights, gradients and AdamW
# moments, 16 B a parameter) and ~0.46 GiB of activations
# (tools/ssd_bwd_time.py --depths: 19.85 GiB at 16 layers, 62.34 at 56,
# 70.84 at all 64).  All 64 fit the card; the cut to 56 is a headroom
# rule, the deepest multiple of 8 layers under ~70 GiB, not a fit limit.
# Its gradient check holds three gradient sets at once beside the
# weights: 16 layers.
MAMBA_LAYERS, MAMBA_STEPS, MAMBA_CHECK_LAYERS = 56, 4, 16
# Full-width recurrentgemma-2b, all 26 layers (18 recurrent, 8 local
# attention) at B 4 x 1024: 2.66 B parameters, 42.6 GB of fp32 weights,
# gradients and AdamW moments, under the ~72 GiB headroom rule with its
# activations (the run fails past it).  Its gradient check: three (rec,
# rec, local) units.
RG_LAYERS, RG_STEPS, RG_CHECK_LAYERS, RG_PEAK_GIB = 26, 4, 9, 72.0
# MLA, B 4 x 1024, MLA_STEPS steps each, peak under MLA_PEAK_GIB: 15 GiB
# of the card's 79.2 GiB kept free, since the caching allocator's
# fragmentation ran the next depths out of memory (minicpm3-4b at 48
# layers with 47.7 GiB allocated and 29.7 GiB reserved but unallocated,
# deepseek at 6 with 64.9 and 12.8; launch.train on an NVIDIA H100 80GB
# HBM3).  Full-width minicpm3-4b: 4.07 B parameters, 60.7 GiB of fp32
# weights, gradients and AdamW moments (ArchConfig.n_params x 16 B) at all
# 62 layers, 2.8 GiB of embedding and head and 0.93 GiB a layer; at 40
# layers 40.2 GiB of state and a 58.5 GiB peak with the activations (~0.46
# GiB a layer).  Its gradient check computes three gradient sets beside
# the weights, two held at once (12 B a parameter; 1.19 B parameters at 16
# layers, 13.3 GiB).
MLA_LAYERS, MLA_STEPS, MLA_CHECK_LAYERS, MLA_PEAK_GIB = 40, 4, 16, 64.0
# Full-width deepseek-v2-lite-16b: 16.21 B parameters, 241.6 GiB of state
# at 27 layers; the first layer is dense (1.00 B parameters with the
# embedding and head, 15.0 GiB of state) and each MoE layer (64 experts
# top 6 + 2 shared) adds 0.585 B, 8.7 GiB: 49.8 GiB at 5 layers (one
# dense, four MoE), a 58.9 GiB peak.  Its gradient check: one dense and
# one MoE layer (1.59 B parameters, 17.8 GiB at the check's 12 B a
# parameter).
DSV2_LAYERS, DSV2_CHECK_LAYERS, DSV2_PEAK_GIB = 5, 2, 64.0
# deepseek-v2-lite-16b trained twice from one seed and resumed: one dense
# and one MoE layer at full width, 1.085 B parameters, so a checkpoint of
# fp32 weights and AdamW moments (12 B a parameter) is 13.0 GB.  A GPU
# host may end a command that writes 45 GiB to its disk, deleted files
# included, so each resume check writes its middle checkpoint alone:
# yi-6b's 10.4 GB and this 13.0.
DSV2_REPEAT_LAYERS, DSV2_REPEAT_STEPS = 2, 4
# Full-width yi-34b (60 layers, d 7168, 56 heads over 8 of 128, d_ff
# 20480, vocab 64000) cut to 4 layers: 3.149 B parameters, 46.9 GiB of
# fp32 weights, gradients and AdamW moments (the 60 layers' 512 GiB do
# not fit), peak under the 64 GiB headroom rule of the MLA and prefixed
# trains.
YI34_LAYERS, YI34_STEPS, YI34_PEAK_GIB = 4, 4, 64.0
# Full-width whisper-large-v3: 1.60 B parameters (ArchConfig.n_params'
# 1.39 B leaves out cross attention), 25.6 GB of fp32 state; all 32
# encoder and 32 decoder layers at B 4 x (1024 tokens + 1536 frames),
# ~52 GiB with the activations.  Full-width pixtral-12b: 12.25 B
# parameters; the embedding and head alone are 1.34 B (21.5 GB of state)
# and each layer 0.273 B (4.4 GB): 6 layers peak at ~59.5 GiB at B 4 x
# (1024 patches + 1024 tokens), 8 at ~67.6, past ENCDEC_PEAK_GIB
# (launch.train on an NVIDIA H100 80GB HBM3).  Gradient checks: whisper
# at WHISPER_CHECK_LAYERS of each stack, pixtral at PIXTRAL_CHECK_LAYERS.
WHISPER_LAYERS, WHISPER_CHECK_LAYERS = 32, 4
PIXTRAL_LAYERS, PIXTRAL_CHECK_LAYERS = 6, 2
ENCDEC_STEPS, ENCDEC_PEAK_GIB = 4, 64.0
SLEEP_CYCLES = 200_000_000            # device sleep before a timed run
# The reduced configs (``.reduced()``: d_model 128, 4 heads of 32, MLA's
# qk 48 padded to 64 beside v 32), as the reference's ``make smoke`` and
# quickstart run them: a prompt of 8 tokens (after pixtral's 8 patches;
# whisper with its 32 frames), REDUCED_DECODE decode steps, and one train
# step at the quickstart's B 4 x 64 tokens.  The make smoke serve line
# (tokens per block 4, longest job 4 blocks) caches REDUCED_MAX_SEQ slots.
REDUCED_PROMPT, REDUCED_SEQ, REDUCED_DECODE = 8, 64, 4
REDUCED_MAX_SEQ = REDUCED_PROMPT + 4 * 4 + 8
MAKE_SMOKE = ["--reduced", "--policy", "srtf", "--compare-fifo",
              "--tokens-per-block", "4", "--prompt-len", "8", "--batch", "1"]
MAKE_SMOKE_JOBS = "yi-6b:4,minicpm3-4b:2"
# The kernels each mixer launches when a model serves (prefill, decode)
# and trains; MLA decodes with plain products, as the reference does.
MIXER_KERNELS = {
    "gqa": ("flash_attention", "decode_attention", "flash_attention_bwd"),
    "local": ("flash_attention", "decode_attention", "flash_attention_bwd"),
    "mla": ("flash_attention", "flash_attention_bwd"),
    "ssd": ("ssd_scan", "ssd_scan_bwd"),
    "rglru": ("rglru_scan", "rglru_scan_bwd"),
}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def wall_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call, calls back to back, as a caller sees them
    (paced by the host when launching costs more than the device work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device milliseconds per call, with CUDA events.  The device first
    sleeps (~0.1 s) while the host enqueues every call, so the host's launch
    overhead stays out of the measurement; a run whose enqueueing outlasts
    the sleep would be host-paced and fails the check below."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_start = torch.cuda.Event(enable_timing=True)
    sleep_start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if enqueue_ms >= sleep_start.elapsed_time(start):
        fail(f"timing was paced by the host ({enqueue_ms:.1f} ms to enqueue "
             f"{iters} calls)")
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """Least milliseconds for the work: the larger of operations over the
    peak rate of their type and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa(q, k, v, mask=None, causal=False, scale=None):
    """F.scaled_dot_product_attention on the port's layout (the yardstick)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          is_causal=causal, scale=scale,
                                          enable_gqa=True)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                tol: float = ATTN_TOL) -> float:
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    err = float(diff.max())
    print(f"[kernels] {name}: max_abs_err={err:.3e} "
          f"(tol {tol} + {tol}*|plain|) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    print(card(), flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)",
          flush=True)
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel sources built in {secs:.1f}s",
          flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            # ptxas -v: each kernel's name, registers and spills, and any
            # wgmma it had to serialize (a kernel that lost its overlap).
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "wgmma")):
                print(f"[build] {name}: {line.strip()}", flush=True)
            # Flash keeps its scores and output rows, decode attention its
            # fragments, the SSD scan its fp32 state and the RG-LRU scan
            # its steps' maps in registers: a spill would put them in
            # local memory on every key tile, key or chunk.
            if "bytes spill" in line \
                    and any(int(w) for w in line.split() if w.isdigit()):
                fail(f"{name} spills registers: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> dict:
    out = {}
    out.update(kernels_attention(gen))
    out["flash_attention_bwd"] = kernel_flash_bwd(gen)
    out["ssd_scan"] = [kernel_ssd(gen)]
    out["ssd_scan_bwd"] = [kernel_ssd_bwd(gen)]
    out["rglru_scan"] = kernel_rglru(gen)
    out["rglru_scan_bwd"] = [kernel_rglru_bwd(gen)]
    return out


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


def kernel_flash_bwd(gen: torch.Generator) -> list:
    """The flash backward against its plain version (the reference formula
    in float32) on the same bf16 q, k, v, dout and the forward kernel's
    out and lse: each gradient within max(BWD_REL_L2, 2 x floor) relative
    L2, the floor being the plain formula in bf16 against it in fp32; two
    launches bitwise equal.  Also the forward's lse against the plain lse
    (within LSE_TOL absolute) and its out with and without lse bitwise
    equal.  Cases at the pairs (64, 64), (128, 128) and (128, 64) (the
    split kernels; minicpm3-4b's qk 96 zero-padded to 128 as ``mla_apply``
    pads it, at the scale of 96) and (256, 256) and (192, 128) (the wide
    kernels).  Times at yi-6b's, recurrentgemma-2b's, minicpm3-4b's and
    deepseek-v2-lite's training shapes, against SDPA's backward
    (:func:`time_flash_bwd`)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
    )

    cases = [
        # name, B, Sq, Sk, H, KV, qk, D, Dv, mask, window, q_offset: q and
        # k of width qk zero-padded to D, at the scale of qk
        ("yi-6b train B4 S1024 H32 KV4 D128 causal", B, 1024, 1024, 32, 4,
         128, 128, 128, "causal", 0, 0),
        ("example B8 S128 H10 KV2 D64 causal", 8, 128, 128, 10, 2, 64, 64,
         64, "causal", 0, 0),
        ("ragged B2 S1000 H32 KV4 D128 causal", 2, 1000, 1000, 32, 4, 128,
         128, 128, "causal", 0, 0),
        ("window B2 Sq300 Sk600 H8 KV2 D128 w150 q_offset300", 2, 300, 600,
         8, 2, 128, 128, 128, "window", 150, 300),
        ("none B2 Sq77 Sk150 H8 KV2 D64", 2, 77, 150, 8, 2, 64, 64, 64,
         "none", 0, 0),
        # (256, 256), the wide kernels: recurrentgemma-2b's local layers
        # (MQA, window 2048 >= S: causal in effect), a window shorter than
        # S, ragged S with a q_offset, and no mask with Sq != Sk.
        ("recurrentgemma train B4 S1024 H10 KV1 D256 window2048", B, 1024,
         1024, 10, 1, 256, 256, 256, "window", 2048, 0),
        ("window B1 S300 H5 KV1 D256 w100", 1, 300, 300, 5, 1, 256, 256,
         256, "window", 100, 0),
        ("ragged B2 Sq150 Sk201 H4 KV2 D256 causal q_offset51", 2, 150, 201,
         4, 2, 256, 256, 256, "causal", 0, 51),
        ("none B1 Sq77 Sk190 H4 KV1 D256", 1, 77, 190, 4, 1, 256, 256, 256,
         "none", 0, 0),
        # MLA: minicpm3-4b's training shape (40 heads, the rope key
        # expanded over them: G 1; qk 96 run as 128 beside v 64, the split
        # kernels) and deepseek-v2-lite's (16 heads of (192, 128), the
        # wide kernels, one slice a group), then for each pair ragged S
        # with a q_offset and no mask with Sq != Sk.
        ("minicpm3 train B4 S1024 H40 KV40 qk96->128 Dv64 causal", B, 1024,
         1024, 40, 40, 96, 128, 64, "causal", 0, 0),
        ("deepseek train B4 S1024 H16 KV16 D192 Dv128 causal", B, 1024,
         1024, 16, 16, 192, 192, 128, "causal", 0, 0),
        ("ragged B2 Sq150 Sk201 H8 KV8 qk96->128 Dv64 causal q_offset51", 2,
         150, 201, 8, 8, 96, 128, 64, "causal", 0, 51),
        ("none B1 Sq77 Sk190 H4 KV2 qk96->128 Dv64", 1, 77, 190, 4, 2, 96,
         128, 64, "none", 0, 0),
        ("ragged B2 Sq150 Sk201 H4 KV4 D192 Dv128 causal q_offset51", 2, 150,
         201, 4, 4, 192, 192, 128, "causal", 0, 51),
        ("none B1 Sq77 Sk190 H4 KV2 D192 Dv128", 1, 77, 190, 4, 2, 192, 192,
         128, "none", 0, 0),
        # whisper-large-v3's three training shapes (20 heads over 20 of 64:
        # the split kernels at G 1): the encoder over 1536 frames and
        # cross attention of 1024 tokens over them, both without a mask,
        # and the decoder's causal self attention; then pixtral-12b's
        # (1024 patches and 1024 tokens, causal, 32 heads over 8 of 128).
        ("whisper encoder train B4 S1536 H20 KV20 D64 none", B, 1536, 1536,
         20, 20, 64, 64, 64, "none", 0, 0),
        ("whisper decoder train B4 S1024 H20 KV20 D64 causal", B, PROMPT,
         PROMPT, 20, 20, 64, 64, 64, "causal", 0, 0),
        ("whisper cross train B4 Sq1024 Sk1536 H20 KV20 D64 none", B,
         PROMPT, 1536, 20, 20, 64, 64, 64, "none", 0, 0),
        ("pixtral train B4 S2048 H32 KV8 D128 causal", B, 2 * PROMPT,
         2 * PROMPT, 32, 8, 128, 128, 128, "causal", 0, 0),
        # yi-34b's G 7 (56 heads over 8 of 128): a dK/dV CTA's (head,
        # query tile) steps, dealt to its two warpgroups in turns, come to
        # an odd count wherever the query tiles are; then a ragged S with
        # a q_offset, a window and no mask with Sq != Sk.
        ("yi-34b train B4 S1024 H56 KV8 D128 causal", B, PROMPT, PROMPT, 56,
         8, 128, 128, 128, "causal", 0, 0),
        ("G7 ragged B2 Sq150 Sk201 H14 KV2 D128 causal q_offset51", 2, 150,
         201, 14, 2, 128, 128, 128, "causal", 0, 51),
        ("G7 window B2 Sq300 Sk600 H7 KV1 D128 w150 q_offset300", 2, 300,
         600, 7, 1, 128, 128, 128, "window", 150, 300),
        ("G7 none B1 Sq77 Sk190 H7 KV1 D128", 1, 77, 190, 7, 1, 128, 128,
         128, "none", 0, 0),
        # The reduced configs' (32, 32) and reduced MLA's qk 48 padded to
        # (64, 32), the split kernels on (64, 64) tiles: the quickstart's
        # training batch (yi-6b's 4 heads over 2; MLA's 4 over 4), then
        # recurrentgemma's window 64 over a longer S, a ragged S with a
        # q_offset and no mask with Sq != Sk (whisper's cross attention
        # over its 32 frames).
        ("reduced train B4 S64 H4 KV2 D32 causal", B, REDUCED_SEQ,
         REDUCED_SEQ, 4, 2, 32, 32, 32, "causal", 0, 0),
        ("reduced MLA train B4 S64 H4 KV4 qk48->64 Dv32 causal", B,
         REDUCED_SEQ, REDUCED_SEQ, 4, 4, 48, 64, 32, "causal", 0, 0),
        ("reduced window B2 S200 H4 KV1 D32 w64", 2, 200, 200, 4, 1, 32, 32,
         32, "window", 64, 0),
        ("reduced ragged B2 Sq150 Sk201 H4 KV2 D32 causal q_offset51", 2, 150,
         201, 4, 2, 32, 32, 32, "causal", 0, 51),
        ("reduced cross B4 Sq56 Sk32 H4 KV4 D32 none", B, 56, 32, 4, 4, 32,
         32, 32, "none", 0, 0),
        ("reduced MLA ragged B2 Sq150 Sk201 H4 KV4 qk48->64 Dv32 causal "
         "q_offset51", 2, 150, 201, 4, 4, 48, 64, 32, "causal", 0, 51),
    ]
    # Timed: the training shapes of yi-6b, recurrentgemma-2b, minicpm3-4b,
    # deepseek-v2-lite, whisper-large-v3 (three), pixtral-12b and yi-34b.
    timed_cases = [c for c in cases if "train" in c[0]]
    results = {}
    for name, b, sq, sk, h, kv, qk, d, dv, kind, window, off in cases:
        q, k, v, dout = flash_bwd_inputs(gen, b, sq, sk, h, kv, qk, d, dv)
        kw = dict(mask_kind=kind, window=window, q_offset=off,
                  scale=qk ** -0.5)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        alone = flash_attention_cuda(q, k, v, **kw)
        _, want_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                            return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        truth = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        plain16 = flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                            dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, alone):
            fail(f"flash_attention {name}: out differs with and without lse")
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= LSE_TOL:
            fail(f"flash_attention {name}: lse off by {lse_err:.3e}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"flash_attention_bwd {name}: two launches differ")
        errs = []
        for grad, g, w, f16 in zip(("dq", "dk", "dv"), got, truth, plain16):
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"flash_attention_bwd {name} {grad}: shape "
                     f"{tuple(g.shape)} or non-finite")
            err, floor = rel_l2(g, w), rel_l2(f16, w)
            limit = max(BWD_REL_L2, 2 * floor)
            abs_err = float((g.float() - w.float()).abs().max())
            errs.append(abs_err)
            ok = err <= limit
            print(f"[kernels] flash_attention_bwd {name} {grad}: relative "
                  f"L2 {err:.3e} (bound {limit:.3e} = max({BWD_REL_L2}, 2 x "
                  f"floor {floor:.3e})), max_abs_err {abs_err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"flash_attention_bwd {name} {grad} disagrees with its "
                     f"plain version")
        if qk < d and any(g[..., qk:].any() for g in got[:2]):
            fail(f"flash_attention_bwd {name}: dq or dk non-zero in the "
                 f"padded columns")
        print(f"[kernels] flash_attention {name}: lse max abs err "
              f"{lse_err:.3e} (tol {LSE_TOL}), out with and without lse "
              f"bitwise equal", flush=True)
        results[name] = max(errs)
    print("[kernels] flash_attention_bwd: two launches bitwise equal in every "
          "case", flush=True)

    # Each timed entry with the largest error of the cases at its pair.
    def err(case):
        return max(e for c, e in zip(cases, results.values())
                   if c[7:9] == case[7:9])

    return [time_flash_bwd(gen, err(c), *c) for c in timed_cases]


def flash_bwd_inputs(gen: torch.Generator, b, sq, sk, h, kv, qk, d, dv):
    """bf16 q, k, v and dout of a flash backward case, drawn in that
    order: q and k of width qk, zero-padded to d as ``mla_apply`` pads
    them."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def padded(t):
        return torch.cat([t, t.new_zeros(t.shape[:-1] + (d - qk,))], -1)

    q, k = padded(randn(b, sq, h, qk)), padded(randn(b, sk, kv, qk))
    return q, k, randn(b, sk, kv, dv), randn(b, sq, h, dv)


def time_flash_bwd(gen: torch.Generator, max_abs_err: float, name, b, sq,
                   sk, h, kv, qk, d, dv, kind, window, off) -> dict:
    """The flash backward's device time at one shape against SDPA's
    backward on the same (padded) inputs (causal, where the shape's mask
    is causal in effect, or no mask) and both bounds, each of its CUDA
    kernels' own time, and which of SDPA's kernels ran.  The bound counts the work of
    the function at its own qk (inputs and gradients at width qk, the five
    products over qk and dv); the work at the padded d is printed beside
    it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        mask_for,
    )
    from repro_torch.kernels.flash_attention_bwd import (
        WIDE_PAIRS,
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
        wide_ctas,
        wide_splits,
    )

    q, k, v, dout = flash_bwd_inputs(gen, b, sq, sk, h, kv, qk, d, dv)
    kw = dict(mask_kind=kind, window=window, q_offset=off,
              scale=qk ** -0.5)
    mask = mask_for(kind, sq, sk, window, off, "cuda")
    causal = mask is not None
    if causal and not torch.equal(mask, mask_for("causal", sq, sk, 0, 0,
                                                 "cuda")):
        fail(f"flash_attention_bwd {name}: timed masks must be causal in "
             f"effect (SDPA's backward runs is_causal)")
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    pairs = int(mask.sum()) if causal else sq * sk

    def five(w):                       # the formula's products at qk = w
        return 2.0 * b * h * pairs * (3 * w + 2 * dv)

    def moved(w):                      # inputs and gradients once, bytes
        return 2 * 2 * (b * sq * h * w + b * sk * kv * (w + dv)) \
            + nbytes(out, dout, lse)

    flops, total = five(qk), moved(qk)
    flops_done = 2.0 * b * h * pairs * (4 * d + 3 * dv)    # as designed
    b_ms, b_by = bound(flops, total)

    def kernel():
        return flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)

    ms = device_ms(kernel, 20)
    plain_ms = device_ms(
        lambda: flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw), 3)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(qg, kg, vg, causal=causal, scale=qk ** -0.5)
    lib_dout = dout.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qg, kg, vg), lib_dout,
                                   retain_graph=True)

    lib_ms = device_ms(library, 20)
    ran = kernel_times(library, 1,
                       r"(?i)^.*(fmha|flash|attn|attention|cudnn|mha).*$")
    b7_ms = bound(flops_done, moved(d))[0]
    padded = "" if qk == d else (
        f"; at the padded {d}: {five(d) / 1e9:.2f} GFLOP, "
        f"{moved(d) / 1e6:.2f} MB, bound {bound(five(d), moved(d))[0]:.4f} "
        f"ms")
    print(f"[kernels] flash_attention_bwd {name}: kernel {ms:.4f} ms on the "
          f"device, plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP in the five "
          f"products; {total / 1e6:.2f} MB{padded}; {flops_done / 1e9:.2f} "
          f"GFLOP as designed = {b7_ms:.4f} ms); kernel at "
          f"{b_ms / ms:.1%} of the five-product bound and {b7_ms / ms:.1%} "
          f"of the seven-product one; SDPA's backward ran "
          f"{[k[:90] for k in ran] or 'not measured'}", flush=True)
    # Each of the wrapper's CUDA kernels on its own (delta, dK/dV, dQ).
    parts = kernel_times(kernel, 10, r"flash_bwd_\w+")
    by_kernel = ", ".join(f"{k} {t:.4f}" for k, t in parts.items())
    print(f"[kernels] flash_attention_bwd {name}: device ms per call by "
          f"CUDA kernel (torch.profiler, 10 calls): "
          f"{by_kernel or 'not measured'}", flush=True)
    if (d, dv) in WIDE_PAIRS:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = wide_splits(b, sq, sk, h, kv, kind, window, off, sms=sms)
        print(f"[kernels] flash_attention_bwd {name}: CTAs an SM (dK/dV, "
              f"dQ) {wide_ctas(torch.device('cuda', 0), d, dv)}; dK/dV in "
              f"{splits} head slices, {kv * splits * b * -(-sk // 64)} CTAs "
              f"on {sms} SMs", flush=True)
    return dict(shape=f"B{b} S{sq} H{h} KV{kv} qk{qk} D{d} Dv{dv} {kind}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def kernel_times(fn, n: int, pattern: str) -> dict:
    """Device milliseconds per call of each CUDA kernel whose name matches
    ``pattern``, from torch.profiler over ``n`` calls (empty if the
    profiler recorded no device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        named = re.search(pattern, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and named:
            key = named.group(0)
            times[key] = times.get(key, 0.0) + e.time_range.elapsed_us()
    return {k: t / 1e3 / n for k, t in sorted(times.items())}


def kernels_attention(gen: torch.Generator) -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        mask_for,
    )
    from repro_torch.models.mla import padded_qk_dim

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}

    # -- flash attention (prefill) ---------------------------------------
    flash_cases = [
        # name, B, Sq, Sk, H, KV, (D, Dv), mask, window, q_offset
        ("prefill B4 S1024 causal", B, PROMPT, PROMPT, 32, 4, (128, 128),
         "causal", 0, 0),
        ("ragged Sq200 Sk333 causal q_offset133", 2, 200, 333, 32, 4,
         (128, 128), "causal", 0, 133),
        ("ragged Sq77 Sk150 none", 3, 77, 150, 32, 4, (128, 128), "none", 0,
         0),
        ("window S700 w128", 2, 700, 700, 32, 4, (128, 128), "window", 128,
         0),
        ("D256 prefill B4 S1024 H10 KV1 window2048", B, PROMPT, PROMPT, 10,
         1, (256, 256), "window", 2048, 0),
        ("D256 ragged Sq77 Sk150 causal q_offset73", 1, 77, 150, 4, 2,
         (256, 256), "causal", 0, 73),
        ("D256 window S300 w50", 2, 300, 300, 10, 1, (256, 256), "window",
         50, 0),
        # Batch edge: B > 1 with Sq, Sk no multiple of 64; the tensor maps
        # zero-fill each batch's ragged edge instead of reading the next.
        ("batch edge B3 Sq150 Sk201 causal q_offset51", 3, 150, 201, 32, 4,
         (128, 128), "causal", 0, 51),
        ("D256 batch edge B3 Sq99 Sk99 causal", 3, 99, 99, 10, 1,
         (256, 256), "causal", 0, 0),
        # Ring phase: the first visible key tile is odd (1, 2, 3 at D 128;
        # 3, 5 at D 256), so the two-stage K/V ring starts off stage 0.
        ("ring phase Sq300 Sk600 window150 q_offset300", 2, 300, 600, 32, 4,
         (128, 128), "window", 150, 300),
        ("D256 ring phase Sq200 Sk500 window100 q_offset300", 1, 200, 500,
         10, 1, (256, 256), "window", 100, 300),
        # MLA: deepseek-v2-lite's (192, 128), three TMA boxes of D, and
        # minicpm3-4b's qk 96 zero-padded to (128, 64); both with the scale
        # of the true qk dim, as the model calls them.
        ("MLA D192 Dv128 prefill B4 S1024 H16 KV16 causal", B, PROMPT,
         PROMPT, 16, 16, (192, 128), "causal", 0, 0),
        ("MLA D96 padded to 128 Dv64 prefill B4 S1024 H40 KV40 causal", B,
         PROMPT, PROMPT, 40, 40, (96, 64), "causal", 0, 0),
        ("MLA D192 Dv128 ragged S1000 causal", 2, 1000, 1000, 16, 16,
         (192, 128), "causal", 0, 0),
        ("MLA D192 Dv128 window S700 w128", 2, 700, 700, 16, 16,
         (192, 128), "window", 128, 0),
        ("MLA D192 Dv128 Sq200 Sk333 causal q_offset133", 3, 200, 333, 16,
         16, (192, 128), "causal", 0, 133),
        ("MLA D192 Dv128 ring phase Sq200 Sk500 window100 q_offset300", 1,
         200, 500, 16, 16, (192, 128), "window", 100, 300),
        ("MLA D96 padded to 128 Dv64 ragged S1000 causal", 2, 1000, 1000,
         40, 40, (96, 64), "causal", 0, 0),
        ("MLA D96 padded to 128 Dv64 Sq200 Sk333 causal q_offset133", 3,
         200, 333, 40, 40, (96, 64), "causal", 0, 133),
        ("MLA D96 padded to 128 Dv64 window S300 w50", 2, 300, 300, 40, 40,
         (96, 64), "window", 50, 0),
        # whisper-large-v3 (20 heads over 20 of 64): the encoder over its
        # 1536 frames and cross attention at prefill and in every decode
        # step (Sq 1), all without a mask, and Sq 1 over a ragged Sk and at
        # G 4; pixtral-12b's prefill (1024 patches, then 1024 tokens).
        ("whisper encoder B4 S1536 H20 KV20 D64 none", B, 1536, 1536, 20,
         20, (64, 64), "none", 0, 0),
        ("whisper cross B4 Sq1024 Sk1536 H20 KV20 D64 none", B, PROMPT,
         1536, 20, 20, (64, 64), "none", 0, 0),
        ("whisper cross decode B4 Sq1 Sk1536 H20 KV20 D64 none", B, 1, 1536,
         20, 20, (64, 64), "none", 0, 0),
        ("Sq1 Sk1537 H20 KV20 D64 none", 2, 1, 1537, 20, 20, (64, 64),
         "none", 0, 0),
        ("Sq1 Sk1536 H8 KV2 D128 none", 2, 1, 1536, 8, 2, (128, 128), "none",
         0, 0),
        ("pixtral prefill B4 S2048 H32 KV8 D128 causal", B, 2 * PROMPT,
         2 * PROMPT, 32, 8, (128, 128), "causal", 0, 0),
        # yi-34b's G 7 (56 heads over 8 of 128): its prefill, then a
        # ragged edge with a q_offset, a window and no mask at Sq != Sk.
        ("yi-34b prefill B4 S1024 H56 KV8 D128 causal", B, PROMPT, PROMPT,
         56, 8, (128, 128), "causal", 0, 0),
        ("G7 ragged B3 Sq200 Sk333 H56 KV8 D128 causal q_offset133", 3, 200,
         333, 56, 8, (128, 128), "causal", 0, 133),
        ("G7 window B2 S700 H14 KV2 D128 w128", 2, 700, 700, 14, 2,
         (128, 128), "window", 128, 0),
        ("G7 none B2 Sq77 Sk150 H7 KV1 D128", 2, 77, 150, 7, 1, (128, 128),
         "none", 0, 0),
        # The reduced configs' head dim 32 on the (64, 64) tiles: the make
        # smoke serve line's yi-6b prefill (B 1, 8 tokens, 4 heads over 2),
        # the quickstart's training batch (B 4 x 64), recurrentgemma's
        # window 64, whisper's encoder and cross attention at Sq 1 over its
        # 32 frames, a ragged edge with a q_offset; reduced MLA's qk 48
        # padded to (64, 32), at the quickstart's batch and ragged.
        ("reduced serve prefill B1 S8 H4 KV2 D32 causal", 1,
         REDUCED_PROMPT, REDUCED_PROMPT, 4, 2, (32, 32), "causal", 0, 0),
        ("reduced train B4 S64 H4 KV2 D32 causal", B, REDUCED_SEQ,
         REDUCED_SEQ, 4, 2, (32, 32), "causal", 0, 0),
        ("reduced window B2 S200 H4 KV1 D32 w64", 2, 200, 200, 4, 1,
         (32, 32), "window", 64, 0),
        ("reduced whisper encoder B2 S32 H4 KV4 D32 none", 2, 32, 32, 4, 4,
         (32, 32), "none", 0, 0),
        ("reduced whisper cross decode B2 Sq1 Sk32 H4 KV4 D32 none", 2, 1, 32,
         4, 4, (32, 32), "none", 0, 0),
        ("reduced ragged B3 Sq77 Sk150 H4 KV2 D32 causal q_offset73", 3, 77,
         150, 4, 2, (32, 32), "causal", 0, 73),
        ("reduced MLA qk48 padded to 64 Dv32 train B4 S64 H4 KV4 causal", B,
         REDUCED_SEQ, REDUCED_SEQ, 4, 4, (48, 32), "causal", 0, 0),
        ("reduced MLA qk48 padded to 64 Dv32 ragged Sq77 Sk150 causal "
         "q_offset73", 2, 77, 150, 4, 4, (48, 32), "causal", 0, 73),
    ]

    def padded(q, k, dv):
        """q, k zero-padded along D to a pair the kernel takes, as the MLA
        layer pads them (``models.mla``); the callers pass the scale of
        the true width, which padding leaves right."""
        pad = padded_qk_dim(q.shape[-1], dv) - q.shape[-1]
        return tuple(torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], -1)
                     for t in (q, k))

    errs = {}
    for name, b, sq, sk, h, kv, (d, dv), kind, window, off in flash_cases:
        q, k, v = randn(b, sq, h, d), randn(b, sk, kv, d), \
            randn(b, sk, kv, dv)
        qp, kp = padded(q, k, dv)
        kw = dict(mask_kind=kind, window=window, q_offset=off,
                  scale=d ** -0.5)
        got = flash_attention_cuda(qp, kp, v, **kw)
        again = flash_attention_cuda(qp, kp, v, **kw)
        want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        errs[name] = check_close(f"flash_attention {name}", got, want)
        if not torch.equal(got, again):
            fail(f"flash_attention {name}: two launches on one input differ")
    print("[kernels] flash_attention: two launches bitwise equal in every "
          "case", flush=True)

    def time_flash(case, sq, sk, h, kv, d, dv, kind, window, label, b=B):
        """Times at a path's shape, with the error of ``case``, the check
        at that shape.  A masked shape must be causal in effect (S <=
        window, so the window mask is the causal one and SDPA's is_causal
        matches it); "none" is SDPA without a mask.  At minicpm3's qk 96
        the kernel runs on q, k padded to 128; the bound counts the true
        work, and the padded work is printed beside it.  At Sq 1 (cross
        attention in a decode step) the calls take eight copies of K and V
        in turn, as a decode step finds them in HBM (the 50 MB L2 would
        hold one)."""
        turns = 8 if sq == 1 else 1
        q = randn(b, sq, h, d)
        raw = [(randn(b, sk, kv, d), randn(b, sk, kv, dv))
               for _ in range(turns)]
        qp = padded(q, raw[0][0], dv)[0]
        kvs = [(padded(q, kc, dv)[1], vc) for kc, vc in raw]
        k, v = raw[0]
        turn = [0]

        def next_kv(pairs_of):
            turn[0] += 1
            return pairs_of[turn[0] % turns]

        scale = d ** -0.5
        causal = kind != "none"
        mask = mask_for(kind, sq, sk, window, 0, dev)
        if causal and not torch.equal(mask, mask_for("causal", sq, sk, 0, 0,
                                                     dev)):
            fail(f"flash_attention {label}: timed masks must be causal in "
                 f"effect (SDPA runs is_causal)")
        pairs = sq * sk if mask is None else int(mask.sum())
        flops = 2.0 * b * h * pairs * (d + dv)
        out_bytes = b * sq * h * dv * 2
        b_ms, b_by = bound(flops, nbytes(q, k, v) + out_bytes)
        pad_ms, _ = bound(2.0 * b * h * pairs * (qp.shape[-1] + dv),
                          nbytes(qp, kvs[0][0], v) + out_bytes)
        kw = dict(mask_kind=kind, window=window, scale=scale)
        ms = device_ms(lambda: flash_attention_cuda(qp, *next_kv(kvs), **kw),
                       20)
        call_ms = wall_ms(lambda: flash_attention_cuda(qp, *next_kv(kvs),
                                                       **kw), 20)
        plain_ms = device_ms(lambda: flash_attention_plain(q, k, v, **kw), 5)
        # SDPA on the unpadded q, k: it takes Dv != D
        lib_ms = device_ms(lambda: sdpa(q, *next_kv(raw), causal=causal,
                                        scale=scale), 20)
        shape = f"B{b} Sq{sq} Sk{sk} H{h} KV{kv} D{d} Dv{dv} {kind}"
        if qp.shape[-1] != d:
            shape += f" (q, k padded to D{qp.shape[-1]})"
        extra = ""
        if sq == 1:
            # The decode kernel computes the same function (one query a
            # row over a full cache); the model calls flash, as the
            # reference does.
            length = torch.full((b,), sk, dtype=torch.int32, device=dev)
            q1 = qp[:, 0].contiguous()
            dec_ms = device_ms(lambda: decode_attention_cuda(
                q1, *next_kv(kvs), length), 20)
            extra = f", decode kernel on the same inputs {dec_ms:.4f} ms"
        print(f"[kernels] flash_attention {label} {shape}: kernel {ms:.4f} "
              f"ms on the device ({call_ms:.4f} ms per call back to back), "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms{extra}, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
              f"{(nbytes(q, k, v) + out_bytes) / 1e6:.2f} MB; "
              f"{pad_ms:.4f} ms for the work as padded; K/V taken from "
              f"{turns} copies in turn)", flush=True)
        return dict(shape=shape, max_abs_err=errs[case], ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)

    out["flash_attention"] = [
        time_flash("prefill B4 S1024 causal", PROMPT, PROMPT, 32, 4, 128,
                   128, "causal", 0, "yi-6b"),
        time_flash("D256 prefill B4 S1024 H10 KV1 window2048", PROMPT,
                   PROMPT, 10, 1, 256, 256, "window", 2048,
                   "recurrentgemma-2b"),
        time_flash("MLA D96 padded to 128 Dv64 prefill B4 S1024 H40 KV40 "
                   "causal", PROMPT, PROMPT, 40, 40, 96, 64, "causal", 0,
                   "minicpm3-4b"),
        time_flash("MLA D192 Dv128 prefill B4 S1024 H16 KV16 causal", PROMPT,
                   PROMPT, 16, 16, 192, 128, "causal", 0,
                   "deepseek-v2-lite-16b"),
        time_flash("whisper encoder B4 S1536 H20 KV20 D64 none", 1536, 1536,
                   20, 20, 64, 64, "none", 0, "whisper-large-v3 encoder"),
        time_flash("whisper cross B4 Sq1024 Sk1536 H20 KV20 D64 none",
                   PROMPT, 1536, 20, 20, 64, 64, "none", 0,
                   "whisper-large-v3 cross"),
        time_flash("whisper cross decode B4 Sq1 Sk1536 H20 KV20 D64 none", 1,
                   1536, 20, 20, 64, 64, "none", 0,
                   "whisper-large-v3 cross in a decode step"),
        time_flash("pixtral prefill B4 S2048 H32 KV8 D128 causal",
                   2 * PROMPT, 2 * PROMPT, 32, 8, 128, 128, "causal", 0,
                   "pixtral-12b"),
        time_flash("yi-34b prefill B4 S1024 H56 KV8 D128 causal", PROMPT,
                   PROMPT, 56, 8, 128, 128, "causal", 0, "yi-34b"),
        time_flash("reduced serve prefill B1 S8 H4 KV2 D32 causal",
                   REDUCED_PROMPT, REDUCED_PROMPT, 4, 2, 32, 32, "causal", 0,
                   "reduced yi-6b serve (make smoke)", b=1),
        time_flash("reduced train B4 S64 H4 KV2 D32 causal", REDUCED_SEQ,
                   REDUCED_SEQ, 4, 2, 32, 32, "causal", 0,
                   "reduced yi-6b train (quickstart)"),
        time_flash("reduced MLA qk48 padded to 64 Dv32 train B4 S64 H4 KV4 "
                   "causal", REDUCED_SEQ, REDUCED_SEQ, 4, 4, 48, 32, "causal",
                   0, "reduced minicpm3-4b train")]

    # -- decode attention -------------------------------------------------
    from repro_torch.kernels.decode_attention import counters

    errs = {128: [], 256: [], 32: [], "G7": []}
    decode_cases = [
        # name, B, H, KV, D, cache slots, lengths
        ("decode B4 mixed lengths", B, 32, 4, 128, MAX_SEQ,
         [1, 300, 777, MAX_SEQ]),
        ("decode B4 short lengths", B, 32, 4, 128, MAX_SEQ, [1, 2, 63, 65]),
        # B * KV = 64 (b, kv head) counters.
        ("decode B8 KV8", 8, 64, 8, 128, MAX_SEQ,
         [1, 37, 64, 100, 555, 1000, 1095, MAX_SEQ]),
        # yi-34b's G 7: seven of the 16 mma rows a (batch row, KV head)
        # used, nine idle.
        ("yi-34b G7 mixed lengths", B, 56, 8, 128, MAX_SEQ,
         [1, 300, 777, MAX_SEQ]),
        ("yi-34b G7 short lengths", B, 56, 8, 128, MAX_SEQ, [1, 2, 63, 65]),
        ("D256 G10 ring of 2048 mixed lengths", B, 10, 1, 256, 2048,
         [1, PROMPT, MAX_SEQ, 2048]),
        # Lengths below the 33 splits: CTAs with no keys reach the combine.
        ("D256 G10 ring of 2048 lengths below n_split", B, 10, 1, 256, 2048,
         [1, 2, 3, 0]),
        # The reduced configs' (32, 32): the make smoke serve line's yi-6b
        # cache (G 2, 32 slots), recurrentgemma's 64-slot window (G 4, two
        # splits of 32 keys at B 1), lengths 0 and 64 at G 1.
        ("reduced G2 serve cache", 1, 4, 2, 32, REDUCED_MAX_SEQ,
         [REDUCED_PROMPT + 8]),
        ("reduced G4 window of 64", 1, 4, 1, 32, 64, [64]),
        ("reduced G1 lengths 0 and 64", 2, 4, 4, 32, 64, [0, 64]),
    ]
    for name, b, h, kv, d, slots, lens in decode_cases:
        q = randn(b, h, d)
        kc, vc = randn(b, slots, kv, d), randn(b, slots, kv, d)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention_cuda(q, kc, vc, length)
        again = decode_attention_cuda(q, kc, vc, length)
        want = decode_attention_plain(q.float(), kc.float(), vc.float(),
                                      length)
        torch.cuda.synchronize()
        errs["G7" if h // kv == 7 else d].append(check_close(
            f"decode_attention {name} {lens}", got, want))
        if not torch.equal(got, again):
            fail(f"decode_attention {name}: two launches on one input differ")
        if bool(counters(dev).any()):
            fail(f"decode_attention {name}: counters left non-zero")
        check_decode_lse(name, q, kc, vc, length, got)
    print("[kernels] decode_attention: two launches bitwise equal, counters "
          "zero after every call; with the lse, out bitwise the same and "
          "the lse within tolerance of the plain lse", flush=True)
    q, kc, vc = randn(B, 32, 128), randn(B, MAX_SEQ, 4, 128), \
        randn(B, MAX_SEQ, 4, 128)
    zero = torch.tensor([0, 5, 0, 9], dtype=torch.int32, device=dev)
    z = decode_attention_cuda(q, kc, vc, zero)
    torch.cuda.synchronize()
    if bool(z[0].any()) or bool(z[2].any()):
        fail("decode_attention: length 0 rows are not zero")
    print("[kernels] decode_attention length 0 rows: zeros ok", flush=True)

    def time_decode(h, kv, d, slots, fill, label, b=B, lse=False):
        """Times at a serving decode step: every row at a mid-run length;
        eight cache copies in turn so the 50 MB L2 does not hold the K/V
        reads.  With ``lse`` the kernel asked for its lse too, timed in
        turns with the kernel without it (without, with, with,
        without)."""
        length = torch.full((b,), fill, dtype=torch.int32, device=dev)
        q = randn(b, h, d)
        caches = [(randn(b, slots, kv, d), randn(b, slots, kv, d))
                  for _ in range(8)]
        turn = [0]

        def run(fn):
            kc, vc = caches[turn[0] % len(caches)]
            turn[0] += 1
            return fn(q, kc, vc, length)

        kv_bytes = b * fill * kv * (d + d) * 2
        flops = 2.0 * b * h * fill * (d + d)
        b_ms, b_by = bound(flops, kv_bytes + nbytes(q, q, length))
        ms = device_ms(lambda: run(decode_attention_cuda), 100)
        if lse:
            with_lse = functools.partial(decode_attention_cuda,
                                         return_lse=True)
            lse_ms = [device_ms(lambda: run(with_lse), 100)
                      for _ in range(2)]
            ms = (ms + device_ms(lambda: run(decode_attention_cuda), 100)) / 2
            print(f"[kernels] decode_attention {label}: with the lse "
                  f"{lse_ms[0]:.4f} / {lse_ms[1]:.4f} ms, without "
                  f"{ms:.4f} ms (mean of two; in turns)", flush=True)
            ms = sum(lse_ms) / 2
            label += " with lse"
        call_ms = wall_ms(lambda: run(decode_attention_cuda), 100)
        plain_ms = device_ms(lambda: run(decode_attention_plain), 20)
        valid = torch.arange(slots, device=dev)[None] < length[:, None]
        amask = valid[:, None, None, :]
        lib_ms = device_ms(lambda: run(lambda q_, k_, v_, _l: sdpa(
            q_[:, None], k_, v_, mask=amask)), 50)
        print(f"[kernels] decode_attention {label} B{b} S{slots} fill {fill} "
              f"H{h} KV{kv} D{d}: kernel {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms per call back to back), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {kv_bytes / 1e6:.2f} MB of K/V)", flush=True)
        return dict(shape=f"B{b} S{slots} fill {fill} H{h} KV{kv} D{d}"
                    + (" with lse" if lse else ""),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)

    out["decode_attention"] = [
        dict(max_abs_err=max(errs[128]),
             **time_decode(32, 4, 128, MAX_SEQ,
                           PROMPT + LONGEST * TOKENS_PER_BLOCK // 2,
                           "yi-6b")),
        dict(max_abs_err=max(errs[128]),
             **time_decode(32, 4, 128, MAX_SEQ,
                           PROMPT + LONGEST * TOKENS_PER_BLOCK // 2,
                           "yi-6b", lse=True)),
        dict(max_abs_err=max(errs[256]),
             **time_decode(10, 1, 256, 2048, PROMPT + TOKENS_PER_BLOCK,
                           "recurrentgemma-2b")),
        dict(max_abs_err=max(errs["G7"]),
             **time_decode(56, 8, 128, MAX_SEQ,
                           PROMPT + LONGEST * TOKENS_PER_BLOCK // 2,
                           "yi-34b")),
        dict(max_abs_err=max(errs[32]),
             **time_decode(4, 2, 32, REDUCED_MAX_SEQ, REDUCED_PROMPT + 8,
                           "reduced yi-6b serve (make smoke)", b=1))]
    return out


def check_decode_lse(name: str, q, kc, vc, length, out) -> None:
    """The decode kernel with its lse: ``out`` bitwise the kernel's without
    it, the lse within ATTN_TOL + ATTN_TOL * |plain| of the plain lse and
    -inf exactly where a row's length is 0."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    got, lse = decode_attention_cuda(q, kc, vc, length, return_lse=True)
    _, want = decode_attention_plain(q.float(), kc.float(), vc.float(),
                                     length, return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(got, out):
        fail(f"decode_attention {name}: out differs with the lse asked for")
    empty = (length == 0)[:, None].expand_as(lse)
    if not bool((torch.isneginf(lse) == empty).all()) \
            or not bool(torch.isneginf(want)[empty].all()):
        fail(f"decode_attention {name}: lse is not -inf exactly at length 0")
    keep = ~empty
    check_close(f"decode_attention {name} lse", lse[keep], want[keep])


def kernel_ssd(gen: torch.Generator) -> dict:
    """The SSD scan against its plain (chunked fp32) version; times at the
    mamba2-2.7b prefill shape.  No single PyTorch call computes the scan,
    so there is no library time."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_plain

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(b, s, h, p, g, n, init, decay=1.0):
        return ((randn(b, s, h, p) * 0.5).to(torch.bfloat16),
                F.softplus(randn(b, s, h)), -torch.exp(randn(h)) * decay,
                (randn(b, s, g, n) * 0.3).to(torch.bfloat16),
                (randn(b, s, g, n) * 0.3).to(torch.bfloat16),
                randn(b, h, p, n) * 0.2 if init else None)

    serve = (B, PROMPT, 80, 64, 1, 128, 128, False)
    cases = [
        # name, (B, S, H, P, G, N, chunk, initial_state[, decay])
        ("serve B4 S1024 H80 P64 G1 N128 chunk128", serve),
        # A dt << 0: exp(cum) underflows within a step or two.
        ("strong decay A*300 S256 with initial_state",
         (2, 256, 4, 64, 1, 128, 128, True, 300.0)),
        ("G2 S=chunk=64", (2, 64, 8, 32, 2, 64, 64, False)),
        ("G4 S320 chunk64 with initial_state", (3, 320, 8, 64, 4, 128, 64,
                                                True)),
        ("G4 S320 chunk64 without initial_state", (3, 320, 8, 64, 4, 128, 64,
                                                   False)),
        ("ragged P24 N40 chunk48 S96 with initial_state",
         (1, 96, 3, 24, 1, 40, 48, True)),
    ]
    errs = []
    for name, (b, s, h, p, g, n, chunk, init, *decay) in cases:
        x, dt, A, Bm, Cm, h0 = inputs(b, s, h, p, g, n, init, *decay)
        y, state = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
        again = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
        want_y, want_state = ssd_plain(x.float(), dt, A, Bm.float(),
                                       Cm.float(), chunk=chunk,
                                       initial_state=h0)
        torch.cuda.synchronize()
        errs.append(check_close(f"ssd_scan {name} y", y, want_y, SCAN_TOL))
        errs.append(check_close(f"ssd_scan {name} state", state, want_state,
                                SCAN_TOL))
        if not (torch.equal(y, again[0]) and torch.equal(state, again[1])):
            fail(f"ssd_scan {name}: two launches on one input differ")
    print("[kernels] ssd_scan: two launches bitwise equal in every case",
          flush=True)

    b, s, h, p, g, n, chunk, _ = serve
    x, dt, A, Bm, Cm, _ = inputs(b, s, h, p, g, n, False)
    y, state = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    nc = s // chunk
    # per (b, h, chunk): C B^T, L x, C state^T and the chunk state
    flops = 2.0 * b * h * nc * chunk * (chunk * n + chunk * p + 2 * p * n)
    total = nbytes(x, dt, A, Bm, Cm, y, state)
    b_ms, b_by = bound(flops, total)
    ms = device_ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk), 20)
    plain_ms = device_ms(lambda: ssd_plain(x, dt, A, Bm, Cm, chunk=chunk), 3)
    print(f"[kernels] ssd_scan serve B{b} S{s} H{h} P{p} G{g} N{n} chunk "
          f"{chunk}: kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} "
          f"ms, library none, bound {b_ms:.4f} ms ({b_by}; "
          f"{total / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(shape=f"B{b} S{s} H{h} P{p} G{g} N{n} chunk {chunk}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def kernel_ssd_bwd(gen: torch.Generator) -> dict:
    """The SSD backward against its plain version (the chunked formula in
    float32) on the same bf16 x, B, C, dy and fp32 dt, A, initial state
    and final-state cotangent: each gradient within max(SSD_BWD_REL_L2, 2 x
    floor) relative L2, the floor being the plain formula with bf16
    operands against it in fp32, and within SSD_BWD_REL_L2 whatever the
    floor; two launches bitwise equal.  Times at mamba2-2.7b's training
    shape, each of its CUDA kernels' own time and the bytes of its dB / dC
    partials.  No single PyTorch call computes the backward, so there is
    no library time."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan_bwd import flops as ssd_bwd_flops
    from repro_torch.kernels.ssd_scan_bwd import (
        kernel_chunk,
        plan,
        ssd_bwd_cuda,
        ssd_bwd_plain,
    )

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(b, s, h, p, g, n, init, dstate, decay=1.0):
        return ((randn(b, s, h, p) * 0.5).to(torch.bfloat16),
                F.softplus(randn(b, s, h)), -torch.exp(randn(h)) * decay,
                (randn(b, s, g, n) * 0.3).to(torch.bfloat16),
                (randn(b, s, g, n) * 0.3).to(torch.bfloat16),
                randn(b, s, h, p).to(torch.bfloat16),
                randn(b, h, p, n) * 0.5 if dstate else None,
                randn(b, h, p, n) * 0.2 if init else None)

    train = (B, PROMPT, 80, 64, 1, 128, 128, False, False)
    cases = [
        # name, (B, S, H, P, G, N, chunk, initial_state, dstate[, decay])
        ("mamba2 train B4 S1024 H80 P64 G1 N128 chunk128", train),
        ("G2 S256 chunk64 with initial_state and dstate",
         (2, 256, 8, 64, 2, 128, 64, True, True)),
        ("G4 S=chunk=64", (2, 64, 8, 32, 4, 64, 64, False, True)),
        ("chunk256 S512 P32 N32 with initial_state",
         (2, 512, 4, 32, 1, 32, 256, True, False)),
        # A dt << 0: exp(cum) underflows within a step or two.
        ("strong decay A*300 S256 with initial_state and dstate",
         (2, 256, 4, 64, 1, 128, 128, True, True, 300.0)),
        ("ragged P24 N40 chunk48 S96 with initial_state and dstate",
         (1, 96, 3, 24, 1, 40, 48, True, True)),
        # both warpgroups of a CTA take its rows, each half of dB's and
        # dC's columns
        ("widest P128 N128 chunk64 S128 with initial_state and dstate",
         (1, 128, 2, 128, 1, 128, 64, True, True)),
        # rows no multiple of 16 bytes: x, dy, B and C by plain loads
        ("plain loads P21 N35 chunk48 S96 with initial_state and dstate",
         (1, 96, 3, 21, 1, 35, 48, True, True)),
    ]
    names = ("dx", "ddt", "dA", "dB", "dC", "d initial_state")
    errs = []
    for name, (b, s, h, p, g, n, chunk, init, dst, *decay) in cases:
        x, dt, A, Bm, Cm, dy, ds, h0 = inputs(b, s, h, p, g, n, init, dst,
                                              *decay)
        kw = dict(chunk=chunk, initial_state=h0)
        got = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
        again = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, ds, **kw)
        truth = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds, **kw)
        plain16 = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, ds,
                                dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)
                   if u is not None):
            fail(f"ssd_scan_bwd {name}: two launches differ")
        for grad, k, w, f16 in zip(names, got, truth, plain16):
            if w is None:
                continue
            if k.shape != w.shape or k.dtype != w.dtype \
                    or not torch.isfinite(k).all():
                fail(f"ssd_scan_bwd {name} {grad}: {tuple(k.shape)} "
                     f"{k.dtype} or non-finite")
            abs_err = float((k.float() - w.float()).abs().max())
            errs.append(abs_err)
            if not w.any():
                print(f"[kernels] ssd_scan_bwd {name} {grad}: plain all "
                      f"zero, kernel {'all zero' if not k.any() else 'NOT'}",
                      flush=True)
                if k.any():
                    fail(f"ssd_scan_bwd {name} {grad} is not zero")
                continue
            err, floor = rel_l2(k, w), rel_l2(f16, w)
            limit = max(SSD_BWD_REL_L2, 2 * floor)
            ok = err <= limit and err <= SSD_BWD_REL_L2
            print(f"[kernels] ssd_scan_bwd {name} {grad}: relative L2 "
                  f"{err:.3e} (bound {limit:.3e} = max({SSD_BWD_REL_L2}, 2 x "
                  f"floor {floor:.3e}), and at most {SSD_BWD_REL_L2}), "
                  f"max_abs_err {abs_err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"ssd_scan_bwd {name} {grad} disagrees with its plain "
                     f"version")
    print("[kernels] ssd_scan_bwd: two launches bitwise equal in every case",
          flush=True)

    b, s, h, p, g, n, chunk, _, _ = train
    x, dt, A, Bm, Cm, dy, _, _ = inputs(b, s, h, p, g, n, False, False)
    # the bound from the products the gradients need; the design's (its
    # triangles by 64 x 64 blocks, Z·B and Zᵀ·C per head) printed beside it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flops, flops_done = ssd_bwd_flops(b, s, h, p, g, n, chunk, sms)
    grads = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=chunk)
    total = nbytes(x, dt, A, Bm, Cm, dy) + nbytes(*grads[:5])
    b_ms, b_by = bound(flops, total)
    ms = device_ms(lambda: ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=chunk),
                   20)
    plain_ms = device_ms(
        lambda: ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=chunk), 3)
    parts = kernel_times(
        lambda: ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=chunk), 10,
        r"ssd_bwd_\w+")
    by_kernel = ", ".join(f"{k} {t:.4f}" for k, t in parts.items())
    # dB and dC leave the chunk pass as one fp32 partial per slice of R
    # heads, written once and read once by the reductions
    nck = s // kernel_chunk(chunk, p, n)
    R = plan(b, nck, h, g, sms)
    partial_bytes = 2 * 2 * b * s * g * -(-(h // g) // R) * n * 4
    per_head_bytes = 2 * 2 * b * s * h * n * 4
    print(f"[kernels] ssd_scan_bwd train: dB / dC partials {R} heads a "
          f"slice, {partial_bytes / 1e6:.1f} MB written and read (per-head "
          f"partials would move {per_head_bytes / 1e6:.1f} MB, "
          f"{per_head_bytes / partial_bytes:.0f}x)", flush=True)
    print(f"[kernels] ssd_scan_bwd train B{b} S{s} H{h} P{p} G{g} N{n} chunk "
          f"{chunk}: kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} "
          f"ms, library none, bound {b_ms:.4f} ms ({b_by}; "
          f"{total / 1e6:.2f} MB over {PEAK_BYTES / 1e12} TB/s = "
          f"{total / PEAK_BYTES * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP the "
          f"gradients need over {PEAK_FLOPS / 1e12:.0f} TFLOP/s = "
          f"{flops / PEAK_FLOPS * 1e3:.4f} ms; {flops_done / 1e9:.2f} GFLOP "
          f"as designed = {bound(flops_done, total)[0]:.4f} ms); kernel at "
          f"{b_ms / ms:.1%} of the bound and "
          f"{bound(flops_done, total)[0] / ms:.1%} of the design's; device "
          f"ms per call by "
          f"CUDA kernel (torch.profiler, 10 calls): "
          f"{by_kernel or 'not measured'}", flush=True)
    return dict(shape=f"B{b} S{s} H{h} P{p} G{g} N{n} chunk {chunk}",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def kernel_rglru(gen: torch.Generator) -> list:
    """The RG-LRU scan against its plain (sequential fp32) version, two
    launches on one input bitwise equal, h and the final state bitwise the
    same with the entering states asked for (the training path's launch)
    and those states within SCAN_TOL of the plain forward's; times at the
    recurrentgemma-2b prefill shape and at one request's (B 1), without
    and with the entering states.  No single PyTorch call computes the
    recurrence, so there is no library time."""
    from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(b, s, c, init, decay=1.0, gate_a_scale=1.0):
        return ((randn(b, s, c) * 0.5).to(torch.bfloat16),
                torch.sigmoid(randn(b, s, c)) * gate_a_scale,
                torch.sigmoid(randn(b, s, c)),
                -torch.nn.functional.softplus(randn(c)) * decay,
                randn(b, c) if init else None)

    serve, single = (B, PROMPT, 2560, False), (1, PROMPT, 2560, False)
    cases = [
        # name, (B, S, C, initial_state[, log_a scale[, gate_a scale]])
        ("serve B4 S1024 C2560", serve),
        ("B1 S1024 C2560", single),
        ("S300 C384 with initial_state", (2, 300, 384, True)),
        ("S77 C100", (3, 77, 100, False)),
        # TMA route, ragged: C a multiple of 8 but not of the 32-channel
        # tile, S not a multiple of the 64-step chunk.
        ("ragged S333 C200 with initial_state", (2, 333, 200, True)),
        # log_a x 100: products of a (and a) underflow to 0.
        ("strong decay log_a*100 S300 C256", (2, 300, 256, True, 100.0)),
        # gate_a ~ 0: a ~ 1, beta ~ 0.
        ("near one gate_a*1e-6 S300 C256", (2, 300, 256, True, 1.0, 1e-6)),
    ]
    errs = []
    for name, (b, s, c, init, *scales) in cases:
        x, ga, gi, la, h0 = inputs(b, s, c, init, *scales)
        h, state = rglru_cuda(x, ga, gi, la, initial_state=h0)
        again = rglru_cuda(x, ga, gi, la, initial_state=h0)
        with_entering = rglru_cuda(x, ga, gi, la, initial_state=h0,
                                   entering=True)
        want_h, want_state, want_entering = rglru_plain(
            x.float(), ga, gi, la, initial_state=h0, entering=True)
        torch.cuda.synchronize()
        errs.append(check_close(f"rglru_scan {name} h", h, want_h, SCAN_TOL))
        errs.append(check_close(f"rglru_scan {name} state", state,
                                want_state, SCAN_TOL))
        errs.append(check_close(f"rglru_scan {name} entering states",
                                with_entering[2], want_entering, SCAN_TOL))
        if not (torch.equal(h, again[0]) and torch.equal(state, again[1])):
            fail(f"rglru_scan {name}: two launches on one input differ")
        if not (torch.equal(h, with_entering[0])
                and torch.equal(state, with_entering[1])):
            fail(f"rglru_scan {name}: h or the state differs with the "
                 f"entering states asked for")
    print("[kernels] rglru_scan: two launches bitwise equal in every case, "
          "and with the entering states asked for", flush=True)

    def time_rglru(b, s, c, label):
        """Times with input copies in turn, at least 100 MB of them, so the
        50 MB L2 does not hold a launch's inputs (10 bytes an element: the
        serve shape's 105 MB need one copy, B 1 four)."""
        copies = [inputs(b, s, c, False)[:4]
                  for _ in range(-(-100_000_000 // (b * s * c * 10)))]
        turn = [0]

        def run(fn):
            args = copies[turn[0] % len(copies)]
            turn[0] += 1
            return fn(*args)

        x, ga, gi, la = copies[0]
        h, state = rglru_cuda(x, ga, gi, la)
        # per element: 2 exp, a sqrt and ~7 multiply-adds, in fp32
        flops = 10.0 * b * s * c
        total = nbytes(x, ga, gi, la, h, state)
        b_ms, b_by = bound(flops, total, PEAK_FP32)

        def entering(*args):
            return rglru_cuda(*args, entering=True)

        # without and with the entering states, in turns
        times = [device_ms(lambda: run(fn), 100)
                 for fn in (rglru_cuda, entering, entering, rglru_cuda)]
        ms, entering_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        # The plain version is a Python loop over the 1024 steps, ~10k small
        # operations: more than the launch queue holds behind device_ms's
        # sleep, so it is timed back to back (host-paced, as it runs).
        plain_ms = wall_ms(lambda: run(rglru_plain), 2)
        print(f"[kernels] rglru_scan {label} B{b} S{s} C{c}: kernel {ms:.4f} "
              f"ms on the device ({times[0]:.4f}, {times[3]:.4f}), with the "
              f"entering states {entering_ms:.4f} ms ({times[1]:.4f}, "
              f"{times[2]:.4f}; in turns), plain {plain_ms:.4f} ms (back to "
              f"back), library none, bound {b_ms:.4f} ms ({b_by}; "
              f"{total / 1e6:.2f} MB; kernel at {b_ms / ms:.1%} of it)",
              flush=True)
        return dict(shape=f"B{b} S{s} C{c}", max_abs_err=max(errs), ms=ms,
                    entering_ms=entering_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    return [time_rglru(*serve[:3], "serve"),
            time_rglru(*single[:3], "one request")]


def kernel_rglru_bwd(gen: torch.Generator) -> dict:
    """The RG-LRU backward against its plain version (the sequential
    formula in float32) on the same bf16 x and dh and fp32 gates, log_a,
    initial state and final-state cotangent, the kernel given the states
    entering each chunk by the forward kernel: dx within
    max(RGLRU_BWD_REL_L2, 2 x floor) relative L2 and the fp32 gradients
    within RGLRU_BWD_F32_REL_L2, two launches bitwise equal.  Times at
    recurrentgemma-2b's training shape (its 18 recurrent layers' shape)
    against the bound of the bytes it must move, and prints the CTAs an
    SM holds.  No single PyTorch call computes the backward, so there is
    no library time."""
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rglru_scan_bwd import (
        TILE,
        occupancy,
        rglru_bwd_cuda,
        rglru_bwd_plain,
    )

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(b, s, c, init, dstate, decay=1.0, gate_a_scale=1.0,
               zero_share=0.0):
        x = (randn(b, s, c) * 0.5).to(torch.bfloat16)
        ga = torch.sigmoid(randn(b, s, c)) * gate_a_scale
        if zero_share:
            zero = torch.rand((b, s, c), generator=gen, device="cuda")
            ga = ga.masked_fill(zero < zero_share, 0.0)
        return (x, ga, torch.sigmoid(randn(b, s, c)),
                -torch.nn.functional.softplus(randn(c)) * decay,
                randn(b, s, c).to(torch.bfloat16),
                randn(b, c) if dstate else None,
                randn(b, c) if init else None)

    train = (B, PROMPT, 2560, False, False)
    cases = [
        # name, (B, S, C, initial_state, dstate[, log_a scale[, gate_a
        # scale[, share of gate_a set to 0]]])
        ("recurrentgemma train B4 S1024 C2560", train),
        ("ragged C100 S130 with initial_state and dstate",
         (2, 130, 100, True, True)),
        ("ragged C35 S77 with dstate", (3, 77, 35, False, True)),
        # TMA route, ragged: C a multiple of 8 but not of the 32-channel
        # tile, S not a multiple of the 64-step chunk.
        ("ragged C200 S333 with initial_state and dstate",
         (2, 333, 200, True, True)),
        ("S0 C256 with initial_state and dstate", (2, 0, 256, True, True)),
        # log_a x 100: a (and its products) underflow to 0
        ("strong decay log_a*100 S300 C256 with initial_state and dstate",
         (2, 300, 256, True, True, 100.0)),
        # gate_a ~ 1e-3: beta small, e / beta large
        ("gates near 0 gate_a*1e-3 S300 C256 with initial_state and dstate",
         (2, 300, 256, True, True, 1.0, 1e-3)),
        # gate_a exactly 0: L 0, 1 - exp(2L) = 0, beta 0 and its derivative
        # taken as 0
        ("gate_a 0 at a fifth of steps S300 C256 with initial_state and "
         "dstate", (2, 300, 256, True, True, 1.0, 1.0, 0.2)),
    ]
    names = ("dx", "d gate_a", "d gate_i", "d log_a", "d initial_state")
    errs = []
    for name, (b, s, c, init, dst, *scales) in cases:
        x, ga, gi, la, dh, ds, h0 = inputs(b, s, c, init, dst, *scales)
        entering = rglru_cuda(x, ga, gi, la, initial_state=h0,
                              entering=True)[2]
        got = rglru_bwd_cuda(x, ga, gi, la, dh, ds, entering=entering,
                             initial_state=h0)
        again = rglru_bwd_cuda(x, ga, gi, la, dh, ds, entering=entering,
                               initial_state=h0)
        truth = rglru_bwd_plain(x.float(), ga, gi, la, dh, ds,
                                initial_state=h0)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)
                   if u is not None):
            fail(f"rglru_scan_bwd {name}: two launches differ")
        for grad, k, w in zip(names, got, truth):
            if w is None:
                continue
            if k.shape != w.shape or not torch.isfinite(k).all():
                fail(f"rglru_scan_bwd {name} {grad}: {tuple(k.shape)} or "
                     f"non-finite")
            abs_err = float((k.float() - w.float()).abs().max()) \
                if k.numel() else 0.0
            errs.append(abs_err)
            if not w.any():
                print(f"[kernels] rglru_scan_bwd {name} {grad}: plain all "
                      f"zero, kernel {'all zero' if not k.any() else 'NOT'}",
                      flush=True)
                if k.any():
                    fail(f"rglru_scan_bwd {name} {grad} is not zero")
                continue
            err = rel_l2(k, w)
            if k.dtype == torch.bfloat16:
                floor = rel_l2(w.to(k.dtype), w)
                limit = max(RGLRU_BWD_REL_L2, 2 * floor)
                why = f"max({RGLRU_BWD_REL_L2}, 2 x floor {floor:.3e})"
            else:
                limit, why = RGLRU_BWD_F32_REL_L2, "fp32"
            ok = err <= limit
            print(f"[kernels] rglru_scan_bwd {name} {grad}: relative L2 "
                  f"{err:.3e} (bound {limit:.3e} = {why}), max_abs_err "
                  f"{abs_err:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"rglru_scan_bwd {name} {grad} disagrees with its "
                     f"plain version")
    print("[kernels] rglru_scan_bwd: two launches bitwise equal in every "
          "case", flush=True)

    b, s, c, _, _ = train
    # Input copies in turn, over 100 MB of them (22 B an element: one copy
    # of the training shape's 231 MB), so the L2 holds no launch's inputs;
    # each with the forward kernel's entering states.
    copies = []
    for _ in range(-(-100_000_000 // (b * s * c * 22))):
        x, ga, gi, la, dh = inputs(b, s, c, False, False)[:5]
        copies.append((x, ga, gi, la, dh,
                       rglru_cuda(x, ga, gi, la, entering=True)[2]))
    turn = [0]

    def run(fn):
        args = copies[turn[0] % len(copies)]
        turn[0] += 1
        return fn(*args)

    def kernel(x, ga, gi, la, dh, entering):
        return rglru_bwd_cuda(x, ga, gi, la, dh, entering=entering)

    def plain(x, ga, gi, la, dh, entering):
        return rglru_bwd_plain(x, ga, gi, la, dh)

    grads = kernel(*copies[0])
    # the least traffic: read x, dh (bf16), both gates and the entering
    # states (fp32), write dx (bf16) and both gate gradients (fp32); ~25
    # fp32 operations an element (3 exp, a sqrt, a divide, the
    # multiply-adds)
    total = nbytes(*copies[0]) + nbytes(*grads[:4])
    flops = 25.0 * b * s * c
    b_ms, b_by = bound(flops, total, PEAK_FP32)
    ms = device_ms(lambda: run(kernel), 50)
    # The plain version is a Python loop over the steps, twice: timed back
    # to back (host-paced, as it runs), as the forward's is.
    plain_ms = wall_ms(lambda: run(plain), 1)
    parts = kernel_times(lambda: run(kernel), 10, r"rglru_bwd_\w+")
    blocks = occupancy(tma=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = b * -(-c // TILE)
    print(f"[kernels] rglru_scan_bwd train: the scan kernel holds {blocks} "
          f"CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
          f"{min(ctas, blocks * sms)} of its {ctas} CTAs resident at once "
          f"on {sms} SMs", flush=True)
    by_kernel = ", ".join(f"{k} {t:.4f}" for k, t in parts.items())
    print(f"[kernels] rglru_scan_bwd train B{b} S{s} C{c}: kernel {ms:.4f} "
          f"ms on the device, plain {plain_ms:.4f} ms (back to back), "
          f"library none, bound {b_ms:.4f} ms ({b_by}; {total / 1e6:.2f} MB "
          f"over {PEAK_BYTES / 1e12} TB/s; {flops / 1e9:.2f} GFLOP fp32 "
          f"over {PEAK_FP32 / 1e12:.0f} TFLOP/s = "
          f"{flops / PEAK_FP32 * 1e3:.4f} ms); kernel at {b_ms / ms:.1%} of "
          f"the bound; device ms per call by CUDA kernel (torch.profiler, "
          f"10 calls): {by_kernel or 'not measured'}", flush=True)
    return dict(shape=f"B{b} S{s} C{c}", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


KINDS = {   # device-time classes of the profiler's kernel names
    "attention kernels": ("flash_fwd_kernel", "flash_bwd",
                          "decode_attention_kernel"),
    "scan kernels": ("ssd_scan_kernel", "ssd_bwd", "rglru_scan_kernel",
                     "rglru_bwd"),
    "matmuls": ("gemm", "xmma", "cutlass", "nvjet"),
}


def profile(fn, n: int, what: str, tag: str = "model") -> None:
    """torch.profiler over ``n`` calls: device busy time by kind of kernel,
    and the device's idle share between the first kernel's start and the
    last one's end; printed on ``[tag]`` lines."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kinds = {kind: 0.0 for kind in list(KINDS) + ["other"]}
    first, last = math.inf, -math.inf
    attention = set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        named = re.search(r"(decode|flash)\w*kernel(<[^>]*>)?", e.name)
        if named:
            attention.add(named.group(0))
        kind = next((k for k, tags in KINDS.items()
                     if any(t in name for t in tags)), "other")
        kinds[kind] += e.time_range.elapsed_us()
        first = min(first, e.time_range.start)
        last = max(last, e.time_range.end)
    busy = sum(kinds.values())
    if busy == 0.0:
        print(f"[{tag}] profiler recorded no device time for the {what}: "
              f"device busy and idle share not measured", flush=True)
        return
    parts = ", ".join(f"{k} {v / 1e3 / n:.3f} ms" for k, v in kinds.items())
    print(f"[{tag}] profiled {what} (torch.profiler, {n} calls): device busy "
          f"{busy / 1e3 / n:.3f} ms per call ({parts}); device idle "
          f"{1 - busy / (last - first):.1%} of the "
          f"{(last - first) / 1e3 / n:.3f} ms per call between first and "
          f"last kernel; attention kernels by name: "
          f"{sorted(attention) or 'none'}", flush=True)


class Routes:
    """Within ``with``: the experts every MoE layer picks, call by call
    (``models.moe.route`` wrapped).  Given ``replay``, another run's
    picks, each call routes to the replayed experts instead, with gates
    renormalised from this run's probabilities, and still records the
    experts it would have picked."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe

        self.picks, self._route = [], moe.route

        def route(*args, **kwargs):
            probs, gate, idx = self._route(*args, **kwargs)
            self.picks.append(idx)
            if self.replay is not None:
                idx = self.replay[len(self.picks) - 1]
                gate = probs.gather(-1, idx)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9)
            return probs, gate, idx

        moe.route = route
        return self.picks

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route


def rerouted(a, b) -> str:
    """Share of (layer, token) routings whose set of experts differs."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    total = sum(x[..., 0].numel() for x in a)
    return f"{diff}/{total} = {diff / max(total, 1):.3%}"



def reset_counts() -> None:
    """Set every kernel's launch count to 0: the model's seven
    (``ops.KERNELS``) and the threefry kernel, which draws the weights and
    batches."""
    from repro_torch.kernels import ops, threefry

    ops.reset_launch_counts()
    threefry.threefry_cuda.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import ops, threefry

    return {**ops.launch_counts(),
            "threefry": threefry.threefry_cuda.launches}


def randn_init(cfg, seed: int = 0, device="cuda",
               dtype=torch.bfloat16) -> dict:
    """The port's ``lm.init`` before the threefry kernel: every random
    leaf from ``torch.randn`` with one generator, one repeat at a time
    through a float32 transient.  Kept here only to time the init
    against."""
    from repro_torch.models import lm
    from repro_torch.models.bridge import leaf_dtype, params_from_numpy

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = {}
    for key, (shape, how) in lm.param_shapes(cfg).items():
        if isinstance(how, str):
            flat[key] = lm._fixed_init(how, shape[-1]).to(device).expand(
                shape).clone()
            continue
        t = torch.empty(shape, dtype=leaf_dtype(key, dtype), device=device)
        stacked_leaf = key.startswith(("stage", "encoder/layers"))
        for part in (t if stacked_leaf else [t]):
            part.copy_(torch.randn(part.shape, generator=gen,
                                   device=device).mul_(how))
        flat[key] = t
    return params_from_numpy(cfg, flat, device=device, dtype=dtype)


def threefry_agree(label: str, got: torch.Tensor, want: torch.Tensor,
                   exact: bool) -> float:
    """Fail unless ``got`` equals ``want`` bitwise (``exact``) or within
    THREEFRY_ULPS float32 ulps (one bf16 ulp for bf16); print the bitwise
    share.  Returns the largest absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"threefry {label}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.int32:
        ulps = (got.long() - want.long()).abs()
    else:
        wide = got.dtype == torch.bfloat16
        a = (got.float() if wide else got).view(torch.int32).long()
        b = (want.float() if wide else want).view(torch.int32).long()
        ulps = (a - b).abs() >> (16 if wide else 0)
    limit = 0 if exact else (1 if got.dtype == torch.bfloat16
                             else THREEFRY_ULPS)
    worst, share = int(ulps.max()), float((ulps == 0).double().mean())
    err = float((got.double() - want.double()).abs().max())
    print(f"[threefry] {label}: {share:.6%} bitwise, at most {worst} "
          f"{'bf16 ' if got.dtype == torch.bfloat16 else ''}ulps apart "
          f"(limit {limit}), max_abs_err {err:.3e}", flush=True)
    if worst > limit or not torch.isfinite(got.double()).all():
        fail(f"threefry {label} disagrees with its plain version")
    return err


def phase_threefry() -> list:
    """The threefry kernel against its plain version on the card, yi-6b's
    init against the CPU plain version, the kernel's time against its
    bound, yi-34b's init time against the torch.randn init's (and its key
    tree's share), and a train block's tokens drawn on the card."""
    from repro_torch import prng, tree
    from repro_torch.configs import get_arch
    from repro_torch.core import jobs
    from repro_torch.kernels import threefry
    from repro_torch.models import lm

    key = prng.fold_in(prng.key(0), 12345)
    errs = []
    cases = [
        ("bits", 1 << 24, "bits", {}, torch.int32, 0),
        ("bits past counter 2**32", 1 << 20, "bits", {}, torch.int32,
         2 ** 32 - 4096),
        ("uniform [1e-6, 1) (tokens)", 1 << 24, "uniform",
         dict(lo=1e-6, hi=1.0), torch.float32, 0),
        ("uniform [-3, 0.5)", 1 << 20, "uniform", dict(lo=-3.0, hi=0.5),
         torch.float32, 7),
        ("normal x 1/sqrt(4096)", 1 << 24, "normal",
         dict(scale=1 / math.sqrt(4096)), torch.float32, 0),
        ("normal / sqrt(1536) into bf16", 1 << 24, "normal",
         dict(scale=math.sqrt(1536), divide=True), torch.bfloat16, 99),
        ("normal x 0.02 into bf16 (weights)", 1 << 24, "normal",
         dict(scale=0.02), torch.bfloat16, 0),
        ("bf16 normal x 0.02 (whisper's frames)", 4 * 1536 * 1280,
         "normal", dict(scale=0.02, bf16_math=True), torch.bfloat16, 0),
    ]
    for label, n, dist, kw, dtype, offset in cases:
        got = threefry.threefry_cuda(torch.empty(n, dtype=dtype,
                                                 device="cuda"), key, dist,
                                     offset=offset, **kw)
        torch.cuda.synchronize()
        plain = threefry.threefry_plain(key, n, dist, offset=offset,
                                        device="cuda", **kw).to(dtype)
        errs.append(threefry_agree(f"{label}, {n} elements at {offset}",
                                   got, plain, dist != "normal"))
        again = threefry.threefry_cuda(torch.empty_like(got), key, dist,
                                       offset=offset, **kw)
        if not torch.equal(again, got):
            fail(f"threefry {label}: two launches differ")
        del got, plain, again

    # Full-width yi-6b's serving init on the card against the plain
    # version on the CPU, on parts of a few leaves (offsets into the leaf).
    cfg = get_arch("yi-6b")
    params = lm.init(cfg, seed=0, device="cuda")
    draws = lm.draw_keys(cfg, 0)
    leaves = [("embed/table", None, params["embed"]["table"], 0),
              ("embed/table", None, params["embed"]["table"], 123_456_789),
              ("stage0/u0/mixer/wq", 0, params["stage0"]["u0"][0]["mixer"]
               ["wq"], 0),
              ("stage0/u0/mixer/wo", 31, params["stage0"]["u0"][31]["mixer"]
               ["wo"], 4_000_000),
              ("stage0/u0/ffn/down/w", 17, params["stage0"]["u0"][17]["ffn"]
               ["down"]["w"], 1_000_000)]
    for path, r, leaf, offset in leaves:
        keys, scale, divide = draws[path]
        flat = leaf.reshape(-1)[offset:offset + (1 << 20)]
        cpu = threefry.draw(torch.empty(flat.numel()), keys[r or 0],
                            "normal", scale=scale, divide=divide,
                            offset=offset)
        threefry_agree(f"yi-6b {path}{'' if r is None else f'[{r}]'} at "
                       f"{offset} (card vs CPU)", flat.cpu(),
                       cpu.to(torch.bfloat16), False)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Time on one yi-34b feed-forward leaf against its bound.
    n = THREEFRY_LEAF[0] * THREEFRY_LEAF[1]
    out = torch.empty(THREEFRY_LEAF, dtype=torch.bfloat16, device="cuda")
    scale = 1 / math.sqrt(THREEFRY_LEAF[0])
    ms = device_ms(lambda: threefry.threefry_cuda(out, key, scale=scale), 20)
    plain_ms = wall_ms(lambda: threefry.threefry_plain(
        key, n, scale=scale, device="cuda").to(torch.bfloat16), 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ms = threefry.int_ops(n, "normal") / (
        sms * INT32_PER_SM_CLOCK * BOOST_HZ) * 1e3
    flt_ms = threefry.float_ops(n, "normal") / PEAK_FP32 * 1e3
    byte_ms = n * out.element_size() / PEAK_BYTES * 1e3
    b_ms = max(int_ms, byte_ms)
    b_by = "operations" if int_ms > byte_ms else "bytes"
    print(f"[threefry] yi-34b ffn leaf {THREEFRY_LEAF} normal -> bf16: "
          f"kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} ms, "
          f"library none (torch.randn draws another stream), bound "
          f"{b_ms:.4f} ms ({b_by}: {threefry.int_ops(n, 'normal') / 1e9:.2f}"
          f" G integer operations at {sms} SMs x {INT32_PER_SM_CLOCK} x "
          f"{BOOST_HZ / 1e9} GHz = {int_ms:.4f} ms; stores {byte_ms:.4f} "
          f"ms; float operations {flt_ms:.4f} ms), kernel at "
          f"{b_ms / ms:.1%} of it", flush=True)
    del out
    torch.cuda.empty_cache()

    # Full-width yi-34b's init, this tree's kernel against torch.randn;
    # before each kernel init, its key tree (lm.draw_keys) alone.
    smi = card()
    big = get_arch("yi-34b")
    times = {}
    for name in ("randn", "threefry", "threefry", "randn"):
        fn = randn_init if name == "randn" else lm.init
        if name == "threefry":
            t0 = time.perf_counter()
            lm.draw_keys(big, 0)
            times.setdefault("keys", []).append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = fn(big, seed=0, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gib = sum(t.numel() * t.element_size()
                  for t in tree.leaves(p)) / 2 ** 30
        times.setdefault(name, []).append(secs)
        del p
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[threefry] yi-34b init ({name}): {secs:.3f} s, {gib:.1f} GiB "
              f"of weights; {smi}", flush=True)
    keys_s = sum(times["keys"]) / 2
    init_s = sum(times["threefry"]) / 2
    print(f"[threefry] yi-34b init, mean of two in turns: threefry kernel "
          f"{init_s:.3f} s, torch.randn {sum(times['randn']) / 2:.3f} s; "
          f"of the kernel's init, the key tree (lm.draw_keys, "
          f"{init_launches(big)} keys, host integers) "
          f"{keys_s * 1e3:.2f} ms and the rest (a launch a leaf part, the "
          f"fixed leaves, the layout) {init_s - keys_s:.3f} s; {smi}",
          flush=True)

    # One full-width train block's tokens (yi-6b, B x PROMPT) drawn on the
    # card (two bits launches and int64 arithmetic there), bitwise the
    # plain version's on the CPU; the host's ms to issue a draw, the
    # device's ms, and the wall ms of the host draw copied to the card.
    cfg6 = get_arch("yi-6b")
    for seed, block in ((0, 0), (3, 7)):
        got = jobs.train_tokens(cfg6, seed, block, B, PROMPT, device="cuda")
        want = prng.randint(prng.fold_in(prng.key(seed + 1), block),
                            (B, PROMPT), 0, cfg6.vocab_size)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            fail(f"train tokens of block {block} drawn on the card differ "
                 f"from the plain version's")
    prompt = jobs.serve_prompt(cfg6, 1, B, PROMPT, device="cuda")
    if not torch.equal(prompt.cpu(), prng.randint(
            prng.key(1), (B, PROMPT), 0, cfg6.vocab_size)):
        fail("a serve prompt drawn on the card differs from the plain "
             "version's")

    def tokens():
        return jobs.train_tokens(cfg6, 0, 5, B, PROMPT, device="cuda")

    tokens()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        tokens()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    tok_ms = device_ms(tokens, 20)
    copy_ms = wall_ms(lambda: prng.randint(
        prng.fold_in(prng.key(1), 5), (B, PROMPT), 0,
        cfg6.vocab_size).to("cuda"), 5)
    print(f"[threefry] yi-6b train block tokens {B} x {PROMPT} on the card, "
          f"bitwise the plain version's (and a serve prompt): host "
          f"{host_ms:.4f} ms to issue a draw, device {tok_ms:.4f} ms; "
          f"drawn on the host and copied {copy_ms:.4f} ms wall; {smi}",
          flush=True)
    return [dict(shape=f"{THREEFRY_LEAF[0]}x{THREEFRY_LEAF[1]} normal "
                       f"-> bf16", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=None)]


def phase_model(gen: torch.Generator, arch: str) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.bridge import leaf_dtype

    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] {arch} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}) initialised in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (4, B), generator=gen,
                          device="cuda")
    # whisper's frames and pixtral's patches, scaled as the data pipeline
    # scales them; the patches count against max_seq and the lengths.
    extra = {}
    if cfg.encoder is not None:
        extra["enc_frames"] = (0.02 * torch.randn(
            (B, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device="cuda")).to(torch.bfloat16)
    if cfg.n_patches:
        extra["patches"] = (0.02 * torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen,
            device="cuda")).to(torch.bfloat16)
    n0, max_seq = cfg.n_patches + PROMPT, cfg.n_patches + MAX_SEQ
    layers = [spec for stage in lm.build_plan(cfg)
              for spec in stage.unit * stage.repeats]
    cross = sum(spec.cross for spec in layers) if extra.get(
        "enc_frames") is not None else 0

    def run(backend, dtype=torch.bfloat16):
        logits, caches = lm.prefill(cfg, params, prompt, max_seq=max_seq,
                                    backend=backend, dtype=dtype, **extra)
        out = [logits.float()]
        lengths = torch.full((B,), n0, dtype=torch.int32, device="cuda")
        for tok in steps:
            logits, caches = lm.decode_step(cfg, params, tok, caches,
                                            lengths, backend=backend,
                                            dtype=dtype)
            out.append(logits.float())
            lengths = lengths + 1
        torch.cuda.synchronize()
        return out

    def rel_l2(got, want):
        return max(float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
                   for g, w in zip(got, want))

    # The plain runs route as the kernel run did (see MODEL_REL_L2).
    ops.reset_launch_counts()
    with Routes() as routes_kernel:
        got = run("kernel")
    launches = ops.launch_counts()
    if extra:
        # every attention layer (encoder, self, cross) through flash in the
        # prefill; each decode step's self attention through the decode
        # kernel and its cross attention through flash at Sq 1
        enc = cfg.encoder.n_layers if cross else 0
        want = {"flash_attention": enc + len(layers) + cross * 5,
                "decode_attention": 4 * len(layers)}
        print(f"[model] {arch} kernel launches {launches} (expected "
              f"{want}: {enc} encoder, {len(layers)} decoder and {cross} "
              f"cross layers, 4 decode steps)", flush=True)
        if any(launches[k] != n for k, n in want.items()):
            fail(f"{arch}: the kernel run launched {launches}, expected "
                 f"{want}")
    with Routes(routes_kernel) as routes_plain:
        want = run("ref")
    agree, total = 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != (B, cfg.padded_vocab) or not torch.isfinite(g).all():
            fail(f"{arch} step {i}: logits shape {tuple(g.shape)} or "
                 f"non-finite")
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
        total += B
    worst = rel_l2(got, want)
    # The fp32 run reads the bf16 weights and casts each at use (exact: bf16
    # values fit), so no float32 copy of the weights is made.
    with Routes(routes_kernel) as routes_truth:
        truth = run("ref", torch.float32)
    if not len(routes_kernel) == len(routes_plain) == len(routes_truth):
        fail(f"{arch}: the runs made {len(routes_kernel)}, "
             f"{len(routes_plain)} and {len(routes_truth)} routing calls")
    floor, kernel_to_truth = rel_l2(want, truth), rel_l2(got, truth)
    limit = max(MODEL_REL_L2, 2 * floor)
    print(f"[model] {arch} prefill + 4 decode steps, kernels vs plain: max "
          f"relative L2 error of logits {worst:.3e} (bound {limit:.3e} = "
          f"max({MODEL_REL_L2}, 2 x floor)), argmax agreement "
          f"{agree}/{total}; floor (plain bf16 vs plain fp32) {floor:.3e}, "
          f"kernels bf16 vs plain fp32 {kernel_to_truth:.3e}", flush=True)
    if routes_plain:
        print(f"[model] {arch} MoE tokens the plain runs would have routed "
              f"to another set of experts (all three runs take the kernel "
              f"run's): plain bf16 vs kernels "
              f"{rerouted(routes_kernel, routes_plain)}, plain fp32 vs "
              f"plain bf16 {rerouted(routes_plain, routes_truth)}",
              flush=True)
    if not worst < limit:
        fail(f"{arch}: full-width logits through the kernels disagree with "
             f"the plain versions")
    del truth, routes_kernel, routes_plain, routes_truth

    # Where a serving step's time goes: prefill and decode-step wall time
    # (back to back, as the serving loop runs them), then the profiler.
    # A decode step reads every decoder weight once (not the encoder's,
    # nor cross attention's key and value projections, whose outputs the
    # prefill cached); with tied embeddings the head reads the whole
    # embedding table too.  It reads the cached cross keys and values
    # whole.
    weight_bytes = sum(
        math.prod(shape) * leaf_dtype(key, torch.bfloat16).itemsize
        for key, (shape, _) in lm.param_shapes(cfg).items()
        if (key != "embed/table" or cfg.tie_embeddings)
        and not key.startswith("encoder/")
        and not re.search(r"/cross/(wk|wv|bk|bv)$", key))

    def do_prefill():
        return lm.prefill(cfg, params, prompt, max_seq=max_seq, **extra)

    prefill_ms = wall_ms(do_prefill, 3)
    _, caches = do_prefill()
    cross_bytes = sum(nbytes(*unit["cross"].values())
                      for stage in caches.values() for unit in stage.values()
                      if "cross" in unit)
    lengths = torch.full((B,), n0, dtype=torch.int32, device="cuda")

    def step():
        lm.decode_step(cfg, params, steps[0], caches, lengths)

    step_ms = wall_ms(step, 10, warmup=2)
    read = weight_bytes + cross_bytes
    print(f"[model] {arch} prefill B{B} S{n0}"
          + (f" + {cfg.encoder.n_frames} frames" if cross else "")
          + f": {prefill_ms:.3f} ms; decode step B{B}: {step_ms:.3f} ms; "
          f"decode-step bound: {weight_bytes / 1e9:.2f} GB of weights"
          + (f" + {cross_bytes / 1e9:.2f} GB of cross keys and values"
             if cross_bytes else "")
          + f" / 3.35 TB/s = {read / PEAK_BYTES * 1e3:.3f} ms", flush=True)
    profile(step, 3, f"{arch} decode step")
    profile(do_prefill, 1, f"{arch} prefill")
    del got, want, caches
    timed("graphs", phase_graphs, arch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_graphs(arch: str, cfg, params) -> None:
    """A serve job's decode step on the card as the job runs it
    (``core.jobs.DecodeStep``: the prompt alone, as a serve job passes
    it; a prefill, the capture of one step as a CUDA graph after its eager
    warm-up steps, then the first block's prefill into the same caches
    and GRAPH_BLOCKS blocks of TOKENS_PER_BLOCK replays), held bitwise to
    the eager ``lm.decode_step`` loop (every step's token and logits, the
    caches at the end); then the step's wall ms graphed and eager in
    turns (eager, graphed, graphed, eager; each the same body on the same
    buffers, 10 steps back to back after a fresh prefill) and the device
    idle share of a graphed step (torch.profiler)."""
    from repro_torch.core import jobs
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    prompt = jobs.serve_prompt(cfg, 0, B, PROMPT, device="cuda")
    step = jobs.DecodeStep(cfg, params, prompt, MAX_SEQ)
    step.prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    step.prefill()
    n = GRAPH_BLOCKS * TOKENS_PER_BLOCK
    got = []
    for _ in range(n):
        logits = step()
        got.append((step.token.clone(), logits.clone()))
    logits, caches = lm.prefill(cfg, params, prompt, max_seq=MAX_SEQ)
    token = torch.argmax(logits, -1)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
    for i, (tok, logits) in enumerate(got):
        want, caches = lm.decode_step(cfg, params, token, caches, lengths)
        token = torch.argmax(want, -1)
        lengths = lengths + 1
        if not (torch.equal(tok, token) and torch.equal(logits, want)):
            fail(f"graphs {arch}: replayed step {i} differs from the eager "
                 f"step (tokens {tok.tolist()} vs {token.tolist()})")
    for g, w in zip(leaves(step.caches), leaves(caches)):
        if not torch.equal(g, w):
            fail(f"graphs {arch}: the caches after {n} replays differ from "
                 f"the eager loop's")
    del got, caches, want
    counts = {fn.__name__: k for fn, k in step.graph.counts.items()}
    print(f"[graphs] {arch}: {GRAPH_BLOCKS} blocks of {TOKENS_PER_BLOCK} "
          f"replays bitwise the eager steps (tokens, logits, caches); "
          f"capture {capture_s:.3f} s; launches a replay {counts}",
          flush=True)

    def eager():
        jobs.decode_in_place(cfg, params, step.token, step.caches,
                             step.lengths)

    times = {"eager": [], "graphed": []}
    for kind in ("eager", "graphed", "graphed", "eager"):
        step.prefill()
        times[kind].append(wall_ms(eager if kind == "eager" else step, 10,
                                   warmup=2))
    print(f"[graphs] {arch} decode step B{B} wall ms (10 steps back to "
          f"back, in turns): eager {times['eager']}, graphed "
          f"{times['graphed']}; {card()}", flush=True)
    step.prefill()
    profile(step, 3, f"{arch} graphed decode step", tag="graphs")
    del step


def phase_reduced(gen: torch.Generator, arch: str) -> dict:
    """``arch`` at ``.reduced()`` on the card: prefill of B x
    REDUCED_PROMPT tokens (after its prefix) and REDUCED_DECODE decode
    steps in bf16, then one train step's gradients from fp32 weights at B
    x REDUCED_SEQ tokens, through the kernels against the plain versions:
    the logits and each stacked leaf within max(MODEL_REL_L2, 2 x floor)
    relative L2 (floor: plain bf16 vs plain fp32; in the MoE archs the
    plain runs take the kernel run's experts).  Every kernel of the
    arch's mixers must have launched in both runs' counts, and no other.
    Returns the kernel runs' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path

    cfg = get_arch(arch).reduced()
    mixers = sorted({spec.mixer for stage in lm.build_plan(cfg)
                     for spec in stage.unit})
    want = {k for m in mixers for k in MIXER_KERNELS[m]}
    params = lm.init(cfg, seed=0, device="cuda")
    prefix = cfg.n_patches
    prompt = torch.randint(0, cfg.vocab_size, (B, REDUCED_PROMPT),
                           generator=gen, device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (REDUCED_DECODE, B),
                          generator=gen, device="cuda")
    extra = {}
    if cfg.encoder is not None:
        extra["enc_frames"] = (0.02 * torch.randn(
            (B, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device="cuda")).to(torch.bfloat16)
    if prefix:
        extra["patches"] = (0.02 * torch.randn(
            (B, prefix, cfg.d_model), generator=gen,
            device="cuda")).to(torch.bfloat16)

    def serve(backend, dtype=torch.bfloat16):
        logits, caches = lm.prefill(
            cfg, params, prompt, max_seq=prefix + REDUCED_PROMPT
            + REDUCED_DECODE + 8, backend=backend, dtype=dtype, **extra)
        out = [logits.float()]
        lengths = torch.full((B,), prefix + REDUCED_PROMPT,
                             dtype=torch.int32, device="cuda")
        for tok in steps:
            logits, caches = lm.decode_step(cfg, params, tok, caches,
                                            lengths, backend=backend,
                                            dtype=dtype)
            out.append(logits.float())
            lengths = lengths + 1
        torch.cuda.synchronize()
        return out

    def worst(got, want):
        return max(float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
                   for g, w in zip(got, want))

    ops.reset_launch_counts()
    with Routes() as routes:
        got = serve("kernel")
    launches = ops.launch_counts()
    with Routes(routes):
        plain = serve("ref")
    with Routes(routes):
        truth = serve("ref", torch.float32)
    if not all(torch.isfinite(g).all() and g.shape == (B, cfg.padded_vocab)
               for g in got):
        fail(f"reduced {arch}: non-finite logits or wrong shape")
    err, floor = worst(got, plain), worst(plain, truth)
    limit = max(MODEL_REL_L2, 2 * floor)
    print(f"[reduced] {arch} ({', '.join(mixers)}; head dim "
          f"{cfg.head_dim_}) prefill B{B} S{prefix + REDUCED_PROMPT} + "
          f"{REDUCED_DECODE} decode steps, kernels vs plain: max relative L2 "
          f"of logits {err:.3e} (bound {limit:.3e}; floor {floor:.3e}) "
          f"{'ok' if err <= limit else 'MISMATCH'}", flush=True)
    if not err <= limit:
        fail(f"reduced {arch}: logits through the kernels disagree with the "
             f"plain versions")
    del params, got, plain, truth

    tparams = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                      stacked=True)
    paths = [path for path, _ in leaves_with_path(tparams)]
    ps = [t.requires_grad_() for _, t in leaves_with_path(tparams)]
    batch = data.batch_for_step(
        cfg, InputShape("reduced", prefix + REDUCED_SEQ, B, "train"), 0,
        device="cuda")

    def grads(backend, dtype):
        total, _ = lm.loss_fn(cfg, tparams, batch, backend=backend,
                              dtype=dtype)
        g = torch.autograd.grad(total, ps)
        torch.cuda.synchronize()
        return g

    ops.reset_launch_counts()
    with Routes() as routes:
        kernel = grads("kernel", torch.bfloat16)
    for name, n in ops.launch_counts().items():
        launches[name] += n
    with Routes(routes):
        plain = grads("ref", torch.bfloat16)
    with Routes(routes):
        truth = grads("ref", torch.float32)
    ratio, at = 0.0, ""
    for path, k, p, t in zip(paths, kernel, plain, truth):
        if not torch.isfinite(k).all():
            fail(f"reduced {arch} {path}: non-finite kernel gradient")
        err, floor = rel_l2(k, p), rel_l2(p, t)
        limit = max(MODEL_REL_L2, 2 * floor)
        if not err <= limit:
            fail(f"reduced {arch} train step: {path} through the kernels "
                 f"disagrees with the plain versions ({err:.3e} > bound "
                 f"{limit:.3e})")
        if err / limit >= ratio:
            ratio, at = err / limit, f"{path} {err:.3e} (bound {limit:.3e})"
    ran = {name for name, n in launches.items() if n > 0}
    print(f"[reduced] {arch} train step B{B} S{prefix + REDUCED_SEQ}, "
          f"{len(paths)} stacked leaves, kernels vs plain: worst {at}, "
          f"{ratio:.1%} of its bound; kernel launches {launches} "
          f"(expected {sorted(want)})", flush=True)
    if ran != want:
        fail(f"reduced {arch}: launched {sorted(ran)}, expected "
             f"{sorted(want)}")
    del tparams, ps, kernel, plain, truth
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_quickstart() -> dict:
    """The port's quickstart with its defaults (yi-6b reduced, 12 steps) on
    the card: every nll finite, the staircase prediction made from step 1,
    one flash forward and backward launch per layer and step."""
    from repro_torch.configs import get_arch
    from repro_torch.core.predictor import staircase_runtime
    from repro_torch.examples import quickstart

    print("[quickstart] python -m repro_torch.examples.quickstart",
          flush=True)
    reset_counts()
    run = quickstart.main([])
    launches = read_counts()
    steps, layers = len(run["nll"]), get_arch("yi-6b").reduced().n_layers
    if steps != 12 or not all(math.isfinite(x) for x in run["nll"]):
        fail(f"quickstart: {steps} steps, nll {run['nll']}")
    if run["predicted_s"] != staircase_runtime(11, 1, run["dt_1"]):
        fail("quickstart: the prediction is not the staircase of step 1")
    want = {"flash_attention": steps * layers,
            "flash_attention_bwd": steps * layers}
    print(f"[quickstart] step ms {[round(ms, 3) for ms in run['ms']]}; "
          f"predicted {run['predicted_s']!r} s for steps 1-11 from step 1, "
          f"steps 1-11 took {sum(run['ms'][1:]) / 1e3!r} s; kernel launches "
          f"{launches} (expected {want})", flush=True)
    if any(launches[k] != n for k, n in want.items()):
        fail(f"quickstart launched {launches}, expected {want}")
    return launches


def phase_serve(jobs: str, path_kernels, pacing,
                common=SERVE_COMMON) -> dict:
    from repro_torch.launch import serve

    args = ["--jobs", jobs] + common + pacing
    print(f"[serve] python -m repro_torch.launch.serve {' '.join(args)}",
          flush=True)
    schedule = serve.submission_schedule(serve.build_parser().parse_args(args))
    print(f"[serve] submission offsets (s): {schedule}", flush=True)
    if pacing == POISSON and not (
            len(schedule) == len(POISSON_OFFSETS)
            and all(abs(got - want) < 5e-5
                    for got, want in zip(schedule, POISSON_OFFSETS))):
        fail(f"serve --scenario poisson-open submits at {schedule}, not at "
             f"the reference's {POISSON_OFFSETS}")
    reset_counts()
    runs = serve.main(args)
    launches = read_counts()
    want = serve_launches(args)
    print(f"[serve] kernel launches in the serve run: {launches}; the "
          f"model's kernels' expected with each decode step's launches "
          f"counted at every replay: {want}", flush=True)
    if any(launches[name] != n for name, n in want.items()):
        fail(f"serve --jobs {jobs} launched {launches}, expected {want}")
    want_blocks = sorted(int(item.split(":")[1]) for item in jobs.split(","))
    for policy, run in runs.items():
        blocks = sorted(r.blocks for r in run["results"])
        if blocks != want_blocks or any(r.cancelled for r in run["results"]):
            fail(f"serve {policy}: jobs finished {blocks} blocks, expected "
                 f"{want_blocks}")
        m = run["metrics"]
        print(f"[serve] {policy}: STP={m.stp:.4f} ANTT={m.antt:.4f} "
              f"fairness={m.fairness:.4f} peak_memory="
              f"{run['peak_bytes'] / 2**30:.2f} GiB, every job finished",
              flush=True)
    if sorted(runs) != ["fifo", "srtf"]:
        fail(f"serve ran {sorted(runs)}, expected srtf and fifo")
    for name in (*path_kernels, "threefry"):
        if launches[name] <= 0:
            fail(f"serve --jobs {jobs} never launched the {name} kernel")
    return launches


def serve_launches(args: list) -> dict:
    """The kernel launches of ``launch.serve`` with ``args``, counted per
    replay: every job instance (each distinct item's solo run, then each
    policy's run) prefills twice (warm-up and first block) and runs
    ``graphs.WARMUP`` eager decode steps and ``blocks x tokens_per_block``
    replays.  Prefill launches flash at every attention layer (MLA's too)
    and each scan at its layers; a decode step launches the decode
    kernel at every GQA and local layer (MLA decodes with plain
    products)."""
    from repro_torch import graphs
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import lm

    a = serve.build_parser().parse_args(args)
    items = serve.parse_jobs(a)
    runs = 2 if a.compare_fifo else 1
    want = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
            "rglru_scan": 0}
    for arch, blocks in list(dict.fromkeys(items)) + items * runs:
        cfg = get_arch(arch).reduced() if a.reduced else get_arch(arch)
        mixers = [spec.mixer for stage in lm.build_plan(cfg)
                  for spec in stage.unit * stage.repeats]
        steps = graphs.WARMUP + blocks * a.tokens_per_block
        want["flash_attention"] += 2 * sum(m in ("gqa", "local", "mla")
                                           for m in mixers)
        want["decode_attention"] += steps * sum(m in ("gqa", "local")
                                                for m in mixers)
        want["ssd_scan"] += 2 * mixers.count("ssd")
        want["rglru_scan"] += 2 * mixers.count("rglru")
    return want


def phase_scenario_kernels() -> None:
    """The scenario's own arrivals as synthetic jobs on the card, twice:
    the second run must read every solo baseline from the sweep cache."""
    import statistics
    import tempfile

    from repro_torch.core import sweep
    from repro_torch.core.scenarios import (
        _synthetic_block,
        _synthetic_graph,
        _synthetic_shape,
        executor_job,
    )
    from repro_torch.launch import serve

    measured = []
    real = sweep._measure_executor_solo

    def counted(payload):
        measured.append(payload["spec"].name)
        return real(payload)

    with tempfile.TemporaryDirectory() as cache:
        args = ["--scenario", "poisson-open", "--scenario-kernels",
                "--time-scale", "1e-6", "--max-blocks", "16", "--cache-dir",
                cache, "--policy", "srtf", "--compare-fifo", "--seed", "0"]
        print(f"[scenario] python -m repro_torch.launch.serve "
              f"{' '.join(args)}", flush=True)
        arrivals = serve.scenario_arrivals(
            serve.build_parser().parse_args(args))
        for a in arrivals:
            print(f"[scenario] arrival {a.uid} at {a.time * 1e-6:.4f} s: "
                  f"{a.spec.num_blocks} blocks of shape "
                  f"{_synthetic_shape(a.spec)}", flush=True)
        n_specs = len({a.spec for a in arrivals})
        want = sorted((a.uid, a.spec.num_blocks) for a in arrivals)
        sweep._measure_executor_solo = counted
        try:
            for attempt in ("cold cache", "warm cache"):
                measured.clear()
                runs = serve.main(args)
                for policy, run in runs.items():
                    got = sorted((r.key, r.blocks) for r in run["results"])
                    if got != want or any(r.cancelled
                                          for r in run["results"]):
                        fail(f"scenario kernels {policy}: finished {got}, "
                             f"expected {want}")
                    m = run["metrics"]
                    print(f"[scenario] {attempt} {policy}: STP={m.stp:.4f} "
                          f"ANTT={m.antt:.4f} fairness={m.fairness:.4f}, "
                          f"every job finished; turnaround (s): " + ", ".join(
                              f"{r.key} {r.turnaround:.6f}" for r in sorted(
                                  run["results"], key=lambda r: r.key)),
                          flush=True)
                print(f"[scenario] {attempt}: {len(measured)} solo "
                      f"baselines measured", flush=True)
                if attempt == "cold cache" and len(measured) != n_specs:
                    fail(f"cold run measured {len(measured)} solo "
                         f"baselines for {n_specs} specs")
                if attempt == "warm cache" and measured:
                    fail(f"warm run re-measured solo baselines {measured}")
        finally:
            sweep._measure_executor_solo = real

    dev = torch.device("cuda")
    for dim, reps in sorted({_synthetic_shape(a.spec) for a in arrivals}):
        a = next(a for a in arrivals if _synthetic_shape(a.spec) == (dim,
                                                                   reps))
        job = executor_job(a, device="cuda")
        job.warmup_fn()
        block = job.make_block_fn(1)
        walls = []
        for _ in range(200):
            t0 = time.perf_counter()
            block()
            walls.append((time.perf_counter() - t0) * 1e3)
        # 20 calls: eager, 4 launches a repetition, and the launch queue
        # holds ~1000 behind device_ms's sleep before the host has to
        # wait; a replay is one launch.
        step, x0 = _synthetic_block(dim, reps, dev)
        dev_ms = device_ms(lambda: step(x0), 20)
        graph_ms = device_ms(_synthetic_graph(dim, reps, dev).replay, 20)
        print(f"[scenario] synthetic block ({dim}, {reps}): median "
              f"{statistics.median(walls):.4f} ms wall per block (200 "
              f"blocks, each a graph replay ending in a synchronize; p10 "
              f"{statistics.quantiles(walls, n=10)[0]:.4f}, p90 "
              f"{statistics.quantiles(walls, n=10)[-1]:.4f}), "
              f"{graph_ms:.4f} ms on the device replayed, {dev_ms:.4f} ms "
              f"eager", flush=True)


def check_executor_sweeps(record: dict) -> None:
    """What the benchmark run's executor sweeps did on the card
    (``BENCH_CHILD``'s record).  It asserts what a run can show: every
    cell's jobs finish on the card, the main sweep measures each distinct
    spec's solo baseline once and the EWMA sweep reads them all from the
    cache.  How many cells overlap their jobs in lane time is printed, not
    checked: only those can rank the policies."""
    from repro_torch.benchmarks import executor_policies

    cells = record["cells"]
    want = 2 * len(executor_policies.POLICY_NAMES) + 2
    if len(cells) != want:
        fail(f"executor sweep gave {len(cells)} cells, expected {want}")
    for c in cells:
        if (not c["measured"] or c["unfinished"]
                or c["n_finished"] != len(c["arrival"])):
            fail(f"executor cell {c['workload']}/{c['policy']}/"
                 f"{c['predictor']}: {c['n_finished']} of "
                 f"{len(c['arrival'])} jobs finished, unfinished "
                 f"{c['unfinished']}")
        print(f"[sweep] {c['workload']} {c['policy']}+{c['predictor']}: "
              "arrival (s) " + ", ".join(
                  f"{k} {v:.6f}" for k, v in sorted(
                      c["arrival"].items(), key=lambda kv: kv[1]))
              + "; finish (s) " + ", ".join(
                  f"{k} {v:.6f}" for k, v in sorted(
                      c["finish"].items(), key=lambda kv: kv[1]))
              + f"; overlap {c['overlap']}", flush=True)
    measured = sorted(record["measured"])
    specs = sorted(executor_policies.SPECS)
    print(f"[sweep] solo baselines measured: {measured}", flush=True)
    if measured != specs:
        fail(f"the sweeps measured solo baselines {measured}, expected "
             f"each of {specs} once (the EWMA sweep reads the cache)")


#: Each module of ``repro_torch.benchmarks.run`` and its rows' prefixes.
BENCH_ROWS = {
    "fig01_fifo_luck": ("fig01.",),
    "fig03_staircase_trace": ("fig03.", "fig05."),
    "fig04_prediction_accuracy": ("fig04.",),
    "fig06_block_durations": ("fig06.",),
    "fig07_residency": ("fig07.", "fig08."),
    "fig09_corunner": ("fig09.", "fig10."),
    "fig11_ss_predictor": ("fig11.",),
    "table5_policies": ("table5.",),
    "fig14_15_16_per_workload": ("fig14.", "fig15.", "fig16."),
    "table6_arrival_offsets": ("table6.",),
    "scenarios_openloop": ("scenarios.",),
    "closedloop": ("closedloop.",),
    "executor_policies": ("executor.",),
    "roofline": ("roofline.",),
}


def bench_run(cwd: str, *args: str, label: str = "") -> tuple:
    """``python <args>`` in ``cwd`` with the checkout's ``src`` alone on
    the path: its stdout lines, after a zero exit.  ``label`` names the
    run in place of its arguments."""
    label = label or " ".join(args)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=600)
    print(f"[bench] python {label}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if proc.returncode != 0:
        fail(f"python {label} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout.splitlines()


# ``benchmarks.run``'s entry point in a child that also writes what its
# executor sweeps did to the file named by its first argument: the solo
# baselines it measured and each cell.  The other arguments are the run's.
BENCH_CHILD = """
import json, sys
from repro_torch.benchmarks import executor_policies, run
from repro_torch.core import sweep
out = sys.argv.pop(1)
measured, results = [], []
solo, sweeps = sweep._measure_executor_solo, executor_policies.sweeps

def counted(payload):
    measured.append(payload["spec"].name)
    return solo(payload)

def kept(*args, **kwargs):
    got = sweeps(*args, **kwargs)
    results.extend(got)
    return got

sweep._measure_executor_solo = counted
executor_policies.sweeps = kept
try:
    run.main()
finally:
    cells = [{"workload": c.workload, "policy": c.policy,
              "predictor": c.predictor, "measured": c.measured,
              "unfinished": list(c.unfinished),
              "n_finished": c.window.n_finished, "arrival": c.arrival,
              "finish": c.finish,
              "overlap": executor_policies.overlaps(c)}
             for r in results for c in r.cells]
    with open(out, "w") as f:
        json.dump({"measured": measured, "cells": cells}, f,
                  allow_nan=False)
"""


def bench_rows(lines: list) -> tuple:
    """A benchmark run's engine token and its ``(name, derived)`` rows."""
    engine = next(line.split(" -> ")[1] for line in lines
                  if line.startswith("# engine="))
    body = lines[lines.index("name,us_per_call,derived") + 1:]
    return engine, [(name, rest.split(",", 1)[1])
                    for name, rest in (line.split(",", 1) for line in body)]


def phase_benchmarks() -> None:
    """The paper's benchmarks and the cluster example through their entry
    points, each in a subprocess run from a temporary directory."""
    import tempfile

    from repro_torch.benchmarks import executor_policies

    with tempfile.TemporaryDirectory() as cwd:
        record = os.path.join(cwd, "executor_sweeps.json")
        lines = bench_run(cwd, "-c", BENCH_CHILD, record, "--cache-dir",
                          os.path.join(cwd, "sweep_cache"),
                          label="-m repro_torch.benchmarks.run --cache-dir "
                                "<temporary>")
        for line in lines:
            print(f"[bench] {line}", flush=True)
        with open(record) as f:
            check_executor_sweeps(json.load(f))
        engine, rows = bench_rows(lines)
        errors = [name for name, derived in rows if derived == '"ERROR"']
        if errors:
            fail(f"benchmarks.run: ERROR rows {errors}")
        missing = [m for m, prefixes in BENCH_ROWS.items()
                   if not any(n.startswith(prefixes) for n, _ in rows)]
        if missing:
            fail(f"benchmarks.run printed no row of {missing}")
        workloads = [wl["name"] for wl in executor_policies.TRACE["workloads"]]
        want = ([f"executor.{wl}.{p}" for wl in workloads
                 for p in executor_policies.POLICY_NAMES]
                + [f"executor.{wl}.srtf+ewma" for wl in workloads]
                + ["executor.note"])
        got = [n for n, _ in rows if n.startswith("executor.")]
        if got != want:
            fail(f"benchmarks.run's executor rows {got}, expected {want}")
        by_engine = {}
        for name in ("python", "compiled"):
            lines = bench_run(cwd, "-m", "repro_torch.benchmarks.run",
                              "--machine", "des", "--subset", "2",
                              "--no-cache", "--engine", name)
            by_engine[name] = bench_rows(lines)
            print(f"[bench] --subset 2 --engine {name}: engine "
                  f"{by_engine[name][0]}, {len(by_engine[name][1])} rows",
                  flush=True)
        if by_engine["python"][1] != by_engine["compiled"][1]:
            fail("the DES rows under --engine python and --engine compiled "
                 "differ at --subset 2")
        if not by_engine["compiled"][0].startswith("compiled-"):
            fail(f"--engine compiled ran {by_engine['compiled'][0]}")
        print(f"[bench] full size under {engine}; at --subset 2 the python "
              f"and {by_engine['compiled'][0]} engines' rows are equal",
              flush=True)
        lines = bench_run(cwd, "-m", "repro_torch.examples.cluster_sim")
        for line in lines:
            print(f"[bench] {line}", flush=True)
        policies = [line.split()[0] for line in lines if " STP=" in line]
        if policies != ["fifo", "mpmax", "srtf", "srtf-adaptive"]:
            fail(f"cluster_sim printed the policies {policies}")


#: The perf lane's rows in full mode at ``--jobs 4``, in the reference's
#: order.
PERF_ROWS = [
    "blocks_per_sec.table5_pair", "blocks_per_sec.mix4_10x",
    "blocks_per_sec.mgk_saturated", "blocks_per_sec.table5_pair.compiled",
    "blocks_per_sec.mix4_10x.compiled",
    "blocks_per_sec.mgk_saturated.compiled", "segment_exits.mgk_saturated",
    "table5.cold.jobs4", "table5.warm.jobs4", "sweep_cells_per_sec.local",
    "sweep_cells_per_sec.queue",
]


def phase_perf() -> None:
    """The DES perf lane through its entry point in a subprocess run from
    a temporary directory, checked against the lane's shape and the JSON
    it wrote."""
    import tempfile

    root_files = {name: (ROOT / name).read_bytes()
                  if (ROOT / name).exists() else None
                  for name in ("BENCH_des.json", "BENCH_des_torch.json")}
    with tempfile.TemporaryDirectory() as cwd:
        out = os.path.join(cwd, "perf.json")
        lines = bench_run(cwd, "-m", "repro_torch.benchmarks.perf", "--jobs",
                          "4", "--repeat", "2", "--out", out,
                          label="-m repro_torch.benchmarks.perf --jobs 4 "
                                "--repeat 2 --out <temporary>")
        for line in lines:
            print(f"[perf] {line}", flush=True)
        with open(out) as f:
            payload = json.load(f)
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    by_name = {row["name"]: row for row in rows}
    names = [row["name"] for row in rows]
    if names != PERF_ROWS:
        fail(f"the perf lane printed the rows {names}, expected {PERF_ROWS}")
    for name in PERF_ROWS[:3]:
        if by_name[name]["blocks"] != by_name[f"{name}.compiled"]["blocks"]:
            fail(f"{name}: the python engine ran {by_name[name]['blocks']} "
                 f"blocks, the compiled one "
                 f"{by_name[name + '.compiled']['blocks']}")
    engines = {row["name"]: row["engine"] for row in rows
               if row["name"].endswith(".compiled")}
    if not all(e.startswith("compiled-") for e in engines.values()):
        fail(f"the compiled rows ran the engines {engines}")
    cells = [by_name[f"sweep_cells_per_sec.{d}"]["cells"]
             for d in ("local", "queue")]
    if cells[0] != cells[1]:
        fail(f"the local and queue dispatchers computed {cells} cells")
    if payload["rows"] != rows:
        fail("the perf lane's JSON differs from the rows it printed")
    changed = [name for name, data in root_files.items()
               if ((ROOT / name).read_bytes() if (ROOT / name).exists()
                   else None) != data]
    if changed:
        fail(f"the perf lane changed {changed} in the checkout's root")
    print(f"[perf] {len(rows)} rows; blocks "
          f"{[by_name[n]['blocks'] for n in PERF_ROWS[:3]]}, cells "
          f"{cells[0]}, chunk {by_name['sweep_cells_per_sec.queue']['chunk']}"
          f", compiled backend {payload['compiled_backend']}, commit "
          f"{payload['commit']}", flush=True)


def phase_analysis() -> None:
    """The static analyzer over the checkout in a subprocess run from a
    temporary directory; stale baseline entries (keys that matched no
    finding) are counted against the port's ``baseline.json``."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cwd:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--json"],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    blocking = [f["location"] for f in report["findings"]
                if not f["suppressed"]]
    if not report["ok"] or blocking:
        fail(f"the analyzer's report is not clean: ok {report['ok']}, "
             f"blocking {blocking}")
    seen = {f"{f['rule']}::{f['file'][:-3]}::{f['context']}"
            for f in report["findings"]}
    baseline = json.loads(
        (ROOT / "src/repro_torch/analysis/baseline.json").read_text())
    stale = sorted(e["key"] for e in baseline["entries"]
                   if e["key"] not in seen)
    print(f"[analysis] {len(blocking)} blocking, "
          f"{len(report['findings']) - len(blocking)} baselined, "
          f"{len(stale)} stale {stale} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def train_args(layers: int, arch: str = "yi-6b") -> list:
    """The train driver's flags for ``arch`` at ``layers`` layers: B 4 x
    1024 tokens, after the patches where the arch has them."""
    return ["--arch", arch, "--n-layers", str(layers), "--batch", str(B),
            "--seq", str(depth_cut(arch, layers).n_patches + PROMPT)]


def depth_cut(arch: str, layers: int):
    """``arch`` at full width cut to ``layers`` layers, as ``launch.train
    --n-layers`` cuts it (an encoder's stack alike)."""
    from repro_torch.launch import train

    return train.arch_config(
        train.build_parser().parse_args(["--n-layers", str(layers)]), arch)


TRAIN_METRICS = ("nll", "aux", "z", "grad_norm", "lr")


def train_run(args: list, layers: int, steps_run: int,
              kernels=("flash_attention", "flash_attention_bwd"),
              per_step=None) -> dict:
    """``repro_torch.launch.train`` with the launch counters set to 0 just
    before and read just after: every loss finite, each step's wall ms
    printed, and ``per_step[name]`` launches of each of ``kernels`` (a
    forward and its backward) per step: one per layer unless given."""
    from repro_torch.launch import train

    print(f"[train] python -m repro_torch.launch.train {' '.join(args)}",
          flush=True)
    reset_counts()
    t0 = time.perf_counter()
    run = train.main(args)
    secs = time.perf_counter() - t0
    launches = read_counts()
    for r in run["steps"]:
        if not all(math.isfinite(r[k]) for k in TRAIN_METRICS):
            fail(f"train step {r['step']}: non-finite metrics {r}")
        print(f"[train] step {r['step']}: {r['ms']:.1f} ms wall, nll "
              f"{r['nll']!r}, grad_norm {r['grad_norm']!r}", flush=True)
    per_step = per_step or {name: layers for name in kernels}
    want = {name: per_step[name] * steps_run for name in kernels}
    expected = ", ".join(f"{name}: {per_step[name]} a step x {steps_run} "
                         f"steps = {want[name]}" for name in kernels)
    print(f"[train] {len(run['steps'])} steps in {secs:.1f}s of "
          f"train.main (weights, steps, checkpoints); predictor after the "
          f"first steady step: {run['predicted_s']!r} s for the rest; peak "
          f"device memory {run['peak_bytes'] / 2**30:.2f} GiB "
          f"(max_memory_allocated); kernel launches {launches} ({expected})",
          flush=True)
    if len(run["steps"]) != steps_run:
        fail(f"train ran {len(run['steps'])} steps, expected {steps_run}")
    for name in kernels:
        if launches[name] != want[name]:
            fail(f"train launched {name} {launches[name]} times, expected "
                 f"{want[name]}")
    if launches["threefry"] <= 0:
        fail("train drew its weights and batches without the threefry "
             "kernel")
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": run, "launches": launches}


def profile_train_step(arch: str = "yi-6b",
                       layers: int = TRAIN_LAYERS) -> None:
    """Where a train step's device time goes at full width and ``layers``
    layers: torch.profiler over two steps after a warm one (outside the
    launch-counting windows)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    cfg = depth_cut(arch, layers)
    shape = InputShape("profile", cfg.n_patches + PROMPT, B, "train")
    params = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                     stacked=True)
    for p in leaves(params):
        p.requires_grad_()
    opt = adamw.init(params)
    bundle = build_train_step(cfg, shape, remat=False)
    batch = data.batch_for_step(cfg, shape, 0, device="cuda")

    def step():
        bundle.fn(params, opt, batch)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profile(step, 2, f"{arch} {layers}-layer train step")
    print(f"[train] the profile of two {arch} steps took "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def phase_train() -> dict:
    """Full-width yi-6b cut to TRAIN_LAYERS layers for TRAIN_STEPS steps;
    then the resume check (``resume_check``) at RESUME_LAYERS layers.
    (A checkpoint of fp32 state is 31 GB at 12 layers, 10.4 GB at 2; a GPU
    host may end a command that writes 45 GiB to its disk.)"""
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(train_run(train_args(TRAIN_LAYERS) + ["--steps", str(TRAIN_STEPS)],
                  TRAIN_LAYERS, TRAIN_STEPS)["launches"])
    profile_train_step()
    for run in resume_check("yi-6b", RESUME_LAYERS, TRAIN_STEPS):
        add(run["launches"])
    return launches


def require_bitwise(what: str, want: list, got: list) -> None:
    """Fails unless the two runs' step records agree in every bit of
    TRAIN_METRICS.  Every kernel on the train paths is deterministic, the
    MoE's dispatch and combine have no atomics and the data are seekable,
    so a difference is a fault, not noise."""
    if len(want) != len(got):
        fail(f"{what}: {len(got)} steps, expected {len(want)}")
    diffs = [(a["step"], name, a[name], b[name]) for a, b in zip(want, got)
             for name in TRAIN_METRICS if a[name] != b[name]]
    if diffs:
        fail(f"{what} steps differ from the uninterrupted run: {diffs}")


def resume_check(arch: str, layers: int, steps: int) -> tuple:
    """``arch`` at full width and ``layers`` layers for ``steps`` steps
    with one checkpoint, at the middle step (``--no-final-checkpoint``),
    in the temporary directory; then a run resumed from it, whose steps
    must equal the uninterrupted run's bitwise.  Returns both runs."""
    import tempfile

    half = steps // 2
    args = train_args(layers, arch) + ["--steps", str(steps),
                                       "--no-final-checkpoint"]
    with tempfile.TemporaryDirectory() as tmp:
        whole = train_run(args + ["--checkpoint-dir", tmp,
                                  "--checkpoint-every", str(half)],
                          layers, steps)
        written = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                      if f.is_file())
        resumed = train_run(args + ["--checkpoint-dir", tmp, "--resume"],
                            layers, steps - half)
        kept = sorted(f.name for f in Path(tmp).iterdir())
    if kept != [f"step_{half:010d}"]:
        fail(f"{arch} resume check: the runs left {kept}, expected the "
             f"step-{half} checkpoint alone")
    require_bitwise(f"{arch} resumed", whole["run"]["steps"][half:],
                    resumed["run"]["steps"])
    print(f"[train] {arch} resumed from step {half}: steps {half}-"
          f"{steps - 1} bitwise equal to the uninterrupted run in "
          f"{TRAIN_METRICS}; one checkpoint, {written / 1e9:.2f} GB, "
          f"written", flush=True)
    return whole, resumed


def phase_train_moe_repeat() -> dict:
    """Full-width deepseek-v2-lite-16b at DSV2_REPEAT_LAYERS layers (one
    dense, one MoE) for DSV2_REPEAT_STEPS steps, once and then in
    ``resume_check``: every step's metrics bitwise equal between the
    first run and the check's uninterrupted one (the MoE dispatch's and
    combine's backwards are gathers summed in a fixed order, not atomic
    scatter-adds)."""
    arch, layers, steps = ("deepseek-v2-lite-16b", DSV2_REPEAT_LAYERS,
                           DSV2_REPEAT_STEPS)
    first = train_run(train_args(layers, arch) + ["--steps", str(steps)],
                      layers, steps)
    whole, resumed = resume_check(arch, layers, steps)
    require_bitwise(f"{arch} second run", first["run"]["steps"],
                    whole["run"]["steps"])
    print(f"[train] {arch} at {layers} layers: two runs from one seed "
          f"bitwise equal in every step's {TRAIN_METRICS}", flush=True)
    launches = {}
    for run in (first, whole, resumed):
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def phase_train_yi34() -> dict:
    """Full-width yi-34b cut to YI34_LAYERS layers for YI34_STEPS steps:
    every loss finite, one flash forward and one flash backward launch per
    layer and step, the peak under YI34_PEAK_GIB; then where a step's
    device time goes."""
    from repro_torch.configs import get_arch

    arch, layers = "yi-34b", YI34_LAYERS
    full, cfg = get_arch(arch), depth_cut(arch, layers)
    print(f"[train] {arch} at full width, depth cut {full.n_layers} -> "
          f"{layers} layers (d {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} of {cfg.head_dim or cfg.d_model // cfg.n_heads},"
          f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}); "
          f"{cfg.n_params() / 1e9:.3f} B parameters, "
          f"{cfg.n_params() * 16 / 2**30:.2f} GiB of fp32 weights, "
          f"gradients and AdamW moments", flush=True)
    run = train_run(train_args(layers, arch) + ["--steps", str(YI34_STEPS)],
                    layers, YI34_STEPS)
    peak = run["run"]["peak_bytes"] / 2**30
    if peak > YI34_PEAK_GIB:
        fail(f"{arch} at {layers} layers peaked at {peak:.2f} GiB, over the "
             f"{YI34_PEAK_GIB} GiB headroom rule")
    profile_train_step(arch, layers)
    return run["launches"]


def phase_train_check(arch: str = "yi-6b", layers: int = TRAIN_LAYERS,
                      remat: bool = True) -> None:
    """One step's gradients of ``arch`` at full width and ``layers``
    layers, from the same fp32 weights and batch, through the kernels and
    through the plain versions (``backend="ref"``): each stacked leaf
    within max(MODEL_REL_L2, 2 x floor) relative L2, the floor being the
    plain path in bf16 against it in fp32.  Gradients only, no optimizer
    state, so that two sets fit beside the weights; with ``remat`` the
    plain runs recompute each layer in the backward to keep their
    quadratic attention's (and chunked scan's) activations small.  In a
    MoE arch the plain bf16 run's experts are replayed in the other two
    (:class:`Routes`, call by call, so without remat, whose backward
    would route each layer again), and the share of routings each would
    have changed is printed."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path

    cfg = depth_cut(arch, layers)
    params = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                     stacked=True)
    paths = [p for p, _ in leaves_with_path(params)]
    leaves = [t.requires_grad_() for _, t in leaves_with_path(params)]
    batch = data.batch_for_step(
        cfg, InputShape("check", cfg.n_patches + PROMPT, B, "train"), 0,
        device="cuda")

    if cfg.moe is not None and remat:
        fail(f"train check {arch}: the routing replay counts calls, which "
             f"remat repeats")
    routes = {}

    def grads(backend, dtype, recompute, name):
        replay = routes.get("plain bf16")
        with Routes(replay) as picks:
            total, _ = lm.loss_fn(cfg, params, batch, backend=backend,
                                  dtype=dtype, remat=recompute)
            g = torch.autograd.grad(total, leaves)
        torch.cuda.synchronize()
        routes[name] = picks
        return float(total.detach()), g

    t0 = time.perf_counter()
    loss_ref, plain = grads("ref", torch.bfloat16, remat, "plain bf16")
    loss_truth, truth = grads("ref", torch.float32, remat, "plain fp32")
    floors = [rel_l2(p, t) for p, t in zip(plain, truth)]
    del truth
    loss_kernel, kernel = grads("kernel", torch.bfloat16, False, "kernels")
    if cfg.moe is not None:
        calls = {name: len(p) for name, p in routes.items()}
        if len(set(calls.values())) != 1 or not routes["kernels"]:
            fail(f"train check {arch}: routing calls {calls}")
        print(f"[train-check] {arch} MoE routings the other runs would have "
              f"sent to another set of experts (all three take the plain "
              f"bf16 run's): kernels vs plain bf16 "
              f"{rerouted(routes['plain bf16'], routes['kernels'])}, plain "
              f"fp32 vs plain bf16 "
              f"{rerouted(routes['plain bf16'], routes['plain fp32'])}",
              flush=True)
    worst = 0.0
    for path, k, p, floor in zip(paths, kernel, plain, floors):
        if not torch.isfinite(k).all():
            fail(f"train check {path}: non-finite kernel gradient")
        err, limit = rel_l2(k, p), max(MODEL_REL_L2, 2 * floor)
        worst = max(worst, err / limit)
        print(f"[train-check] {arch} {path}: relative L2 kernels vs plain "
              f"{err:.3e} "
              f"(bound {limit:.3e}; floor, plain bf16 vs fp32, "
              f"{floor:.3e}) {'ok' if err <= limit else 'MISMATCH'}",
              flush=True)
        if not err <= limit:
            fail(f"train check: {path} through the kernels disagrees with "
                 f"the plain versions")
    print(f"[train-check] {arch} {layers} layers: losses: kernels "
          f"{loss_kernel!r}, plain bf16 "
          f"{loss_ref!r}, plain fp32 {loss_truth!r}; worst error at "
          f"{worst:.1%} of its bound; {time.perf_counter() - t0:.1f}s",
          flush=True)
    del params, leaves, kernel, plain, routes
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_mamba2() -> dict:
    """Full-width mamba2-2.7b cut to MAMBA_LAYERS layers (the cut printed)
    for MAMBA_STEPS steps: every loss finite, one SSD forward and backward
    launch per layer and step; then where a step's device time goes."""
    from repro_torch.configs import get_arch

    full = get_arch("mamba2-2.7b").n_layers
    print(f"[train] mamba2-2.7b at full width, depth cut {full} -> "
          f"{MAMBA_LAYERS} layers (the deepest multiple of 8 whose fp32 "
          f"weights, gradients, AdamW moments and activations stay under "
          f"~70 GiB)", flush=True)
    run = train_run(train_args(MAMBA_LAYERS, "mamba2-2.7b")
                    + ["--steps", str(MAMBA_STEPS)], MAMBA_LAYERS,
                    MAMBA_STEPS, ("ssd_scan", "ssd_scan_bwd"))
    profile_train_step("mamba2-2.7b", MAMBA_LAYERS)
    return run["launches"]


def phase_train_recurrentgemma() -> dict:
    """Full-width recurrentgemma-2b at RG_LAYERS layers for RG_STEPS steps:
    every loss finite, one RG-LRU forward and backward launch per
    recurrent layer and one flash forward and backward (at (256, 256)) per
    local-attention layer, each step; then where a step's device time
    goes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    full = get_arch("recurrentgemma-2b")
    cfg = dataclasses.replace(full, n_layers=RG_LAYERS)
    mixers = [spec.mixer for stage in lm.build_plan(cfg)
              for spec in stage.unit * stage.repeats]
    rec, local = mixers.count("rglru"), mixers.count("local")
    print(f"[train] recurrentgemma-2b at full width, {RG_LAYERS} of "
          f"{full.n_layers} layers ({rec} recurrent, {local} local "
          f"attention at head dim 256, window {full.rglru.window})",
          flush=True)
    run = train_run(train_args(RG_LAYERS, "recurrentgemma-2b")
                    + ["--steps", str(RG_STEPS)], RG_LAYERS, RG_STEPS,
                    ("rglru_scan", "rglru_scan_bwd", "flash_attention",
                     "flash_attention_bwd"),
                    {"rglru_scan": rec, "rglru_scan_bwd": rec,
                     "flash_attention": local, "flash_attention_bwd": local})
    peak = run["run"]["peak_bytes"] / 2**30
    if peak > RG_PEAK_GIB:
        fail(f"recurrentgemma-2b at {RG_LAYERS} layers peaked at "
             f"{peak:.2f} GiB, over the {RG_PEAK_GIB} GiB headroom rule")
    profile_train_step("recurrentgemma-2b", RG_LAYERS)
    return run["launches"]


def phase_train_mla(arch: str, layers: int, peak_gib: float) -> dict:
    """Full-width ``arch`` (minicpm3-4b or deepseek-v2-lite-16b) cut to
    ``layers`` layers for MLA_STEPS steps: every loss finite, one flash
    forward and one flash backward launch per layer and step (at (128,
    64) or (192, 128)), the peak under ``peak_gib``; then where a step's
    device time goes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.mla import padded_qk_dim

    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    dense = min(layers, cfg.moe.first_dense_layers) if cfg.moe else layers
    print(f"[train] {arch} at full width, depth cut {full.n_layers} -> "
          f"{layers} layers ({dense} dense"
          + (f", {layers - dense} MoE of {cfg.moe.n_experts} experts top "
             f"{cfg.moe.top_k}" if cfg.moe else "")
          + f"; {cfg.n_heads} heads, qk {qk} run as "
          f"{padded_qk_dim(qk, m.v_head_dim)} beside v {m.v_head_dim}); "
          f"{cfg.n_params() / 1e9:.3f} B parameters, "
          f"{cfg.n_params() * 16 / 2**30:.2f} GiB of fp32 weights, "
          f"gradients and AdamW moments", flush=True)
    run = train_run(train_args(layers, arch) + ["--steps", str(MLA_STEPS)],
                    layers, MLA_STEPS)
    peak = run["run"]["peak_bytes"] / 2**30
    if peak > peak_gib:
        fail(f"{arch} at {layers} layers peaked at {peak:.2f} GiB, over the "
             f"{peak_gib} GiB headroom rule")
    profile_train_step(arch, layers)
    return run["launches"]


def phase_train_prefixed(arch: str, layers: int) -> dict:
    """Full-width whisper-large-v3 (its frames through the encoder, cross
    attention in every decoder layer) or pixtral-12b (its patches in front
    of the tokens) at ``layers`` layers for ENCDEC_STEPS steps: every loss
    finite, one flash forward and one flash backward launch per attention
    layer (encoder, self and cross) and step, the peak under
    ENCDEC_PEAK_GIB; then where a step's device time goes."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    full, cfg = get_arch(arch), depth_cut(arch, layers)
    specs = [spec for stage in lm.build_plan(cfg)
             for spec in stage.unit * stage.repeats]
    n_params = sum(math.prod(shape)
                   for shape, _ in lm.param_shapes(cfg).values())
    enc = cfg.encoder.n_layers if cfg.encoder else 0
    cross = sum(spec.cross for spec in specs)
    attention = enc + len(specs) + cross
    print(f"[train] {arch} at full width, {len(specs)} of {full.n_layers} "
          f"decoder layers" + (f" and {enc} of {full.encoder.n_layers} "
                               f"encoder layers over {cfg.encoder.n_frames} "
                               f"frames" if enc else "")
          + (f", {cfg.n_patches} patches before {PROMPT} tokens"
             if cfg.n_patches else "")
          + f"; {attention} attention layers a step ({cross} cross); "
          f"{n_params / 1e9:.3f} B parameters, "
          f"{n_params * 16 / 2**30:.2f} GiB of fp32 weights, gradients and "
          f"AdamW moments", flush=True)
    run = train_run(train_args(layers, arch) + ["--steps", str(ENCDEC_STEPS)],
                    layers, ENCDEC_STEPS,
                    per_step={"flash_attention": attention,
                              "flash_attention_bwd": attention})
    peak = run["run"]["peak_bytes"] / 2**30
    if peak > ENCDEC_PEAK_GIB:
        fail(f"{arch} at {layers} layers peaked at {peak:.2f} GiB, over the "
             f"{ENCDEC_PEAK_GIB} GiB headroom rule")
    profile_train_step(arch, layers)
    return run["launches"]


def init_launches(cfg) -> int:
    """Threefry launches of ``lm.init(cfg)`` on the card: one a random
    leaf, or one a repeat of a stacked leaf."""
    from repro_torch.models import lm

    return sum(len(keys) for keys, _, _ in lm.draw_keys(cfg).values())


def phase_train_multi() -> dict:
    """``--jobs yi-6b:8,yi-6b:2`` at full width and 2 layers under SRTF and
    FIFO: every job finishes, and each job (a solo baseline for each
    distinct item, then the mix) launches the threefry kernel once a
    weight leaf part and twice (its tokens' two 32-bit draws) in its
    warm-up and in every block."""
    from repro_torch.launch import train

    items = [(arch, int(n)) for arch, n in
             (j.split(":") for j in TRAIN_JOBS.split(","))]
    jobs = sorted(set(items)) + items
    want_threefry = sum(init_launches(depth_cut(arch, 2)) + 2 * (n + 1)
                        for arch, n in jobs)
    launches = {}
    for policy in ("srtf", "fifo"):
        args = ["--jobs", TRAIN_JOBS, "--n-layers", "2", "--batch", str(B),
                "--seq", str(PROMPT), "--policy", policy]
        print(f"[train-multi] python -m repro_torch.launch.train "
              f"{' '.join(args)}", flush=True)
        reset_counts()
        run = train.main(args)
        counts = read_counts()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        blocks = sorted(r.blocks for r in run["results"].values())
        want = sorted(int(j.split(":")[1]) for j in TRAIN_JOBS.split(","))
        if blocks != want or any(r.cancelled
                                 for r in run["results"].values()):
            fail(f"train --jobs {TRAIN_JOBS} {policy}: blocks {blocks}, "
                 f"expected {want}")
        m = run["metrics"]
        print(f"[train-multi] {policy}: STP={m.stp:.4f} ANTT={m.antt:.4f} "
              f"fairness={m.fairness:.4f} peak_memory="
              f"{run['peak_bytes'] / 2**30:.2f} GiB, every job finished; "
              f"kernel launches {counts}", flush=True)
        if counts["flash_attention_bwd"] <= 0:
            fail("multi-job training never launched the flash backward")
        if counts["threefry"] != want_threefry:
            fail(f"multi-job training launched threefry "
                 f"{counts['threefry']} times, expected {want_threefry} (a "
                 f"weight leaf part each, and two a block and a warm-up)")
    return launches


# The sharded phase: the sharded steps on a one-rank NCCL mesh of shape
# (1, 1) ("data", "model"), at full width.  yi-6b trains at SHARD_TRAIN
# layers: fp32 weights and AdamW moments of the sharded and the unsharded
# run (12 B a parameter, 1.33 B parameters: 2 x 16 GB) beside their
# gradients; deepseek-v2-lite-16b at SHARD_DSV2 layers (one dense, two
# MoE) with capacity factor 16, where the per-row dispatch and the
# expert-parallel one drop nothing and so compute the same function.
SHARD_TRAIN, SHARD_DSV2, SHARD_DECODE = 4, 3, 4
SHARD_PATHS = (("yi-6b", None, ("flash_attention", "decode_attention")),
               ("mamba2-2.7b", None, ("ssd_scan",)),
               ("recurrentgemma-2b", None,
                ("flash_attention", "decode_attention", "rglru_scan")),
               ("deepseek-v2-lite-16b", SHARD_DSV2, ("flash_attention",)))


def compare(name: str, got, want, bound: float = MODEL_REL_L2) -> str:
    """``got`` (from a DTensor path) against ``want``: bitwise, or within
    ``bound`` relative L2 (PERF.md's model bound); fails past it."""
    from torch.distributed.tensor import DTensor

    if isinstance(got, DTensor):
        got = got.full_tensor()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"sharded {name}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)} or non-finite values")
    if torch.equal(got, want):
        return "bitwise"
    err = rel_l2(got.float(), want.float())
    if err > bound:
        fail(f"sharded {name}: relative L2 {err:.3e} past {bound}")
    return f"rel L2 {err:.3e}"


def phase_sharded() -> dict:
    """The sharded train, prefill and decode steps (``launch.steps.
    build_step`` with a mesh, the ``Sharder``, every kernel inside
    ``local_map``) on a (1, 1) mesh of one NCCL rank (a HashStore: no port
    opened), against the unsharded steps on the same weights."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import steps
    from repro_torch.sharding.calls import combine_slices

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    launches: dict = {}
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).view(1, 1),
                          mesh_dim_names=("data", "model"))
        # the slice combine over one rank is the identity, bitwise
        out = torch.randn(B, 32, 128, device="cuda").to(torch.bfloat16)
        lse = torch.randn(B, 32, device="cuda")
        if not torch.equal(combine_slices(mesh, "model", out, lse), out):
            fail("sharded: the one-rank log-sum-exp combine changed out")
        for name, count in sharded_train(mesh, steps).items():
            launches[name] = launches.get(name, 0) + count
        for arch, layers, kernels in SHARD_PATHS:
            for name, count in sharded_serve(mesh, steps, arch, layers,
                                             kernels).items():
                launches[name] = launches.get(name, 0) + count
    finally:
        dist.destroy_process_group()
    return launches


def _counted(fn, *args):
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def sharded_train(mesh, steps) -> dict:
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import pipeline as data
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = depth_cut("yi-6b", SHARD_TRAIN)
    shape = InputShape("sharded", PROMPT, B, "train")
    plain = lm.init(cfg, seed=0, device="cuda", dtype=torch.float32,
                    stacked=True)
    for _, t in leaves_with_path(plain):
        t.requires_grad_()
    # a copy placed by param_spec (the step updates its params in place)
    placed = steps.place(tree_map(lambda t: t.detach().clone()
                                  .requires_grad_(), plain), mesh)
    batch = data.batch_for_step(cfg, shape, 0, device="cuda")
    sbatch = steps.place(batch, mesh, steps.batch_specs(cfg, batch, mesh))
    bundle = steps.build_step(cfg, shape, mesh=mesh)
    (_, s_state, s_met), counts = _counted(
        bundle.fn, placed, adamw.init(placed), sbatch)
    _, u_state, u_met = steps.build_step(cfg, shape).fn(
        plain, adamw.init(plain), batch)
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] <= 0:
            fail(f"sharded yi-6b train step never launched {name}")
    verdicts = {name: compare(f"train {name}", s_met[name],
                              u_met[name].reshape(()), bound=1e-3)
                for name in ("nll", "grad_norm")}
    # AdamW's first moment after one step is (1 - b1) x the clipped
    # gradient: each leaf against the unsharded step's
    worst = "bitwise"
    for (path, got), (_, want) in zip(leaves_with_path(s_state["m"]),
                                      leaves_with_path(u_state["m"])):
        v = compare(f"train m {path}", got, want)
        if v != "bitwise" and (worst == "bitwise"
                               or float(v.split()[-1]) > float(
                                   worst.split()[-1])):
            worst = v
    print(f"[sharded] yi-6b train step, {SHARD_TRAIN} layers, B {B} x "
          f"{PROMPT}: nll {verdicts['nll']}, grad norm "
          f"{verdicts['grad_norm']}, AdamW first moments {worst} (worst "
          f"leaf); launches {counts}", flush=True)
    del plain, placed, s_state, u_state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def sharded_serve(mesh, steps, arch: str, layers, kernels) -> dict:
    """Prefill of B x PROMPT and SHARD_DECODE decode steps, sharded and
    not, on the same bf16 weights."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models import lm
    from repro_torch.sharding.specs import placements

    cfg = get_arch(arch) if layers is None else depth_cut(arch, layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    params = lm.init(cfg, seed=0, device="cuda", stacked=True)
    placed = steps.place(params, mesh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (SHARD_DECODE, B), generator=gen,
                         device="cuda")
    max_seq = PROMPT + SHARD_DECODE + 8
    pshape = InputShape("sharded", max_seq, B, "prefill")
    dshape = InputShape("sharded", max_seq, B, "decode")
    tspec = placements(steps.token_spec(B, mesh), mesh)

    def run(mesh_):
        pre = steps.build_step(cfg, pshape, mesh=mesh_).fn
        dec = steps.build_step(cfg, dshape, mesh=mesh_).fn
        p = placed if mesh_ is not None else params
        batch = {"tokens": prompt}
        if mesh_ is not None:
            batch = steps.place(batch, mesh, steps.batch_specs(cfg, batch,
                                                               mesh))
        (logits, caches), c1 = _counted(pre, p, batch)
        outs, counts = [logits], dict(c1)
        lengths = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")
        for i, tok in enumerate(toks):
            n = lengths + i
            if mesh_ is not None:
                tok = distribute_tensor(tok, mesh, tspec)
                n = distribute_tensor(n, mesh, tspec)
            (logits, caches), c2 = _counted(dec, p, tok, caches, n)
            outs.append(logits)
            for k, v in c2.items():
                counts[k] += v
        return outs, counts

    t0 = time.perf_counter()
    got, counts = run(mesh)
    t_sharded = time.perf_counter() - t0
    want, _ = run(None)
    for name in kernels:
        if counts[name] <= 0:
            fail(f"sharded {arch} serving never launched {name}")
    verdicts = [compare(f"{arch} {'prefill' if i == 0 else f'decode {i}'}",
                        g, w) for i, (g, w) in enumerate(zip(got, want))]
    print(f"[sharded] {arch}{'' if layers is None else f' {layers} layers'}"
          f" prefill B {B} x {PROMPT} and {SHARD_DECODE} decode steps "
          f"({t_sharded:.1f}s sharded): logits "
          + ", ".join(verdicts) + f"; launches {counts}", flush=True)
    del params, placed
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------- 7b. ops
# The steps the ops phase traces and runs: (arch, layers, kind, tokens),
# at full width, B x tokens (decode: the cache of a prefill of PROMPT
# plus the serving paths' tokens, the token at PROMPT).  Together they
# reach all seven ops: flash and its backward at (128, 128) and at (256,
# 256) (recurrentgemma-2b's local layer, its third), decode, the SSD scan
# and its backward, the RG-LRU scan and its backward.  recurrentgemma-2b
# trains on 512 tokens: its `ref` trace walks the plain RG-LRU step by
# step, and at 1024 it kept the phase past 60 s.
TRACE_STEPS = (("yi-6b", 4, "train", PROMPT), ("yi-6b", 4, "decode", PROMPT),
               ("mamba2-2.7b", 4, "train", PROMPT),
               ("recurrentgemma-2b", 3, "train", 512))
# A step's measured peak against its traced one: never below it (the
# trace must miss no allocation), at most 5% and 256 MiB above it (the
# allocator rounds each block up to 512 bytes, or keeps up to 1 MiB past
# a large one, and keeps cuBLAS's workspace).
TRACE_RATIO, TRACE_SLACK = 1.05, 256 * 2 ** 20
# One child per (step, backend), all started at the phase's start: each
# traces under a fake process group of one rank with the card hidden.
TRACE_CHILD = """
import json, sys, time
import torch
torch.set_num_threads(1)
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import chip_smoke
from repro_torch.launch import dryrun
arch, layers, kind, tokens, backend = sys.argv[2:]
t0 = time.perf_counter()
with dryrun.fake_world(1):
    mesh = dryrun._mesh((1, 1), ("data", "model"), "cpu")
    rec = dryrun.trace_step(chip_smoke.depth_cut(arch, int(layers)),
                            chip_smoke.trace_shape(kind, int(tokens)), mesh,
                            backend, probes=False)
out = dict(rec["memory_analysis"], seconds=time.perf_counter() - t0)
print("TRACED " + json.dumps(out, allow_nan=False))
"""


def trace_shape(kind: str, tokens: int):
    from repro_torch.configs.shapes import InputShape

    return InputShape(f"ops-{kind}", MAX_SEQ if kind == "decode" else tokens,
                      B, kind)


def opcheck_cases(gen: torch.Generator) -> list:
    """``(label, op, args)``: each op at one shape per instantiation of its
    kernel (bf16 inputs, fp32 dt, A, gates and states)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fwd
    from repro_torch.kernels import flash_attention_bwd as bwd
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rglru_scan_bwd as rgb
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.kernels import ssd_scan_bwd as sdb

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cases = []
    for D, Dv in fwd.HEAD_DIMS:
        q, k, v = randn(1, 80, 4, D), randn(1, 80, 2, D), randn(1, 80, 2, Dv)
        cases.append((f"flash ({D}, {Dv})", fwd.OP,
                      (q, k, v, "causal", 0, 0, D ** -0.5, True)))
    for D, Dv in bwd.HEAD_DIMS:
        H, KV = (4, 1) if (D, Dv) == (256, 256) else (2, 2) \
            if (D, Dv) == (192, 128) else (4, 2)
        q, k, v = randn(1, 80, H, D), randn(1, 80, KV, D), randn(1, 80, KV,
                                                                  Dv)
        out, lse = fwd.OP(q, k, v, "causal", 0, 0, D ** -0.5, True)
        cases.append((f"flash backward ({D}, {Dv})", bwd.OP,
                      (q, k, v, out, randn(1, 80, H, Dv), lse, "causal", 0,
                       0, D ** -0.5)))
    for D, Dv in dec.HEAD_DIMS:
        length = torch.tensor([60, 0], dtype=torch.int32, device="cuda")
        cases.append((f"decode ({D}, {Dv})", dec.OP,
                      (randn(2, 8, D), randn(2, 100, 2, D),
                       randn(2, 100, 2, Dv), length, D ** -0.5, True)))

    def ssd_inputs(b, s, h, p, g, n, init):
        return (randn(b, s, h, p, scale=0.5),
                F.softplus(randn(b, s, h, dtype=torch.float32)),
                -torch.exp(randn(h, dtype=torch.float32)),
                randn(b, s, g, n, scale=0.3), randn(b, s, g, n, scale=0.3),
                randn(b, h, p, n, dtype=torch.float32, scale=0.2)
                if init else None)

    for label, shape in (("TMA", (1, 256, 2, 64, 1, 128, 128, False)),
                         ("plain loads", (1, 96, 3, 24, 1, 40, 48, True))):
        *dims, chunk, init = shape
        cases.append((f"ssd scan {label}", sd.OP,
                      (*ssd_inputs(*dims, init), chunk)))
    for p_, n_ in ((32, 64), (64, 128), (128, 32), (128, 128)):
        x, dt, A, Bm, Cm, h0 = ssd_inputs(1, 128, 2, p_, 1, n_, p_ == 128)
        cases.append((f"ssd backward P{p_} N{n_}", sdb.OP,
                      (x, dt, A, Bm, Cm, randn(1, 128, 2, p_),
                       None if h0 is None else randn(
                           1, 2, p_, n_, dtype=torch.float32), h0, 64)))

    def rglru_inputs(b, s, c, init):
        gates = torch.sigmoid(randn(2, b, s, c, dtype=torch.float32))
        return (randn(b, s, c), gates[0], gates[1],
                -F.softplus(randn(c, dtype=torch.float32)),
                randn(b, c, dtype=torch.float32) if init else None)

    for label, (b, s, c, init) in (("TMA", (2, 130, 64, False)),
                                   ("plain loads", (2, 70, 100, True))):
        x, ga, gi, la, h0 = rglru_inputs(b, s, c, init)
        cases.append((f"rglru scan {label}", rg.OP,
                      (x, ga, gi, la, h0, 8.0, True)))
        _, _, entering = rg.OP(x, ga, gi, la, h0, 8.0, True)
        cases.append((f"rglru backward {label}", rgb.OP,
                      (x, ga, gi, la, randn(b, s, c),
                       randn(b, c, dtype=torch.float32), entering, h0,
                       8.0)))
    return cases


def start_traces() -> dict:
    """Start the dry-run's trace of each of TRACE_STEPS on both backends,
    a child process each: ``{(arch, kind, backend): process}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return {(arch, kind, backend): subprocess.Popen(
        [sys.executable, "-c", TRACE_CHILD, str(ROOT), arch, str(layers),
         kind, str(tokens), backend], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, layers, kind, tokens in TRACE_STEPS
        for backend in ("kernel", "ref")}


def collect_traces(procs: dict) -> dict:
    """Each child's memory record (the dry-run's ``memory_analysis``)."""
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("TRACED ")]
        if proc.returncode != 0 or not lines:
            fail(f"the dry-run's trace of {key} exited {proc.returncode}:\n"
                 f"{stdout[-3000:]}{stderr[-3000:]}")
        out[key] = json.loads(lines[-1][len("TRACED "):])
    return out


def real_args(cfg, shape, bundle, mesh) -> list:
    """Tensors on the card for a bundle's argument structs, placed as the
    dry-run's fake ones are: trained params from ``lm.init`` (fp32 master
    weights, grad on), AdamW's state and a batch of the data pipeline;
    serving params in bf16, zeroed caches, tokens and lengths at PROMPT."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.data import pipeline as data
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.sharding.specs import placements
    from repro_torch.tree import tree_map

    def put(struct, t, grad=False):
        d = distribute_tensor(t.detach(), mesh, placements(struct.spec, mesh))
        return d.requires_grad_(grad)

    train = shape.kind == "train"
    params = lm.init(cfg, seed=0, device="cuda", stacked=True,
                     dtype=torch.float32 if train else torch.bfloat16)
    placed = tree_map(lambda s, t: put(s, t, train), bundle.arg_specs[0],
                      params)
    del params
    if train:
        batch = data.batch_for_step(cfg, shape, 0, device="cuda")
        return [placed, adamw.init(placed),
                tree_map(put, bundle.arg_specs[2], batch)]
    _, tok, caches, lengths = bundle.arg_specs
    return [placed,
            put(tok, torch.randint(0, cfg.vocab_size, tok.shape,
                                   generator=torch.Generator(
                                       device="cuda").manual_seed(1),
                                   device="cuda", dtype=tok.dtype)),
            tree_map(lambda s: put(s, torch.zeros(s.shape, dtype=s.dtype,
                                                  device="cuda")), caches),
            put(lengths, torch.full(lengths.shape, PROMPT,
                                    dtype=lengths.dtype, device="cuda"))]


def run_steps() -> dict:
    """Each of TRACE_STEPS on both backends on the card, on a (1, 1) mesh
    of one NCCL rank (a HashStore, as the sharded phase's):
    ``{(arch, kind, backend): (peak bytes from before the arguments,
    their bytes, the kernels' launches)}``; the peak statistic is reset
    once the arguments are placed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    out = {}
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).view(1, 1),
                          mesh_dim_names=("data", "model"))
        for arch, layers, kind, tokens in TRACE_STEPS:
            cfg, shape = depth_cut(arch, layers), trace_shape(kind, tokens)
            for backend in ("kernel", "ref"):
                bundle = steps.build_step(cfg, shape, mesh=mesh,
                                          backend=backend)
                gc.collect()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                args = real_args(cfg, shape, bundle, mesh)
                gc.collect()
                torch.cuda.synchronize()
                arg_bytes = torch.cuda.memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                result = bundle.fn(*args)
                torch.cuda.synchronize()
                out[arch, kind, backend] = (
                    torch.cuda.max_memory_allocated() - base, arg_bytes,
                    {k: v for k, v in ops.launch_counts().items() if v})
                del result, args
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def phase_ops(gen: torch.Generator) -> None:
    """opcheck of every op on the card, then TRACE_STEPS traced (child
    processes, started first) and run (see the module docstring, 7b)."""
    t0 = time.perf_counter()
    procs = start_traces()
    try:
        opcheck_all(gen)
        measured = run_steps()
        t1 = time.perf_counter()
        traced = collect_traces(procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[ops] {len(traced)} traces from child processes: waited "
          f"{time.perf_counter() - t1:.1f}s for them after the runs, "
          f"{time.perf_counter() - t0:.1f}s since they started", flush=True)
    check_peaks(traced, measured)


def opcheck_all(gen: torch.Generator) -> None:
    t0 = time.perf_counter()
    cases = opcheck_cases(gen)
    for label, op, args in cases:
        try:
            torch.library.opcheck(op, args)
        except Exception as exc:       # report which op and shape
            fail(f"opcheck of {op} at {label}: {exc}")
    print(f"[ops] opcheck passed for {len(cases)} cases, every op at one "
          f"shape per kernel instantiation: "
          + "; ".join(label for label, _, _ in cases)
          + f" ({time.perf_counter() - t0:.1f}s)", flush=True)


def check_peaks(traced: dict, measured: dict) -> None:
    """Each step's measured peak within [traced, traced x TRACE_RATIO +
    TRACE_SLACK] on both backends; the kernel runs launched every op of
    their mixers (all seven in all), the ref runs none."""
    from repro_torch.kernels import ops

    expect = {"yi-6b": {"train": {"flash_attention", "flash_attention_bwd"},
                        "decode": {"decode_attention"}},
              "mamba2-2.7b": {"train": {"ssd_scan", "ssd_scan_bwd"}},
              "recurrentgemma-2b": {"train": {
                  "rglru_scan", "rglru_scan_bwd", "flash_attention",
                  "flash_attention_bwd"}}}
    reached = set()
    for arch, layers, kind, tokens in TRACE_STEPS:
        for backend in ("kernel", "ref"):
            rec = traced[arch, kind, backend]
            want = rec["peak_bytes"]
            peak, arg_bytes, counts = measured[arch, kind, backend]
            top = want * TRACE_RATIO + TRACE_SLACK
            print(f"[ops] {arch} {layers} layers {kind} B {B} x {tokens}, "
                  f"{backend}: measured peak {peak / 2**30:.3f} GiB, traced "
                  f"{want / 2**30:.3f} GiB (bound {top / 2**30:.3f}; "
                  f"measured - traced {(peak - want) / 2**20:.1f} MiB); "
                  f"arguments {arg_bytes / 2**30:.3f} GiB real, "
                  f"{rec['argument_size_in_bytes'] / 2**30:.3f} traced "
                  f"in {rec['seconds']:.1f}s; launches {counts}", flush=True)
            if backend == "ref" and counts:
                fail(f"{arch} {kind} on the ref backend launched {counts}")
            if backend == "kernel":
                if not expect[arch][kind] <= set(counts):
                    fail(f"{arch} {kind} launched {counts}, not every op of "
                         f"{sorted(expect[arch][kind])}")
                reached |= set(counts)
            if not want <= peak <= top:
                fail(f"{arch} {kind} {backend}: measured peak {peak} bytes "
                     f"outside [traced {want}, {int(top)}]")
    if reached != set(ops.KERNELS):
        fail(f"the traced steps launched {sorted(reached)}, not all seven "
             f"ops")


def timed(name: str, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    print(f"[{name}] phase took {time.perf_counter() - t0:.1f}s", flush=True)
    return result


def main() -> None:
    # A run that hangs ends with every thread's stack on stderr before the
    # 1200 s a run may take, not at a caller's kill.
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    kind = timed("device", phase_device)
    timed("build", phase_build)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stats = timed("kernels", phase_kernels, gen)
    stats["threefry"] = timed("threefry", phase_threefry)
    for arch in MODELS:
        timed("model", phase_model, gen, arch)
    launches = {}
    for jobs, path_kernels, pacing in SERVE_PATHS:
        counts = timed("serve", phase_serve, jobs, path_kernels, pacing)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    for phase, *args in (
            (phase_train,), (phase_train_mamba2,),
            (phase_train_recurrentgemma,), (phase_train_multi,),
            (phase_train_mla, "minicpm3-4b", MLA_LAYERS, MLA_PEAK_GIB),
            (phase_train_mla, "deepseek-v2-lite-16b", DSV2_LAYERS,
             DSV2_PEAK_GIB),
            (phase_train_prefixed, "whisper-large-v3", WHISPER_LAYERS),
            (phase_train_prefixed, "pixtral-12b", PIXTRAL_LAYERS),
            (phase_train_moe_repeat,),
            (phase_train_yi34,)):
        counts = timed("train", phase, *args)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    timed("train-check", phase_train_check)
    timed("train-check", phase_train_check, "mamba2-2.7b",
          MAMBA_CHECK_LAYERS)
    timed("train-check", phase_train_check, "recurrentgemma-2b",
          RG_CHECK_LAYERS)
    timed("train-check", phase_train_check, "minicpm3-4b",
          MLA_CHECK_LAYERS)
    timed("train-check", phase_train_check, "deepseek-v2-lite-16b",
          DSV2_CHECK_LAYERS, False)
    timed("train-check", phase_train_check, "whisper-large-v3",
          WHISPER_CHECK_LAYERS)
    timed("train-check", phase_train_check, "pixtral-12b",
          PIXTRAL_CHECK_LAYERS)
    counts = timed("sharded", phase_sharded)
    for name, count in counts.items():
        launches[name] = launches.get(name, 0) + count
    timed("ops", phase_ops, gen)
    timed("scenario", phase_scenario_kernels)
    from repro_torch.configs import ARCHS

    for phase, *args in [(phase_reduced, gen, arch) for arch in sorted(ARCHS)] \
            + [(phase_serve, MAKE_SMOKE_JOBS,
                ("flash_attention", "decode_attention"), [], MAKE_SMOKE),
               (phase_quickstart,)]:
        counts = timed("reduced", phase, *args)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    timed("benchmarks", phase_benchmarks)
    timed("perf", phase_perf)
    timed("analysis", phase_analysis)
    sources = {
        "flash_attention": "src/repro/kernels/flash_attention.py:109",
        "flash_attention_bwd":
            "src/repro/kernels/ops.py:152 (XLA custom_vjp backward)",
        "decode_attention": "src/repro/kernels/decode_attention.py:84",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:94",
        "ssd_scan_bwd":
            "src/repro/kernels/ops.py:255 (XLA autodiff of _ssd_chunked_xla)",
        "rglru_scan": "src/repro/kernels/rglru_scan.py:74",
        "rglru_scan_bwd": "src/repro/kernels/ops.py:339 (XLA autodiff of "
                          "the two-level scan)",
        "threefry": "none: src/repro/models/lm.py:118 and "
                    "src/repro/data/pipeline.py:38 draw with jax.random, "
                    "which XLA compiles",
    }
    kernels = []
    for name, replaces in sources.items():
        # One entry per timed shape; launches are the kernel's count over
        # the serve and train paths, whatever the shape.
        for s in stats[name]:
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                "shape": s["shape"]})
    total = time.perf_counter() - t_start
    print(f"[total] every phase took {total:.1f}s (the tree before the "
          f"threefry kernel: {PREVIOUS_TOTAL_S}s); {card()}", flush=True)
    print(json.dumps({"kernels": kernels}, allow_nan=False), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}, allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
