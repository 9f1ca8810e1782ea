#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result lines) if it fails,
and each of which prints its wall time:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the five CUDA kernel packages (chunk_gather, flash_attention,
   decode_attention, ssd_scan, fused_adamw) from the sources in this
   checkout, one nvcc each, all started together;
3. kernel parity: every kernel against its plain PyTorch version on the
   card, over the port's parity grid, edge cases and the shapes the main
   paths give it: exact for the two integer gathers, the registry's
   scale-normalised tolerance for the attention kernels (f32 2e-5, bf16
   2e-2) and the SSD scan (f32 2e-4, bf16 5e-2). The attention edge cases
   sit at the kernels' tile edges: flash at S 1-257 with windows of
   127-129 (first kv tiles fully masked), D 32/64/128, G 1/4/8, causal and
   not; decode at G 1-16 with a split and an unsplit cache, a ring mask
   that wraps and a fully masked row; and each attention kernel run twice
   and replayed three times in a CUDA graph, bit for bit equal (their
   self-resetting counters: flash's work items, decode's split merge).
   Both attention kernels also run with a logit softcap of 50 (Gemma 2's)
   on logits that overrun it: flash at S 257 and 640, windows 0 and 129,
   decode with a split and an unsplit cache and a ring mask, D 64 and 128
   at G 1 and 7, f32 and bf16, each held to its plain version at the
   registry's tolerances (and read against the uncapped plain version,
   which must miss), with the same replay check; the capped kernels are
   timed at tinyllama's and deepseek-moe-16b's shapes.
   ssd_scan at its bf16 kernel's edges: H of 1, G - 1, G, G + 1 and 65
   (G heads a block), S of 1-257 across the 64-step tile, (P, N) padded
   to 64 with copies of 16 (TMA), 8 and 4 bytes, with and without an
   initial state, contiguous and strided, bf16 and f32; a bf16 x at an odd
   element offset must raise; and the same replay check.
   Times each kernel, its plain version and, where one exists, the PyTorch
   library call computing the same function on the device (a CUDA graph
   of many calls, CUDA events), and computes its bound from the inputs;
   the attention kernels at each serving path's shapes, deepseek-moe-16b's
   16/16 heads of 128 among them. The flash training route (the forward
   with its log-sum-exp, the backward) at the four benchmark cells'
   attention shapes: output, log-sum-exp and dq, dk, dv against the plain
   version in f32 under autograd (2e-2 scale-normalised, log-sum-exp
   1e-4), then timed beside its bound.
   The two gathers also run over their edge grid (``chunk_gather/
   edges.py``: 16-byte and scalar paths, slot views at offsets 0-3, rows
   at run, warp and block edges, n of 0, 1, 3, 4, 5, S and S + 1,
   out-of-range slots) and a replay check on each path; their times at
   B = 8 print beside the launch floor (a one-element ``fill_`` in the
   same harness), with host time per call, and ``chunk_gather_train``
   is timed at the large shape (``train_4k`` as one batch: B = U = 256,
   S = 4096) against its bytes bound, rotating 8 input sets and keeping
   every output so that no call finds its bytes in the L2.
   3o: the fused clip and AdamW (``fused_adamw``) on the benchmark
   configurations' real parameter trees, as ``--optim`` below does; its
   launches on the AdamW training paths (phases 4, 8, 14, 15) go into the
   ``kernels`` line, and phases 4 and 12 fail unless AdamW launched it
   and Adafactor and SGDM did not;
4. training main path: ``repro_torch.launch.train`` at tinyllama-1.1b
   full width (22 layers, d_model 2048, 32/4 heads, vocab 32000, bf16),
   B=8, S=2048, ``--device-path gather --remat dots`` for 6 steps. Checks
   that the gather kernel ran once per staged batch, every loss is finite,
   the first loss is near ln(vocab), and the staged batches equal a second
   loader's host stream; then profiles a 4-step run for the device's idle
   share and its heaviest kernels (fails if the trace holds no device
   events or no gather kernel, or unless each staged batch is 2 device
   operations on the stager's side stream: one copy and the gather);
5. serving main path: ``repro_torch.launch.serve`` at tinyllama-1.1b full
   width, B=8, a 1920-token prompt, 128 new tokens. Checks 22 flash and
   22 x 127 decode launches, tokens in range, finite logits, and decode
   against a fresh prefill at four positions (scale-normalised error <=
   5e-2 and argmax agreeing on 7 of 8 rows). Decode goes through the
   server's step, one captured CUDA graph replayed a token (the phase
   fails unless it was captured; every serving phase checks the same and
   prints the graph's device operations). 5b profiles 16 decode steps
   through the graph and 16 through the eager step (``model.decode_step``)
   in the same call, for the device's idle share, busy time and
   operations a step and the heaviest kernels (fails if the trace holds no
   device events or no decode kernel), and times, without the profiler,
   the device time a step as served and the host time of a call and of a
   bare replay. 5c holds the graph to the eager step bit for bit (tokens,
   logits and caches): tinyllama at full width on phase 5's weights and
   prompts for 32 steps, and reduced zamba2 in f32 with its SSM and conv
   states for 16; then a reduced tinyllama with the softcap in f32 is
   served and its decode held to a fresh prefill (SMALL_TOL);
6. small-input reference: reduced tinyllama in f32 on the card against the
   same weights on the CPU, TF32 off: logits and one train step, and
   prefill + greedy decode with a full, a rotating-window and an int8
   cache, and with the softcap; reduced zamba2 the same way, with a full
   cache and a window the
   prompt overfills; reduced deepseek-moe-16b the same way, and reduced
   xlstm-350m with a full cache;
7. hybrid serving main path: ``repro_torch.launch.serve`` at zamba2-1.2b
   full width (38 Mamba-2 blocks, d_model 2048, 64 SSM heads of 64, state
   64; the shared attention+MLP block, 32/32 heads, at 6 sites; vocab
   32000, bf16), B=8, a 3584-token prompt, 512 new tokens. Checks 38
   ssd_scan and 6 flash launches in the prefill and 6 x 511 decode
   launches, tokens in range, finite logits, and decode step 255 against a
   fresh prefill of its 3840 tokens: logits (scale-normalised error <= 5e-2,
   argmax agreeing on 7 of 8 rows) and all 38 SSM and conv states, and
   reads the states one token stale as a planted fault, which the bound
   must catch; then profiles the prefill (ssd_scan's share of device time)
   and 16 decode steps (the device's idle share);
8. data-service main path: ``repro_torch.launch.data_service --serve`` in
   a subprocess (1024 records of mean length 2048, vocab 32000,
   ``--co-refill``), the training path of phase 4 through it
   (``--data-server SOCK --device-path stage``) and a co-tenant job
   consuming epoch 0 over its own ``RedoxClient`` in a thread of this
   script. Checks 6 finite losses, the first near ln(vocab), both jobs'
   streams byte for byte against in-process loaders of their specs on the
   server's store, no gather launch (ring frames ship assembled grids),
   and reads the server's storage bytes against the two jobs' demand;
   profiles 4 steps of the same path for its idle share. Then
   ``--autotune --device-path gather --steps 3`` on a store the trainer
   builds: the calibrated choice, one gather launch a staged batch, and
   the staged batches against a loader on the reopened store. The server
   is stopped in a ``finally``; its stderr is shown if it dies or a check
   fails;
9. MoE serving main path: ``repro_torch.launch.serve`` at deepseek-moe-16b
   full width (28 layers: one dense, d_ff 10944, then 27 MoE with 64 routed
   experts of d_ff 1408, top-6, and 2 shared; d_model 2048, 16/16 heads of
   128, vocab 102400, bf16, capacity factor 1.25), B=8, a 1920-token
   prompt, 128 new tokens. Checks 28 flash and 28 x 127 decode launches (no
   other kernel), tokens in range, finite logits; reads the share of the
   prefill's routed assignments that capacity dropped; profiles 16 decode
   steps (idle share). Then the check run: one sequence in f32 at capacity
   factor 11 (no prefill drops), decode at phase 5's four positions
   against a fresh prefill (scale-normalised error <= 1e-3, argmax equal),
   and a planted fault, the cache one token stale, which must read above
   the bound;
10. xLSTM serving main path: ``repro_torch.launch.serve`` at xlstm-350m
   full width (24 blocks, every 8th sLSTM; d_model 1024, 4 heads, the
   mLSTM inner 2048 in heads of 512; vocab 50304, bf16), B=8, a 1792-token
   prompt, 257 new tokens. Checks that no kernel launched, tokens in range,
   finite logits, and reads the sLSTM blocks' share of a prefill. Then the
   check run in f32: decode step 255 against a fresh prefill of its 2048
   tokens, the logits and the 21 mLSTM and 3 sLSTM states, and the states
   one token stale as a planted fault, which must read above every bound;
11. VLM serving main path: ``repro_torch.launch.serve`` at llava-next-34b
   full width (60 layers, d_model 7168, 56/8 heads of 128, d_ff 20480,
   vocab 64000; 2304 patch embeddings of width 1024 projected by the
   ``frontend`` leaf; bf16), B=4, 2304 zero patches and a 256-token prompt
   (a 2560-position prefill), 64 new tokens against the reference's ring of
   320 slots. Checks 60 flash and 60 x 63 decode launches (G = 7 padded to
   a query group of 8), decode positions after the patches, tokens in
   range, finite logits and peak memory within the card; profiles 16
   decode steps (idle share). Then the check run (11c): the same model
   with a cache that holds every position, seeded random patches, decode
   at steps 0, 20, 41 and 62 against a fresh prefill (phase 5's bounds,
   argmax on all rows but one), and a planted stale cache above them;
12. encoder training main path: ``repro_torch.launch.train`` at
   hubert-xlarge full width (48 layers, d_model 1280, 16/16 heads of 80,
   d_ff 5120, vocab 504, non-causal; one-hot frames of width 512 projected
   in place of the tokens), B=8, S=2048, ``--device-path gather --remat
   dots --optimizer adafactor`` for 6 steps, then ``--optimizer sgdm`` for
   3, each checked as phase 4 is (the frames held to the host stream's
   tokens) and phase 4b's profile of the Adafactor run (12b); then (12c)
   phi3-medium-14b at full width cut to 2 layers, B=1, S=4096, bf16:
   ``_chunked_attention_vecq`` against ``_chunked_attention`` on the same
   q/k/v (2e-2), and 2 AdamW train steps, which attend through the flash
   training kernels (plain bf16 tensors on one card), with finite losses;
13. the all-to-all MoE: phase 9's run (deepseek-moe-16b full width and
   depth, bf16, B=8, a 1920-token prompt, 128 new tokens) with
   ``moe_impl="a2a"``, through the port's prefill and decode steps under a
   1x1 ("data", "model") mesh on a one-rank NCCL group, its rules installed
   as the sharding context: the prefill's MoE layers go through
   ``moe_block_a2a`` (decode routes one token through ``moe_block``, as the
   reference's does). Checks 28 flash and 28 x 127 decode launches, tokens
   in range and finite logits, and prints which decode step ran (under the
   rule of ``build_decode_step``, a mesh of one device captures the graph);
   reads each capacity stage's dropped share
   over a prefill; profiles 16 decode steps and one prefill, beside a
   prefill of the same weights through ``moe_block``, and prints them
   beside phase 9's. Then (13b) the a2a against ``moe_block`` on the same
   weights in f32, B=1, the depth cut to 4 layers at full width (9c runs
   full depth): ``moe_block`` at capacity factor 11 and the a2a at 3.32,
   where neither drops (both must count 0 drops), the prefill logits and
   decode steps 0, 42, 84 and 126 within 1e-3 scale-normalised, argmax
   equal on every row; and (13c) ``python -m repro_torch.launch.dryrun
   --arch tinyllama-1.1b --shape train_4k --single-pod-only`` on this host:
   the full config's train step on DTensors over meta tensors on a 16x16
   mesh of a fake 512-rank group (no JAX here), which must come back ok;
   prints FLOPs per device, collective bytes by kind, memory and the
   H100 roofline row of ``repro_torch.launch.roofline``.

14. the examples: ``examples/train_lm_torch.py --preset 100m --device-path
   gather --ckpt-every 20`` (12 layers, d_model 768, 12/4 heads of 64, d_ff
   3072, vocab 32000, f32, B=8, S=512) for 40 steps in a fresh workdir,
   then the same command there with ``--steps 60`` (on the first run's
   chunk store, handed to ``train``), which must print ``resumed from step
   40`` and ``done: 60 steps``. Each run is checked as phase 4's is (one
   gather launch a staged batch, every staged batch equal to the host
   stream of a fresh loader on the store, every loss finite, printed ones
   included, the first near ln(vocab)), and the resumed run's first loss,
   on the same first batch, must lie below the init's. Prints the steady
   tokens/s (and without the checkpoint saves) and the stager's overlap
   fraction. Then ``examples/serve_decode_torch.py`` at its defaults
   (reduced zamba2-1.2b, f32, B=4, a 48-token prompt, 24 new tokens), a
   functional check (its printed rate, at this size the first call's
   warm-up and capture, is no measurement): the decode step captured, flash
   once per attention site and ssd_scan once per Mamba-2 block in the
   prefill, decode attention once per site and decode step (2, 4 and 2 x
   23 on the reduced layout), and the ids equal to ``generate`` on the CPU
   with the same weights;
15. convergence parity, ``benchmarks/convergence.py``'s recipe (the paper's
   Fig. 15 and Table 7) on the port: 1536 records of mean length 72 at
   vocab 211, chunks of 8, 3 nodes, B=24, S=96, one init (seed 7) for
   every run. Each cell trains Redox at 96 memory slots and at 32 (another
   chunk mapping), through ``epoch_device`` and the gather (launches equal
   to the staged batches, every fed batch equal to the host stream of a
   fresh loader on the same store), and an exact global shuffle staged
   plainly (no gather launch), and fails unless each Redox run's tail-mean loss (the
   last third of the curve) lies within 0.15 of the exact shuffle's, after
   printing a loss row every sixth of the run. 15a: the reference's model,
   reduced tinyllama cut to 2 layers, AdamW 3e-3, 120 steps. 15b: the 100m
   preset's widths, 160 steps (2.5 epochs), AdamW 3e-4, with a fourth run,
   an exact shuffle of another sampler seed, whose gap is printed as the
   yardstick of two honest shuffles. 15c: 15b's first Redox run profiles
   its steps 3-6 (idle share, device operations a step);
16. the compiled train step (``train_step.GraphTrain``, which every
   training phase above runs through on the card): (16a) at phase 4's
   shape (tinyllama-1.1b full width, bf16, B=8, S=2048, remat dots,
   AdamW) and at the 100m preset's widths (f32, B=8, S=512) with AdamW,
   Adafactor and SGDM, 4 steps through the eager step twice and through
   the graph, each from the same init on the same seeded feeds: the
   graph's difference from the first eager run, per state leaf (every
   parameter, moment, factored moment, momentum, master and the step) and
   per metric, must not exceed the eager step's own run-to-run spread
   (bit for bit where eager repeats itself); (16b) the graph and the eager
   step in turn at 15c's step (15b's config, the first six batches of its
   exact shuffle) and at phase 4's (seeded feeds), steps 3-6 profiled:
   idle share, device operations and busy ms a step, the graph's nodes,
   host µs a call and a bare replay (each alone on an idle card), and the
   run's peak memory; (16c) while a reduced tinyllama step is captured,
   another thread stages a pack as the stager does: its gather counts one
   launch over 4 steps, none of it in the graph, its grids the plain
   gather's.

Phase 6 also holds reduced llava-next-34b (serving, with patches),
hubert-xlarge and phi3-medium-14b (through vecq) to the CPU in f32:
logits and two Adafactor and two SGDM steps each. Phase 3 also holds
both attention kernels at G = 7 and G = 4, D = 128, and times them at
llava's shapes.

The last fifteen lines are the training path's numbers as JSON, the
serving path's, the hybrid serving path's, the data-service path's, the MoE
serving path's, the xLSTM serving path's, the VLM serving path's, the
encoder training path's, the all-to-all MoE path's (with 13b and 13c),
the examples' (phase 14), the convergence cells' (phase 15), the train
graph's (phase 16), the card's name and power limit, the kernel
table as JSON (five kernels), and ``{"ok": true, "device": {...}}``. Exits non-zero without a card, and in
a directory without the port's sources.

    python3 chip_smoke.py --gathers

runs phases 1-2 for ``chunk_gather`` only, the gathers' timings and
phase 4b's profile (the staged batch's device operations on the stager's
side stream), and prints them as JSON last.

    python3 chip_smoke.py --decode

runs phases 1-2, phase 3's attention kernels (the softcap cases and
times included) and phases 5, 5b and 5c, and prints them as JSON last.

    python3 chip_smoke.py --examples

runs phases 1-2, 14, 15 and 16 and prints them as JSON last.

    python3 chip_smoke.py --flash

runs phases 1-2 and phase 3's flash-attention rows: the prefill forward's
times (tinyllama's and deepseek-moe's shapes, D 64 and 128) and the
training kernels' (the forward with its log-sum-exp and the backward) at
the four benchmark cells' shapes: the training route's output, log-sum-exp
and gradients against the plain version in f32 (a mismatch fails), then
the times, each beside its bound, the plain version under autograd and
``scaled_dot_product_attention``'s forward and backward (yardstick only);
then the same for multi-head latent attention's (192, 128) kernels at
kimi-k2-instruct.tokens4k's shape (``check_flash_mla``), and prints them as
JSON last.

    python3 chip_smoke.py --optim

runs phases 1-2 for ``fused_adamw`` and phase 3o: the global-norm clip and
AdamW with an f32 master on each benchmark configuration's real parameter
tree (hubert-xlarge, zamba2-1.2b, nemotron-3-nano-30b-a3b's stage; bf16
parameters and gradients drawn on the card), as the loop of
``optim/optimizers.py`` and as the two fused launches, each timed in a CUDA
graph in turns beside the bound of 30 bytes a parameter at 3.35 TB/s; the
fused norm against the loop's (1e-6 relative) and across two passes (bit
for bit), two launches a pass; from one state kept on the host, a fused
pass against the loop on the gradients clipped by the fused pass's own
scale, every parameter, m, v and master bit for bit (a mismatch fails);
and each kernel's time from the profiler.
No one PyTorch call computes the same update, so there is no library
yardstick. Prints them as JSON last.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM device memory rate and dense bf16 tensor-core rate (NVIDIA
#: data sheet), bytes/s and FLOP/s.
HBM_BYTES_PER_S = 3.35e12
#: Input sets the large gather rotates through in one graph (see time_gathers).
LARGE_GATHER_SETS = 8
BF16_FLOP_PER_S = 989e12
#: f32 outside the tensor cores (NVIDIA data sheet, 700 W).
F32_FLOP_PER_S = 67e12
KERNEL_PACKAGES = ("chunk_gather", "flash_attention", "decode_attention", "ssd_scan",
                   "fused_adamw")
#: The benchmark cells whose configurations' parameter trees phase 3o updates.
OPTIM_CELLS = ("hubert-xlarge.frames2k", "zamba2-1.2b.tokens2k",
               "nemotron-3-nano-30b-a3b.tokens4k")
MAIN_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--nodes", "2", "--batch", "8",
             "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
             "--steps", "6"]
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--batch", "8", "--prompt-len", "1920",
              "--new-tokens", "128", "--seed", "0"]
SMALL_TOL = 1e-4  # f32 on the card vs the CPU: summation order only
#: The logit softcap of phase 3's and 5c's capped cases: Gemma 2's
#: attn_logit_softcapping (arXiv:2408.00118, Table 1). No registered
#: config sets one.
SOFTCAP = 50.0
#: int8 caches on the card vs the CPU: K/V that agree to f32 summation
#: order can still round to neighbouring codes at a .5 boundary, and one
#: such code moved reduced-model logits by 2.8e-4 of their max
#: (tests/test_torch_serve.py); the greedy tokens must still be equal.
SMALL_INT8_TOL = 1e-3
#: Decode against a fresh prefill at full width in bf16: the two paths
#: round at different places (GEMMs of other shapes, the kernels' p cast).
#: Reduced widths at the full depth reached 8.2e-3 on the CPU
#: (tests/test_torch_serve.py::test_decode_matches_fresh_prefill); a wrong
#: cache slot or mask gives errors of order 1.
AGREEMENT_TOL = 5e-2
AGREEMENT_MIN_ROWS = 7
AGREEMENT_STEPS = (0, 42, 84, 126)
HYBRID_ARGS = ["--arch", "zamba2-1.2b", "--full", "--batch", "8", "--prompt-len", "3584",
               "--new-tokens", "512", "--seed", "0"]
#: The decode step held to a fresh prefill: after it the cache holds 3840
#: tokens, a multiple of the 256-token SSD chunk, which a prefill needs.
HYBRID_AGREEMENT_STEP = 255
#: Decode's SSM and conv states after that step against the fresh
#: prefill's, per leaf the worst per-layer scale-normalised error. Reduced
#: widths at Zamba2's depth, SSM head dim and state in bf16 reached 2.6e-2
#: (ssm) and 8.9e-3 (conv) on the CPU over 35 tokens (tests/
#: test_torch_serve.py::test_hybrid_decode_matches_fresh_prefill); this
#: phase on an H100 at 3840 tokens read 4.5e-2 and 3.0e-2. The phase also
#: reads a planted fault, decode's states one token stale (after step 254)
#: against the same prefill, and fails unless that reading lies above the
#: bound: the bound must tell a state that missed one token from a sound one.
HYBRID_STATE_TOL = {"mamba2.ssm": 1e-1, "mamba2.conv": 5e-2}
#: Phase 8: the data server's store (1024 records of mean length 2048 at
#: tinyllama's vocab) and the trainer through it at phase 4's width.
DATA_SERVICE_ARGS = ["--num-docs", "1024", "--seq-len", "2048", "--vocab-size", "32000",
                     "--co-refill"]
SERVED_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--job-id", "job0", "--device-path",
               "stage", "--batch", "8", "--seq-len", "2048", "--nodes", "2", "--remat",
               "dots", "--steps", "6"]
#: The co-tenant job's session: the trainer's shape, seeds of its own
#: (the trainer's are 2 and 3 at ``--seed 0``).
CO_TENANT_SPEC = {"seed": 12, "sampler_seed": 13, "num_nodes": 2, "batch_per_node": 4,
                  "seq_len": 2048, "remote_memory_limit_bytes": 1_000_000}
#: Phase 9: deepseek-moe-16b served at full width (the context 2048) and
#: the decode-vs-prefill check's run: one sequence in f32 at a capacity
#: factor at which no prefill assignment drops (``cap = int(s * 6 * 11 /
#: 64) >= s``). At the configured 1.25 a fresh prefill drops the later
#: tokens' assignments, which decode never does, so the two differ by
#: design; in bf16 the router's rounding picks other experts between the
#: two paths (tests/test_torch_serve.py::test_moe_bf16_decode_drifts_by_routing:
#: 2.0e-1 at reduced widths and full depth), as far as a cache missing a
#: token reads. In f32 they agree to reassociation (3.1e-6 at full depth
#: on the CPU), and the cache one token stale read 3.3e-1 at 960 tokens.
MOE_ARGS = ["--arch", "deepseek-moe-16b", "--full", "--batch", "8", "--prompt-len", "1920",
            "--new-tokens", "128", "--seed", "0"]
MOE_CHECK_ARGS = ["--arch", "deepseek-moe-16b", "--full", "--batch", "1", "--prompt-len",
                  "1920", "--new-tokens", "128", "--seed", "0"]
NO_DROP_CAPACITY = 11.0
#: Decode's logits against a fresh prefill in f32 (phases 9 and 10),
#: scale-normalised; argmax equal on every row. Reduced widths at the full
#: depths read at most 3.1e-6 (MoE) and 4.3e-5 (xLSTM) on the CPU
#: (tests/test_torch_serve.py); on an H100 at full width 2.0e-5 and 2.2e-4.
F32_AGREEMENT_TOL = 1e-3
#: Phase 10: xlstm-350m served at full width; the prompt is 7 mLSTM
#: chunks, and 257 new tokens make 256 decode steps, the last (step 255)
#: reading position 2047, so the fresh prefill it is held to is 8 chunks
#: (a prefill must be at most 256 tokens or a multiple of 256). The check
#: runs in f32: in bf16 the sLSTM's c and n read 1.6e-1 against a fresh
#: prefill at reduced widths, within 3x of a state one token stale.
XLSTM_ARGS = ["--arch", "xlstm-350m", "--full", "--batch", "8", "--prompt-len", "1792",
              "--new-tokens", "257", "--seed", "0"]
XLSTM_AGREEMENT_STEP = 255
#: The state bounds of that check, per leaf the worst per-layer
#: scale-normalised error. The sLSTM's stabiliser m is a running sum of
#: forget pre-activations, about one a token, so by 2048 tokens it is about
#: 2,000, and ``ft + m - m_new`` in the gates loses f32 digits to it: on an
#: H100 the sLSTM's c and n read 2.1e-3 and 2.6e-3, h 6.0e-4, m 4.8e-5, the
#: mLSTM's C and n 1.1e-4 (my first run of this phase; the CPU test at 35
#: tokens reads 4.3e-5 at most), where the states one token stale read
#: 2.2e-1, 1.9e-1, 9.0e-1, 2.2e-3, 8.4e-1 and 5.9e-1. Each bound lies
#: between the two, near 10x from each where the two allow.
XLSTM_STATE_TOL = {"mlstm.C": 1e-3, "mlstm.n": 1e-3, "slstm.c": 2e-2, "slstm.n": 2e-2,
                   "slstm.h": 1e-2, "slstm.m": 5e-4}
#: Phase 11: llava-next-34b served at full width (64.07 GiB of bf16
#: weights): 2304 zero patches and a 256-token prompt prefilled (2560
#: positions), 63 decode steps against the reference's ring of 320 slots.
VLM_ARGS = ["--arch", "llava-next-34b", "--full", "--batch", "4", "--prompt-len", "256",
            "--new-tokens", "64", "--seed", "0"]
#: Phase 11c's steps held to a fresh prefill (phase 5's bounds, AGREEMENT_TOL
#: and argmax on all rows but one). At reduced widths with llava's depth,
#: query group and head dim in bf16, step 10 read 2.1e-2 and the cache one
#: token stale 5.0e-1 (tests/test_torch_frontends.py).
VLM_AGREEMENT_STEPS = (0, 20, 41, 62)
#: Phase 12: hubert-xlarge trained at full width on MAIN_ARGS' store flags,
#: with Adafactor for 6 steps, then with SGDM for 3.
ENCODER_ARGS = ["--arch", "hubert-xlarge", "--full", "--nodes", "2", "--batch", "8",
                "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
                "--optimizer", "adafactor", "--steps", "6"]
ENCODER_SGDM_ARGS = ENCODER_ARGS[:-4] + ["--optimizer", "sgdm", "--steps", "3"]
#: Phase 12c: phi3-medium-14b at full width cut to 2 layers (with AdamW's
#: f32 state, 16 bytes a parameter, 40 layers would need 235 GB), at S =
#: 4096 above ``attn_dense_threshold``: ``attention_block`` takes the
#: sequence-split path. Its output against the chunked path's in bf16.
VECQ_LAYERS = 2
VECQ_SEQ = 4096
VECQ_TOL = 2e-2
#: Phase 13b's capacity factor for the all-to-all MoE on one rank: cap_pair
#: = int(1920 * 6 * 3.32) = 38,246 rows covers the 11,520 assignments and
#: cap_local = int(38,246 * 3.32 / 64) = 1,984 the most one expert can get
#: (1,920), so nothing drops there, beside moe_block's cap of 1,980 at
#: NO_DROP_CAPACITY.
A2A_CAPACITY = 3.32
#: Phase 13b's depth cut, at full width (9c holds full depth in f32).
A2A_CHECK_LAYERS = 4
#: Phase 13c: the dry run's CLI for one cell on the single-pod mesh.
DRYRUN_ARGS = ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--single-pod-only"]
AUTOTUNE_ARGS = ["--arch", "tinyllama-1.1b", "--full", "--nodes", "2", "--batch", "8",
                 "--seq-len", "2048", "--device-path", "gather", "--remat", "dots",
                 "--autotune", "--steps", "3"]
#: Phase 14: ``examples/train_lm_torch.py`` at its 100m preset through the
#: CUDA gather with a checkpoint every 20 steps: 40 steps in a fresh
#: workdir, then the same command there with ``--steps 60`` on the first
#: run's chunk store, which must resume at 40.
#: ``examples/serve_decode_torch.py`` runs at its defaults.
EXAMPLE_TRAIN_ARGS = ["--preset", "100m", "--device-path", "gather", "--ckpt-every", "20"]
EXAMPLE_TRAIN_STEPS = (40, 60)
#: Phase 15: ``benchmarks/convergence.py``'s recipe (the paper's Fig. 15 and
#: Table 7): the corpus, the Redox cluster and the batch grid, the two
#: memory budgets (in slots) that give two chunk mappings, one init for
#: every run, and the bound on the tail-mean losses' gaps.
CONV_DOCS, CONV_VOCAB, CONV_MEAN_LEN, CONV_CHUNK = 1536, 211, 72, 8
CONV_NODES, CONV_REMOTE_LIMIT, CONV_SAMPLER_SEED = 3, 64_000, 11
CONV_BATCH, CONV_SEQ = 24, 96
CONV_SLOTS, CONV_SMALL_SLOTS = 96, 32
CONV_INIT_SEED = 7
CONV_TAIL_TOL = 0.15
#: 15b's second exact shuffle, the yardstick of how far two honest
#: shuffles' tail means lie apart.
CONV_YARDSTICK_SEED = 12
#: 15b's steps: 2.5 of the recipe's 3 epochs of 64 steps, cut for time.
#: Its steps are host-bound (15c: the card idle 0.47-0.70 of a step on an
#: H100), 0.10-0.17 s each by machine, so four runs of 192 steps take
#: 77-131 s of the 150 s meant for phases 14-15 together. At 160 the tail
#: (steps 108-159) still ends on the plateau that a 192-step run reached
#: by step 128 (loss 2.60-2.63 in every run).
CONV_WIDE_STEPS = 160
#: Phase 16a: steps of each run, the graph's and the eager step's, and the
#: optimizers run at the 100m preset's widths.
GRAPH_STEPS = 4
GRAPH_OPTIMIZERS = ("adamw", "adafactor", "sgdm")


class PhaseClock:
    """Prints each phase's heading and, at the next heading, its wall time."""

    def __init__(self):
        self.times: dict = {}
        self._name, self._t0 = None, time.perf_counter()

    def __call__(self, name: str | None) -> None:
        now = time.perf_counter()
        if self._name is not None:
            self.times[self._name] = now - self._t0
            print(f"-- {self._name}: {now - self._t0:.1f} s wall", flush=True)
        self._name, self._t0 = name, now
        if name is not None:
            print(f"\n== {name}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def graph_ms(fn, *, calls: int = 50, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, so no host code runs between the launches; the graph replayed
    ``reps`` times between CUDA events; the median replay over ``calls``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(samples)


def host_ms(fn, *, calls: int = 50, reps: int = 20) -> float:
    """Host time per call of ``fn`` (checks, allocation, launch): the median
    over ``reps`` of ``calls`` back-to-back calls on the host clock."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(samples)


def turns(kernel, plain, library=None, **kw) -> dict:
    """Device time per call in turns (plain, kernel, kernel, plain, and the
    library call last), so drift hits both versions alike."""
    p1 = graph_ms(plain, **kw)
    k1, k2 = graph_ms(kernel, **kw), graph_ms(kernel, **kw)
    p2 = graph_ms(plain, **kw)
    out = {"ms": statistics.median([k1, k2]), "plain_ms": statistics.median([p1, p2]),
           "runs_ms": [k1, k2], "plain_runs_ms": [p1, p2], "library_ms": None}
    if library is not None:
        out["library_ms"] = graph_ms(library, **kw)
    return out


def gather_bytes(slots, lens, idx, seq_len: int) -> tuple[int, int]:
    """Bytes ``chunk_gather_train`` must move on these inputs, and the
    number of distinct slot rows: ``idx`` read once, ``lens`` and the first
    ``min(lens[s], S + 1)`` tokens of each distinct selected row ``s`` read
    once, three (B, S) 4-byte outputs written once."""
    import torch

    rows = torch.unique(idx.long())
    row_tokens = int(lens[rows].long().clamp(max=seq_len + 1).sum())
    b = idx.numel()
    return b * 4 + rows.numel() * 4 + row_tokens * 4 + b * seq_len * 12, rows.numel()


def bound(flops: float, moved: int, rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over their peak rate (bf16 tensor cores unless given) and
    the bytes over the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / rate * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def zero_launches() -> None:
    from repro_torch.kernels.common import kernel_wrappers

    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.common import kernel_wrappers

    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# --------------------------------------------------------------- phase 3
def launch_floor() -> float:
    """The least time one launch takes in :func:`graph_ms`: a one-element
    ``fill_`` on the card, in ms."""
    import torch

    x = torch.empty(1, device="cuda")
    return graph_ms(lambda: x.fill_(1.0))


def large_gather_sets(device, sets: int = LARGE_GATHER_SETS) -> tuple[int, list]:
    """``sets`` input sets of the large shape: the repo's ``train_4k``
    (S = 4096, global batch 256) staged as one batch, B = U = 256, slot rows
    padded to 8 as the stager packs them; ``idx`` a permutation (every
    record distinct, as exactly-once makes them), ``lens`` uniform in
    [1, S + 1], from numpy with seed 0."""
    import numpy as np
    import torch

    from repro_torch.configs.shapes import get_shape

    shape = get_shape("train_4k")
    b, s = shape.global_batch, shape.seq_len
    lp = -(-(s + 1) // 8) * 8
    rng = np.random.default_rng(0)
    out = []
    for _ in range(sets):
        lens = rng.integers(1, s + 2, b)
        slots = rng.integers(1, 32000, (b, lp))
        idx = rng.permutation(b)
        out.append(tuple(torch.as_tensor(np.asarray(a, np.int32), device=device)
                         for a in (slots, lens, idx)))
    return s, out


def time_gathers(device) -> dict:
    """Both gathers timed at B = 8 beside the launch floor (before and
    after), with their plain versions and host time per call; then
    ``chunk_gather_train`` at the large shape, each input set first held to
    its plain version (tolerance 0), timed with the L2 defeated: each
    captured call takes the next of 8 input sets and keeps its outputs, so
    between two reads of one set some 100 MB pass through the 50 MB L2."""
    import itertools

    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.chunk_gather.ops import chunk_gather, chunk_gather_train
    from repro_torch.kernels.chunk_gather.ref import chunk_gather_ref, chunk_gather_train_ref

    floor = [launch_floor()]
    train_case = parity.KernelCase("chunk_gather_train", (8, 2048, 8), "int32")
    slot, lens, idx = parity.make_inputs(train_case, device=device, row_pad=8)

    def train():
        return chunk_gather_train(slot, lens, idx, seq_len=2048)

    def train_plain():
        return chunk_gather_train_ref(slot, lens, idx, seq_len=2048)

    raw_case = parity.KernelCase("chunk_gather", (8, 2176, 8), "int32")
    rslots, rlens, ridx = parity.make_inputs(raw_case, device=device)

    def raw():
        return chunk_gather(rslots, rlens, ridx)

    def raw_plain():
        return chunk_gather_ref(rslots, rlens, ridx)

    out = {"chunk_gather_train": turns(train, train_plain),
           "chunk_gather": turns(raw, raw_plain)}
    for name, (kernel, plain) in (("chunk_gather_train", (train, train_plain)),
                                  ("chunk_gather", (raw, raw_plain))):
        out[name].update(host_ms=host_ms(kernel), plain_host_ms=host_ms(plain))
    floor.append(launch_floor())
    out["floor_runs_ms"] = floor
    out["floor_ms"] = statistics.median(floor)
    # The stores alone: one fill_ of the trainer's three outputs.
    grids = torch.empty((3, 8, 2048), dtype=torch.int32, device=device)
    out["store_floor_ms"] = graph_ms(lambda: grids.fill_(0))
    moved, rows = gather_bytes(slot, lens, idx, 2048)
    out["chunk_gather_train"].update(bytes=moved, rows=rows, inputs=(slot, lens, idx),
                                     shape=f"B=8 S=2048 Lp={slot.shape[1]}")
    rows = torch.unique(ridx.long())
    row_len = rslots.shape[1]
    # idx read once; lens and the first min(len, L) tokens of each distinct
    # selected row read once; (B, L) int32 tokens and f32 mask written once.
    moved = (ridx.numel() * 4 + rows.numel() * 4
             + int(rlens[rows].long().clamp(max=row_len).sum()) * 4 + ridx.numel() * row_len * 8)
    out["chunk_gather"].update(bytes=moved, rows=rows.numel(), inputs=(rslots, rlens, ridx),
                               shape=f"B=8 L={row_len}")

    s, sets = large_gather_sets(device)
    for i, inputs in enumerate(sets):
        got = chunk_gather_train(*inputs, seq_len=s)
        want = chunk_gather_train_ref(*inputs, seq_len=s)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"chunk_gather_train at the large shape, input set {i}: kernel disagrees "
                 f"with its plain version (tolerance 0)")
    del got, want
    cycle, keep = itertools.cycle(sets), []

    def large():
        slots_, lens_, idx_ = next(cycle)
        keep.append(chunk_gather_train(slots_, lens_, idx_, seq_len=s))

    runs = []
    for _ in range(2):
        runs.append(graph_ms(large))
        keep.clear()
    moved = statistics.mean(gather_bytes(*inputs, s)[0] for inputs in sets)
    bound_ms, _ = bound(0, moved)
    out["large"] = {"shape": f"B=U={sets[0][2].numel()} S={s} Lp={sets[0][0].shape[1]}",
                    "runs_ms": runs, "bytes": moved, "bound_ms": bound_ms,
                    "share_of_bound": [bound_ms / r for r in runs], "sets": len(sets)}
    return out


def print_gather_times(t: dict) -> None:
    floor = t["floor_runs_ms"]
    print(f"launch floor (a one-element fill_, CUDA graph of 50 calls): "
          f"{floor[0] * 1e3:.3f} / {floor[1] * 1e3:.3f} us (before / after the gathers); "
          f"a fill_ of the trainer's three (8, 2048) outputs: "
          f"{t['store_floor_ms'] * 1e3:.3f} us")
    for name in ("chunk_gather_train", "chunk_gather"):
        g = t[name]
        print(f"{name} at {g['shape']}: device time per call (CUDA graph of 50 calls, CUDA "
              f"events): kernel {g['runs_ms'][0] * 1e3:.3f} / {g['runs_ms'][1] * 1e3:.3f} us "
              f"(floor {t['floor_ms'] * 1e3:.3f} us), plain {g['plain_runs_ms'][0] * 1e3:.3f} / "
              f"{g['plain_runs_ms'][1] * 1e3:.3f} us; host time per call: kernel "
              f"{g['host_ms'] * 1e3:.2f} us, plain {g['plain_host_ms'] * 1e3:.2f} us; bound "
              f"{g['bytes'] / HBM_BYTES_PER_S * 1e6:.4f} us ({g['bytes']} bytes, {g['rows']} "
              f"distinct slot rows, at 3.35 TB/s); library: none")
    big = t["large"]
    print(f"chunk_gather_train at {big['shape']} ({big['sets']} input sets rotated, outputs "
          f"kept, each equal to its plain version): {big['runs_ms'][0] * 1e3:.3f} / {big['runs_ms'][1] * 1e3:.3f} us against a "
          f"{big['bound_ms'] * 1e3:.3f} us bound ({big['bytes']:.0f} bytes at 3.35 TB/s): "
          f"{big['share_of_bound'][0]:.1%} / {big['share_of_bound'][1]:.1%} of it")


def check_gather_edges(device) -> None:
    """Both gathers over their edge grid (``chunk_gather/edges.py``: both
    paths, views at offsets 0-3, row lengths at run, warp and block edges,
    n at 0, 1, 3, 4, 5, S, S + 1, out-of-range slots), exactly, then a
    replay check of each on each path."""
    import torch

    from repro_torch.kernels.chunk_gather import edges

    cases = edges.edge_cases(device)
    for case in cases:
        got, want = edges.run(case), edges.expected(case)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"gather edge case {case.name}: kernel disagrees with its plain version "
                 f"(tolerance 0)")
    paths = {c.vector for c in cases}
    if paths != {True, False}:
        fail(f"the gather edge grid took only the {'vector' if True in paths else 'scalar'} path")
    print(f"gather edge grid: {len(cases)} cases ({sum(c.vector for c in cases)} on the 16-byte "
          f"path, {sum(not c.vector for c in cases)} scalar) equal their plain versions")
    for case in cases:
        if case.inputs[0].shape[1] in (2056, 2176) and case.offset in (0, 1):
            check_replay(f"{case.name} ({'16-byte' if case.vector else 'scalar'} path)",
                         lambda c=case: torch.cat([t.view(torch.int32).flatten()
                                                   for t in edges.run(c)]))


def check_chunk_gather(device) -> None:
    """chunk_gather_train against its plain version (exact) over the parity
    grid and the trainer's shape (row_pad 8, as the stager packs), then
    both gathers' edge grid."""
    import torch

    from repro_torch.kernels import parity

    trainer_case = parity.KernelCase("chunk_gather_train", (8, 2048, 8), "int32")
    cases = [(c, 128) for c in parity.iter_cases("chunk_gather_train")] + [(trainer_case, 8)]
    for case, row_pad in cases:
        inputs = parity.make_inputs(case, device=device, row_pad=row_pad)
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        abs_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(max abs err {abs_err}, tolerance 0)")
        print(f"{case.name} row_pad {row_pad}: equal (max abs err {abs_err})")
    check_gather_edges(device)


def gather_row(name: str, times: dict) -> dict:
    """A gather's kernel-table row: its B = 8 timing from ``times``, its
    result there held to its plain version."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.chunk_gather import ops, ref

    t = times[name]
    inputs = t["inputs"]
    kw = {"seq_len": 2048} if name == "chunk_gather_train" else {}
    got = getattr(ops, name)(*inputs, **kw)
    want = getattr(ref, f"{name}_ref")(*inputs, **kw)
    abs_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    if abs_err != 0:
        fail(f"{name} at {t['shape']}: max abs err {abs_err}, tolerance 0")
    bound_ms, bound_by = bound(0, t["bytes"])
    spec = parity.KERNELS[name]
    row = {"name": name, "route": "cuda", "source": spec["source"],
           "replaces": spec["replaces"], "launches": None, "max_abs_err": abs_err,
           "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "runs_ms": t["runs_ms"],
           "floor_ms": times["floor_ms"], "host_ms": t["host_ms"],
           "plain_host_ms": t["plain_host_ms"], "bytes": t["bytes"]}
    if name == "chunk_gather_train":
        row["at_large_shape"] = times["large"]
    return row


def check_attention_grid(device) -> None:
    """Both attention kernels against their plain versions over the parity
    grid and edge cases: fully masked decode rows, lengths that are not a
    multiple of the tiles, windows whose first kv tile is fully masked,
    then :func:`check_flash_edges` and :func:`check_decode_edges`."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    extra = [parity.KernelCase("decode_attention", shape, dtype)
             for shape in ((2, 8, 2, 40, 64), (2, 4, 4, 96, 32), (3, 32, 4, 72, 64))
             for dtype in ("float32", "bfloat16")]
    for case in parity.iter_cases("flash_attention") + parity.iter_cases("decode_attention") \
            + extra:
        inputs = parity.make_inputs(case, device=device)
        if case.kernel == "decode_attention":
            inputs[3][0] = False  # batch row 0: no valid slot
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        tol = parity.KERNELS[case.kernel]["tols"][case.dtype]
        if not err <= tol or not torch.isfinite(got.float()).all():
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(scale-normalised err {err:.3e}, tolerance {tol})")
        if case.kernel == "decode_attention" and got[0].any():
            fail(f"{case.name}: a fully masked row is not zeros")
        print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tol})")
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        for s, causal, window in ((96, True, 16), (100, True, 0), (80, False, 24),
                                  (130, True, 1), (200, True, 70)):
            q, k, v = (torch.randn(2, s, 32, generator=gen, device=device)
                       .to(getattr(torch, dtype)) for _ in range(3))
            err = parity.max_err(flash_attention(q, k, v, causal=causal, window=window),
                                 attention_ref(q, k, v, causal=causal, window=window))
            tol = parity.KERNELS["flash_attention"]["tols"][dtype]
            if not err <= tol:
                fail(f"flash_attention S={s} causal={causal} window={window} {dtype}: "
                     f"err {err:.3e} > {tol}")
            print(f"flash_attention S={s} causal={causal} window={window} {dtype}: "
                  f"scale-normalised err {err:.3e} (tolerance {tol})")
    check_flash_edges(device)
    check_decode_edges(device)
    check_attention_groups(device)
    check_softcap(device)


#: Phase 3's softcap cases: flash (S, window, D, G) causal and decode (B,
#: KVH, S, D, G), at the serving head dims and query groups 1 and 7, with
#: a split and an unsplit decode cache and a ring mask that wraps.
SOFTCAP_FLASH = list(itertools.product((257, 640), (0, 129), ((64, 1), (128, 7))))
SOFTCAP_DECODE = [(b, kvh, s, d, g) for d, g in ((64, 1), (128, 7))
                  for b, kvh, s in ((2, 2, 1000), (16, 16, 300))]


def check_softcap(device) -> None:
    """Both attention kernels with ``softcap = SOFTCAP`` against their plain
    versions (SOFTCAP_FLASH, SOFTCAP_DECODE) in f32 and bf16 at the
    registry's tolerances, q and k drawn at scale 4 so that the scaled
    logits (standard deviation 16) reach the cap's bend; batch row 0 of
    each decode mask fully masked. Then :func:`check_replay` of a capped
    bf16 call of each (flash's work counters, decode's split merge)."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, _splits, decode_attention, query_group)
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    gen = torch.Generator(device=device).manual_seed(7)

    def draw(*shape, scale=1.0, dtype):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for s, window, (d, g) in SOFTCAP_FLASH:
            q, k = draw(2, s, 2 * g, d, scale=4, dtype=dt), draw(2, s, 2, d, scale=4, dtype=dt)
            v = draw(2, s, 2, d, dtype=dt)
            got = flash_attention_gqa(q, k, v, causal=True, window=window, softcap=SOFTCAP)
            want = attention_gqa_ref(q, k, v, causal=True, window=window, softcap=SOFTCAP)
            err = parity.max_err(got, want)
            tol = parity.KERNELS["flash_attention"]["tols"][dtype]
            uncapped = parity.max_err(attention_gqa_ref(q, k, v, causal=True, window=window),
                                      want)
            print(f"flash_attention_gqa softcap {SOFTCAP} S={s} window={window} D={d} G={g} "
                  f"{dtype}: scale-normalised err {err:.3e} (tolerance {tol}); the uncapped "
                  f"plain version reads {uncapped:.3e}")
            if not err <= tol or not torch.isfinite(got.float()).all() or not uncapped > tol:
                fail(f"flash_attention_gqa softcap S={s} window={window} D={d} G={g} {dtype}: "
                     f"err {err:.3e} > {tol}, or the cap changes nothing ({uncapped:.3e})")
            worst[("flash", dtype)] = max(worst.get(("flash", dtype), 0.0), err)
        for b, kvh, s, d, g in SOFTCAP_DECODE:
            splits = _splits(b * kvh * -(-g // query_group(g)), s, _sm_count(device.index or 0))
            q = draw(b, kvh * g, d, scale=4, dtype=dt)
            ck, cv = draw(b, s, kvh, d, scale=4, dtype=dt), draw(b, s, kvh, d, dtype=dt)
            mask = ring_mask(b, s, s - 37, s - 5, device)
            got = decode_attention(q, ck, cv, mask, softcap=SOFTCAP)
            want = decode_attention_plain(q, ck, cv, mask, softcap=SOFTCAP)
            err = parity.max_err(got, want)
            tol = parity.KERNELS["decode_attention"]["tols"][dtype]
            uncapped = parity.max_err(decode_attention_plain(q, ck, cv, mask), want)
            print(f"decode_attention softcap {SOFTCAP} (B, KVH, S, D)={(b, kvh, s, d)} G={g} "
                  f"{dtype}, {splits} splits: scale-normalised err {err:.3e} (tolerance {tol}); "
                  f"the uncapped plain version reads {uncapped:.3e}")
            if not err <= tol or not torch.isfinite(got.float()).all() or got[0].any() \
                    or not uncapped > tol:
                fail(f"decode_attention softcap {(b, kvh, s, d)} G={g} {dtype}: err {err:.3e} "
                     f"> {tol}, row 0 not zeros, or the cap changes nothing ({uncapped:.3e})")
            worst[("decode", dtype)] = max(worst.get(("decode", dtype), 0.0), err)
    print("softcap cases, worst scale-normalised err: " + ", ".join(
        f"{kernel} {dtype} {err:.3e}" for (kernel, dtype), err in worst.items()))
    q, k = draw(2, 1000, 8, 64, scale=4, dtype=torch.bfloat16), draw(2, 1000, 2, 64, scale=4,
                                                                      dtype=torch.bfloat16)
    v = draw(2, 1000, 2, 64, dtype=torch.bfloat16)
    check_replay("flash_attention_gqa softcap (work counters)",
                 lambda: flash_attention_gqa(q, k, v, causal=True, window=300,
                                             softcap=SOFTCAP))
    q = draw(8, 32, 64, scale=4, dtype=torch.bfloat16)
    ck, cv = draw(8, 2048, 4, 64, scale=4, dtype=torch.bfloat16), draw(8, 2048, 4, 64,
                                                                        dtype=torch.bfloat16)
    mask = ring_mask(8, 2048, 100, 2000, device)
    check_replay("decode_attention softcap (split merge)",
                 lambda: decode_attention(q, ck, cv, mask, softcap=SOFTCAP))


#: The query groups of phi3-medium-14b (40/10 heads, G = 4) and
#: llava-next-34b (56/8, G = 7) at head dim 128: flash (B, S, H, KVH) causal,
#: and decode (B, H, KVH, S) against llava's full ring of 320 slots and a
#: 1024-slot cache whose mask wraps.
GROUP_FLASH = ((2, 640, 56, 8), (2, 640, 40, 10))
GROUP_DECODE = ((3, 56, 8, 320), (3, 40, 10, 1024))


def check_attention_groups(device) -> None:
    """Both attention kernels against their plain versions at G = 7 and G =
    4, D = 128, bf16 and f32 (GROUP_FLASH, GROUP_DECODE). Decode pads G = 7
    to a query group of 8; batch row 0 of its mask is fully masked."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import decode_attention, query_group
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    gen = torch.Generator(device=device).manual_seed(6)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for b, s, h, kvh in GROUP_FLASH:
            q = torch.randn(b, s, h, 128, generator=gen, device=device).to(dt)
            k, v = (torch.randn(b, s, kvh, 128, generator=gen, device=device).to(dt)
                    for _ in range(2))
            got = flash_attention_gqa(q, k, v, causal=True)
            err = parity.max_err(got, attention_gqa_ref(q, k, v, causal=True))
            tol = parity.KERNELS["flash_attention"]["tols"][dtype]
            print(f"flash_attention_gqa (B, S, H/KVH, D)=({b}, {s}, {h}/{kvh}, 128) G={h // kvh} "
                  f"{dtype} causal: scale-normalised err {err:.3e} (tolerance {tol})")
            if not err <= tol or not torch.isfinite(got.float()).all():
                fail(f"flash_attention_gqa at G={h // kvh}, D=128, {dtype}: err {err:.3e} > {tol}")
        for b, h, kvh, s in GROUP_DECODE:
            q = torch.randn(b, h, 128, generator=gen, device=device).to(dt)
            ck, cv = (torch.randn(b, s, kvh, 128, generator=gen, device=device).to(dt)
                      for _ in range(2))
            mask = ring_mask(b, s, s - 37, s if s == 320 else s - 5, device)
            got = decode_attention(q, ck, cv, mask)
            err = parity.max_err(got, decode_attention_plain(q, ck, cv, mask))
            tol = parity.KERNELS["decode_attention"]["tols"][dtype]
            print(f"decode_attention (B, H/KVH, S, D)=({b}, {h}/{kvh}, {s}, 128) G={h // kvh} "
                  f"(query group {query_group(h // kvh)}) {dtype}: scale-normalised err "
                  f"{err:.3e} (tolerance {tol}); fully masked row zeros")
            if not err <= tol or not torch.isfinite(got.float()).all() or got[0].any():
                fail(f"decode_attention at G={h // kvh}, D=128, {dtype}: err {err:.3e} > {tol} "
                     f"or row 0 not zeros")


#: Flash edge cases at the 128-row tiles' edges: (S, window, causal, (D, G)).
#: Windows of 127-129 leave some rows' first kv tile fully masked.
FLASH_EDGES = list(itertools.product((1, 127, 128, 129, 255, 257), (0, 127, 128, 129),
                                     (True, False), ((32, 1), (64, 4), (128, 8))))


def check_flash_edges(device) -> None:
    """flash_attention_gqa (B=2, 2 kv heads) against its plain version at
    the tile edges: every case of FLASH_EDGES in bf16, and those at D = 64
    with window 0 or 128 in f32; then :func:`check_replay` of a bf16 call
    (its work counters reset)."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    gen = torch.Generator(device=device).manual_seed(4)
    tols = parity.KERNELS["flash_attention"]["tols"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(*c, "bfloat16") for c in FLASH_EDGES] + [
        (*c, "float32") for c in FLASH_EDGES if c[1] in (0, 128) and c[3][0] == 64]
    for s, window, causal, (d, g), dtype in cases:
        q = torch.randn(2, s, 2 * g, d, generator=gen, device=device).to(getattr(torch, dtype))
        k, v = (torch.randn(2, s, 2, d, generator=gen, device=device).to(q.dtype)
                for _ in range(2))
        got = flash_attention_gqa(q, k, v, causal=causal, window=window)
        err = parity.max_err(got, attention_gqa_ref(q, k, v, causal=causal, window=window))
        if not err <= tols[dtype] or not torch.isfinite(got.float()).all():
            fail(f"flash_attention_gqa S={s} window={window} causal={causal} D={d} G={g} "
                 f"{dtype}: scale-normalised err {err:.3e} > {tols[dtype]}")
        worst[dtype] = max(worst[dtype], err)
    q = torch.randn(2, 1000, 8, 64, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(2, 1000, 2, 64, generator=gen, device=device).bfloat16()
            for _ in range(2))
    check_replay("flash_attention_gqa (persistent blocks, work counters)",
                 lambda: flash_attention_gqa(q, k, v, causal=True, window=300))
    print(f"flash_attention_gqa at the tile edges: {len(cases)} cases (S 1-257, windows "
          f"0/127/128/129, causal and not, D 32/64/128, G 1/4/8); worst scale-normalised "
          f"err f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} (tolerance "
          f"{tols['float32']} / {tols['bfloat16']})")


def ring_mask(b: int, s: int, start: int, count: int, device):
    """(B, S) validity of ``count`` ring slots from ``start``, wrapping
    past S; batch row 0 fully masked."""
    import torch

    slots = (torch.arange(s, device=device) - start) % s
    mask = (slots < count)[None, :].expand(b, s).contiguous()
    mask[0] = False
    return mask


def check_decode_edges(device) -> None:
    """decode_attention against its plain version at G = 1, 2, 4, 8, 16: a
    shape whose cache is split (few blocks, 1000 slots) and one that is
    not (256 blocks), S not a multiple of any tile, a ring mask that wraps,
    batch row 0 fully masked; then :func:`check_decode_replay`."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import (
        _sm_count, _splits, decode_attention, query_group)
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain

    gen = torch.Generator(device=device).manual_seed(5)
    tols = parity.KERNELS["decode_attention"]["tols"]
    for i, g in enumerate((1, 2, 4, 8, 16)):
        d = (32, 64, 128)[i % 3]
        for b, kvh, s in ((2, 2, 1000), (16, 16, 300)):  # split, and not
            blocks = b * kvh * -(-g // query_group(g))
            splits = _splits(blocks, s, _sm_count(device.index or 0))
            for dtype in ("float32", "bfloat16"):
                q = torch.randn(b, kvh * g, d, generator=gen, device=device).to(
                    getattr(torch, dtype))
                ck, cv = (torch.randn(b, s, kvh, d, generator=gen, device=device).to(q.dtype)
                          for _ in range(2))
                mask = ring_mask(b, s, s - 37, s - 5, device)
                got = decode_attention(q, ck, cv, mask)
                err = parity.max_err(got, decode_attention_plain(q, ck, cv, mask))
                if not err <= tols[dtype] or not torch.isfinite(got.float()).all() \
                        or got[0].any():
                    fail(f"decode_attention G={g} {(b, kvh, s, d)} {dtype}, {splits} splits: "
                         f"scale-normalised err {err:.3e} (tolerance {tols[dtype]}) or row 0 "
                         f"not zeros")
                print(f"decode_attention G={g} (B, KVH, S, D)={(b, kvh, s, d)} {dtype}, "
                      f"{splits} splits: scale-normalised err {err:.3e} (tolerance "
                      f"{tols[dtype]}); fully masked row zeros")
    check_decode_replay(device)


def check_replay(name: str, fn) -> None:
    """``fn()`` run twice in a row, then captured in a CUDA graph replayed
    three times: every result must equal the first bit for bit (a kernel's
    self-resetting counters are back at 0 after each launch)."""
    import torch

    first = fn()
    runs = [fn()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        graph.replay()
        runs.append(out.clone())
    torch.cuda.synchronize()
    if not all(torch.equal(r, first) for r in runs):
        fail(f"{name} differs between calls or graph replays (counters not reset?)")
    print(f"{name}: a second call and 3 graph replays equal the first call bit for bit")
    del graph


def check_decode_replay(device) -> None:
    """:func:`check_replay` of decode_attention at a shape whose splits
    merge through the ticket counters."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import _sm_count, _splits, decode_attention

    case = parity.KernelCase("decode_attention", (8, 32, 4, 2048, 64), "bfloat16")
    q, ck, cv, _ = parity.make_inputs(case, device=device)
    mask = ring_mask(8, 2048, 100, 2000, device)
    splits = _splits(8 * 4, 2048, _sm_count(device.index or 0))
    if splits < 2:
        fail(f"the replay check needs a split shape, got {splits} split")
    check_replay(f"decode_attention with {splits} splits",
                 lambda: decode_attention(q, ck, cv, mask))


def check_flash_main(device) -> dict:
    """flash_attention at the prefill's shapes: parity as a (BH, S, D) call,
    timing as the GQA call the model makes, at tinyllama's prefill (the
    row's numbers), at zamba2's (``at_hybrid_shape``), at
    deepseek-moe-16b's, 16/16 heads of 128 (``at_moe_shape``), and at
    llava-next-34b's, 2304 patches and 256 tokens over 56/8 heads of 128
    (``at_vlm_shape``)."""
    from repro_torch.kernels import parity

    case = parity.KernelCase("flash_attention", (256, 1920, 64, True), "bfloat16")
    inputs = parity.make_inputs(case, device=device)
    err = parity.max_err(parity.run_kernel(case, inputs), parity.run_ref(case, inputs))
    tol = parity.KERNELS["flash_attention"]["tols"]["bfloat16"]
    if not err <= tol:
        fail(f"{case.name}: err {err:.3e} > {tol}")
    print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tol})")
    del inputs
    row = flash_timing(device, 8, 1920, 32, 4, calls=5)
    hybrid = flash_timing(device, 8, 3584, 32, 32, calls=1)
    moe = flash_timing(device, 8, 1920, 16, 16, d=128, calls=5)
    vlm = flash_timing(device, 4, 2560, 56, 8, d=128, calls=2)
    capped = {"at_main_shape": flash_timing(device, 8, 1920, 32, 4, calls=5, softcap=SOFTCAP),
              "at_moe_shape": flash_timing(device, 8, 1920, 16, 16, d=128, calls=5,
                                           softcap=SOFTCAP)}
    spec = parity.KERNELS["flash_attention"]
    return {"name": "flash_attention", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, **row, "at_hybrid_shape": hybrid,
            "at_moe_shape": moe, "at_vlm_shape": vlm, "softcap": capped}


def flash_timing(device, b: int, s: int, h: int, kvh: int, *, d: int = 64, calls: int,
                 softcap: float = 0.0) -> dict:
    """flash_attention_gqa on causal (B, S, H, D) x (B, S, KVH, D) bf16,
    logits capped at ``softcap`` when it is > 0: parity with its plain
    version, and kernel / plain / library time (the library call has no
    cap: it is timed for the uncapped call only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref

    tol = parity.KERNELS["flash_attention"]["tols"]["bfloat16"]
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(b, s, h, d, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=gen, device=device).bfloat16()
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    got = flash_attention_gqa(q, k, v, softcap=softcap)
    want = attention_gqa_ref(q, k, v, softcap=softcap)
    err = parity.max_err(got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        fail(f"flash_attention_gqa at {(b, s, h, kvh, d)} softcap {softcap}: err {err:.3e} "
             f"> {tol}")
    del got, want
    torch.cuda.empty_cache()
    library = None if softcap else (
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))
    t = turns(lambda: flash_attention_gqa(q, k, v, causal=True, softcap=softcap),
              lambda: attention_gqa_ref(q, k, v, causal=True, softcap=softcap), library,
              calls=calls, reps=5)
    flops = 4 * d * (s * (s + 1) // 2) * b * h  # unmasked causal pairs, QK^T and PV
    moved = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v read; out written
    bound_ms, bound_by = bound(flops, moved)
    library_ms = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    print(f"flash_attention_gqa q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal, softcap "
          f"{softcap}: device time per call (CUDA graph of {calls} calls): kernel "
          f"{t['runs_ms'][0]:.4f} / {t['runs_ms'][1]:.4f} ms, plain {t['plain_runs_ms'][0]:.4f} / "
          f"{t['plain_runs_ms'][1]:.4f} ms, library (scaled_dot_product_attention) "
          f"{library_ms}; bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP "
          f"at 989 TFLOP/s, {moved} bytes at 3.35 TB/s); scale-normalised err {err:.3e}, "
          f"max abs err {abs_err:.4g}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"max_abs_err": abs_err, "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library_ms"],
            "flops": flops, "bytes": moved}


#: The training kernels' rows: the benchmark cells' attention shapes (B, S,
#: H, KVH, D, causal, window) and the plain version's batch (B = 1 where
#: the f32 (B, H, S, S) arrays of the full batch would not fit beside the
#: rest; its time is then scaled by B).
FLASH_TRAIN_SHAPES = {
    "hubert-xlarge.frames2k": ((8, 2048, 16, 16, 80, False, 0), 8),
    "hubert-xlarge.frames512": ((32, 512, 16, 16, 80, False, 0), 32),
    "zamba2-1.2b.tokens2k": ((2, 2048, 32, 32, 64, True, 4096), 2),
    "nemotron-3-nano-30b-a3b.tokens4k": ((4, 4096, 32, 2, 128, True, 0), 1),
}


#: The training route against the plain version in f32 under autograd:
#: scale-normalised max error of the output and of dq, dk, dv (the card
#: tests' bound: the kernels round P and dS to bf16 before their
#: products), and the largest gap of the f32 log-sum-exp.
FLASH_TRAIN_TOL = 2e-2
FLASH_LSE_TOL = 1e-4


def check_flash_train(device) -> dict:
    """The training kernels at the cells' shapes. First the route itself:
    ``flash_attention_gqa`` on bf16 tensors that require grad (its
    ``_FlashTrain`` forward with the log-sum-exp and its backward), on the
    first ``b_plain`` rows against ``attention_gqa_ref`` in f32 under
    autograd: out, dq, dk and dv within FLASH_TRAIN_TOL scale-normalised,
    and the forward's log-sum-exp within FLASH_LSE_TOL of the f32 masked
    logits'; a mismatch fails. Then the same launches' device time a call
    in a CUDA graph (the forward with its log-sum-exp; the backward:
    pre-pass, main kernel, dQ conversion, GQA reduction), against the bound
    (4 B H D P and 10 B H D P FLOP at 989 TFLOP/s, P the kept pairs, D the
    true head dim), the plain version (``attention_gqa_ref`` in bf16, the
    forward and its autograd backward) and ``scaled_dot_product_attention``
    forward and backward (a yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (_launch, _launch_bwd,
                                                         attention_flops, flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import attention_gqa_ref
    from repro_torch.kernels.parity import max_err

    rows = {}
    for cell, ((b, s, h, kvh, d, causal, window), b_plain) in FLASH_TRAIN_SHAPES.items():
        gen = torch.Generator(device=device).manual_seed(2)
        q = torch.randn(b, s, h, d, generator=gen, device=device).bfloat16()
        k, v = (torch.randn(b, s, kvh, d, generator=gen, device=device).bfloat16()
                for _ in range(2))
        g = torch.randn(b, s, h, d, generator=gen, device=device).bfloat16()

        got = [x.clone().requires_grad_() for x in (q, k, v)]
        flash_out = flash_attention_gqa(*got, causal=causal, window=window)
        flash_out.backward(g)
        want = [x[:b_plain].float().requires_grad_() for x in (q, k, v)]
        ref_out = attention_gqa_ref(*want, causal=causal, window=window)
        ref_out.backward(g[:b_plain].float())
        errs = {name: max_err(a[:b_plain], r) for name, a, r in
                zip(("out", "dq", "dk", "dv"), [flash_out] + [x.grad for x in got],
                    [ref_out] + [x.grad for x in want])}
        del got, want, flash_out, ref_out
        out, lse = _launch(q, k, v, causal, window, 0.0, lse=True)
        with torch.no_grad():
            kk = torch.repeat_interleave(k[:b_plain].float(), h // kvh, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q[:b_plain].float(), kk) * d**-0.5
            qpos = torch.arange(s, device=device)[:, None]
            kpos = torch.arange(s, device=device)[None, :]
            keep = torch.ones((s, s), dtype=torch.bool, device=device)
            if causal:
                keep &= kpos <= qpos
            if window:
                keep &= kpos > qpos - window
            lse_want = torch.logsumexp(logits.masked_fill_(~keep, -torch.inf), dim=-1)
            errs["lse"] = float((lse[:b_plain] - lse_want).abs().max())
            del kk, logits, lse_want
        torch.cuda.empty_cache()
        if not all(e <= FLASH_TRAIN_TOL for n, e in errs.items() if n != "lse") or \
                not errs["lse"] <= FLASH_LSE_TOL:
            fail(f"flash training at {cell}: errors {errs} against the f32 plain version "
                 f"(limits {FLASH_TRAIN_TOL}, log-sum-exp {FLASH_LSE_TOL})")

        fwd = [graph_ms(lambda: _launch(q, k, v, causal, window, 0.0, lse=True), calls=5,
                        reps=5) for _ in range(2)]
        bwd = [graph_ms(lambda: _launch_bwd(q, k, v, out, lse, g, causal, window, 0.0),
                        calls=3, reps=5) for _ in range(2)]
        pq, pk, pv, pg = (x[:b_plain].clone().requires_grad_(x is not g) for x in (q, k, v, g))

        def plain():
            o = attention_gqa_ref(pq, pk, pv, causal=causal, window=window)
            return torch.autograd.grad(o, (pq, pk, pv), pg)

        plain_ms = graph_ms(plain, calls=1, reps=3) * b / b_plain
        del pq, pk, pv, pg
        torch.cuda.empty_cache()
        lq, lk, lv = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        lg = g.transpose(1, 2).contiguous()

        def library():
            o = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal, enable_gqa=True)
            return torch.autograd.grad(o, (lq, lk, lv), lg)

        library_ms = graph_ms(library, calls=3, reps=5)
        ff = attention_flops((b, s, h, d), causal, window)
        fb = attention_flops((b, s, h, d), causal, window, backward=True)
        row = {"shape": [b, s, h, kvh, d, causal, window], "fwd_ms": statistics.median(fwd),
               "bwd_ms": statistics.median(bwd), "fwd_runs_ms": fwd, "bwd_runs_ms": bwd,
               "fwd_bound_ms": ff / BF16_FLOP_PER_S * 1e3,
               "bwd_bound_ms": fb / BF16_FLOP_PER_S * 1e3, "plain_fwd_bwd_ms": plain_ms,
               "plain_batch": b_plain, "library_fwd_bwd_ms": library_ms, "errors": errs}
        row["fwd_roofline"] = 100 * row["fwd_bound_ms"] / row["fwd_ms"]
        row["bwd_roofline"] = 100 * row["bwd_bound_ms"] / row["bwd_ms"]
        print(f"flash training at {cell} (B, S, H/KVH, D) = ({b}, {s}, {h}/{kvh}, {d}) "
              f"causal {causal} window {window}: forward with lse {fwd[0]:.4f} / {fwd[1]:.4f} ms "
              f"(bound {row['fwd_bound_ms']:.4f}, {row['fwd_roofline']:.1f}%), backward "
              f"{bwd[0]:.4f} / {bwd[1]:.4f} ms (bound {row['bwd_bound_ms']:.4f}, "
              f"{row['bwd_roofline']:.1f}%); plain forward + backward {plain_ms:.3f} ms"
              f"{'' if b_plain == b else f' (B = {b_plain}, times {b // b_plain})'}; "
              f"library (scaled_dot_product_attention) forward + backward {library_ms:.4f} ms; "
              f"against the f32 plain version (B = {b_plain}): out {errs['out']:.3e}, dq "
              f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} (limit "
              f"{FLASH_TRAIN_TOL}), log-sum-exp {errs['lse']:.2e} (limit {FLASH_LSE_TOL})",
              flush=True)
        rows[cell] = row
        del q, k, v, g, out, lse, lq, lk, lv, lg
        torch.cuda.empty_cache()
    return rows


#: Multi-head latent attention's core at kimi-k2-instruct.tokens4k's shape:
#: (B, S, H, causal), q and k 192 wide, v 128, the softmax at YaRN's scale;
#: the plain version's batch (B = 1: the f32 (1, 64, S, S) arrays of its
#: autograd are 13 GB; its time is then scaled by B).
FLASH_MLA_SHAPE = ((4, 4096, 64, True), 1)
MLA_SCALE = 192**-0.5 * (0.1 * math.log(32) + 1) ** 2


def check_flash_mla(device) -> dict:
    """The MLA training kernels (``flash_attention_mla`` on bf16 tensors
    that require grad: the (192, 128) forward with its log-sum-exp and the
    backward) at the cell's shape: out, dq, dk and dv on the first
    ``b_plain`` rows against the plain version in f32 under autograd within
    FLASH_TRAIN_TOL, the log-sum-exp within FLASH_LSE_TOL (a mismatch
    fails); then the launches' device time a call in a CUDA graph against
    the bound (``attention_flops`` at 989 TFLOP/s), the plain version (bf16,
    forward and autograd backward) and ``scaled_dot_product_attention``
    forward and backward where it takes values of another width (a
    yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (_launch, _launch_bwd, attention_flops,
                                                         flash_attention_mla)
    from repro_torch.kernels.parity import max_err

    (b, s, h, causal), b_plain = FLASH_MLA_SHAPE
    gen = torch.Generator(device=device).manual_seed(3)
    q, k = (torch.randn(b, s, h, 192, generator=gen, device=device).bfloat16() for _ in range(2))
    v = torch.randn(b, s, h, 128, generator=gen, device=device).bfloat16()
    g = torch.randn(b, s, h, 128, generator=gen, device=device).bfloat16()
    got = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_mla(*got, scale=MLA_SCALE, causal=causal)
    out.backward(g)
    want = [x[:b_plain].float().requires_grad_() for x in (q, k, v)]
    logits = torch.einsum("bqhd,bkhd->bhqk", want[0], want[1]) * MLA_SCALE
    keep = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    probs = torch.softmax(logits.masked_fill(~keep, -torch.inf), dim=-1)
    ref = torch.einsum("bhqk,bkhd->bqhd", probs, want[2])
    ref.backward(g[:b_plain].float())
    errs = {name: max_err(a[:b_plain], r) for name, a, r in
            zip(("out", "dq", "dk", "dv"), [out] + [x.grad for x in got],
                [ref] + [x.grad for x in want])}
    with torch.no_grad():
        lse_want = torch.logsumexp(logits.masked_fill(~keep, -torch.inf), dim=-1)
    del got, want, out, ref, probs, logits
    torch.cuda.empty_cache()
    o, lse = _launch(q, k, v, causal, 0, 0.0, lse=True, scale=MLA_SCALE)
    errs["lse"] = float((lse[:b_plain] - lse_want).abs().max())
    del lse_want
    torch.cuda.empty_cache()
    if not all(e <= FLASH_TRAIN_TOL for n, e in errs.items() if n != "lse") or \
            not errs["lse"] <= FLASH_LSE_TOL:
        fail(f"flash MLA training at {(b, s, h)}: errors {errs} against the f32 plain version "
             f"(limits {FLASH_TRAIN_TOL}, log-sum-exp {FLASH_LSE_TOL})")

    fwd = [graph_ms(lambda: _launch(q, k, v, causal, 0, 0.0, lse=True, scale=MLA_SCALE),
                    calls=3, reps=5) for _ in range(2)]
    bwd = [graph_ms(lambda: _launch_bwd(q, k, v, o, lse, g, causal, 0, 0.0, MLA_SCALE), calls=2,
                    reps=5) for _ in range(2)]
    pq, pk, pv, pg = (x[:b_plain].clone().requires_grad_(x is not g) for x in (q, k, v, g))

    def plain():
        lg = torch.einsum("bqhd,bkhd->bhqk", pq, pk).float() * MLA_SCALE
        p = torch.softmax(lg.masked_fill(~keep, -torch.inf), dim=-1).to(pv.dtype)
        return torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", p, pv), (pq, pk, pv), pg)

    plain_ms = graph_ms(plain, calls=1, reps=3) * b / b_plain
    del pq, pk, pv, pg
    torch.cuda.empty_cache()
    lq, lk, lv = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lg = g.transpose(1, 2).contiguous()

    def library():
        y = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal, scale=MLA_SCALE)
        return torch.autograd.grad(y, (lq, lk, lv), lg)

    try:
        library_ms = graph_ms(library, calls=2, reps=5)
    except RuntimeError as exc:  # no backend takes values of another width
        print(f"scaled_dot_product_attention at q/k 192, v 128: {str(exc).splitlines()[0]}")
        library_ms = None
    ff = attention_flops((b, s, h, 192), causal, 0, dv=128)
    fb = attention_flops((b, s, h, 192), causal, 0, dv=128, backward=True)
    row = {"shape": [b, s, h, 192, 128, causal], "fwd_ms": statistics.median(fwd),
           "bwd_ms": statistics.median(bwd), "fwd_runs_ms": fwd, "bwd_runs_ms": bwd,
           "fwd_bound_ms": ff / BF16_FLOP_PER_S * 1e3, "bwd_bound_ms": fb / BF16_FLOP_PER_S * 1e3,
           "plain_fwd_bwd_ms": plain_ms, "plain_batch": b_plain,
           "library_fwd_bwd_ms": library_ms, "errors": errs}
    row["fwd_roofline"] = 100 * row["fwd_bound_ms"] / row["fwd_ms"]
    row["bwd_roofline"] = 100 * row["bwd_bound_ms"] / row["bwd_ms"]
    library_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"flash MLA training at kimi-k2-instruct.tokens4k (B, S, H) = ({b}, {s}, {h}), q/k 192, "
          f"v 128, causal {causal}: forward with lse {fwd[0]:.4f} / {fwd[1]:.4f} ms (bound "
          f"{row['fwd_bound_ms']:.4f}, {row['fwd_roofline']:.1f}%), backward {bwd[0]:.4f} / "
          f"{bwd[1]:.4f} ms (bound {row['bwd_bound_ms']:.4f}, {row['bwd_roofline']:.1f}%); plain "
          f"forward + backward {plain_ms:.3f} ms (B = {b_plain}, times {b // b_plain}); library "
          f"(scaled_dot_product_attention) forward + backward {library_txt}; against the f32 "
          f"plain version (B = {b_plain}): out {errs['out']:.3e}, dq {errs['dq']:.3e}, dk "
          f"{errs['dk']:.3e}, dv {errs['dv']:.3e} (limit {FLASH_TRAIN_TOL}), log-sum-exp "
          f"{errs['lse']:.2e} (limit {FLASH_LSE_TOL})", flush=True)
    del q, k, v, g, o, lse, lq, lk, lv, lg
    torch.cuda.empty_cache()
    return row


def check_decode_main(device) -> dict:
    """decode_attention at the decode's shapes with the real ring mask of
    the last decode step: tinyllama's (cache position 2046 of 2048 slots;
    the row's numbers), zamba2's (4094 of 4096, G = 1;
    ``at_hybrid_shape``), deepseek-moe-16b's (2046 of 2048, G = 1, D =
    128; ``at_moe_shape``) and llava-next-34b's (position 2622 in a ring of
    320 slots, every slot valid, G = 7, D = 128; ``at_vlm_shape``), this
    last beside the launch floor."""
    from repro_torch.kernels import parity

    row = decode_timing(device, 8, 32, 4, 2048)
    hybrid = decode_timing(device, 8, 32, 32, 4096)
    moe = decode_timing(device, 8, 16, 16, 2048, d=128)
    vlm = decode_timing(device, 4, 56, 8, 320, d=128, pos=2622)
    vlm["floor_ms"] = launch_floor()
    print(f"decode_attention at llava's shape beside the launch floor (a one-element fill_): "
          f"{vlm['ms'] * 1e3:.2f} us against {vlm['floor_ms'] * 1e3:.3f} us")
    capped = {"at_main_shape": decode_timing(device, 8, 32, 4, 2048, softcap=SOFTCAP),
              "at_moe_shape": decode_timing(device, 8, 16, 16, 2048, d=128, softcap=SOFTCAP)}
    spec = parity.KERNELS["decode_attention"]
    return {"name": "decode_attention", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, **row, "at_hybrid_shape": hybrid,
            "at_moe_shape": moe, "at_vlm_shape": vlm, "softcap": capped}


def decode_timing(device, b: int, h: int, kvh: int, s: int, *, d: int = 64,
                  pos: int | None = None, softcap: float = 0.0) -> dict:
    """decode_attention on a (B, S, KVH, D) bf16 cache at position ``pos``
    (S - 2 unless given; past S the ring is full), scores capped at
    ``softcap`` when it is > 0: parity with its plain version, and kernel /
    plain / library time (the library call for the uncapped call only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_plain
    from repro_torch.models.attention import slot_validity

    case = parity.KernelCase("decode_attention", (b, h, kvh, s, d), "bfloat16")
    q, ck, cv, _ = parity.make_inputs(case, device=device)
    pos = s - 2 if pos is None else pos
    mask = slot_validity(pos, s, 0, device)[None, :].expand(b, s).contiguous()
    got = decode_attention(q, ck, cv, mask, softcap=softcap)
    want = decode_attention_plain(q, ck, cv, mask, softcap=softcap)
    err = parity.max_err(got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    tol = parity.KERNELS["decode_attention"]["tols"]["bfloat16"]
    if not err <= tol:
        fail(f"decode_attention at {(b, h, kvh, s, d)}: err {err:.3e} > {tol}")
    qt = q[:, :, None, :]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (ck, cv))
    amask = mask[:, None, None, :]
    library = None if softcap else (
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=True))
    t = turns(lambda: decode_attention(q, ck, cv, mask, softcap=softcap),
              lambda: decode_attention_plain(q, ck, cv, mask, softcap=softcap), library)
    valid = int(mask.sum())  # (batch, slot) pairs whose K and V must be read
    moved = 2 * q.numel() * 2 + mask.numel() + 2 * valid * kvh * d * 2
    flops = 4 * d * valid * h
    bound_ms, bound_by = bound(flops, moved)
    library_us = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
    print(f"decode_attention q {tuple(q.shape)} cache {tuple(ck.shape)} bf16, "
          f"{valid // b} valid slots, softcap {softcap}: device time per call (CUDA graph of 50 "
          f"calls): kernel {t['runs_ms'][0] * 1e3:.2f} / {t['runs_ms'][1] * 1e3:.2f} us, plain "
          f"{t['plain_runs_ms'][0] * 1e3:.2f} / {t['plain_runs_ms'][1] * 1e3:.2f} us, "
          f"library (scaled_dot_product_attention) {library_us}; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}: {moved} bytes at 3.35 TB/s); "
          f"scale-normalised err {err:.3e}, max abs err {abs_err:.4g}")
    return {"max_abs_err": abs_err, "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library_ms"],
            "bytes": moved}


def check_chunk_gather_raw(device) -> None:
    """The raw chunk_gather against its plain version (exact) over its
    grid and a training-sized shape (B = 8 rows of L = 2176, a slot row of
    the trainer's S = 2048 padded to 128)."""
    import torch

    from repro_torch.kernels import parity

    main_case = parity.KernelCase("chunk_gather", (8, 2176, 8), "int32")
    for case in parity.iter_cases("chunk_gather") + [main_case]:
        inputs = parity.make_inputs(case, device=device)
        got, want = parity.run_kernel(case, inputs), parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{case.name}: kernel disagrees with its plain version (tolerance 0)")
        print(f"{case.name}: equal")


def check_ssd_grid(device) -> None:
    """ssd_scan against its plain version over the parity grid and edge
    cases: a chunk that does not divide the kernel's 64-step tile, a chunk
    of 1, S not a multiple of the tile, a state that decays below 1e-30
    within a step, the model-layout entry with an initial state, the
    head-group edges (:func:`check_ssd_heads_edges`) and a replay check."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref, ssd_scan_ref

    tols = parity.KERNELS["ssd_scan"]["tols"]
    extra = [parity.KernelCase("ssd_scan", shape, dtype)
             for shape in ((3, 100, 64, 64, 24), (2, 70, 32, 16, 1), (2, 200, 48, 40, 200))
             for dtype in ("float32", "bfloat16")]
    for case in parity.iter_cases("ssd_scan") + extra:
        inputs = parity.make_inputs(case, device=device)
        got = parity.run_kernel(case, inputs)
        want = parity.run_ref(case, inputs)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        if not err <= tols[case.dtype] or not torch.isfinite(got.float()).all():
            fail(f"{case.name}: kernel disagrees with its plain version "
                 f"(scale-normalised err {err:.3e}, tolerance {tols[case.dtype]})")
        print(f"{case.name}: scale-normalised err {err:.3e} (tolerance {tols[case.dtype]})")
    gen = torch.Generator(device=device).manual_seed(2)
    x, b, c = (torch.randn(2, 150, n, generator=gen, device=device) for n in (32, 16, 16))
    dt = torch.full((2, 150), 5.0, device=device)
    a = torch.full((2, 1), -20.0, device=device)  # exp(a dt) = 3.7e-44 per step
    got = ssd_scan(x, dt, a, b, c, chunk=64)
    err = parity.max_err(got, ssd_scan_ref(x, dt, a, b, c))
    if not err <= tols["float32"] or not torch.isfinite(got).all():
        fail(f"ssd_scan with a state decaying below 1e-30: err {err:.3e}")
    print(f"ssd_scan, state decaying by 3.7e-44 a step: scale-normalised err {err:.3e}")
    # The same in bf16 through the model layout (f32 out): denormal lo terms.
    args = (x.bfloat16()[:, :, None], dt[:, :, None], a[0], b.bfloat16(), c.bfloat16())
    got = ssd_scan_heads(*args)
    err = parity.max_err(got, ssd_scan_heads_ref(*args))
    if not err <= tols["float32"] or not all(torch.isfinite(t).all() for t in got):
        fail(f"ssd_scan_heads bf16 with a state decaying below 1e-30: err {err:.3e}")
    print(f"ssd_scan_heads bf16, state decaying by 3.7e-44 a step: scale-normalised err "
          f"{err:.3e} (tolerance {tols['float32']})")
    xh = torch.randn(2, 90, 3, 64, generator=gen, device=device)
    dth = torch.rand(2, 90, 3, generator=gen, device=device) * 0.5 + 0.01
    ah = -torch.rand(3, generator=gen, device=device) * 2 - 0.1
    bh, ch = (torch.randn(2, 90, 64, generator=gen, device=device) for _ in range(2))
    s0 = torch.randn(2, 3, 64, 64, generator=gen, device=device)
    got = ssd_scan_heads(xh, dth, ah, bh, ch, s0)
    err = parity.max_err(got, ssd_scan_heads_ref(xh, dth, ah, bh, ch, s0))
    if not err <= tols["float32"] or not all(torch.isfinite(t).all() for t in got):
        fail(f"ssd_scan_heads with an initial state: err {err:.3e}")
    print(f"ssd_scan_heads with an initial state (y and final state): "
          f"scale-normalised err {err:.3e} (tolerance {tols['float32']})")
    check_ssd_heads_edges(device)
    args = ssd_heads_inputs(device, 2, 257, 65, 64, 64, init=True, strided=True,
                            dtype=torch.bfloat16, seed=5)
    check_replay("ssd_scan_heads bf16 (2, 257, 65, 64) with 64 states",
                 lambda: torch.cat([t.flatten() for t in ssd_scan_heads(*args)]))


def ssd_heads_inputs(device, b: int, s: int, h: int, p: int, n: int, *, init: bool,
                     strided: bool, dtype, seed: int) -> tuple:
    """Model-layout inputs: x, B and C contiguous, or column slices of one
    conv output (b, s, h p + 2 n) as the model hands them over; dt from
    [0.01, 0.51), A from [-2.1, -0.1); with ``init`` an f32 initial state."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        xbc = torch.randn(b, s, h * p + 2 * n, generator=gen, device=device).to(dtype)
        xh = xbc[..., : h * p].reshape(b, s, h, p)
        bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    else:
        xh = torch.randn(b, s, h, p, generator=gen, device=device).to(dtype)
        bm, cm = (torch.randn(b, s, n, generator=gen, device=device).to(dtype)
                  for _ in range(2))
    dt = torch.rand(b, s, h, generator=gen, device=device) * 0.5 + 0.01
    a = -torch.rand(h, generator=gen, device=device) * 2 - 0.1
    s0 = torch.randn(b, h, p, n, generator=gen, device=device) if init else None
    return xh, dt, a, bm, cm, s0


def check_ssd_heads_edges(device) -> None:
    """ssd_scan_heads against its plain version where the bf16 kernel's
    head groups, tiles and copies have edges: H of 1, G - 1, G, G + 1 and
    65 (G heads a block; heads past H masked), S of 1, 63, 64, 65 and 257
    (tiles of 64), (P, N) of (20, 12), (48, 40), (64, 64) and (18, 10)
    (zero padding to 64; (18, 10) gives 4-byte copies), with and without an
    initial state, contiguous and strided; bf16 and f32 inputs alike, at
    the registry's f32 tolerance (bf16 inputs are exact in f32). A bf16
    view with an odd element offset must raise."""
    import torch

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import copy_width, heads_per_block, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref

    tol = parity.KERNELS["ssd_scan"]["tols"]["float32"]
    group = heads_per_block()
    heads = sorted({hh for hh in (1, group - 1, group, group + 1, 65) if hh >= 1})
    worst, widths, count = {}, {}, 0
    for seed, (hh, s, (p, n), init, strided, dtype) in enumerate(itertools.product(
            heads, (1, 63, 64, 65, 257), ((20, 12), (48, 40), (64, 64), (18, 10)),
            (False, True), (False, True), (torch.bfloat16, torch.float32))):
        args = ssd_heads_inputs(device, 2, s, hh, p, n, init=init, strided=strided,
                                dtype=dtype, seed=seed)
        got = ssd_scan_heads(*args)
        want = ssd_scan_heads_ref(*args)
        torch.cuda.synchronize()
        err = parity.max_err(got, want)
        if not err <= tol or not all(torch.isfinite(t).all() for t in got):
            fail(f"ssd_scan_heads {dtype} (2, {s}, {hh}, {p}) N {n} init {init} strided "
                 f"{strided}: scale-normalised err {err:.3e} (tolerance {tol})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        if dtype == torch.bfloat16:
            width = copy_width(*args[0:1], *args[3:5])
            widths[width] = widths.get(width, 0) + 1
        count += 1
    if sorted(widths) != [4, 8, 16]:
        fail(f"the edge grid copied in pieces of {sorted(widths)} bytes, not 4, 8 and 16")
    print(f"ssd_scan_heads edges, G = {group}: {count} cases (H {heads}; S 1, 63, 64, 65, 257; "
          f"(P, N) (20, 12), (48, 40), (64, 64), (18, 10); with and without a state; "
          f"contiguous and strided): worst err bf16 {worst[torch.bfloat16]:.3e}, f32 "
          f"{worst[torch.float32]:.3e} (tolerance {tol}); bf16 copies of 16 / 8 / 4 bytes in "
          f"{widths[16]} / {widths[8]} / {widths[4]} cases")
    xh, dt, a, bm, cm, _ = ssd_heads_inputs(device, 1, 8, 2, 16, 16, init=False, strided=False,
                                            dtype=torch.bfloat16, seed=0)
    odd = torch.empty(xh.numel() + 1, dtype=xh.dtype, device=device)[1:].view(xh.shape)
    odd.copy_(xh)
    try:
        ssd_scan_heads(odd, dt, a, bm, cm)
    except ValueError as exc:
        print(f"ssd_scan_heads refuses a bf16 x at an odd element offset: {exc}")
    else:
        fail("ssd_scan_heads took a bf16 x at an odd element offset")


def ssd_least_work(b: int, s: int, h: int, p: int, n: int) -> int:
    """The least FLOP of the scan, the bare recurrence: per step and head a
    P x N outer product into the state and a P x N contraction out of it."""
    return 4 * b * h * s * p * n


def ssd_tile_work(b: int, s: int, h: int, p: int, n: int, tile: int = 64) -> int:
    """FLOP of the chunked form at a tile of ``tile`` steps: per tile of L
    steps, the causal half of the intra term, L(L+1)/2 (N + P)
    multiply-adds, the inter term and the state update, 2 L N P."""
    full, rest = divmod(s, tile)
    per_head = sum(ln * (ln + 1) // 2 * (n + p) + 2 * ln * n * p
                   for ln in [tile] * full + ([rest] if rest else []))
    return 2 * b * h * per_head


def ssd_mma_work(b: int, s: int, h: int, group: int) -> int:
    """FLOP the bf16 kernel issues on the tensor cores (m16n8k16, 4096 FLOP
    each; P and N padded to 64): per 64-step tile, 80 for C Bᵀ a block and
    672 a head (intra 160, inter 256, update 256, the hi + lo splits
    doubled)."""
    tiles, blocks = -(-s // 64), -(-h // group)
    return b * tiles * (blocks * 80 + h * 672) * 4096


def check_ssd_main(device) -> dict:
    """ssd_scan at the prefill's shape, as the model calls it: x, B and C
    bf16 column slices of one conv output, dt from a softplus, A =
    -linspace(1, 16) (the init); y and the final state held to the plain
    version (f32 arithmetic on bf16-exact inputs: the registry's f32 2e-4).
    The bound is the bytes (the bare recurrence's FLOP take 0.03 ms on the
    bf16 tensor cores); its f32 CUDA-core time is printed beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import parity
    from repro_torch.kernels.ssd_scan.ops import heads_per_block, ssd_scan_heads
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_heads_ref

    b, s, h, p, n = 8, 3584, 64, 64, 64
    gen = torch.Generator(device=device).manual_seed(3)
    xbc = F.silu(torch.randn(b, s, h * p + 2 * n, generator=gen, device=device)).bfloat16()
    xh = xbc[..., : h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device=device))
    a = -torch.linspace(1.0, 16.0, h, device=device)
    got, want = ssd_scan_heads(xh, dt, a, bm, cm), ssd_scan_heads_ref(xh, dt, a, bm, cm)
    errs = [parity.max_err(g, w) for g, w in zip(got, want)]
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tol = parity.KERNELS["ssd_scan"]["tols"]["float32"]
    if not max(errs) <= tol or not all(torch.isfinite(g).all() for g in got):
        fail(f"ssd_scan at the prefill shape: y err {errs[0]:.3e}, final state err "
             f"{errs[1]:.3e} (tolerance {tol})")
    del got, want
    torch.cuda.empty_cache()
    t = turns(lambda: ssd_scan_heads(xh, dt, a, bm, cm),
              lambda: ssd_scan_heads_ref(xh, dt, a, bm, cm), calls=1, reps=3)
    group = heads_per_block()
    flops, tile_flops = ssd_least_work(b, s, h, p, n), ssd_tile_work(b, s, h, p, n)
    mma_flops = ssd_mma_work(b, s, h, group)
    # x, B, C read once (bf16); dt (f32) and A once; y (f32) and the final
    # state (f32) written once.
    moved = (xh.numel() + bm.numel() + cm.numel()) * 2 + dt.numel() * 4 + a.numel() * 4 \
        + xh.numel() * 4 + b * h * p * n * 4
    bound_ms, bound_by = bound(flops, moved)
    f32_bound_ms, _ = bound(flops, moved, F32_FLOP_PER_S)
    print(f"ssd_scan_heads xh {tuple(xh.shape)} bf16 (strided), B/C {tuple(bm.shape)}, "
          f"{group} heads a block: y err {errs[0]:.3e}, final state err {errs[1]:.3e} "
          f"(tolerance {tol}), max abs err {abs_err:.4g}; device time per call (CUDA graph of "
          f"1 call): kernel {t['runs_ms'][0]:.4f} / {t['runs_ms'][1]:.4f} ms, plain "
          f"{t['plain_runs_ms'][0]:.2f} / {t['plain_runs_ms'][1]:.2f} ms; library: none; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {moved} bytes at 3.35 TB/s; the bare "
          f"recurrence's {flops:.4g} FLOP take {flops / BF16_FLOP_PER_S * 1e3:.4f} ms at "
          f"989 TFLOP/s bf16); on the CUDA cores in f32 they would take {f32_bound_ms:.4f} ms "
          f"at 67 TFLOP/s; the kernel issues {mma_flops:.4g} FLOP on the tensor cores (the "
          f"chunked form at 64-step tiles is {tile_flops:.4g})")
    spec = parity.KERNELS["ssd_scan"]
    return {"name": "ssd_scan", "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": None, "max_abs_err": abs_err,
            "max_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "f32_bound_ms": f32_bound_ms, "group": group, "flops": flops,
            "tile_flops": tile_flops, "mma_flops": mma_flops, "bytes": moved}


# --------------------------------------------------------------- phase 4
def main_path(argv, *, batch: int, seq_len: int, vocab: int) -> dict:
    """Drive ``repro_torch.launch.train`` with ``argv``; check it; return
    its numbers, with the kernels' launches in the run (counts zeroed just
    before)."""
    import torch

    from repro_torch.core import ChunkStore, RedoxLoader
    from repro_torch.launch.train import parse_args, train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work])
        staged = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        summary = train(args, on_batch=lambda step, feed: staged.append(feed))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        stats = summary["device_stats"]
        losses = summary["losses"]
        print(f"losses {losses}")
        print(f"tokens/sec {summary['tokens_per_s']:.1f} (whole run), "
              f"{summary['steady_tokens_per_s']:.1f} (steps 2-{len(losses)}); "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"stager wait {1e3 * stats.wait_s / max(len(losses), 1):.3f} ms a batch "
              f"(host clock); "
              f"{stats.bytes_to_device / 1e6:.3f} MB to device over {stats.steps} staged "
              f"batches; kernel launches {launches}")
        gathers = launches["chunk_gather_train"]
        if gathers == 0 or gathers != stats.steps or gathers != stats.kernel_steps:
            fail(f"kernel launches {gathers} != staged batches {stats.steps}")
        if (launches["fused_adamw"] > 0) != (args.optimizer == "adamw"):
            fail(f"{args.optimizer} launched the fused AdamW kernels "
                 f"{launches['fused_adamw']} times")
        if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
            fail(f"expected {args.steps} finite losses, got {losses}")
        if abs(losses[0] - math.log(vocab)) > 2.0:
            fail(f"first loss {losses[0]} is not near ln({vocab}) at random init")
        if len(staged) != args.steps:
            fail(f"the trainer saw {len(staged)} batches, expected {args.steps}")
        store = ChunkStore.open(Path(work) / "chunks")
        host = RedoxLoader.from_spec(summary["spec"], store).epoch(0)
        for i, (feed, ref) in enumerate(zip(staged, host)):
            keys = ("tokens", "targets", "loss_mask")
            if "frames" in feed:  # a frame arch: one-hot frames of tokens % frontend_dim
                frames = feed["frames"]
                if frames.shape[:2] != (batch, seq_len) or not bool(
                        (frames.float().sum(-1) == 1).all()):
                    fail(f"the frames of step {i} are not one-hot")
                hot = frames.argmax(-1).cpu().numpy()
                if not (hot == ref["tokens"] % frames.shape[-1]).all():
                    fail(f"the frames of step {i} are not the host stream's tokens "
                         f"modulo {frames.shape[-1]}")
                keys = ("targets", "loss_mask")
            for k in keys:
                got = feed[k].cpu().numpy()
                if got.shape != (batch, seq_len) or not (got == ref[k]).all():
                    fail(f"staged {k} of step {i} differs from the host stream")
        store.close()
        print(f"staged batches equal the host stream ({len(staged)} steps)")
    return {
        "launches": gathers, "optim_launches": launches["fused_adamw"], "losses": losses,
        "tokens_per_s": summary["tokens_per_s"],
        "steady_tokens_per_s": summary["steady_tokens_per_s"],
        "max_memory_allocated_gib": peak / 2**30,
        "stager_wait_ms_a_batch": 1e3 * stats.wait_s / max(len(losses), 1),
        "mb_to_device": stats.bytes_to_device / 1e6, "staged_batches": stats.steps,
    }


def device_profile(prof, start_marker: str, kernel: str | None, steps: int) -> dict:
    """From a profiler run: the device's idle share from ``start_marker``
    to the last device event (``steps`` steps), the device operations per
    step, the heaviest kernels and, unless ``kernel`` is None, the launches
    of kernels whose name holds ``kernel`` (fails without any), and over
    the whole run the device operations and device time per launch on the
    streams that ran it."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        trace_file = Path(work) / "trace.json"
        prof.export_chrome_trace(str(trace_file))
        events = json.loads(trace_file.read_text())["traceEvents"]
    start = min((e["ts"] for e in events if e.get("name") == start_marker), default=None)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                     e.get("args", {}).get("stream"))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if start is None or not device:
        fail("the profiler trace has no step marker or no device events")
    end = max(d[1] for d in device)
    busy, cur_s, cur_e, by_name, ops = 0.0, None, None, {}, 0
    for s_, e_, name, _ in device:
        s_, e_ = max(s_, start), min(e_, end)
        if e_ <= s_:
            continue
        ops += 1
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    window = end - start
    idle = 1.0 - busy / window
    print(f"device window {window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, "
          f"idle share {idle:.4f}; {ops} device operations, {ops / steps:.1f} per step")
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        print(f"  {t / total:6.1%}  {t / 1e3:9.3f} ms  {name[:110]}")
    out = {"idle_share": idle, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
           "ops_per_step": ops / steps, "top": [[name[:80], t / total] for name, t in top[:5]]}
    if kernel is None:
        return out
    ours = sum(t for n, t in by_name.items() if kernel in n)
    each = [e_ - s_ for s_, e_, name, _ in device if kernel in name]
    if not each:
        fail(f"the profiled path shows no {kernel} on the device")
    streams = {stream for _, _, name, stream in device if kernel in name}
    on_streams = [(e_ - s_, name) for s_, e_, name, stream in device if stream in streams]
    kinds = {}
    for _, name in on_streams:
        kinds[name[:60]] = kinds.get(name[:60], 0) + 1
    print(f"  {kernel}: {ours / 1e3:.4f} ms of device time in the window "
          f"({ours / total:.4%}); {len(each)} launches in the whole run, "
          f"{statistics.mean(each):.3f} us each; on its streams {sorted(streams)}: "
          f"{len(on_streams) / len(each):.2f} device operations and "
          f"{sum(d for d, _ in on_streams) / len(each):.3f} us of device time a launch "
          f"({kinds})")
    return dict(out, kernel_share=ours / total, kernel_launches=len(each),
                kernel_us_each=statistics.mean(each),
                stream_ops_per_launch=len(on_streams) / len(each),
                stream_us_per_launch=sum(d for d, _ in on_streams) / len(each))


def profile_training(argv, marker: str) -> tuple[dict, int]:
    """Profile a 4-step run of the training path from its third step;
    ``marker`` names the device operation that finds the stager's side
    stream. Returns :func:`device_profile`'s numbers and the run's staged
    batches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch.train import parse_args, train

    def mark(step, feed):
        with record_function(f"chip_smoke.step{step}"):
            pass

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(argv + ["--workdir", work, "--steps", "4"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            summary = train(args, on_batch=mark)  # ends in torch.cuda.synchronize()
    print("steps 3-4:")
    return device_profile(prof, "chip_smoke.step2", marker, 2), summary["device_stats"].steps


def where_time_goes(argv) -> dict:
    """Phase 4b: the training path's profile, its side stream found by the
    gather."""
    out, _ = profile_training(argv, "chunk_gather_train_kernel")
    return {"idle_share": out["idle_share"], "window_ms": out["window_ms"],
            "busy_ms": out["busy_ms"], "ops_per_step": out["ops_per_step"],
            "gather_launches": out["kernel_launches"],
            "gather_us_each": out["kernel_us_each"],
            "side_stream_ops_per_batch": out["stream_ops_per_launch"],
            "side_stream_us_per_batch": out["stream_us_per_launch"]}


# --------------------------------------------------------------- phase 5
def serve_path(argv) -> dict:
    """Drive ``repro_torch.launch.serve`` with ``argv``; check it; return
    its numbers and the run's summary (counts zeroed just before)."""
    import torch

    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=AGREEMENT_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg_layers, vocab = summary["model"].cfg.num_layers, summary["model"].cfg.vocab_size
    print(f"launches {launches}; prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} "
          f"tok/s (all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if launches["flash_attention"] != cfg_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times, "
             f"expected {cfg_layers} (one per layer of the prefill)")
    if launches["decode_attention"] != cfg_layers * steps:
        fail(f"decode_attention launched {launches['decode_attention']} times, "
             f"expected {cfg_layers * steps}")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {vocab})")
    kept = [summary["prefill_logits"], *summary["logits"].values()]
    if len(kept) != 1 + len(AGREEMENT_STEPS) or not all(
            bool(torch.isfinite(x).all()) for x in kept):
        fail("a kept logit is not finite")
    rows = prefill_agreement(summary, AGREEMENT_STEPS)
    for r in rows:
        print(f"decode step {r['step']} vs a fresh prefill of {args.prompt_len + r['step'] + 1}"
              f" tokens: scale-normalised err {r['err']:.3e} (tolerance {AGREEMENT_TOL}), "
              f"argmax agrees on {r['argmax_agree']}/{r['rows']} rows "
              f"(at least {AGREEMENT_MIN_ROWS})")
        if not (r["err"] <= AGREEMENT_TOL and r["argmax_agree"] >= AGREEMENT_MIN_ROWS):
            fail(f"decode step {r['step']} disagrees with a fresh prefill")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    run = {"launches": {k: launches[k] for k in ("flash_attention", "decode_attention")},
           "prefill_s": summary["prefill_s"], "decode_s": summary["decode_s"],
           "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30, "agreement": rows,
           "decode_graph": decode_graph(summary)}
    return run, summary


def decode_graph(summary, *, required: bool = True) -> dict:
    """Print whether the run's decode went through the captured CUDA graph
    and the device operations the graph holds; fail unless it did when
    ``required``. Returns the summary's ``decode_graph``."""
    graph = summary["decode_graph"]
    if graph["captured"]:
        print(f"decode through one captured CUDA graph a step: {graph['nodes']['total']:,d} "
              f"device operations a replay ({graph['nodes']})")
    else:
        print("decode through the eager step, op by op")
        if required:
            fail("decode was not captured in a CUDA graph")
    return graph


def profile_decode(decode, cache, tok, pos0: int, first: int, steps: int, label: str) -> dict:
    """Profile ``decode`` steps ``first`` to ``steps - 1`` (positions from
    ``pos0``) and read the window from step ``first + 2``: its idle share,
    operations and busy time a step (:func:`device_profile`). The card is
    synchronised just before that step's marker, so the window opens on an
    idle card: a graph's replays run behind the host, and the marker of a
    step would otherwise open the window inside an earlier step's work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(first, steps):
            if t == first + 2:
                torch.cuda.synchronize()
            with record_function(f"chip_smoke.{label}{t}"):
                pass
            logits, cache = decode(cache, tok, pos0 + t)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
    print(f"{label} steps {first + 2}-{steps - 1}:")
    out = device_profile(prof, f"chip_smoke.{label}{first + 2}", "decode_attention_kernel",
                         steps - first - 2)
    out["busy_ms_per_step"] = out["busy_ms"] / (steps - first - 2)
    return out


def alone_us(fn, calls: int = 16) -> float:
    """The host time of ``fn()``, each call alone on an idle card: the
    median of ``calls``, in microseconds."""
    import torch

    samples = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(samples)


def where_decode_time_goes(summary, *, steps: int = 16) -> dict:
    """Profile decode steps of the served model after a fresh prefill of
    the same prompts, from the third step, through the step the server
    uses (``build_decode_step``: one CUDA graph replay a step under the
    rule; its first call, which runs the warm-up and captures, comes before
    the profiler starts), and then the eager step (``model.decode_step``)
    on a second fresh prefill, for its numbers beside the graph's in the
    same call. With the graph, also, without the profiler: the device time
    of a step over 16 steps as the server runs them (CUDA events; the host
    runs ahead), against the traced busy time a step (what is left is the
    gaps between the graph's operations), and the host time of a call (the
    tokens' and position's copies and the replay) and of a bare
    ``graph.replay()``, each timed alone on an idle card (the median of
    16)."""
    import torch

    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    model = summary["model"]
    prompts = summary["prompts"].to(model.device)
    pos0 = summary.get("pos0", prompts.shape[1])  # after a patch arch's patches
    prefill = build_prefill_step(model, summary["max_len"])
    logits, cache = prefill({"tokens": prompts, **summary.get("extra", {})})
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    decode = build_decode_step(model)
    logits, cache = decode(cache, tok, pos0)  # the warm-up and, under the rule, the capture
    tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
    out = profile_decode(decode, cache, tok, pos0, 1, steps + 1, "decode")
    out["steps"] = steps
    out["captured"] = decode.captured
    if decode.captured:
        out["graph_nodes"] = decode.nodes
        pos = pos0 + steps + 1
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for t in range(16):
            logits, cache = decode(cache, tok, pos + t)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / 16

        call_us = alone_us(lambda: decode(cache, tok, pos))
        replay_us = alone_us(decode.graph.replay)
        gap_ms = replay_ms - out["busy_ms_per_step"]
        out.update(replay_ms=replay_ms, gaps_ms_per_replay=gap_ms, host_us_per_call=call_us,
                   host_us_per_replay=replay_us)
        print(f"graph: {decode.nodes['total']:,d} device operations a replay; device time a "
              f"step {replay_ms:.4f} ms (16 steps as served, CUDA events) against a traced busy "
              f"{out['busy_ms_per_step']:.4f} ms a step: gaps {gap_ms:.4f} ms a step, "
              f"{gap_ms / decode.nodes['total'] * 1e3:.3f} us an operation; host "
              f"{call_us:.1f} us a call (copies and replay), {replay_us:.1f} us a bare replay "
              f"(each alone on an idle card)")
    del cache, decode
    torch.cuda.empty_cache()
    logits, cache = prefill({"tokens": prompts, **summary.get("extra", {})})
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    eager = torch.inference_mode()(model.decode_step)
    out["eager"] = profile_decode(eager, cache, tok, pos0, 0, steps, "eager")
    print(f"decode a step, graph against eager: busy {out['busy_ms_per_step']:.4f} / "
          f"{out['eager']['busy_ms_per_step']:.4f} ms, idle share {out['idle_share']:.4f} / "
          f"{out['eager']['idle_share']:.4f}, device operations {out['ops_per_step']:.1f} / "
          f"{out['eager']['ops_per_step']:.1f}, window {out['window_ms'] / (steps - 2):.4f} / "
          f"{out['eager']['window_ms'] / (steps - 2):.4f} ms")
    del cache
    return out


def decode_both_ways(model, inputs: dict, pos0: int, max_len: int, steps: int) -> dict:
    """From two fresh prefills of ``inputs``: ``steps`` greedy decode steps
    through ``build_decode_step`` (the captured graph) and as many through
    ``model.decode_step`` (eager). Returns per way the tokens (B, steps),
    the f32 logits of every step and the caches after the last."""
    import torch

    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    out = {}
    for way in ("graph", "eager"):
        logits, cache = build_prefill_step(model, max_len)(inputs)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        step = (build_decode_step(model) if way == "graph"
                else torch.inference_mode()(model.decode_step))
        toks, logs = [], []
        for t in range(steps):
            logits, cache = step(cache, tok, pos0 + t)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
            logs.append(logits[:, 0].to(torch.float32, copy=True))
        if way == "graph" and not step.captured:
            fail("build_decode_step did not capture a CUDA graph on the card")
        out[way] = {"tokens": torch.cat(toks, 1), "logits": torch.stack(logs), "cache": cache}
        del step
    return out


def graph_agreement(runs: dict, name: str) -> dict:
    """Hold :func:`decode_both_ways`'s graph run to its eager run: tokens
    equal on every row and step; logits and every cache leaf bit for bit
    (the same kernels with the same launch parameters read the same
    inputs, and no reduction on the path is order-free, so nothing may
    differ)."""
    import torch

    g, e = runs["graph"], runs["eager"]
    tokens_equal = torch.equal(g["tokens"], e["tokens"])
    logit_diff = float((g["logits"] - e["logits"]).abs().max())
    leaves = {f"{i}.{k}": float((a[k].float() - b[k].float()).abs().max())
              for i, (a, b) in enumerate(zip(g["cache"], e["cache"])) for k in a}
    steps, rows = g["tokens"].shape[1], g["tokens"].shape[0]
    print(f"{name}: {steps} decode steps through the graph and eagerly from the same prefill: "
          f"tokens equal on all {rows} rows and steps: {tokens_equal}; max abs logit difference "
          f"{logit_diff:.3e}; {len(leaves)} cache leaves, max abs difference "
          f"{max(leaves.values()):.3e} (bound: 0, bit for bit)")
    if not tokens_equal or logit_diff != 0 or any(leaves.values()):
        fail(f"{name}: the graph's decode differs from the eager step's")
    return {"steps": steps, "rows": rows, "tokens_equal": tokens_equal,
            "max_abs_logit_diff": logit_diff, "max_abs_cache_diff": max(leaves.values())}


def graph_against_eager(summary, device) -> dict:
    """Phase 5c: the captured graph against the eager step. tinyllama-1.1b at
    full width with phase 5's weights and prompts (B = 8, prompt 1920), 32
    steps each way; then reduced zamba2 in f32 (the SSM and conv states held
    too), 16 steps; both bit for bit (:func:`graph_agreement`). Then reduced
    tinyllama with ``logit_softcap = SOFTCAP`` in f32 on the card: served,
    and decode held to a fresh prefill at three steps (SMALL_TOL, argmax
    equal on every row)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_parser, prefill_agreement, serve
    from repro_torch.models import build_model

    model = summary["model"]
    inputs = {"tokens": summary["prompts"].to(model.device)}
    full = graph_agreement(
        decode_both_ways(model, inputs, summary["pos0"], summary["max_len"], 32),
        "tinyllama-1.1b full width, bf16")
    torch.cuda.empty_cache()
    cfg = reduced(get_config("zamba2-1.2b"))
    hybrid = build_model(cfg, device=device).init(0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    reduced_hybrid = graph_agreement(
        decode_both_ways(hybrid, {"tokens": torch.from_numpy(prompts).to(device)}, 64, 96, 16),
        "reduced zamba2-1.2b, f32")
    capped = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), logit_softcap=SOFTCAP)
    args = build_parser().parse_args(["--arch", "tinyllama-1.1b", "--full", "--batch", "4",
                                      "--prompt-len", "64", "--new-tokens", "17", "--seed", "0"])
    steps = (0, 8, 15)
    with patched_config(capped):
        run = serve(args, keep_logits=steps)
    decode_graph(run)
    rows = prefill_agreement(run, steps)
    for r in rows:
        print(f"reduced tinyllama-1.1b, logit_softcap {SOFTCAP}, f32: decode step {r['step']} vs "
              f"a fresh prefill: scale-normalised err {r['err']:.3e} (tolerance {SMALL_TOL}), "
              f"argmax agrees on {r['argmax_agree']}/{r['rows']} rows")
        if not (r["err"] <= SMALL_TOL and r["argmax_agree"] == r["rows"]):
            fail(f"softcapped decode step {r['step']} disagrees with a fresh prefill")
    return {"full_width": full, "reduced_hybrid_f32": reduced_hybrid,
            "softcap": {"cap": SOFTCAP, "agreement": rows}}


def hybrid_path(argv) -> tuple[dict, dict]:
    """Drive ``repro_torch.launch.serve`` on zamba2 with ``argv``; check it;
    return its numbers and the run's summary (counts zeroed just before)."""
    import torch

    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    step = HYBRID_AGREEMENT_STEP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=(step,), keep_states=(step - 1, step))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = summary["model"].cfg
    kinds = [kind for kind, _ in cfg.segments()]
    mamba = sum(count for kind, count in cfg.segments() if kind == "mamba2")
    sites = kinds.count("shared_attn")
    print(f"launches {launches}; params {summary['params']:,d} (cfg.param_count() "
          f"{cfg.param_count():,d}); prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} tok/s "
          f"(all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    want = {"ssd_scan": mamba, "flash_attention": sites, "decode_attention": sites * steps}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times, expected {n}")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(x).all())
               for x in (summary["prefill_logits"], summary["logits"][step])):
        fail("a kept logit is not finite")
    (row,) = prefill_agreement(summary, (step,))
    # The planted fault: step - 1's states held to the same fresh prefill.
    (stale,) = prefill_agreement({**summary, "states": {step: summary["states"][step - 1]}},
                                 (step,))
    row["stale_state_err"] = stale["state_err"]
    print(f"decode step {step} vs a fresh prefill of {args.prompt_len + step + 1} tokens: "
          f"logits scale-normalised err {row['err']:.3e} (tolerance {AGREEMENT_TOL}), argmax "
          f"agrees on {row['argmax_agree']}/{row['rows']} rows (at least {AGREEMENT_MIN_ROWS}); "
          f"{mamba} SSM states err {row['state_err']['mamba2.ssm']:.3e} (tolerance "
          f"{HYBRID_STATE_TOL['mamba2.ssm']}), conv states err "
          f"{row['state_err']['mamba2.conv']:.3e} (tolerance "
          f"{HYBRID_STATE_TOL['mamba2.conv']}); planted fault, the states one token "
          f"stale: SSM err {stale['state_err']['mamba2.ssm']:.3e}, conv err "
          f"{stale['state_err']['mamba2.conv']:.3e}")
    if not all(stale["state_err"][k] > tol for k, tol in HYBRID_STATE_TOL.items()):
        fail("the state bound does not tell a state one token stale from a sound one")
    if not (row["err"] <= AGREEMENT_TOL and row["argmax_agree"] >= AGREEMENT_MIN_ROWS
            and all(row["state_err"][k] <= tol for k, tol in HYBRID_STATE_TOL.items())):
        fail(f"decode step {step} disagrees with a fresh prefill")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    summary.pop("states")
    run = {"launches": {k: launches[k] for k in want}, "params": summary["params"],
           "param_count": cfg.param_count(), "prefill_s": summary["prefill_s"],
           "decode_s": summary["decode_s"], "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30, "agreement": row,
           "decode_graph": decode_graph(summary)}
    return run, summary


def where_prefill_time_goes(summary, kernel: str = "ssd_scan_bf16_kernel") -> dict:
    """Profile one prefill of the served model's prompts: ``kernel``'s
    share of device time and its time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train.train_step import build_prefill_step

    model = summary["model"]
    prompts = summary["prompts"].to(model.device)
    prefill = build_prefill_step(model, summary["max_len"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.prefill"):
            pass
        prefill({"tokens": prompts})
        torch.cuda.synchronize()
    print("prefill:")
    return device_profile(prof, "chip_smoke.prefill", kernel, 1)


# --------------------------------------------------------------- phase 6
def small_reference(device) -> None:
    """Reduced tinyllama in f32 on ``device`` against the same weights on
    the CPU: logits (dense and chunked attention) and one train step."""
    import numpy as np
    import torch

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import build_train_step, fresh_train_state

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 129)).astype(np.int32)
    batch_np = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
                "loss_mask": (rng.random((4, 128)) < 0.9).astype(np.float32)}
    for threshold in (2048, 64):  # dense, then chunked attention
        cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), attn_chunk=32,
                                  attn_dense_threshold=threshold)
        cpu_model = build_model(cfg, device="cpu").init(0)
        results = []
        for dev in ("cpu", device):
            model = build_model(cfg, device=dev)
            model.load_state_dict(cpu_model.state_dict())
            feed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch_np.items()}
            with torch.no_grad():
                logits = model(feed)[0].double().cpu()
            run = RunConfig()
            opt = make_optimizer(run)
            state = fresh_train_state(model, opt)
            _, m = build_train_step(model, run, opt)(state, feed)
            results.append((logits, float(m["loss"]), float(m["grad_norm"])))
        (lc, loss_c, gn_c), (lg, loss_g, gn_g) = results
        err = float((lg - lc).abs().max() / lc.abs().max())
        print(f"attn_dense_threshold {threshold}: logits err {err:.3e}, loss "
              f"{loss_g:.6f} vs {loss_c:.6f}, grad_norm {gn_g:.6f} vs {gn_c:.6f} "
              f"(tolerance {SMALL_TOL})")
        if not (err <= SMALL_TOL and abs(loss_g - loss_c) <= SMALL_TOL * abs(loss_c)
                and abs(gn_g - gn_c) <= SMALL_TOL * abs(gn_c)):
            fail(f"{device} disagrees with the CPU on the reduced model")


def small_inputs(cfg, b: int = 4, s: int = 128, seed: int = 0) -> dict:
    """Numpy inputs of a reduced model: tokens (patches before them for a
    ``patch`` arch; frames in their place for a ``frame`` one), targets
    and a loss mask over every position."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
           "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if cfg.frontend == "frame":
        out["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
        del out["tokens"]
    elif cfg.frontend == "patch":
        p = cfg.frontend_len
        out["patch_embeds"] = rng.normal(size=(b, p, cfg.frontend_dim)).astype(np.float32)
        out["targets"] = np.concatenate([np.zeros((b, p), np.int32), out["targets"]], 1)
        out["loss_mask"] = np.concatenate([np.zeros((b, p), np.float32), out["loss_mask"]], 1)
    return out


#: Phase 6's reduced frontend and sequence-split archs: llava-next-34b
#: (patches), hubert-xlarge (frames, non-causal), and phi3-medium-14b with
#: ``attn_dense_threshold`` below S = 128 (four blocks of 32), so that its
#: ``attn_shard="seq"`` attention trains through ``_chunked_attention_vecq``.
SMALL_FRONTEND_ARCHS = {"llava-next-34b": {}, "hubert-xlarge": {},
                        "phi3-medium-14b": {"attn_dense_threshold": 64, "attn_chunk": 32}}


@contextlib.contextmanager
def counting_vecq():
    """A list that gains one entry per ``_chunked_attention_vecq`` call in
    the block (``attention_block`` finds it by module lookup)."""
    from repro_torch.models import attention

    calls, vecq = [], attention._chunked_attention_vecq
    with mock.patch.object(attention, "_chunked_attention_vecq",
                           lambda *a: calls.append(1) or vecq(*a)):
        yield calls


def small_frontends(device) -> list:
    """The archs of SMALL_FRONTEND_ARCHS in f32 on ``device`` against the
    same weights on the CPU: logits, then two train steps with Adafactor
    and two with SGDM (each step's loss and grad_norm; the second step's
    loss reads the first update) within SMALL_TOL."""
    import torch

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import build_train_step, fresh_train_state

    out = []
    for arch, changes in SMALL_FRONTEND_ARCHS.items():
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        batch_np = small_inputs(cfg)
        cpu_model = build_model(cfg, device="cpu").init(0)
        results = {}
        with counting_vecq() as calls:
            for dev in ("cpu", device):
                feed = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
                model = build_model(cfg, device=dev)
                model.load_state_dict(cpu_model.state_dict())
                with torch.no_grad():
                    got = [model({k: v for k, v in feed.items()
                                  if k not in ("targets", "loss_mask")})[0].double().cpu()]
                for optimizer in ("adafactor", "sgdm"):
                    model.load_state_dict(cpu_model.state_dict())
                    run = RunConfig(optimizer=optimizer)
                    opt = make_optimizer(run)
                    state, step = fresh_train_state(model, opt), build_train_step(model, run, opt)
                    for _ in range(2):
                        state, m = step(state, feed)
                        got.append(torch.tensor([float(m["loss"]), float(m["grad_norm"])],
                                                dtype=torch.float64))
                results[str(dev)] = got
        (cpu, card) = results["cpu"], results[str(device)]
        logits_err = float((card[0] - cpu[0]).abs().max() / cpu[0].abs().max())
        step_err = max(float(((g - c).abs() / c.abs()).max()) for g, c in zip(card[1:], cpu[1:]))
        print(f"reduced {arch} f32 (vecq calls {len(calls)}): logits err {logits_err:.3e}; "
              f"Adafactor and SGDM, 2 steps each: losses "
              f"{[round(float(x[0]), 6) for x in card[1:]]}, worst relative loss / grad_norm "
              f"err {step_err:.3e} (tolerance {SMALL_TOL})")
        if not (logits_err <= SMALL_TOL and step_err <= SMALL_TOL):
            fail(f"{device} disagrees with the CPU on reduced {arch}")
        if arch == "phi3-medium-14b" and not calls:
            fail("reduced phi3 did not run _chunked_attention_vecq")
        out.append({"arch": arch, "logits_err": logits_err, "step_err": step_err,
                    "vecq_calls": len(calls)})
    return out


def small_serving(device, arch: str = "tinyllama-1.1b") -> list:
    """Reduced ``arch`` in f32: prefill + 12 greedy decode steps on
    ``device`` against the same weights on the CPU, with a full cache, a
    16-slot rotating window that the 24-token prompt overfills (archs with
    attention), and (for tinyllama) an int8 cache and logits capped at
    SOFTCAP. A ``patch`` arch
    prefills seeded random patches before the prompt, and its positions
    start after them. Tokens equal; logits within SMALL_TOL
    (SMALL_INT8_TOL for int8)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    variants = (("full", {}, 16, 29),)
    if get_config(arch).family != "ssm":  # xLSTM has no attention, so no window
        variants += (("window", {"window": 16}, 24, 37),)
    if arch == "tinyllama-1.1b":
        variants += (("int8", {"kv_cache_dtype": "int8"}, 16, 29),
                     ("softcap", {"logit_softcap": SOFTCAP}, 16, 29))
    out = []
    for name, changes, prompt_len, max_len in variants:
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        cpu_model = build_model(cfg, device="cpu").init(0)
        rng = np.random.default_rng(1)
        prompts = rng.integers(0, cfg.vocab_size, (2, prompt_len))
        extra, pos0 = {}, prompt_len
        if cfg.frontend == "patch":
            extra["patch_embeds"] = torch.from_numpy(
                rng.normal(size=(2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
            pos0 += cfg.frontend_len
        results = []
        for dev in ("cpu", device):
            model = build_model(cfg, device=dev)
            model.load_state_dict(cpu_model.state_dict())
            decode = build_decode_step(model)
            logits, cache = build_prefill_step(model, max_len)(
                {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}})
            logs = [logits[:, -1].double().cpu()]
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [tok.cpu()]
            for t in range(max_len - prompt_len - 1):
                logits, cache = decode(cache, tok, pos0 + t)
                logs.append(logits[:, 0].double().cpu())
                tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok.cpu())
            results.append((torch.cat(toks, 1), logs))
        (tc, lc), (tg, lg) = results
        err = max(float((g - c).abs().max() / c.abs().max()) for g, c in zip(lg, lc))
        tol = SMALL_INT8_TOL if name == "int8" else SMALL_TOL
        print(f"{arch} serving {name}: {len(lg)} logits (prefill + {len(lg) - 1} decode "
              f"steps), max err {err:.3e} (tolerance {tol}); tokens equal: "
              f"{torch.equal(tc, tg)}")
        if not torch.equal(tc, tg) or not err <= tol:
            fail(f"{device} disagrees with the CPU on reduced {arch} serving ({name})")
        out.append({"arch": arch, "variant": name, "err": err})
    return out


# --------------------------------------------------------------- phase 8
class DataServer:
    """``repro_torch.launch.data_service --serve`` in a subprocess, on a
    store it builds under ``work``. It needs no card. Stopped by
    :meth:`stop`; :meth:`stderr` shows what it wrote to its standard
    error."""

    def __init__(self, work: Path):
        import os

        self.sock, self.store = work / "svc.sock", work / "store"
        self._out, self._err = work / "server.out", work / "server.err"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
        with open(self._out, "w") as out, open(self._err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.data_service", "--serve",
                 str(self.sock), "--store-dir", str(self.store), *DATA_SERVICE_ARGS],
                cwd=HERE, env=env, stdout=out, stderr=err,
            )

    def wait_ready(self, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while "serving on" not in self._out.read_text():
            self.check_alive()
            if time.monotonic() > deadline:
                fail(f"the data server did not start serving in {timeout:.0f} s")
            time.sleep(0.2)
        print(self._out.read_text().strip())

    def check_alive(self) -> None:
        if self.proc.poll() is not None:
            fail(f"the data server exited early with code {self.proc.returncode}")

    def stderr(self) -> str:
        return self._err.read_text()

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)  # serve_forever stops on ^C
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


#: What phase 8 holds equal: a staged batch's grids; a ring frame's grids,
#: step and returned record ids.
GRID_KEYS = ("tokens", "targets", "loss_mask")
FRAME_KEYS = GRID_KEYS + ("step", "returned")


def batch_digest(batch, keys=GRID_KEYS) -> str:
    """A digest of a batch's ``keys`` (device or host tensors, numpy, ints)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in keys:
        v = batch[k]
        v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        h.update(k.encode() + str(v.dtype).encode() + str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def host_digests(spec, store, steps=None, keys=GRID_KEYS) -> list:
    """Digests of an in-process loader's epoch 0 for ``spec`` on ``store``
    (its first ``steps`` batches, or all)."""
    from repro_torch.core import RedoxLoader

    batches = RedoxLoader.from_spec(spec, store).epoch(0)
    return [batch_digest(b, keys) for b in itertools.islice(batches, steps)]


def co_tenant(sock: Path, spec, start, trainer_done, out: dict) -> None:
    """Job ``job1``: once ``start`` is set, consume epoch 0 over its own
    ``RedoxClient``; after ``trainer_done``, read the server's stats."""
    from repro_torch.service.transport import RedoxClient

    try:
        if not start.wait(timeout=600):
            raise TimeoutError("the trainer never took its first batch")
        with RedoxClient(sock, spec, job_id="job1") as client:
            t0 = time.perf_counter()
            out["digests"] = [batch_digest(b, FRAME_KEYS) for b in client.epoch(0)]
            out["epoch_s"] = time.perf_counter() - t0
            if not trainer_done.wait(timeout=600):
                raise TimeoutError("the trainer did not finish")
            out["stats"] = client.stats()
    except Exception as e:  # the phase fails on it in the main thread
        out["error"] = e


def data_service_path() -> dict:
    """Phase 8: the trainer through a data server beside a co-tenant job,
    its profile, then the autotuned gather path."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        server = DataServer(Path(work))
        try:
            server.wait_ready()
            run = served_training(server)
            server.check_alive()
            run["profile"] = where_served_time_goes(server)
            server.check_alive()
        except BaseException:
            print(f"data server stderr:\n{server.stderr()}", file=sys.stderr, flush=True)
            raise
        finally:
            server.stop()
    run["autotune"] = autotuned_training()
    return run


def served_training(server: DataServer) -> dict:
    """Train through the server while ``job1`` consumes epoch 0 beside it;
    hold both streams to in-process loaders on the server's store. The
    co-tenant opens its session after the trainer's first batch, once the
    trainer's epoch is planned, so each job's plan is its solo one."""
    import threading

    import torch

    from repro_torch.core import ChunkStore, SessionSpec
    from repro_torch.launch.train import parse_args, train

    vocab, co_spec = 32000, SessionSpec(**CO_TENANT_SPEC)
    start, trainer_done, tenant = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=co_tenant, daemon=True,
                              args=(server.sock, co_spec, start, trainer_done, tenant))
    thread.start()
    staged = []

    def on_batch(step, feed):
        staged.append(batch_digest(feed))
        start.set()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(SERVED_ARGS + ["--data-server", str(server.sock), "--workdir", work])
        torch.cuda.synchronize()
        zero_launches()
        try:
            summary = train(args, on_batch=on_batch)
        finally:
            launches = read_launches()
            start.set()
            trainer_done.set()
    thread.join(timeout=900)
    if thread.is_alive():
        fail("the co-tenant job did not finish epoch 0")
    if "error" in tenant:
        fail(f"the co-tenant job failed: {tenant['error']!r}")
    stats = summary["device_stats"]
    losses = summary["losses"]
    print(f"losses {losses}")
    print(f"tokens/sec {summary['tokens_per_s']:.1f} (whole run), "
          f"{summary['steady_tokens_per_s']:.1f} (steps 2-{len(losses)}); "
          f"{stats.steps} staged batches, {stats.kernel_steps} gathered on the card; "
          f"kernel launches {launches}")
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        fail(f"expected {args.steps} finite losses, got {losses}")
    if abs(losses[0] - math.log(vocab)) > 2.0:
        fail(f"first loss {losses[0]} is not near ln({vocab}) at random init")
    if len(staged) != args.steps:
        fail(f"the trainer saw {len(staged)} staged batches, expected {args.steps}")
    if launches["chunk_gather_train"] != 0 or stats.kernel_steps != 0:
        fail(f"chunk_gather_train launched {launches['chunk_gather_train']} times on the "
             f"data-server path: ring frames ship assembled grids")
    store = ChunkStore.open(server.store)
    try:
        if staged != host_digests(summary["spec"], store, args.steps):
            fail("the trainer's batches through the server differ from an in-process "
                 "loader of its spec")
        want = host_digests(co_spec, store, keys=FRAME_KEYS)
    finally:
        store.close()
    if tenant["digests"] != want:
        fail(f"the co-tenant's {len(tenant['digests'])} batches differ from an in-process "
             f"loader of its spec ({len(want)} batches)")
    print(f"both streams equal their in-process loaders: trainer {len(staged)} batches, "
          f"co-tenant {len(want)} batches in {tenant['epoch_s']:.3f} s "
          f"({tenant['epoch_s'] / len(want) * 1e3:.3f} ms a frame, host)")
    rep = tenant["stats"]
    agg = rep["aggregate"]
    demand = {job: int(v) for job, v in rep["bytes_per_job"].items()}
    print(f"server: storage bytes read {agg['physical_bytes']:,d}, demand {demand} "
          f"(sum {sum(demand.values()):,d}); shared hits {agg['shared_hits']}, "
          f"shared bytes {agg['shared_bytes']:,d}, co-refill hits {agg['co_refill_hits']}")
    return {"losses": losses, "tokens_per_s": summary["tokens_per_s"],
            "steady_tokens_per_s": summary["steady_tokens_per_s"],
            "staged_batches": stats.steps, "gather_launches": launches["chunk_gather_train"],
            "optim_launches": launches["fused_adamw"],
            "storage_bytes": int(agg["physical_bytes"]), "demand_bytes": demand,
            "shared_hits": int(agg["shared_hits"]), "co_tenant_batches": len(want),
            "co_tenant_epoch_s": tenant["epoch_s"],
            "co_tenant_ms_per_frame": tenant["epoch_s"] / len(want) * 1e3}


def where_served_time_goes(server: DataServer) -> dict:
    """The data-server path's profile. It runs no gather: a staged batch is
    three pinned copies on the stager's side stream, which is found by
    them."""
    out, staged = profile_training(SERVED_ARGS + ["--data-server", str(server.sock)],
                                   "HtoD (Pinned")
    ops = out["stream_ops_per_launch"] * out["kernel_launches"] / staged
    print(f"{staged} staged batches: {ops:.2f} device operations a staged batch on the "
          f"stager's side stream")
    return {"idle_share": out["idle_share"], "window_ms": out["window_ms"],
            "busy_ms": out["busy_ms"], "ops_per_step": out["ops_per_step"],
            "side_stream_ops_per_batch": ops,
            "side_stream_us_per_batch":
                out["stream_us_per_launch"] * out["kernel_launches"] / staged}


def autotuned_training() -> dict:
    """``--autotune --device-path gather``: the trainer builds its store,
    calibrates it and reopens it with the chosen backend; every staged
    batch is gathered on the card and equals a loader's host stream on
    the reopened store."""
    import torch

    from repro_torch.core import ChunkStore
    from repro_torch.core.storage import make_backend
    from repro_torch.launch.train import parse_args, train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        args = parse_args(AUTOTUNE_ARGS + ["--workdir", work])
        staged = []
        torch.cuda.synchronize()
        zero_launches()
        summary = train(args, on_batch=lambda step, feed: staged.append(batch_digest(feed)))
        launches = read_launches()
        choice, stats = summary["autotune"], summary["device_stats"]
        gathers = launches["chunk_gather_train"]
        print(f"autotune: {choice.describe()}; losses {summary['losses']}; "
              f"{stats.steps} staged batches; kernel launches {launches}")
        if gathers == 0 or gathers != stats.steps or gathers != stats.kernel_steps:
            fail(f"chunk_gather_train launched {gathers} times for {stats.steps} staged "
                 f"batches")
        if len(staged) != args.steps or not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"expected {args.steps} staged batches and finite losses, got "
                 f"{len(staged)} and {summary['losses']}")
        kw = {"readahead": choice.readahead} if choice.readahead else {}
        store = ChunkStore.open(Path(work) / "chunks", backend=make_backend(choice.backend, **kw))
        try:
            if staged != host_digests(summary["spec"], store, args.steps):
                fail("the autotuned path's staged batches differ from the host stream of a "
                     "loader on the reopened store")
        finally:
            store.close()
        print(f"staged batches equal the host stream on the reopened store ({len(staged)} steps)")
    return {"backend": choice.backend, "readahead": choice.readahead,
            "cache_limit_bytes": choice.cache_limit_bytes, "fidelity": choice.fidelity,
            "predicted_epoch_s": choice.predicted_epoch_s, "losses": summary["losses"],
            "staged_batches": stats.steps, "gather_launches": gathers,
            "optim_launches": launches["fused_adamw"]}


# --------------------------------------------------------------- phase 9
def patched_config(cfg):
    """Serve ``cfg`` in place of the registry's config of its name (the
    checks' capacity factor and dtype, a ``dataclasses.replace``)."""
    import repro_torch.launch.serve as serve_mod

    return mock.patch.object(serve_mod, "get_config", lambda name: cfg)


def moe_prefill_drops(summary) -> dict:
    """Run one more prefill of the served prompts, reading at each
    ``attn_moe`` layer the assignments capacity dropped (``moe.route`` and
    ``moe.slot_maps`` on the block's own input): the dropped share of the
    routed assignments over all MoE layers."""
    import repro_torch.models.transformer as transformer
    from repro_torch.models import moe
    from repro_torch.train.train_step import build_prefill_step

    model = summary["model"]
    seen = []
    block = transformer.moe_block

    def counting(p, x, cfg):
        b, s, _ = x.shape
        cap = max(int(s * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_num_experts), 1)
        _, _, top_e = moe.route(p, x, cfg)
        kept = moe.slot_maps(top_e.reshape(b, -1), cfg.moe_num_experts, cfg.moe_top_k, cap)[3]
        seen.append((int((~kept).sum()), kept.numel()))
        return block(p, x, cfg)

    with mock.patch.object(transformer, "moe_block", counting):
        build_prefill_step(model, summary["max_len"])({"tokens": summary["prompts"].to(model.device)})
    dropped, routed = sum(d for d, _ in seen), sum(n for _, n in seen)
    return {"moe_layers": len(seen), "dropped": dropped, "routed": routed,
            "dropped_share": dropped / routed,
            "per_layer_share": [d / n for d, n in seen]}


def attention_serve_path(argv, *, graph_required: bool = True) -> tuple[dict, dict]:
    """Drive ``repro_torch.launch.serve`` with ``argv`` on a model whose
    every layer attends (counts zeroed just before); check one flash launch
    a layer in the prefill, one decode launch a layer and step, no other
    kernel, tokens in range, finite logits and (when ``graph_required``)
    decode through the captured graph; return its numbers and the run's
    summary."""
    import torch

    from repro_torch.launch.serve import build_parser, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=(steps - 1,))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = summary["model"].cfg
    print(f"launches {launches}; params {summary['params']:,d} (cfg.param_count() "
          f"{cfg.param_count():,d}); prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} tok/s "
          f"(all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    want = {"flash_attention": cfg.num_layers, "decode_attention": cfg.num_layers * steps,
            "ssd_scan": 0, "chunk_gather_train": 0, "chunk_gather": 0}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times, expected {n}")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(x).all())
               for x in (summary["prefill_logits"], summary["logits"][steps - 1])):
        fail("a kept logit is not finite")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    run = {"launches": {k: launches[k] for k in ("flash_attention", "decode_attention")},
           "params": summary["params"], "param_count": cfg.param_count(),
           "prefill_s": summary["prefill_s"], "decode_s": summary["decode_s"],
           "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30,
           "decode_graph": decode_graph(summary, required=graph_required)}
    return run, summary


def moe_path(argv) -> tuple[dict, dict]:
    """:func:`attention_serve_path` on deepseek-moe-16b, then the share of
    the prefill's routed assignments that capacity dropped."""
    run, summary = attention_serve_path(argv)
    cfg = summary["model"].cfg
    drops = moe_prefill_drops(summary)
    print(f"prefill capacity drops (capacity factor {cfg.capacity_factor}): "
          f"{drops['dropped']:,d} of {drops['routed']:,d} routed assignments over "
          f"{drops['moe_layers']} MoE layers, share {drops['dropped_share']:.4%} (per layer "
          f"{min(drops['per_layer_share']):.4%}-{max(drops['per_layer_share']):.4%}); decode "
          f"drops none (one token's top-{cfg.moe_top_k} experts are distinct, cap 1)")
    if drops["moe_layers"] != cfg.num_layers - cfg.moe_first_dense:
        fail(f"the prefill ran {drops['moe_layers']} MoE layers")
    run["prefill_drops"] = drops
    return run, summary


def stale_cache_reading(summary, t: int) -> dict:
    """The planted fault: decode step ``t`` against a cache one token
    stale, the K/V of token ``t - 1`` (position pos0 + t - 1, pos0 the
    prompt length, after a patch arch's patches) never written (its slot
    zero in every layer), held to the same fresh prefill as the sound
    step."""
    import torch

    from repro_torch.launch.serve import prefill_agreement
    from repro_torch.train.train_step import build_prefill_step

    model = summary["model"]
    pos0 = summary.get("pos0", summary["prompts"].shape[1])
    seq = torch.cat([summary["prompts"], summary["tokens"][:, :t + 1]], dim=1).to(model.device)
    _, cache = build_prefill_step(model, summary["max_len"])(
        {"tokens": seq[:, :-1], **summary.get("extra", {})})
    with torch.inference_mode():
        for entry in cache:
            entry["k"][:, :, pos0 + t - 1] = 0
            entry["v"][:, :, pos0 + t - 1] = 0
    with torch.inference_mode():  # one step: the eager step, no graph to capture
        logits, _ = model.decode_step(cache, seq[:, -1:], pos0 + t)
    del cache
    (row,) = prefill_agreement({**summary, "logits": {t: logits[:, 0].float()}}, (t,))
    return row


def moe_agreement(argv) -> dict:
    """Decode against a fresh prefill on deepseek-moe-16b at full width and
    depth, at ``NO_DROP_CAPACITY`` and in f32 (one sequence: 65.5 GB of
    weights), at phase 5's four positions, and the planted stale-cache
    fault, which must read above the bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), capacity_factor=NO_DROP_CAPACITY,
                              param_dtype="float32", compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    with patched_config(cfg):
        summary = serve(args, keep_logits=AGREEMENT_STEPS)
    rows = prefill_agreement(summary, AGREEMENT_STEPS)
    stale = stale_cache_reading(summary, AGREEMENT_STEPS[-1])
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        print(f"f32, capacity factor {cfg.capacity_factor}: decode step {r['step']} vs a fresh "
              f"prefill of {args.prompt_len + r['step'] + 1} tokens: scale-normalised err "
              f"{r['err']:.3e} (tolerance {F32_AGREEMENT_TOL}), argmax agrees on "
              f"{r['argmax_agree']}/{r['rows']} rows")
    print(f"planted fault, the cache one token stale at step {stale['step']}: err "
          f"{stale['err']:.3e}, argmax agrees on {stale['argmax_agree']}/{stale['rows']}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if not stale["err"] > F32_AGREEMENT_TOL:
        fail("the bound does not tell a cache one token stale from a sound one")
    for r in rows:
        if not (r["err"] <= F32_AGREEMENT_TOL and r["argmax_agree"] == r["rows"]):
            fail(f"decode step {r['step']} disagrees with a fresh prefill")
    del summary
    return {"capacity_factor": cfg.capacity_factor, "dtype": cfg.param_dtype,
            "batch": args.batch, "agreement": rows, "stale_cache": stale,
            "max_memory_allocated_gib": peak / 2**30}


# -------------------------------------------------------------- phase 10
def slstm_prefill_share(summary) -> dict:
    """One more prefill of the served prompts with each sLSTM block timed
    between device synchronisations: the sLSTM blocks' share of it."""
    import torch

    import repro_torch.models.transformer as transformer
    from repro_torch.train.train_step import build_prefill_step

    model = summary["model"]
    entry = transformer._RECURRENT["slstm"]
    spent = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = entry[0](*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    prefill = build_prefill_step(model, summary["max_len"])
    prompts = summary["prompts"].to(model.device)
    with mock.patch.dict(transformer._RECURRENT, {"slstm": (timed, *entry[1:])}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill({"tokens": prompts})
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return {"slstm_blocks": len(spent), "slstm_s": sum(spent), "prefill_s": total,
            "share": sum(spent) / total}


def xlstm_path(argv) -> tuple[dict, dict]:
    """Drive ``repro_torch.launch.serve`` on xlstm-350m with ``argv``; check
    it; return its numbers (counts zeroed just before: this path launches
    no kernel)."""
    import torch

    from repro_torch.launch.serve import build_parser, serve

    args = build_parser().parse_args(argv)
    steps = args.new_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    summary = serve(args, keep_logits=(steps - 1,))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = summary["model"].cfg
    print(f"launches {launches}; params {summary['params']:,d} (cfg.param_count() "
          f"{cfg.param_count():,d}); prefill {summary['prefill_s']:.4f} s; decode "
          f"{summary['decode_s']:.4f} s for {steps} steps, {summary['decode_tok_s']:.1f} tok/s "
          f"(all steps), {summary['steady_decode_tok_s']:.1f} tok/s (steps 2-{steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if any(launches.values()):
        fail(f"the xLSTM path launched kernels: {launches} (it has none)")
    tokens = summary["tokens"]
    if tokens.shape != (args.batch, args.new_tokens) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens {tuple(tokens.shape)} out of shape or range [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(x).all())
               for x in (summary["prefill_logits"], summary["logits"][steps - 1])):
        fail("a kept logit is not finite")
    share = slstm_prefill_share(summary)
    print(f"sLSTM blocks in a prefill (each between synchronisations): {share['slstm_blocks']} "
          f"blocks, {share['slstm_s']:.4f} s of {share['prefill_s']:.4f} s, share "
          f"{share['share']:.2%}")
    print("first sequence:", tokens[0, :16].tolist(), "...")
    run = {"launches": launches, "params": summary["params"],
           "param_count": cfg.param_count(), "prefill_s": summary["prefill_s"],
           "decode_s": summary["decode_s"], "decode_tok_s": summary["decode_tok_s"],
           "steady_decode_tok_s": summary["steady_decode_tok_s"],
           "max_memory_allocated_gib": peak / 2**30, "slstm_prefill": share,
           "decode_graph": decode_graph(summary)}
    return run, summary


def xlstm_agreement(argv) -> dict:
    """Decode step ``XLSTM_AGREEMENT_STEP`` against a fresh prefill of its
    2048 tokens (8 mLSTM chunks) on xlstm-350m at full width, in f32: the
    logits and the 21 mLSTM ``C``/``n`` and 3 sLSTM ``c``/``n``/``h``/``m``
    states; and the planted fault, the states one token stale, which must
    read above every state bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, prefill_agreement, serve

    args = build_parser().parse_args(argv)
    step = XLSTM_AGREEMENT_STEP
    cfg = dataclasses.replace(get_config(args.arch), param_dtype="float32",
                              compute_dtype="float32")
    with patched_config(cfg):
        summary = serve(args, keep_logits=(step,), keep_states=(step - 1, step))
    (row,) = prefill_agreement(summary, (step,))
    (stale,) = prefill_agreement({**summary, "states": {step: summary["states"][step - 1]}},
                                 (step,))
    row["stale_state_err"] = stale["state_err"]
    print(f"f32: decode step {step} vs a fresh prefill of {args.prompt_len + step + 1} tokens: "
          f"logits scale-normalised err {row['err']:.3e} (tolerance {F32_AGREEMENT_TOL}), "
          f"argmax agrees on {row['argmax_agree']}/{row['rows']} rows; states "
          + ", ".join(f"{k} {v:.3e} (tolerance {XLSTM_STATE_TOL[k]})"
                      for k, v in row["state_err"].items())
          + "; planted fault, the states one token stale: "
          + ", ".join(f"{k} {v:.3e}" for k, v in stale["state_err"].items()))
    if sorted(row["state_err"]) != sorted(XLSTM_STATE_TOL):
        fail(f"the check compared the leaves {sorted(row['state_err'])}")
    if not all(stale["state_err"][k] > tol for k, tol in XLSTM_STATE_TOL.items()):
        fail("the state bounds do not tell a state one token stale from a sound one")
    if not (row["err"] <= F32_AGREEMENT_TOL and row["argmax_agree"] == row["rows"]
            and all(row["state_err"][k] <= tol for k, tol in XLSTM_STATE_TOL.items())):
        fail(f"decode step {step} disagrees with a fresh prefill")
    del summary
    return {"dtype": cfg.param_dtype, "agreement": row}


# -------------------------------------------------------------- phase 11
def vlm_path(argv) -> tuple[dict, dict]:
    """:func:`attention_serve_path` on llava-next-34b (zero patches before
    each prompt, as the reference serves them), then its decode positions
    (after the patches and the prompt) and its peak memory (within the
    card)."""
    import torch

    run, summary = attention_serve_path(argv)
    cfg = summary["model"].cfg
    prompt_len = summary["prompts"].shape[1]
    print(f"prefill of {cfg.frontend_len} patches and {prompt_len} tokens; decode from "
          f"position {summary['pos0']}")
    if summary["pos0"] != cfg.frontend_len + prompt_len:
        fail(f"decode starts at position {summary['pos0']}, not after the patches and prompt")
    total = torch.cuda.get_device_properties(0).total_memory
    if run["max_memory_allocated_gib"] * 2**30 >= total:
        fail(f"peak device memory {run['max_memory_allocated_gib']:.2f} GiB")
    run["prefill_tokens"] = cfg.frontend_len + prompt_len
    return run, summary


def vlm_agreement(summary, new_tokens: int) -> dict:
    """Phase 11c: decode against a fresh prefill on the served llava-next-34b,
    bf16, full width. The serving cache is a ring of prompt + new slots (the
    reference's rule), so decode there is not a fresh prefill's last
    position; this check sizes its own cache to hold every position
    (patches, prompt and ``new_tokens``), prefills seeded random patches
    (so the projection counts) before the served prompts, decodes greedily,
    and holds steps VLM_AGREEMENT_STEPS to phase 5's bounds (argmax equal
    on all rows but one), and the planted stale-cache fault above them."""
    import torch

    from repro_torch.launch.serve import prefill_agreement
    from repro_torch.train.train_step import build_decode_step, build_prefill_step

    model = summary["model"]
    cfg, device = model.cfg, model.device
    prompts = summary["prompts"]
    b, p = prompts.shape
    gen = torch.Generator(device=device).manual_seed(11)
    patches = torch.randn((b, cfg.frontend_len, cfg.frontend_dim), generator=gen,
                          device=device).to(getattr(torch, cfg.compute_dtype))
    pos0 = cfg.frontend_len + p
    max_len = pos0 + new_tokens
    torch.cuda.reset_peak_memory_stats()
    logits, cache = build_prefill_step(model, max_len)(
        {"tokens": prompts.to(device), "patch_embeds": patches})
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    out, kept = [tok], {}
    decode = build_decode_step(model)
    for t in range(new_tokens - 1):
        logits, cache = decode(cache, tok, pos0 + t)
        tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
        if t in VLM_AGREEMENT_STEPS:  # a copy: the graph's next replay overwrites its logits
            kept[t] = logits[:, 0].to(torch.float32, copy=True)
    del cache, logits
    check = {"model": model, "prompts": prompts, "tokens": torch.cat(out, 1).cpu(),
             "logits": kept, "extra": {"patch_embeds": patches}, "pos0": pos0,
             "max_len": max_len}
    rows = prefill_agreement(check, VLM_AGREEMENT_STEPS)
    stale = stale_cache_reading(check, VLM_AGREEMENT_STEPS[-1])
    peak = torch.cuda.max_memory_allocated()
    min_rows = b - 1
    for r in rows:
        print(f"{cfg.compute_dtype}: decode step {r['step']} vs a fresh prefill of {cfg.frontend_len} patches "
              f"and {p + r['step'] + 1} tokens (cache {max_len} slots): scale-normalised err "
              f"{r['err']:.3e} (tolerance {AGREEMENT_TOL}), argmax agrees on "
              f"{r['argmax_agree']}/{r['rows']} rows (at least {min_rows})")
    print(f"planted fault, token t - 1's K/V zeroed at step {stale['step']}: err "
          f"{stale['err']:.3e}, argmax agrees on {stale['argmax_agree']}/{stale['rows']}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if not stale["err"] > AGREEMENT_TOL:
        fail("the bound does not tell a cache one token stale from a sound one")
    for r in rows:
        if not (r["err"] <= AGREEMENT_TOL and r["argmax_agree"] >= min_rows):
            fail(f"decode step {r['step']} disagrees with a fresh prefill")
    return {"cache_slots": max_len, "agreement": rows, "stale_cache": stale,
            "max_memory_allocated_gib": peak / 2**30}


# -------------------------------------------------------------- phase 12
def encoder_path() -> dict:
    """Phase 12: ``repro_torch.launch.train`` on hubert-xlarge with
    Adafactor (ENCODER_ARGS, the first loss near ln(504)), then 3 steps
    with SGDM (ENCODER_SGDM_ARGS); each run checked as phase 4's is, its
    one-hot frames held to the host stream's tokens."""
    run = main_path(ENCODER_ARGS, batch=8, seq_len=2048, vocab=504)
    run["sgdm"] = main_path(ENCODER_SGDM_ARGS, batch=8, seq_len=2048, vocab=504)
    return run


def vecq_check(device) -> dict:
    """Phase 12c: phi3-medium-14b at full width, its depth cut to
    VECQ_LAYERS, B = 1, S = 4096, bf16. ``_chunked_attention_vecq`` (4
    query blocks of 1024, all at once) against ``_chunked_attention`` on
    the same q/k/v (40 query heads, 10 kv heads expanded, head dim 128),
    scale-normalised within VECQ_TOL; then 2 AdamW train steps through
    ``attention_block``, which on plain bf16 tensors on one card must take
    the flash training kernels (a backward launch a layer a step), with
    finite losses (the first near ln(vocab))."""
    import numpy as np
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels.flash_attention.ops import train_calls
    from repro_torch.models import attention, build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import build_train_step, init_train_state

    cfg = dataclasses.replace(get_config("phi3-medium-14b"), num_layers=VECQ_LAYERS)
    s, h, kvh, d = VECQ_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator(device=device).manual_seed(12)
    q = torch.randn(1, s, h, d, generator=gen, device=device).bfloat16()
    k, v = (attention._expand_kv(torch.randn(1, s, kvh, d, generator=gen, device=device)
                                 .bfloat16(), cfg) for _ in range(2))
    with torch.no_grad():
        got = attention._chunked_attention_vecq(q, k, v, cfg)
        want = attention._chunked_attention(q, k, v, cfg)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    print(f"_chunked_attention_vecq vs _chunked_attention, q (1, {s}, {h}, {d}), k/v {kvh} "
          f"heads expanded, bf16, {s // cfg.attn_chunk} query blocks: scale-normalised err "
          f"{err:.3e} (tolerance {VECQ_TOL})")
    if not err <= VECQ_TOL or not torch.isfinite(got.float()).all():
        fail(f"_chunked_attention_vecq disagrees with _chunked_attention: {err:.3e}")
    del q, k, v, got, want
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device)
    run = RunConfig()
    opt = make_optimizer(run)
    state = init_train_state(model, opt, 0)
    step = build_train_step(model, run, opt)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (1, s + 1)).astype(np.int32)
    feed = {"tokens": torch.from_numpy(tokens[:, :-1]).to(device),
            "targets": torch.from_numpy(tokens[:, 1:]).to(device),
            "loss_mask": torch.ones((1, s), device=device)}
    losses, before = [], dict(train_calls)
    for _ in range(2):
        state, m = step(state, feed)
        losses.append(float(m["loss"]))
    calls = {k: train_calls[k] - before[k] for k in ("forward", "backward")}
    peak = torch.cuda.max_memory_allocated()
    print(f"phi3-medium-14b, {VECQ_LAYERS} layers at full width, B=1, S={s}, AdamW, remat "
          f"dots: losses {losses}; flash training launches {calls} (forward with the remat "
          f"recompute, backward); max_memory_allocated {peak / 2**30:.2f} GiB")
    if calls["backward"] != 2 * VECQ_LAYERS:
        fail(f"attention_block took the flash training kernels {calls} in 2 steps")
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - math.log(cfg.vocab_size)) > 2:
        fail(f"phi3 losses {losses}: not finite, or the first not near ln({cfg.vocab_size})")
    del model, state
    return {"layers": VECQ_LAYERS, "seq_len": s, "vecq_err": err, "flash_calls": calls,
            "losses": losses, "max_memory_allocated_gib": peak / 2**30}


# -------------------------------------------------------------- phase 13
@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL group, a 1x1 ("data", "model") mesh on the card, and
    its activation rules installed as the sharding context."""
    import torch.distributed as dist

    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.axes import sharding_ctx
    from repro_torch.parallel.sharding import make_rules

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with sharding_ctx(make_rules(mesh, RunConfig())):
            yield mesh
    finally:
        dist.destroy_process_group()


def a2a_prefill_drops(summary) -> dict:
    """One more prefill of the served prompts, counting at each
    ``moe_block_a2a`` call the assignments each capacity stage routed and
    dropped (``cap_pair``, then ``cap_local``)."""
    import repro_torch.models.transformer as transformer
    from repro_torch.train.train_step import build_prefill_step

    model, seen = summary["model"], []
    block = transformer.moe_block_a2a

    def counting(p, x, cfg):
        drops = {}
        out = block(p, x, cfg, drops=drops)
        seen.append(drops)
        return out

    with mock.patch.object(transformer, "moe_block_a2a", counting):
        build_prefill_step(model, summary["max_len"])(
            {"tokens": summary["prompts"].to(model.device)})
    out = {"moe_layers": len(seen)}
    for stage in ("pair", "local"):
        dropped = sum(d[f"{stage}_dropped"] for d in seen)
        routed = sum(d[f"{stage}_routed"] for d in seen)
        out[stage] = {"dropped": dropped, "routed": routed, "dropped_share": dropped / routed}
    return out


def a2a_buffers(cfg, batch: int, seq: int) -> dict:
    """``moe_block_a2a``'s capacities on one rank and the bytes of its
    send and expert buffers, in the compute dtype."""
    from repro_torch.models.moe import a2a_capacities

    cap_pair, cap_local = a2a_capacities(cfg, batch, seq, 1, 1)
    size = 2 if cfg.compute_dtype == "bfloat16" else 4
    return {"cap_pair": cap_pair, "cap_local": cap_local,
            "send_bytes": cap_pair * cfg.d_model * size,
            "expert_buffer_bytes": cfg.moe_num_experts * cap_local * cfg.d_model * size}


def a2a_path(argv, moe_run: dict) -> tuple[dict, dict]:
    """Phase 9's serving run with ``moe_impl="a2a"`` under a one-rank mesh
    (:func:`attention_serve_path`'s checks), each stage's drop share, and
    decode and prefill profiles beside phase 9's numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser

    args = build_parser().parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), moe_impl="a2a")
    buffers = a2a_buffers(cfg, args.batch, args.prompt_len)
    print(f"one rank, capacity factor {cfg.capacity_factor}: cap_pair {buffers['cap_pair']:,d} "
          f"rows, a send buffer of {buffers['send_bytes'] / 1e9:.3f} GB; cap_local "
          f"{buffers['cap_local']:,d}, an expert buffer of "
          f"{buffers['expert_buffer_bytes'] / 1e9:.3f} GB")
    with one_rank_mesh(), patched_config(cfg):
        # build_decode_step's rule: a graph unless the mesh spans more than one device
        run, summary = attention_serve_path(argv, graph_required=False)
        step = "captured graph" if run["decode_graph"]["captured"] else "eager step"
        print(f"phase 13 decoded through the {step} (a sharding context over a 1x1 mesh is "
              f"installed)")
        drops = a2a_prefill_drops(summary)
        if drops["moe_layers"] != cfg.num_layers - cfg.moe_first_dense:
            fail(f"the a2a prefill ran {drops['moe_layers']} MoE layers")
        print(f"capacity drops over {drops['moe_layers']} MoE layers: per pair "
              f"{drops['pair']['dropped']:,d} of {drops['pair']['routed']:,d} "
              f"({drops['pair']['dropped_share']:.4%}), per local expert "
              f"{drops['local']['dropped']:,d} of {drops['local']['routed']:,d} "
              f"({drops['local']['dropped_share']:.4%})")
        run.update(buffers=buffers, drops=drops)
        run["decode_profile"] = where_decode_time_goes(summary)
        print("prefill through moe_block_a2a:")
        run["prefill_profile"] = where_prefill_time_goes(summary, "flash_attention")
        summary["model"].cfg = dataclasses.replace(cfg, moe_impl="gspmd")
        print("prefill of the same weights through moe_block:")
        run["gspmd_prefill_profile"] = where_prefill_time_goes(summary, "flash_attention")
        summary["model"].cfg = cfg
    steps = run["decode_profile"]["steps"] - 2
    nine = moe_run["decode_profile"]
    print(f"beside phase 9 (moe_block): prefill {run['prefill_s']:.4f} s vs "
          f"{moe_run['prefill_s']:.4f} s; steady decode {run['steady_decode_tok_s']:.1f} vs "
          f"{moe_run['steady_decode_tok_s']:.1f} tok/s; decode device busy "
          f"{run['decode_profile']['busy_ms'] / steps:.3f} vs {nine['busy_ms'] / steps:.3f} "
          f"ms a step; prefill device busy {run['prefill_profile']['busy_ms']:.2f} ms (a2a) vs "
          f"{run['gspmd_prefill_profile']['busy_ms']:.2f} ms (moe_block, same weights)")
    run["phase9"] = {"prefill_s": moe_run["prefill_s"],
                     "steady_decode_tok_s": moe_run["steady_decode_tok_s"],
                     "decode_busy_ms_per_step": nine["busy_ms"] / steps}
    run["decode_busy_ms_per_step"] = run["decode_profile"]["busy_ms"] / steps
    torch.cuda.empty_cache()
    return run, summary


def _scaled_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def a2a_agreement(argv) -> dict:
    """``moe_block_a2a`` against ``moe_block`` on the same weights, f32,
    at capacities where neither drops (both must count 0), depth cut to
    A2A_CHECK_LAYERS at full width: the prefill logits and decode steps
    AGREEMENT_STEPS within F32_AGREEMENT_TOL, argmax equal on every row."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, serve

    args = build_parser().parse_args(argv)
    base = dataclasses.replace(get_config(args.arch), num_layers=A2A_CHECK_LAYERS,
                               param_dtype="float32", compute_dtype="float32")
    gspmd = dataclasses.replace(base, capacity_factor=NO_DROP_CAPACITY)
    a2a = dataclasses.replace(base, capacity_factor=A2A_CAPACITY, moe_impl="a2a")
    with patched_config(gspmd):
        ref = serve(args, keep_logits=AGREEMENT_STEPS)
    ref_drops = moe_prefill_drops(ref)
    ref = {k: ref[k] for k in ("prefill_logits", "logits", "tokens")}
    torch.cuda.empty_cache()
    with one_rank_mesh(), patched_config(a2a):
        got = serve(args, keep_logits=AGREEMENT_STEPS)
        drops = a2a_prefill_drops(got)
    print(f"drops: moe_block at capacity factor {NO_DROP_CAPACITY} {ref_drops['dropped']} of "
          f"{ref_drops['routed']:,d}; a2a at {A2A_CAPACITY} {drops['pair']['dropped']} of "
          f"{drops['pair']['routed']:,d} per pair, {drops['local']['dropped']} of "
          f"{drops['local']['routed']:,d} per local expert "
          f"({a2a_buffers(a2a, args.batch, args.prompt_len)})")
    if ref_drops["dropped"] or drops["pair"]["dropped"] or drops["local"]["dropped"]:
        fail("a capacity dropped an assignment where none may drop")
    rows = []
    pairs = [("prefill", got["prefill_logits"], ref["prefill_logits"])] + [
        (t, got["logits"][t], ref["logits"][t]) for t in AGREEMENT_STEPS]
    for step, a, b in pairs:
        row = {"step": step, "err": _scaled_err(a, b),
               "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum()), "rows": a.shape[0]}
        rows.append(row)
        print(f"a2a vs moe_block, f32, {A2A_CHECK_LAYERS} layers: {step}: scale-normalised err "
              f"{row['err']:.3e} (tolerance {F32_AGREEMENT_TOL}), argmax agrees on "
              f"{row['argmax_agree']}/{row['rows']} rows")
        if not (row["err"] <= F32_AGREEMENT_TOL and row["argmax_agree"] == row["rows"]):
            fail(f"the a2a MoE disagrees with moe_block at {step}")
    if not torch.equal(got["tokens"], ref["tokens"]):
        fail("the a2a and moe_block runs decoded different tokens")
    del got
    torch.cuda.empty_cache()
    return {"layers": A2A_CHECK_LAYERS, "dtype": "float32", "batch": args.batch,
            "capacity_factor": {"moe_block": NO_DROP_CAPACITY, "a2a": A2A_CAPACITY},
            "drops": {"moe_block": ref_drops["dropped"], "a2a": drops}, "agreement": rows}


def dryrun_cell() -> dict:
    """``python -m repro_torch.launch.dryrun`` for one cell on this host (a
    fake 512-rank group, meta tensors, no card): it must come back ok;
    prints its FLOPs, collective bytes by kind, memory and roofline row."""
    import os

    from repro_torch.launch import roofline

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as work:
        out = Path(work) / "dryrun.jsonl"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
                               "--out", str(out)], capture_output=True, text=True, env=env,
                              timeout=600)
        wall = time.perf_counter() - t0
        print(proc.stdout.strip())
        if proc.returncode != 0 or not out.exists():
            fail(f"the dry run exited {proc.returncode}: {proc.stderr[-3000:]}")
        rows = roofline.load_rows(out)
    (row,) = rows
    if row["status"] != "ok":
        fail(f"the dry-run cell is {row['status']}: {row['error']}")
    (an,) = roofline.analyze(rows)
    print(f"dry run {row['arch']} x {row['shape']} on {row['mesh']}: {wall:.1f} s wall "
          f"({'more' if wall > 120 else 'less'} than 120 s); flops/device "
          f"{row['flops_per_device']:.4e}, bytes/device {row['bytes_per_device']:.4e}, "
          f"collectives {row['collectives']}, memory {row['memory']}")
    print(roofline.to_markdown([an]))
    return {"wall_s": wall, "cell": row, "roofline": an}


# -------------------------------------------------------------- phase 14
def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = HERE / "examples" / f"{name}.py"
    if not path.is_file():
        fail(f"no example at {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Tee(io.TextIOBase):
    """A stdout that still prints and keeps a copy of what it printed."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, s: str) -> int:
        self.out.write(s)
        return self.copy.write(s)

    def flush(self) -> None:
        self.out.flush()


def run_printing(fn, *args):
    """``fn(*args)`` and what it printed."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(*args)
    return result, tee.copy.getvalue()


def example_training() -> dict:
    """``examples/train_lm_torch.py`` at EXAMPLE_TRAIN_ARGS in a fresh
    workdir for EXAMPLE_TRAIN_STEPS[0] steps, then resumed there to
    EXAMPLE_TRAIN_STEPS[1] on the first run's chunk store; each run checked
    as phase 4's is (one gather launch a staged batch, every staged batch
    equal to the host stream of a fresh loader on the store, finite losses,
    printed ones included; the first near ln(vocab)), the second for its
    resume from the first's last checkpoint (a lower loss than the init's
    on the same first batch)."""
    import re

    import torch

    example = load_example("train_lm_torch")
    preset = EXAMPLE_TRAIN_ARGS[EXAMPLE_TRAIN_ARGS.index("--preset") + 1]
    vocab = example.PRESETS[preset]["vocab_size"]
    batch_tokens = example.PRESETS[preset]["batch"] * example.PRESETS[preset]["seq"]
    first_steps, resumed_steps = EXAMPLE_TRAIN_STEPS
    runs, store = [], None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as work:
        for steps, expect in ((first_steps, None),
                              (resumed_steps, f"resumed from step {first_steps}")):
            argv = EXAMPLE_TRAIN_ARGS + ["--steps", str(steps), "--workdir", work]
            print(f"$ python examples/train_lm_torch.py {' '.join(argv)}", flush=True)
            args = example.parse_args(argv)
            staged = []
            torch.cuda.synchronize()
            zero_launches()
            summary, out = run_printing(
                lambda: example.train(args, on_batch=lambda step, feed: staged.append(feed),
                                      store=store))
            launches = read_launches()
            store = summary["store"]
            stats = summary["device_stats"]
            losses = summary["losses"]
            printed = [float(x) for x in re.findall(r"^step +\d+ epoch \d+ loss (\S+)", out,
                                                    re.MULTILINE)]
            gathers = launches["chunk_gather_train"]
            # The steady window (steps 2+) holds the checkpoint saves; the
            # rate without them is the train step's own.
            steady_tokens = (len(losses) - 1) * batch_tokens
            steady_s = steady_tokens / summary["steady_tokens_per_s"]
            no_ckpt = steady_tokens / (steady_s - summary["ckpt_s"])
            print(f"launches {launches}; steady tokens/s {summary['steady_tokens_per_s']:.1f} "
                  f"(whole run {summary['tokens_per_s']:.1f}; {no_ckpt:.1f} without the "
                  f"{summary['ckpt_s']:.2f} s of checkpoint saves); stager wait "
                  f"{1e3 * stats.wait_s / max(len(losses), 1):.3f} ms a batch (host clock); "
                  f"{stats.steps} staged batches")
            if gathers == 0 or gathers != stats.steps or gathers != stats.kernel_steps:
                fail(f"kernel launches {gathers} != staged batches {stats.steps}")
            if len(losses) != steps - summary["start"] or not printed or not all(
                    math.isfinite(x) for x in losses + printed):
                fail(f"expected {steps - summary['start']} finite losses, got {losses} "
                     f"(printed {printed})")
            if expect is not None and expect not in out:
                fail(f"the second run did not print '{expect}'")
            if f"done: {steps} steps" not in out:
                fail(f"the run did not print 'done: {steps} steps'")
            # Each run starts again at epoch 0's first batch.
            _, host_loader = example.build_loader(store, preset, args.nodes)
            hold_to_host_stream(f"the example's run to {steps}", staged,
                                host_loader.epoch(0))
            runs.append({"steps": steps, "start": summary["start"], "launches": gathers,
                         "optim_launches": launches["fused_adamw"], "losses": losses,
                         "printed_losses": printed,
                         "tokens_per_s": summary["tokens_per_s"],
                         "steady_tokens_per_s": summary["steady_tokens_per_s"],
                         "ckpt_s": summary["ckpt_s"],
                         "steady_tokens_per_s_without_ckpt": no_ckpt,
                         "stager_wait_ms_a_batch": 1e3 * stats.wait_s / max(len(losses), 1),
                         "staged_batches": stats.steps})
            del staged
            torch.cuda.empty_cache()
        store.close()
    fresh, resumed = runs
    if abs(fresh["losses"][0] - math.log(vocab)) > 2.0:
        fail(f"first loss {fresh['losses'][0]} is not near ln({vocab}) at random init")
    # The resumed run starts again at epoch 0's first batch, on the weights
    # of step 40: a restore that kept the init would read the init's loss.
    if not resumed["losses"][0] < fresh["losses"][0]:
        fail(f"the resumed run's first loss {resumed['losses'][0]} is not below the init's "
             f"{fresh['losses'][0]} on the same batch")
    return {"args": EXAMPLE_TRAIN_ARGS, "steps": EXAMPLE_TRAIN_STEPS, "runs": runs}


def hold_to_host_stream(what: str, staged: list, host) -> None:
    """Fail unless every staged feed equals the host stream's batch of the
    same step, key for key (tokens, targets, loss mask), exactly."""
    n = 0
    for i, (feed, ref) in enumerate(zip(staged, host)):
        for k in ("tokens", "targets", "loss_mask"):
            got = feed[k].cpu().numpy()
            if got.shape != ref[k].shape or not (got == ref[k]).all():
                fail(f"{what}: staged {k} of step {i} differs from the host stream")
        n += 1
    if n != len(staged):
        fail(f"{what}: the host stream ended after {n} of {len(staged)} staged batches")
    print(f"{what}: staged batches equal the host stream ({n} steps)")


def example_serving() -> dict:
    """``examples/serve_decode_torch.py`` at its defaults: the decode step
    captured, flash once per attention site and ssd_scan once per Mamba-2
    block in the prefill, decode attention once per site and decode step,
    read off the reduced layout; its ids equal to ``generate`` on the CPU
    with the same weights (f32, TF32 off)."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.models.transformer import ATTN_KINDS

    example = load_example("serve_decode_torch")
    args = example.build_parser().parse_args([])
    cfg = reduced(ARCHS[args.arch])
    sites = sum(count for kind, count in cfg.segments() if kind in ATTN_KINDS)
    mamba = sum(count for kind, count in cfg.segments() if kind == "mamba2")
    steps = args.new_tokens - 1
    want = {"flash_attention": sites, "ssd_scan": mamba, "decode_attention": sites * steps}
    print(f"$ python examples/serve_decode_torch.py ({args.arch} reduced: {mamba} Mamba-2 "
          f"blocks, {sites} attention sites; {steps} decode steps)", flush=True)
    torch.cuda.synchronize()
    zero_launches()
    summary, out = run_printing(example.main, [])
    launches = read_launches()
    print(f"launches {launches}, expected {want}; decode captured: {summary['captured']}")
    if f"decoded {args.new_tokens} tokens/seq" not in out:
        fail(f"the example did not print 'decoded {args.new_tokens} tokens/seq'")
    if not summary["captured"]:
        fail("the example's decode was not captured in a CUDA graph")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times, expected {n}")
    ids = summary["ids"]
    if ids.shape != (args.batch, args.new_tokens) or not (
            (ids >= 0) & (ids < cfg.vocab_size)).all():
        fail(f"ids {tuple(ids.shape)} out of shape or range [0, {cfg.vocab_size})")
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(summary["model"].state_dict())
    cpu_ids = example.generate(cpu_model, summary["prompts"], args.new_tokens,
                               args.prompt_len + args.new_tokens)
    print(f"ids equal to the CPU's on the same weights: {torch.equal(ids, cpu_ids)}")
    if not torch.equal(ids, cpu_ids):
        fail("the example's ids on the card differ from the CPU's on the same weights")
    # A functional check: at 4 x 24 tokens on 4 small blocks the printed
    # rate is the first call's warm-up and capture, not a decode rate.
    return {"arch": args.arch, "launches": {k: launches[k] for k in want},
            "captured": summary["captured"]}


# -------------------------------------------------------------- phase 15
def redox_loader(store):
    """``benchmarks/convergence.py``'s Redox cluster and loader over
    ``store``."""
    from repro_torch.core import Cluster, EpochSampler, RedoxLoader

    cluster = Cluster(store.plan, CONV_NODES, store=store, seed=2,
                      remote_memory_limit_bytes=CONV_REMOTE_LIMIT)
    sampler = EpochSampler(CONV_DOCS, CONV_NODES, seed=CONV_SAMPLER_SEED)
    return RedoxLoader(cluster, sampler, batch_per_node=CONV_BATCH // CONV_NODES,
                       seq_len=CONV_SEQ)


def redox_batches(tmp, epochs: int, memory_slots: int, stager):
    """``benchmarks/convergence.py``'s ``_redox_batches`` on the port, the
    batches staged by ``stager`` through ``epoch_device`` (on the card,
    assembled by ``chunk_gather_train``)."""
    from repro_torch.data import SyntheticTokenDataset

    ds = SyntheticTokenDataset(CONV_DOCS, CONV_VOCAB, mean_len=CONV_MEAN_LEN, seed=3)
    store = ds.build_store(Path(tmp) / f"chunks_{memory_slots}", CONV_CHUNK,
                           num_slots=memory_slots, seed=1)
    loader = redox_loader(store)
    for e in range(epochs):
        yield from loader.epoch_device(e, stager)


def redox_host_batches(tmp, epochs: int, memory_slots: int):
    """The host stream of :func:`redox_batches`: a fresh loader on the
    chunk store that :func:`redox_batches` built in ``tmp``."""
    from repro_torch.core import ChunkStore

    store = ChunkStore.open(Path(tmp) / f"chunks_{memory_slots}")
    try:
        loader = redox_loader(store)
        for e in range(epochs):
            yield from loader.epoch(e)
    finally:
        store.close()


def exact_shuffle_batches(epochs: int, sampler_seed: int = CONV_SAMPLER_SEED):
    """``benchmarks/convergence.py``'s ``_exact_shuffle_batches`` on the
    port: an exact global shuffle of the same records, as numpy grids."""
    from repro_torch.core import EpochSampler
    from repro_torch.core.loader import _to_grid
    from repro_torch.data import SyntheticTokenDataset

    ds = SyntheticTokenDataset(CONV_DOCS, CONV_VOCAB, mean_len=CONV_MEAN_LEN, seed=3)
    sampler = EpochSampler(CONV_DOCS, 1, seed=sampler_seed)
    for e in range(epochs):
        seq = sampler.global_sequence(e)
        for i in range(len(seq) // CONV_BATCH):
            recs = [ds.record_tokens(int(f)) for f in seq[i * CONV_BATCH:(i + 1) * CONV_BATCH]]
            tokens, mask = _to_grid(recs, CONV_SEQ + 1, 0)
            yield dict(tokens=tokens[:, :-1], targets=tokens[:, 1:], loss_mask=mask[:, 1:])


def convergence_losses(model, lr: float, batches, steps: int, *, on_batch=None,
                       profile_steps: int = 0):
    """Train ``model`` from its current weights with AdamW at ``lr`` on the
    first ``steps`` of ``batches``, as the reference's ``_train``; the
    per-step losses. ``on_batch(step, feed)``, when given, sees every feed
    before its step. With ``profile_steps``, the first ``profile_steps``
    steps run under ``torch.profiler`` (the card synchronised before the
    third and after the last), which is returned beside the losses."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import RunConfig
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import build_train_step, fresh_train_state

    run = RunConfig(optimizer="adamw", learning_rate=lr)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step_fn = build_train_step(model, run, opt)
    prof = None
    if profile_steps:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    losses = []
    for i, b in zip(range(steps), batches):
        feed = {k: torch.as_tensor(b[k]).to(model.device)
                for k in ("tokens", "targets", "loss_mask")}
        if on_batch is not None:
            on_batch(i, feed)
        if i < profile_steps:
            if i == 2:
                torch.cuda.synchronize()
            with record_function(f"chip_smoke.conv_step{i}"):
                pass
        state, metrics = step_fn(state, feed)
        losses.append(metrics["loss"].clone())  # the step may reuse its buffers
        if i == profile_steps - 1:
            torch.cuda.synchronize()
            prof.stop()
    losses = [float(x) for x in losses]
    return (losses, prof) if profile_steps else losses


def tail_mean(losses: list) -> float:
    """The mean of the last third of a curve (the reference's ``tail``)."""
    k = max(len(losses) // 6, 1)
    return statistics.fmean(losses[-2 * k:])


def convergence_cell(name: str, cfg, lr: float, epochs: int, steps: int, device, *,
                     yardstick: bool, profile_steps: int = 0) -> dict:
    """One convergence comparison: from one init, Redox at CONV_SLOTS and
    CONV_SMALL_SLOTS slots (through the gather, whose launches must equal
    the staged batches, and every fed batch equal to the host stream of a
    fresh loader on the same store) and the exact shuffle (staged plainly,
    no gather), with ``yardstick`` a second exact shuffle of another
    sampler seed; the tail means' gaps to the exact shuffle held to
    CONV_TAIL_TOL after the curves print. With ``profile_steps``, the first
    Redox run profiles its first steps (:func:`device_profile`'s numbers
    under ``profile``)."""
    import torch

    from repro_torch.core.device import DeviceStager
    from repro_torch.models import build_model

    params, profiled = None, None
    curves, launches, optim_launches = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_conv_") as tmp:
        runs = [("redox", CONV_SLOTS), ("exact", None), ("redox_small_mem", CONV_SMALL_SLOTS)]
        if yardstick:
            runs.append((f"exact_seed{CONV_YARDSTICK_SEED}", None))
        for run, slots in runs:
            model = build_model(cfg, device=device).init(CONV_INIT_SEED)
            params = sum(p.numel() for p in model.parameters())
            stager = DeviceStager(device=device) if slots else None
            batches = (redox_batches(tmp, epochs, slots, stager) if slots else
                       exact_shuffle_batches(epochs, CONV_YARDSTICK_SEED if "seed" in run
                                             else CONV_SAMPLER_SEED))
            fed = []
            profiling = profile_steps if run == "redox" else 0
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            curves[run] = convergence_losses(
                model, lr, batches, steps, profile_steps=profiling,
                on_batch=(lambda i, feed: fed.append(feed)) if slots else None)
            if profiling:
                curves[run], profiled = curves[run]
            wall = time.perf_counter() - t0
            batches.close()  # tears the stager's stream down before the counts are read
            counts = read_launches()
            launches[run], optim_launches[run] = counts["chunk_gather_train"], counts["fused_adamw"]
            staged = 0
            if stager is not None:
                stager.close()
                staged = stager.stats.steps
                if (launches[run] < steps or launches[run] != staged
                        or launches[run] != stager.stats.kernel_steps):
                    fail(f"{name} {run}: {launches[run]} gather launches for {staged} staged "
                         f"batches and {steps} steps")
                hold_to_host_stream(f"{name} {run}", fed,
                                    redox_host_batches(tmp, epochs, slots))
            elif launches[run]:
                fail(f"{name} {run}: the exact shuffle launched the gather")
            print(f"{name} {run}: {steps} steps in {wall:.1f} s, {launches[run]} gather "
                  f"launches ({staged} staged batches)"
                  + (f", the first {profiling} profiled" if profiling else ""), flush=True)
            del model, fed
            torch.cuda.empty_cache()
    k = max(steps // 6, 1)
    print(f"{name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{params:,d} parameters, AdamW {lr}, B {CONV_BATCH} x S {CONV_SEQ}, {steps} steps")
    print(f"{'step':>5s} " + " ".join(f"{run:>16s}" for run in curves))
    for i in range(0, steps, k):
        print(f"{i:5d} " + " ".join(f"{c[i]:16.4f}" for c in curves.values()))
    tails = {run: tail_mean(c) for run, c in curves.items()}
    gaps = {run: abs(t - tails["exact"]) for run, t in tails.items() if run != "exact"}
    print(f"tail-mean loss: {json.dumps(tails)}; gaps to the exact shuffle {json.dumps(gaps)} "
          f"(bound {CONV_TAIL_TOL} for the Redox runs)")
    if not all(math.isfinite(x) for c in curves.values() for x in c):
        fail(f"{name}: a loss is not finite")
    for run in ("redox", "redox_small_mem"):
        if not gaps[run] < CONV_TAIL_TOL:
            fail(f"{name}: {run}'s tail mean lies {gaps[run]:.4f} from the exact shuffle's "
                 f"(bound {CONV_TAIL_TOL})")
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model, "params": params, "lr": lr,
           "steps": steps, "tail_means": tails, "gaps": gaps, "launches": launches,
           "optim_launches": optim_launches, "curves": {run: c[::k] for run, c in curves.items()}}
    if profiled is not None:
        print(f"-- where {name}'s step time goes (torch.profiler, its Redox run's steps "
              f"3-{profile_steps})", flush=True)
        out["profile"] = device_profile(profiled, "chip_smoke.conv_step2",
                                        "chunk_gather_train_kernel", profile_steps - 2)
    return out


def convergence_path(device) -> dict:
    """Phase 15: 15a at the reference's size (reduced tinyllama, 2 layers,
    AdamW 3e-3, 120 steps), 15b at the 100m preset's widths
    (CONV_WIDE_STEPS, AdamW 3e-4) with the yardstick, its Redox run's
    first 6 steps profiled (15c); both cells at vocab CONV_VOCAB in f32."""
    from repro_torch.configs import ARCHS, reduced

    preset = load_example("train_lm_torch").preset_config("100m")
    small = dataclasses.replace(reduced(ARCHS["tinyllama-1.1b"]), vocab_size=CONV_VOCAB,
                                num_layers=2)
    wide = dataclasses.replace(preset, vocab_size=CONV_VOCAB)
    out = {"15a": convergence_cell("15a", small, 3e-3, 3, 120, device, yardstick=False)}
    print("-- 15b", flush=True)
    out["15b"] = convergence_cell("15b", wide, 3e-4, 3, CONV_WIDE_STEPS, device,
                                  yardstick=True, profile_steps=6)
    return out


# -------------------------------------------------------------- phase 16
def seeded_feeds(cfg, batch: int, seq: int, steps: int, device, seed: int = 0) -> list:
    """``steps`` train feeds from numpy at ``seed`` (tokens over ``cfg``'s
    vocab, the next tokens as targets, a tenth of the positions masked),
    on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
        mask = (rng.random((batch, seq)) < 0.9).astype(np.float32)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in (("tokens", tokens[:, :-1]), ("targets", tokens[:, 1:]),
                                 ("loss_mask", mask))})
    return out


def train_step_of(model, run, opt, graph: bool):
    """``build_train_step``'s step, which must be the graph on the card, or
    the eager step it captures."""
    from repro_torch.train.train_step import GraphTrain, _eager_train_step, build_train_step

    if not graph:
        return _eager_train_step(model, run, opt)
    step = build_train_step(model, run, opt)
    if not isinstance(step, GraphTrain):
        fail(f"build_train_step gave {type(step).__name__} on the card, not GraphTrain")
    return step


def train_run(cfg, run, feeds, device, graph: bool) -> tuple[dict, list]:
    """From ``cfg``'s init at seed 0, one step a feed through the graph or
    the eager step; the state's leaves after the last step and each step's
    metrics."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import fresh_train_state

    model = build_model(cfg, device=device).init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = train_step_of(model, run, opt, graph)
    metrics = [step(state, feed)[1] for feed in feeds]
    if graph and not step.captured:
        fail("the graph step did not capture")
    torch.cuda.synchronize()
    return flatten_tree(state), metrics


def run_diffs(a: tuple, b: tuple) -> dict:
    """Per state leaf and per metric (over every step), the max abs
    difference between two :func:`train_run` results."""
    (sa, ma), (sb, mb) = a, b
    out = {k: float((sa[k].detach().float() - sb[k].detach().float()).abs().max())
           for k in sa}
    for key in ma[0]:
        out[f"metrics/{key}"] = max(float((x[key].float() - y[key].float()).abs().max())
                                    for x, y in zip(ma, mb))
    return out


def graph_against_eager_train(name: str, cfg, run, feeds, device) -> dict:
    """Phase 16a for one shape: the eager step twice, then the graph, each
    from the same init on the same feeds. The graph's difference from the
    first eager run, leaf by leaf and metric by metric, must not exceed the
    eager step's own from run to run: bit for bit where eager repeats
    itself."""
    import torch

    first = train_run(cfg, run, feeds, device, graph=False)
    spread = run_diffs(first, train_run(cfg, run, feeds, device, graph=False))
    torch.cuda.empty_cache()
    graph = run_diffs(first, train_run(cfg, run, feeds, device, graph=True))
    del first
    torch.cuda.empty_cache()
    over = {k: (graph[k], spread[k]) for k in graph if graph[k] > spread[k]}
    worst_spread, worst_graph = max(spread.values()), max(graph.values())
    repeats = worst_spread == 0
    print(f"{name}: {len(feeds)} steps, {len(graph)} state leaves and metrics; eager against "
          f"eager: max abs difference {worst_spread:.3e} "
          f"({'bit for bit' if repeats else 'eager does not repeat itself'}); graph against "
          f"eager: {worst_graph:.3e} (bound: eager's spread, leaf by leaf)")
    if over:
        fail(f"{name}: the graph differs from the eager step beyond eager's own spread: {over}")
    return {"steps": len(feeds), "leaves": len(graph), "eager_spread": worst_spread,
            "graph_diff": worst_graph, "eager_repeats": repeats,
            "bit_for_bit": worst_graph == 0}


def graph_train_cases():
    """Phase 16's shapes: (name, config, run config, batch, sequence)."""
    from repro_torch.configs import RunConfig, get_config

    preset = load_example("train_lm_torch").preset_config("100m")
    cases = [("tinyllama-1.1b full width, bf16, AdamW", get_config("tinyllama-1.1b"),
              RunConfig(optimizer="adamw", remat="dots"), 8, 2048)]
    for optimizer in GRAPH_OPTIMIZERS:
        cases.append((f"the 100m preset's widths, f32, {optimizer}", preset,
                      RunConfig(optimizer=optimizer, remat="dots"), 8, 512))
    return cases


def graph_agreement_train(device) -> dict:
    """Phase 16a: :func:`graph_against_eager_train` at every shape of
    :func:`graph_train_cases`, GRAPH_STEPS steps each."""
    out = {}
    for name, cfg, run, batch, seq in graph_train_cases():
        feeds = seeded_feeds(cfg, batch, seq, GRAPH_STEPS, device)
        out[name] = graph_against_eager_train(name, cfg, run, feeds, device)
    return out


def profile_train_step(cfg, run, feeds, device, *, graph: bool, label: str,
                       calls: int) -> dict:
    """Six steps on ``feeds`` from ``cfg``'s init, steps 3-6 profiled (the
    card synchronised before step 3's marker, after the capture): the idle
    share, device operations and busy ms a step (:func:`device_profile`);
    then the host time of a call and, for the graph, of a bare replay
    (:func:`alone_us`, ``calls`` calls), and the run's peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import fresh_train_state

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device).init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = train_step_of(model, run, opt, graph)
    for feed in feeds[:2]:
        step(state, feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, feed in enumerate(feeds[2:6], 2):
            with record_function(f"chip_smoke.{label}{i}"):
                pass
            step(state, feed)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} steps 3-6:")
    out = device_profile(prof, f"chip_smoke.{label}2", None, 4)
    out["busy_ms_per_step"] = out["busy_ms"] / 4
    out["host_us_per_call"] = alone_us(lambda: step(state, feeds[0]), calls)
    out["max_memory_allocated_gib"] = peak / 2**30
    if graph:
        out["graph_nodes"] = step.nodes
        out["host_us_per_replay"] = alone_us(step.graph.replay, calls)
    del model, state, step
    torch.cuda.empty_cache()
    return out


def where_graph_time_goes(device) -> dict:
    """Phase 16b: :func:`profile_train_step` with the graph and with the
    eager step in turn, at 15c's step (15b's config and shape, on the first
    six batches of its exact shuffle) and at phase 4's (tinyllama-1.1b full
    width, B = 8 x 2048, on seeded feeds)."""
    import torch

    from repro_torch.configs import RunConfig, get_config

    wide = dataclasses.replace(load_example("train_lm_torch").preset_config("100m"),
                               vocab_size=CONV_VOCAB)
    conv_feeds = [{k: torch.as_tensor(b[k]).to(device) for k in ("tokens", "targets",
                                                                "loss_mask")}
                  for _, b in zip(range(6), exact_shuffle_batches(1))]
    cells = {"15c": (wide, RunConfig(optimizer="adamw", learning_rate=3e-4), conv_feeds, 16),
             "4": (get_config("tinyllama-1.1b"), RunConfig(optimizer="adamw", remat="dots"),
                   seeded_feeds(get_config("tinyllama-1.1b"), 8, 2048, 6, device), 3)}
    out = {}
    for cell, (cfg, run, feeds, calls) in cells.items():
        both = {way: profile_train_step(cfg, run, feeds, device, graph=way == "graph",
                                        label=f"p{cell}_{way}", calls=calls)
                for way in ("graph", "eager")}
        g, e = both["graph"], both["eager"]
        print(f"phase {cell}'s step, graph against eager: idle share {g['idle_share']:.4f} / "
              f"{e['idle_share']:.4f}; device operations a step {g['ops_per_step']:.1f} / "
              f"{e['ops_per_step']:.1f} (graph nodes {g['graph_nodes']}); busy "
              f"{g['busy_ms_per_step']:.4f} / {e['busy_ms_per_step']:.4f} ms a step; window "
              f"{g['window_ms'] / 4:.4f} / {e['window_ms'] / 4:.4f} ms a step; host "
              f"{g['host_us_per_call']:.1f} / {e['host_us_per_call']:.1f} us a call "
              f"({g['host_us_per_replay']:.1f} us a bare replay); max_memory_allocated "
              f"{g['max_memory_allocated_gib']:.3f} / {e['max_memory_allocated_gib']:.3f} GiB",
              flush=True)
        out[cell] = both
        del feeds
    return out


def train_graph_path(device) -> dict:
    """Phase 16: the compiled train step (16a against the eager step, 16b
    where its time goes beside the eager step's)."""
    import torch

    out = {"16a": graph_agreement_train(device)}
    torch.cuda.empty_cache()
    out["16b"] = where_graph_time_goes(device)
    torch.cuda.empty_cache()
    out["16c"] = graph_leaves_stager_launches(device)
    return out


def graph_leaves_stager_launches(device) -> dict:
    """16c: while a reduced tinyllama step is captured, another thread
    stages one pack as the stager does (pinned buffers, their copies, the
    gather, on a side stream of its own). The gather must count one launch
    whatever the replays, the graph must hold none of it, and its grids
    must equal the plain gather's."""
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.kernels.chunk_gather.ops import chunk_gather_train
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.train_step import GraphTrain, build_train_step, fresh_train_state

    cfg = reduced(get_config("tinyllama-1.1b"))
    run = RunConfig(remat="dots")
    model = build_model(cfg, device=device).init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    if not isinstance(step, GraphTrain):
        fail(f"build_train_step gave {type(step).__name__} on the card, not GraphTrain")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32))
    feed = {"tokens": tokens[:, :-1].contiguous().to(device),
            "targets": tokens[:, 1:].contiguous().to(device),
            "loss_mask": torch.ones(4, 32, device=device)}
    pack = (rng.integers(0, cfg.vocab_size, (6, 48)).astype(np.int32),
            rng.integers(1, 48, 6).astype(np.int32), rng.permutation(6)[:4].astype(np.int32))
    gathered = []

    def stage():
        with torch.cuda.stream(torch.cuda.Stream(device)):
            dev = []
            for a in pack:
                host = torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
                host.numpy()[:] = a
                dev.append(host.to(device, non_blocking=True))
            gathered.append(chunk_gather_train(*dev, seq_len=32))

    eager_step = step.step

    def step_and_stage(state, batch):
        if torch.cuda.is_current_stream_capturing():
            stager = threading.Thread(target=stage)
            stager.start()
            stager.join()
        return eager_step(state, batch)

    step.step = step_and_stage
    zero_launches()
    for _ in range(4):
        step(state, feed)
    torch.cuda.synchronize()
    launches = read_launches()["chunk_gather_train"]
    in_graph = sum(n for w, n in step._launches if w is chunk_gather_train)
    want = chunk_gather_train(*(torch.from_numpy(a) for a in pack), seq_len=32)
    equal = len(gathered) == 1 and all(torch.equal(g.cpu(), w)
                                       for g, w in zip(gathered[0], want))
    print(f"16c: a gather staged on another thread during the capture: {launches} launch "
          f"counted over 4 steps, {in_graph} in the graph, grids equal to the plain "
          f"gather's: {equal}")
    if launches != 1 or in_graph or not equal:
        fail("16c: a gather staged during the capture was not counted as one launch "
             "outside the graph, or its grids differ from the plain gather's")
    return {"gather_launches": launches, "in_graph": in_graph, "grids_equal": equal}


def examples_and_convergence(phase, device) -> tuple:
    """Phases 14, 15 and 16 (the last phase: the clock stops after it)."""
    import torch

    phase("14. the examples: examples/train_lm_torch.py " + " ".join(EXAMPLE_TRAIN_ARGS)
          + " --steps {} then {}; examples/serve_decode_torch.py".format(*EXAMPLE_TRAIN_STEPS))
    examples_run = {"train": example_training(), "serve": example_serving()}
    torch.cuda.empty_cache()
    phase("15. convergence parity (paper Fig. 15 / Table 7): Redox against an exact "
          "shuffle, 15a reduced tinyllama, 15b the 100m preset's widths")
    conv_run = convergence_path(device)
    torch.cuda.empty_cache()
    phase("16. the compiled train step: 16a the graph against the eager step, 16b where "
          "their time goes, 16c a gather staged during the capture")
    graph_run = train_graph_path(device)
    phase(None)
    return examples_run, conv_run, graph_run


def optimizer_rows(device) -> dict:
    """Phase 3o: the clip and AdamW update over each ``OPTIM_CELLS``
    configuration's real parameter tree, the loop against the fused pass.
    From one state (two fused passes in, so m and v are not zero) kept on
    the host, a fused pass and the loop on the gradients clipped by the
    fused pass's own scale must leave every parameter, m, v and master
    equal bit for bit; then both are timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    from bench import harness
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.fused_adamw import ops as fused
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree
    from repro_torch.optim import optimizers

    def loop_route():
        """AdamW's update on card tensors through the loop, as on the CPU."""
        return mock.patch.object(fused, "takes", lambda *trees: False)

    rows = {}
    for workload in OPTIM_CELLS:
        cell = harness.load_cell(workload)
        meta = flatten_tree(build_model(harness.program_config(cell), device="meta").values())
        gen = torch.Generator(device=device).manual_seed(0)

        def draw(shape, dtype, std):
            return (torch.randn(shape, device=device, generator=gen) * std).to(dtype)

        params = {k: draw(v.shape, v.dtype, 0.02) for k, v in meta.items()}
        grads = {k: draw(v.shape, v.dtype, 1e-3) for k, v in meta.items()}
        hp = cell.train
        run = RunConfig(learning_rate=hp["learning_rate"], weight_decay=hp["weight_decay"],
                        grad_clip=hp["grad_clip"], master_fp32=hp["master_fp32"])
        opt = optimizers.make_optimizer(run)
        state = opt.init(params)
        step = torch.full((), 250, dtype=torch.int32, device=device)
        n = sum(t.numel() for t in params.values())
        if not fused.takes(grads, params, state["m"], state["v"], state["master"]):
            fail(f"{workload}: the fused kernels do not take the tree")

        def loop():
            with loop_route():
                return opt.update(grads, state, params, step, run.grad_clip)

        def fused_pass():
            return opt.update(grads, state, params, step, run.grad_clip)

        launches = fused.clip_adamw_.launches
        norms = [fused_pass(), fused_pass()]
        torch.cuda.synchronize()
        per_pass = (fused.clip_adamw_.launches - launches) // 2
        want = optimizers.global_norm(grads)
        norm_err = abs(float(norms[0]) / float(want) - 1)
        if not torch.equal(norms[0], norms[1]) or norm_err > 1e-6 or per_pass != 2:
            fail(f"{workload}: fused norms {float(norms[0])!r} / {float(norms[1])!r}, the "
                 f"loop's {float(want)!r} (relative {norm_err:.2e}), {per_pass} launches a pass")

        trees = {"param": params, "m": state["m"], "v": state["v"], "master": state["master"]}
        before = {name: {k: t.cpu() for k, t in tree.items()} for name, tree in trees.items()}
        norm = fused_pass()
        scale = optimizers.clip_scale(norm, run.grad_clip)
        differ = []
        with loop_route():
            for k, g in grads.items():
                ref = {name: {k: before[name][k].to(device)} for name in trees}
                opt.update({k: (g.float() * scale).to(g.dtype)},
                           {"m": ref["m"], "v": ref["v"], "master": ref["master"]},
                           ref["param"], step)
                differ += [f"{k} {name}" for name, tree in trees.items()
                           if not torch.equal(tree[k], ref[name][k])]
                del ref
        if differ:
            fail(f"{workload}: the fused pass and the loop (the fused scale "
                 f"{float(scale)!r}) differ in {len(differ)} of {4 * len(grads)} leaves, "
                 f"first {differ[:4]}")
        print(f"{workload}: one fused pass equals the loop bit for bit in every parameter, "
              f"m, v and master ({len(grads)} leaves; clip scale {float(scale)!r})")
        del before
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fused_pass()
            torch.cuda.synchronize()
        kernel_ms = {e.key: e.device_time_total / e.count / 1e3 for e in prof.key_averages()
                     if "optim_" in e.key}
        t = turns(fused_pass, loop, calls=2, reps=5)
        moved = fused.step_bytes(grads, params)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        rows[cell.config["name"]] = row = {
            "parameters": n, "leaves": len(params), "bytes": moved,
            "bytes_per_parameter": moved / n, "fused_ms": t["ms"], "fused_runs_ms": t["runs_ms"],
            "loop_ms": t["plain_ms"], "loop_runs_ms": t["plain_runs_ms"], "bound_ms": bound_ms,
            "roofline_pct": 100.0 * bound_ms / t["ms"], "kernel_ms": kernel_ms,
            "launches_per_pass": per_pass, "norm": float(norms[0]), "loop_norm": float(want),
            "norm_rel_err": norm_err, "clip_scale": float(scale), "equal_to_loop": True}
        print(f"{workload}: {n:,d} parameters in {len(params)} leaves; loop "
              f"{row['loop_ms']:.3f} ms, fused {row['fused_ms']:.3f} ms (kernels "
              f"{json.dumps({k[:60]: round(v, 4) for k, v in kernel_ms.items()})}), bound "
              f"{bound_ms:.3f} ms ({moved / n:.1f} B a parameter), {row['roofline_pct']:.1f}% "
              f"of it; norm {row['norm']!r} against the loop's {row['loop_norm']!r}")
        del params, grads, state, trees, norms, norm, want, meta
        torch.cuda.empty_cache()
    return rows


def optimizer_kernel_row(rows: dict) -> dict:
    """The ``kernels`` line's ``fused_adamw`` row: phase 3o's times on the
    largest tree (nemotron-3-nano-30b-a3b's stage), each tree's row beside."""
    big = max(rows.values(), key=lambda r: r["parameters"])
    return {"name": "fused_adamw", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_adamw/fused_adamw.cu",
            "replaces": "none in the reference (XLA fuses its jnp update)", "launches": None,
            "equal_to_loop": all(r["equal_to_loop"] for r in rows.values()),
            "ms": big["fused_ms"], "plain_ms": big["loop_ms"], "bound_ms": big["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "bytes": big["bytes"],
            "parameters": big["parameters"], "trees": rows}


def build_all(packages=KERNEL_PACKAGES) -> None:
    """One nvcc per kernel package, all started together."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(packages)) as pool:
        futures = {name: pool.submit(build.build, name) for name in packages}
        logs = {name: f.result() for name, f in futures.items()}  # raises a failed build
    print(f"built {', '.join(packages)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        if log is None:
            print(f"  {name}: cached")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gathers", action="store_true",
                        help="run only phases 1-2 for chunk_gather, the gathers' timings "
                             "(launch floor, B = 8, the large shape, host time) and phase "
                             "4b's profile of the training stager; print them as JSON last")
    parser.add_argument("--decode", action="store_true",
                        help="run only phases 1-2, phase 3's attention kernels (softcap "
                             "cases included), and phases 5, 5b and 5c (tinyllama served "
                             "through the decode graph, its profile beside the eager step's, "
                             "the graph against the eager step); print them as JSON last")
    parser.add_argument("--flash", action="store_true",
                        help="run only phases 1-2 and phase 3's flash-attention rows (the "
                             "prefill forward's times and the training kernels' at the "
                             "benchmark cells' shapes); print them as JSON last")
    parser.add_argument("--optim", action="store_true",
                        help="run only phases 1-2 for fused_adamw and phase 3o: the clip and "
                             "AdamW update on the benchmark configurations' parameter trees, "
                             "the loop against the fused kernels; print them as JSON last")
    parser.add_argument("--examples", action="store_true",
                        help="run only phases 1-2, 14 (the example twins), 15 "
                             "(convergence parity) and 16 (the compiled train step); print "
                             "them as JSON last")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no port sources at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    from repro_torch.kernels.common import resolve_device

    phase = PhaseClock()
    # ------------------------------------------------------------ 1. env
    phase("1. environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    device = resolve_device()  # raises unless capability (9, 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 2. build
    phase("2. build")
    if args.gathers:
        build_all(("chunk_gather",))
        phase("3. the gathers' timings")
        times = time_gathers(device)
        print_gather_times(times)
        for name in ("chunk_gather_train", "chunk_gather"):
            times[name].pop("inputs")
        phase("4b. where the training path's device time goes (torch.profiler)")
        times["staging"] = where_time_goes(MAIN_ARGS)
        phase(None)
        print(card_line)
        print(json.dumps({"gathers": times}))
        return 0
    if args.optim:
        build_all(("fused_adamw",))
        phase("3o. the clip and AdamW update: the loop against the fused kernels")
        rows = optimizer_rows(device)
        phase(None)
        print(card_line)
        print(json.dumps({"optimizer": rows}))
        return 0
    build_all()
    if args.examples:
        examples_run, conv_run, graph_run = examples_and_convergence(phase, device)
        print(card_line)
        print(json.dumps({"examples_path": examples_run, "convergence": conv_run,
                          "train_graph": graph_run}))
        return 0
    if args.flash:
        phase("3. flash attention: prefill times and the training kernels' rows")
        flash = check_flash_main(device)
        flash["training"] = check_flash_train(device)
        flash["mla"] = check_flash_mla(device)
        phase(None)
        print(card_line)
        print(json.dumps({"flash_attention": flash}))
        return 0
    if args.decode:
        phase("3. the attention kernels' parity and times (softcap cases included)")
        check_attention_grid(device)
        kernels = {"flash_attention": check_flash_main(device),
                   "decode_attention": check_decode_main(device)}
        torch.cuda.empty_cache()
        phase("5. serving main path: repro_torch.launch.serve " + " ".join(SERVE_ARGS))
        serve_run, summary = serve_path(SERVE_ARGS)
        phase("5b. where decode's device time goes (torch.profiler), graph and eager")
        serve_run["decode_profile"] = where_decode_time_goes(summary)
        phase("5c. the decode graph against the eager step")
        serve_run["graph_against_eager"] = graph_against_eager(summary, device)
        phase(None)
        print(card_line)
        print(json.dumps({"decode": {"serve_path": serve_run, "kernels": kernels}}))
        return 0

    # ------------------------------------------------- 3. kernel parity
    phase("3. kernel parity (CUDA kernels vs plain PyTorch on the card)")
    check_chunk_gather(device)
    check_chunk_gather_raw(device)
    times = time_gathers(device)
    print_gather_times(times)
    kernels = {name: gather_row(name, times) for name in ("chunk_gather_train", "chunk_gather")}
    kernels["chunk_gather"].update(launches=0, main_path=None)
    check_attention_grid(device)
    kernels["flash_attention"] = check_flash_main(device)
    kernels["flash_attention"]["training"] = check_flash_train(device)
    kernels["flash_attention"]["mla"] = check_flash_mla(device)
    kernels["decode_attention"] = check_decode_main(device)
    check_ssd_grid(device)
    kernels["ssd_scan"] = check_ssd_main(device)
    torch.cuda.empty_cache()
    phase("3o. the clip and AdamW update: the loop against the fused kernels")
    kernels["fused_adamw"] = optimizer_kernel_row(optimizer_rows(device))

    # ------------------------------------------------ 4. training path
    phase("4. training main path: repro_torch.launch.train " + " ".join(MAIN_ARGS))
    run = main_path(MAIN_ARGS, batch=8, seq_len=2048, vocab=32000)
    torch.cuda.empty_cache()

    phase("4b. where the training path's device time goes (torch.profiler)")
    run["profile"] = where_time_goes(MAIN_ARGS)
    if run["profile"]["side_stream_ops_per_batch"] != 2:
        fail(f"a staged batch takes {run['profile']['side_stream_ops_per_batch']} device "
             f"operations on the stager's side stream, not 2 (one copy and the gather)")
    torch.cuda.empty_cache()

    # ------------------------------------------------- 5. serving path
    phase("5. serving main path: repro_torch.launch.serve " + " ".join(SERVE_ARGS))
    serve_run, summary = serve_path(SERVE_ARGS)

    phase("5b. where decode's device time goes (torch.profiler), graph and eager")
    serve_run["decode_profile"] = where_decode_time_goes(summary)

    phase("5c. the decode graph against the eager step")
    serve_run["graph_against_eager"] = graph_against_eager(summary, device)
    del summary
    torch.cuda.empty_cache()

    # -------------------------------------- 6. small-input reference check
    phase("6. reduced tinyllama, zamba2, deepseek-moe-16b, xlstm-350m, llava-next-34b, "
          "hubert-xlarge and phi3-medium-14b f32: card vs CPU on the same weights")
    small_reference(device)
    serve_run["small_serving"] = small_serving(device)
    small_hybrid = small_serving(device, "zamba2-1.2b")
    small_moe = small_serving(device, "deepseek-moe-16b")
    small_xlstm = small_serving(device, "xlstm-350m")
    small_vlm = small_serving(device, "llava-next-34b")
    small_frontend = small_frontends(device)

    # ---------------------------------------------- 7. hybrid serving path
    phase("7. hybrid serving main path: repro_torch.launch.serve " + " ".join(HYBRID_ARGS))
    hybrid_run, summary = hybrid_path(HYBRID_ARGS)
    hybrid_run["small_serving"] = small_hybrid

    phase("7b. where the hybrid's prefill and decode device time goes (torch.profiler)")
    hybrid_run["prefill_profile"] = where_prefill_time_goes(summary)
    hybrid_run["decode_profile"] = where_decode_time_goes(summary)
    del summary
    torch.cuda.empty_cache()

    # ------------------------------------------------ 8. data-service path
    phase("8. data-service main path: repro_torch.launch.data_service --serve and "
          "repro_torch.launch.train " + " ".join(SERVED_ARGS) + " --data-server SOCK; "
          + " ".join(AUTOTUNE_ARGS))
    ds_run = data_service_path()
    ds_run["main_path_profile"] = {k: run["profile"][k] for k in
                                   ("idle_share", "ops_per_step", "side_stream_ops_per_batch")}
    ds_run["main_path_steady_tokens_per_s"] = run["steady_tokens_per_s"]
    torch.cuda.empty_cache()

    # --------------------------------------------- 9. MoE serving path
    phase("9. MoE serving main path: repro_torch.launch.serve " + " ".join(MOE_ARGS))
    moe_run, summary = moe_path(MOE_ARGS)
    moe_run["small_serving"] = small_moe

    phase("9b. where the MoE decode's device time goes (torch.profiler)")
    moe_run["decode_profile"] = where_decode_time_goes(summary)
    del summary
    torch.cuda.empty_cache()

    phase(f"9c. MoE decode vs a fresh prefill, f32, capacity factor {NO_DROP_CAPACITY}: "
          + " ".join(MOE_CHECK_ARGS))
    moe_run["check"] = moe_agreement(MOE_CHECK_ARGS)
    torch.cuda.empty_cache()

    # ------------------------------------------- 10. xLSTM serving path
    phase("10. xLSTM serving main path: repro_torch.launch.serve " + " ".join(XLSTM_ARGS))
    xlstm_run, summary = xlstm_path(XLSTM_ARGS)
    xlstm_run["small_serving"] = small_xlstm
    del summary
    torch.cuda.empty_cache()

    phase(f"10b. xLSTM decode step {XLSTM_AGREEMENT_STEP} vs a fresh prefill, f32")
    xlstm_run["check"] = xlstm_agreement(XLSTM_ARGS)
    torch.cuda.empty_cache()

    # --------------------------------------------- 11. VLM serving path
    phase("11. VLM serving main path: repro_torch.launch.serve " + " ".join(VLM_ARGS))
    vlm_run, summary = vlm_path(VLM_ARGS)
    vlm_run["small_serving"] = small_vlm

    phase("11b. where the VLM decode's device time goes (torch.profiler)")
    vlm_run["decode_profile"] = where_decode_time_goes(summary)

    phase("11c. VLM decode vs a fresh prefill, bf16, a cache that holds the patches")
    vlm_run["check"] = vlm_agreement(summary, int(VLM_ARGS[VLM_ARGS.index("--new-tokens") + 1]))
    del summary
    torch.cuda.empty_cache()

    # -------------------------------------------- 12. encoder training path
    phase("12. encoder training main path: repro_torch.launch.train " + " ".join(ENCODER_ARGS)
          + "; then --optimizer sgdm --steps 3")
    enc_run = encoder_path()
    enc_run["small_reference"] = small_frontend
    torch.cuda.empty_cache()

    phase("12b. where the encoder training path's device time goes (torch.profiler)")
    enc_run["profile"] = where_time_goes(ENCODER_ARGS)
    torch.cuda.empty_cache()

    phase(f"12c. sequence-split attention: phi3-medium-14b, {VECQ_LAYERS} layers at full width, "
          f"B=1, S={VECQ_SEQ}, bf16")
    enc_run["vecq"] = vecq_check(device)
    torch.cuda.empty_cache()

    # ----------------------------------------- 13. the all-to-all MoE path
    phase("13. all-to-all MoE serving path: deepseek-moe-16b moe_impl=a2a under a 1x1 mesh, "
          + " ".join(MOE_ARGS))
    a2a_run, summary = a2a_path(MOE_ARGS, moe_run)
    del summary
    torch.cuda.empty_cache()

    phase(f"13b. moe_block_a2a vs moe_block, f32, {A2A_CHECK_LAYERS} layers at full width, "
          f"capacity factors {A2A_CAPACITY} and {NO_DROP_CAPACITY}: " + " ".join(MOE_CHECK_ARGS))
    a2a_run["check"] = a2a_agreement(MOE_CHECK_ARGS)

    phase("13c. dry run: python -m repro_torch.launch.dryrun " + " ".join(DRYRUN_ARGS))
    a2a_run["dryrun"] = dryrun_cell()
    torch.cuda.empty_cache()

    examples_run, conv_run, graph_run = examples_and_convergence(phase, device)

    # Launches in the main paths' runs: flash and decode run in the five
    # attention serving paths, ssd_scan in the hybrid's; the raw gather is
    # on no path, and the xLSTM path launches no kernel.
    by_path = {"serve_path": serve_run["launches"], "hybrid_path": hybrid_run["launches"],
               "moe_path": moe_run["launches"], "vlm_path": vlm_run["launches"],
               "moe_a2a_path": a2a_run["launches"],
               "examples_path": examples_run["serve"]["launches"]}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        counts = {path: launches[name] for path, launches in by_path.items() if name in launches}
        kernels[name]["launches"] = sum(counts.values())
        kernels[name]["launches_by_path"] = counts
    # The training gather runs on phase 4's path, phase 8's autotuned one,
    # phase 12's two, the example trainer's two runs and phase 15's Redox
    # runs; the data-server path ships assembled grids and launches none.
    counts = {"main_path": run["launches"], "data_service_path": ds_run["gather_launches"],
              "autotune_path": ds_run["autotune"]["gather_launches"],
              "encoder_path": enc_run["launches"],
              "encoder_sgdm_path": enc_run["sgdm"]["launches"],
              "examples_path": sum(r["launches"] for r in examples_run["train"]["runs"]),
              "convergence_path": sum(n for cell in conv_run.values()
                                      for n in cell["launches"].values())}
    kernels["chunk_gather_train"]["launches"] = sum(counts.values())
    kernels["chunk_gather_train"]["launches_by_path"] = counts
    # The fused optimizer runs wherever AdamW trains on the card: phase 4's
    # path, phase 8's two, the example trainer's runs and phase 15's; phase
    # 12's Adafactor and SGDM runs take the loop and launch none.
    counts = {"main_path": run["optim_launches"],
              "data_service_path": ds_run["optim_launches"],
              "autotune_path": ds_run["autotune"]["optim_launches"],
              "encoder_path": enc_run["optim_launches"],
              "encoder_sgdm_path": enc_run["sgdm"]["optim_launches"],
              "examples_path": sum(r["optim_launches"] for r in examples_run["train"]["runs"]),
              "convergence_path": sum(n for cell in conv_run.values()
                                      for n in cell["optim_launches"].values())}
    kernels["fused_adamw"]["launches"] = sum(counts.values())
    kernels["fused_adamw"]["launches_by_path"] = counts

    # ----------------------------------------------------------- result
    print(f"phase wall times, s: {json.dumps({k: round(v, 1) for k, v in phase.times.items()})}")
    print(json.dumps({"main_path": run}))
    print(json.dumps({"serve_path": serve_run}))
    print(json.dumps({"hybrid_path": hybrid_run}))
    print(json.dumps({"data_service_path": ds_run}))
    print(json.dumps({"moe_path": moe_run}))
    print(json.dumps({"xlstm_path": xlstm_run}))
    print(json.dumps({"vlm_path": vlm_run}))
    print(json.dumps({"encoder_path": enc_run}))
    print(json.dumps({"moe_a2a_path": a2a_run}))
    print(json.dumps({"examples_path": examples_run}))
    print(json.dumps({"convergence": conv_run}))
    print(json.dumps({"train_graph": graph_run}))
    print(card_line)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
